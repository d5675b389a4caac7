"""Event sinks: Kafka (wire-compatible payloads) + local transports."""

from .kafka_sink import KafkaSink  # noqa: F401
from .eventbus import EventBusBroker, EventBusPublisher, EventBusSubscriber  # noqa: F401
