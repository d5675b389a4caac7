"""Training on one device (the JAX package's ``parallel`` without its mesh).

  * ``train`` — the detection train step: loss, backward, AdamW update.

The JAX package's ``mesh`` (device meshes and shardings) waits for the
multi-device slice (ROADMAP.md Queue A item 7).
"""

from .train import (  # noqa: F401
    TrainState,
    anchor_centers,
    detection_loss,
    make_train_step,
    synthetic_targets,
)
