"""CLI entry points: realtime-analytics / realtime-analytics-dashboard."""
