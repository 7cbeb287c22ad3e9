"""Host-side reductions of telemetry and state (`utils/metrics.py`)."""
