"""Host-side observability helpers of the port (`obs/tags.py`)."""
