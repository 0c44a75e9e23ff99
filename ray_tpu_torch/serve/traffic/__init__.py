"""The traffic plane's per-request deadline and shed error (``config.py``)."""
