"""Host-side helpers of the port (``utils/logger.py``)."""
