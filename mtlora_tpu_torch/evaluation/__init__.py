"""Evaluation meters of the port (``evaluation/meters.py``)."""
