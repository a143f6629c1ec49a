"""Command-line tools: the accuracy-parity harness (``tools/parity.py``)."""
