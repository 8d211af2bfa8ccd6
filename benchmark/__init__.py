"""The port's benchmark: one command runs one cell (``benchmark/run.py``)."""
