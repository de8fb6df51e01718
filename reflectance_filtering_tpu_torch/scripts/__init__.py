"""Measurement scripts of the port, each runnable with ``python -m`` and
importable (``chip_smoke.py`` calls their functions)."""
