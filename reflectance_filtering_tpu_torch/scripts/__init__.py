"""Measurement scripts of the port, each run alone with ``python -m``
(the benchmark measures the product's end-to-end metrics; ``chip_smoke.py``
proves the port on the card and times nothing)."""
