"""Data parallelism over processes (mesh.py) and width-sharded filters of
single large frames (spatial.py)."""
