"""The per-layer metrics' readers, one file a kind of metric: the metric
``<name>`` of BENCHMARK.json is read by ``<name>.py`` or, where there is
none, by the file of the part of its name before the first dot, so that
``idle_share.serve_bf`` and ``idle_share.train`` share ``idle_share.py``.
A file holds its layer (``LAYER``), for a kernel the names it matches in
the trace (``KERNELS``), and ``read(run)``, which returns the number or
None where the run holds nothing to read.  The end-to-end metric each
should move is BENCHMARK.json's ``moves``."""
