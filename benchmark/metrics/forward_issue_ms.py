"""The host's time to issue a served batch's pipeline: the median over
the traced requests of the program's span ``serve.forward``
(``utils/serving.py::FlagshipModule.forward``: K1 with the flip and cast,
the filter, the rounding), recorded while the card's trace ran, so each
of its launches carries CUPTI's cost: a traced reading, above the
untraced issue."""
LAYER = "serving"


def read(run):
    from benchmark.metrics._spans import traced_median_ms
    return traced_median_ms(run, "serve.forward")
