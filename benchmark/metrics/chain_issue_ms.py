"""The host's time to issue a frame's first kernel, the part of the
frame's issue that the card waits for: the median over the traced frames
of the program's span ``guided.stats``
(``ops/guided_chain_kernel.py::guided_filter_chain``: K9's statistics
pass checked, its buffers taken and launched).  The later launches of the
frame overlap the card's work and are left out; the one launch held
carries CUPTI's cost, as the traced run has it."""
LAYER = "filter entry"


def read(run):
    from benchmark.metrics._spans import traced_median_ms
    return traced_median_ms(run, "guided.stats")
