"""The host's time to issue a served batch's WHDR: the median over the
traced requests of the program's span ``whdr.per_image``
(``losses/whdr.py::whdr_per_image``: on the card, with no gradient
wanted, its checks and one ``whdr_scores`` launch), recorded while the
card's trace ran.  CUPTI lengthens the launch, so this traced reading
lies above the untraced issue."""
LAYER = "serving"


def read(run):
    from benchmark.metrics._spans import traced_median_ms
    return traced_median_ms(run, "whdr.per_image")
