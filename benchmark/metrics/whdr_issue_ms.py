"""The host's time to issue a served batch's WHDR: the median over the
traced requests of the program's span ``whdr.per_image``
(``losses/whdr.py::whdr_per_image``: K3 and the glue around it),
recorded while the card's trace ran.  CUPTI lengthens each of its ~30
launches, so this traced reading lies above the untraced issue, more than
``forward_issue_ms`` does."""
LAYER = "serving"


def read(run):
    from benchmark.metrics._spans import traced_median_ms
    return traced_median_ms(run, "whdr.per_image")
