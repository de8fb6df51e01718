"""The card's idle share over the traced calls (requests, frames or chunks
of steps): 100 x (1 - the union of the kernel, copy and memset intervals
over the calls' spans on the card's clock)."""
LAYER = "device"


def read(run):
    from benchmark.metrics._shares import idle_share
    return idle_share(run)
