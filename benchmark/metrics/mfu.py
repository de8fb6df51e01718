"""The whole request's or step's share of the card's TF32 peak: the
model FLOPs a request (``model_flops``, the entry's count from
``benchmark/counts.py``: a served batch's forward, 8,704 a pixel, or a
training step's forward and backward, 3 x 8,704 a pixel) over the
window's wall time a request at 494.7 TFLOP/s."""
LAYER = "model step"


def read(run):
    from benchmark import counts
    from benchmark.metrics._shares import window_s_per_unit
    t = window_s_per_unit(run)
    if t is None or "model_flops" not in run.window:
        return None
    return 100.0 * run.window["model_flops"] / (t * counts.TF32_FLOP_S)
