"""K7's backward (csrc/cnn_train.cu), its block sum included: its bound a
step (twice the forward's MACs at the TF32 peak) over its device time a
step."""
LAYER = "kernels"
KERNELS = (r"trunk_bwd_kernel", r"sum_partials_kernel",
           r"stage_frags_kernel")


def read(run):
    from benchmark import counts
    from benchmark.metrics._shares import roofline
    return roofline(run, KERNELS,
                    counts.k7_bwd_bound_s(run.window["pixels"]))
