"""K1, the flagship CNN's forward (csrc/cnn_fwd.cu): its bound a batch
(the forward's MACs at the TF32 peak) over its device time a batch."""
LAYER = "kernels"
KERNELS = (r"cnn_fwd_kernel",)


def read(run):
    from benchmark import counts
    from benchmark.metrics._shares import roofline
    return roofline(run, KERNELS,
                    counts.k1_bound_s(run.window["pixels"]))
