"""K2, the self-guided gray bilateral (csrc/bilateral_gray_self.cu): its
bound a batch (2 FMAs a disk tap at the float32 peak) over its device
time a batch."""
LAYER = "kernels"
KERNELS = (r"bilateral_gray_self",)


def read(run):
    from benchmark import counts
    from benchmark.metrics._shares import roofline
    sigma = run.config["bilateral"]["sigma_space"]
    return roofline(run, KERNELS,
                    counts.k2_bound_s(run.window["pixels"], sigma))
