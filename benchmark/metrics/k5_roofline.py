"""K5, the guided filter with a color guide (csrc/guided.cu): its bound a
batch (5 bytes a pixel, or its operations at the float32 peak) over its
device time a batch."""
LAYER = "kernels"
KERNELS = (r"gf_fused_kernel", r"gf_solve_rows", r"gf_moment_cols",
           r"col_sum_kernel", r"gf_apply_rows")


def read(run):
    from benchmark import counts
    from benchmark.metrics._shares import roofline
    return roofline(run, KERNELS,
                    counts.k5_bound_s(run.window["pixels"]))
