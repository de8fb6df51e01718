"""K9, the iterated guided chain (csrc/guided_chain.cu): its bound a frame
(the guide's and the source's float32 planes read once, the output
written once, at the HBM's rate) over its device time a frame (the
guide's statistics and every application)."""
LAYER = "kernels"
KERNELS = (r"gf_moment_cols", r"gc_stats_rows", r"gc_solve_cached_rows",
           r"col_sum_kernel", r"gf_apply_rows")


def read(run):
    from benchmark import counts
    from benchmark.metrics._shares import roofline
    return roofline(run, KERNELS,
                    counts.k9_bound_s(run.window["pixels"],
                                      run.config["iterations"]))
