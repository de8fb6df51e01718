"""Image numerics, synthetic workloads and the serving pipeline."""
