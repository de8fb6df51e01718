"""The plain reference that decides ``correct``: straightforward PyTorch,
float32 with TF32 off (float64 where a filter sums many terms), written
from the paper's and OpenCV's definitions.  It imports nothing of
reflectance_filtering_tpu_torch, nor JAX or the JAX package, and takes
nothing that the program made: it rebuilds the disk, the tables and the
training state from the inputs the benchmark hands to both sides.

``low=True`` computes each stage one precision step lower: matrix products
on TF32-rounded operands, other float32 arithmetic in bfloat16.  That is the
control, which the comparison has to fail.
"""
