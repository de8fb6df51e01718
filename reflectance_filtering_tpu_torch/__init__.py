"""reflectance_filtering_tpu_torch — the PyTorch/CUDA port of
reflectance_filtering_tpu for NVIDIA Hopper (H100).

The JAX package beside it is the reference; this package computes the
same functions with PyTorch for the plain tensor code and hand-written
CUDA C++ kernels (``csrc/*.cu``, built for ``sm_90a`` at first use) for
what the JAX package wrote in Pallas.  It never imports ``jax`` or
``reflectance_filtering_tpu``.

Ported so far: every TPU kernel (K1-K9 in ``csrc/``) and the paths over
them — the BF(CNN,CNN) and GF(CNN, image) serving pipelines
(``utils/serving.py``), the decompose and filter CLIs (the approximate
bilateral grid among the filter types), the iterated guided chain,
training (``train/``, ``cli/train.py`` with ``--decompose``), the dataset
builder (``data/builder.py``, ``cli/build_dataset.py``) and multi-GPU
data and spatial parallelism (``parallel/``).  Not yet: the serving
export (``torch.export`` artifacts).

Every kernel wrapper dispatches on the device of the tensor it is given:
a CPU tensor runs the plain PyTorch version, a CUDA tensor launches the
kernel (or raises).  Nothing here touches CUDA at import time.
"""

__version__ = "0.1.0"
