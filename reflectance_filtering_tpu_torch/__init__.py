"""reflectance_filtering_tpu_torch — the PyTorch/CUDA port of
reflectance_filtering_tpu for NVIDIA Hopper (H100).

The JAX package beside it is the reference; this package computes the
same functions with PyTorch for the plain tensor code and hand-written
CUDA C++ kernels (``csrc/*.cu``, built for ``sm_90a`` at first use) for
what the JAX package wrote in Pallas.  It never imports ``jax`` or
``reflectance_filtering_tpu``.

The port does everything the JAX package does: every TPU kernel (K1-K9
in ``csrc/``) and the paths over them — the BF(CNN,CNN) and GF(CNN,
image) serving pipelines and their export as ``torch.export`` artifacts
(``utils/serving.py``), the decompose and filter CLIs (the approximate
bilateral grid among the filter types), the iterated guided chain,
training (``train/``, ``cli/train.py`` with ``--decompose``), the dataset
builder (``data/builder.py``, ``cli/build_dataset.py``) and multi-GPU
data and spatial parallelism (``parallel/``).

Every kernel wrapper dispatches on the device of the tensor it is given:
a CPU tensor runs the plain PyTorch version, a CUDA tensor launches the
kernel (or raises).  The kernels of the exported paths (K1, K2, K5) are
``torch.library`` operators (``rf::cnn_fwd``, ``rf::bilateral_gray_self``,
``rf::guided_filter``), registered when their modules are imported, so
that ``torch.export`` can trace them.  Nothing here touches CUDA at
import time.
"""

__version__ = "0.1.0"
