"""reflectance_filtering_tpu_torch — the PyTorch/CUDA port of
reflectance_filtering_tpu for NVIDIA Hopper (H100).

The JAX package beside it is the reference; this package computes the
same functions with PyTorch for the plain tensor code and hand-written
CUDA C++ kernels (``csrc/*.cu``, built for ``sm_90a`` at first use) for
what the JAX package wrote in Pallas.  It never imports ``jax`` or
``reflectance_filtering_tpu``.

Ported so far: the BF(CNN,CNN) serving path — uint8 photo -> reflectance
CNN -> ``floor(r*255)`` -> self-guided gray bilateral (sigma_c=20,
sigma_s=22) -> ``rint``/clip -> WHDR — with its CLIs
(``cli/decompose.py``, ``cli/filter.py``) and ``utils/serving.py``.

Every kernel wrapper dispatches on the device of the tensor it is given:
a CPU tensor runs the plain PyTorch version, a CUDA tensor launches the
kernel (or raises).  Nothing here touches CUDA at import time.
"""

__version__ = "0.1.0"
