"""K1: the flagship CNN's fused forward (csrc/cnn_fwd.cu), its plain
PyTorch version and its wrapper.

Port of reflectance_filtering_tpu/ops/cnn_pallas.py
(``reflectance_cnn_pallas_planar`` and ``reflectance_cnn_pallas``).  The
kernel is bound by its matrix products (4,192 MACs a pixel), so it runs
layers 1-4 on the tensor cores as 3xTF32 (``mma.sync`` m16n8k8: each f32
operand split into a TF32 hi and lo, hi.hi + hi.lo + lo.hi accumulated in
f32), which keeps about f32's accuracy, as the TPU kernel's bf16 pieces
did on its matrix unit; one TF32 product would keep ~3 decimal digits,
too few for the floor(r * 255) byte gate.  Layer 0 and the 160 -> 1 fuse
are f32 FMAs.  The kernel splits and reorders the weights itself into
shared memory, so :func:`pack_weights` is only a flattening of the
module's ``[in, out]`` matrices (see the notes in csrc/cnn_fwd.cu).

The wrapper runs the ``torch.library`` operator ``rf::cnn_fwd``, which
``torch.export`` records in the serving artifacts (utils/serving.py): its
body dispatches on the device, its fake implementation gives the output's
shape to the tracer.
"""
from __future__ import annotations

from typing import List, Tuple

import torch

from ..models.networks import ReflectanceNet, mlp_forward
from ..utils.image import srgb_to_rgb_t
from . import _build

NUM_WEIGHTS = 4513


def pack_weights(net: ReflectanceNet) -> torch.Tensor:
    """The module's parameters as the kernel's flat f32 [4513] vector, on
    the module's device: per layer ``W [in, out]`` row-major then its
    bias, then the 160 fuse weights and the fuse bias."""
    parts: List[torch.Tensor] = []
    for w, b in zip(net.weights, net.biases):
        parts += [w.reshape(-1), b]
    parts += [net.fuse_weight, net.fuse_bias]
    flat = torch.cat([p.detach().to(torch.float32) for p in parts])
    assert flat.numel() == NUM_WEIGHTS
    return flat.contiguous()


def _unpack(flat: torch.Tensor) -> Tuple[list, list, torch.Tensor,
                                         torch.Tensor]:
    weights, biases = [], []
    i, ci = 0, 3
    for _ in range(5):
        weights.append(flat[i:i + ci * 32].reshape(ci, 32))
        biases.append(flat[i + ci * 32:i + ci * 32 + 32])
        i += ci * 32 + 32
        ci = 32
    return weights, biases, flat[i:i + 160], flat[i + 160:i + 161]


def reflectance_cnn_plain(x: torch.Tensor, weights: torch.Tensor, *,
                          srgb_input: bool) -> torch.Tensor:
    """Plain version of K1: planar x [B, 3, HW] f32 -> [B, HW]."""
    if srgb_input:
        x = srgb_to_rgb_t(x)
    return mlp_forward(x.transpose(1, 2), *_unpack(weights))[..., 0]


@torch.library.custom_op("rf::cnn_fwd", mutates_args=(),
                         schema="(Tensor x, Tensor weights, bool srgb_input)"
                                " -> Tensor")
def _cnn_fwd(x: torch.Tensor, weights: torch.Tensor,
             srgb_input: bool) -> torch.Tensor:
    """K1 as an operator ``torch.export`` can trace: a CPU tensor runs
    :func:`reflectance_cnn_plain`, a CUDA tensor launches the kernel."""
    if x.device.type == "cpu":
        return reflectance_cnn_plain(x, weights, srgb_input=srgb_input)
    _build.require_cuda(x, "reflectance_cnn")
    b, _, hw = x.shape
    # checked here, at call time: a symbolic export's batch is unbounded
    if b > 65535:
        raise ValueError("batch {} exceeds the kernel's grid limit of "
                         "65535".format(b))
    out = torch.empty((b, hw), dtype=torch.float32, device=x.device)
    if out.numel():
        _build.launch("rf_cnn_fwd", x.device, x.data_ptr(),
                      weights.data_ptr(), out.data_ptr(), b, hw,
                      int(bool(srgb_input)))
        _build.count(reflectance_cnn)
    return out


@_cnn_fwd.register_fake
def _(x, weights, srgb_input):
    return x.new_empty((x.shape[0], x.shape[2]))


def reflectance_cnn(x: torch.Tensor, weights: torch.Tensor, *,
                    srgb_input: bool) -> torch.Tensor:
    """Fused flagship forward: planar x [B, 3, HW] f32 (RGB in [0, 1];
    sRGB with ``srgb_input=True``, linear otherwise) and the flat weights
    of :func:`pack_weights` -> reflectance intensity [B, HW] in (0, 1).

    Runs the operator ``torch.ops.rf.cnn_fwd``: a CPU tensor runs
    :func:`reflectance_cnn_plain`; a CUDA tensor launches the kernel."""
    _build.check_tensor(x, "x", torch.float32, 3)
    _build.check_tensor(weights, "weights", torch.float32, 1)
    if x.shape[1] != 3 or weights.numel() != NUM_WEIGHTS:
        raise ValueError("expected x [B, 3, HW] and weights [{}], got {} "
                         "and {}".format(NUM_WEIGHTS, tuple(x.shape),
                                         tuple(weights.shape)))
    if weights.device != x.device:
        raise ValueError("x and weights must share a device")
    if x.device.type != "cpu":
        _build.require_cuda(x, "reflectance_cnn")
    return torch.ops.rf.cnn_fwd(x, weights, bool(srgb_input))


reflectance_cnn.launches = 0
