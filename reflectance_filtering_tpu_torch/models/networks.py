"""Reflectance networks in PyTorch (port of
reflectance_filtering_tpu/models/networks.py).

Two faces of the same numbers:

* ``ReflectanceNet`` is the shipped model for serving (:632-674): a
  per-pixel MLP 3 -> 32 -> 32 -> 32 -> 32 -> 32 with ReLU, skip-concat of
  the five activations to 160 channels, 160 -> 1 fuse, sigmoid — 4,513
  parameters, kept as plain ``[in, out]`` matrices so the module, the CUDA
  kernel K1 (ops/cnn_kernel.py) and the JAX package read the same numbers
  in the same order.
* ``init_network`` / ``apply_network`` are the training factories of all
  seven architectures (:239-611) and of pix2pix's U-Net generator
  (``pix2pixUnet``, which the JAX package lacks): parameters are the JAX
  package's pytree as torch tensors, ``{"conv0": {"kernel": HWIO, "bias":
  [out]}, ..., "bn0": {"mean", "var"}, ...}``, and images are NHWC.  For the
  skip-layer trunks (``convStaticSkipLayers`` and both levels of
  ``cascadeSkipLayers``), a CUDA tensor whose config passes
  ``fits_fused_trunk`` runs the fused trunk K7 (ops/cnn_train_kernel.py);
  every other config and architecture runs plain ``F.conv2d`` /
  ``F.conv_transpose2d``, as the JAX package runs XLA convolutions for
  them.  Batch normalization is caffe's (no scale or shift): batch
  statistics in training, folded into the running ones after the
  optimizer step (:func:`update_bn_stats`), the running ones in eval;
  pix2pix's is PyTorch's ``BatchNorm2d`` (:func:`batch_norm` with
  ``gamma`` and ``beta``).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops import _build
from ..ops.cnn_train_kernel import fits_fused_trunk, skip_trunk_pre
from ..utils.profiling import span
from .recover import recover_reflectance_shading

Params = Dict[str, Dict[str, torch.Tensor]]

# Head width per RS estimation mode (the reference's networks.py:95-111).
_SCALAR_MODES = (
    "sAbs", "rAbs",
    "rRelNorm", "rRelMean", "rRelY", "rRelMax",
    "sRelNorm", "sRelMean", "sRelY", "sRelMax",
    "rDirectly",
)

NETWORK_TYPES = (
    "uNet",
    "simpleConvolutionsRelu",
    "convStatic",
    "convIncreasing",
    "convStaticWithSigmoid",
    "convStaticSkipLayers",
    "cascadeSkipLayers",
    "pix2pixUnet",
)

def head_channels(rs_est_mode: str) -> int:
    mode = rs_est_mode.split("-")[0]
    if mode == "RS":
        return 6
    if mode in ("S", "R"):
        return 3
    if mode in _SCALAR_MODES:
        return 1
    raise ValueError("RS-estimation '{}' not known".format(mode))


@dataclasses.dataclass(frozen=True)
class NetworkConfig:
    """Architecture hyperparameters (the network-shaping subset of the
    reference's flags)."""

    network_type: str = "convStaticSkipLayers"
    num_layers: int = 5
    num_filters_log: int = 5           # 2**k filters
    kernel_pad: int = 0                # kernel = 2p+1
    dilation: int = 1
    use_batch_normalization: bool = False
    rs_est_mode: str = "rDirectly"

    @property
    def kernel(self) -> int:
        return 2 * self.kernel_pad + 1

    @property
    def pad(self) -> int:
        return self.kernel_pad + (self.dilation - 1)

    @property
    def num_filters(self) -> int:
        return 2 ** self.num_filters_log

    @property
    def num_output_final(self) -> int:
        return head_channels(self.rs_est_mode)


# The shipped trained model: five 1x1x32 convs + 160->1 fuse + sigmoid,
# rDirectly head.
REFERENCE_CONFIG = NetworkConfig()

_LAYERS = tuple("conv{}".format(i) for i in range(REFERENCE_CONFIG.num_layers))
_FUSE = "fuse_skip_layers"


def mlp_forward(x: torch.Tensor, weights: Sequence[torch.Tensor],
                biases: Sequence[torch.Tensor], fuse_weight: torch.Tensor,
                fuse_bias: torch.Tensor) -> torch.Tensor:
    """x [..., 3] linear RGB -> reflectance intensity [..., 1] in (0, 1).

    The plain forward: matmul + ReLU per layer, skip-concat, fuse,
    sigmoid — the twin of the JAX ``reflectance_net_apply``."""
    skips = []
    for w, b in zip(weights, biases):
        x = torch.relu(x @ w + b)
        skips.append(x)
    pre = torch.cat(skips, dim=-1) @ fuse_weight[:, None] + fuse_bias
    return torch.sigmoid(pre)


class ReflectanceNet(nn.Module):
    """The shipped model; ``forward`` maps [..., 3] linear RGB to
    reflectance intensity [..., 1].  Parameters start at zero: load them
    with ``load_state_dict(params_from_numpy(...))``."""

    def __init__(self, cfg: NetworkConfig = REFERENCE_CONFIG):
        super().__init__()
        if cfg != REFERENCE_CONFIG:
            raise NotImplementedError(
                "ReflectanceNet is the shipped convStaticSkipLayers n5 f32 k1 "
                "rDirectly network; use init_network/apply_network for "
                "other skip-layer configs")
        f = cfg.num_filters
        dims = [3] + [f] * cfg.num_layers
        self.weights = nn.ParameterList(
            nn.Parameter(torch.zeros(ci, f)) for ci in dims[:-1])
        self.biases = nn.ParameterList(
            nn.Parameter(torch.zeros(f)) for _ in dims[:-1])
        self.fuse_weight = nn.Parameter(torch.zeros(f * cfg.num_layers))
        self.fuse_bias = nn.Parameter(torch.zeros(1))

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return mlp_forward(images, list(self.weights), list(self.biases),
                           self.fuse_weight, self.fuse_bias)


def params_from_numpy(params: Dict) -> Dict[str, torch.Tensor]:
    """The JAX package's params (``{conv0..conv4, fuse_skip_layers:
    {kernel HWIO, bias}}`` as numpy, e.g. ``caffe_io.load_reference_weights``
    or ``reference_params_from_caffe`` after ``np.asarray``) -> a
    ``ReflectanceNet`` state dict."""
    state = {}
    for i, name in enumerate(_LAYERS):
        state["weights.{}".format(i)] = torch.tensor(
            np.asarray(params[name]["kernel"], np.float32)[0, 0])
        state["biases.{}".format(i)] = torch.tensor(
            np.asarray(params[name]["bias"], np.float32).reshape(-1))
    state["fuse_weight"] = torch.tensor(
        np.asarray(params[_FUSE]["kernel"], np.float32)[0, 0, :, 0])
    state["fuse_bias"] = torch.tensor(
        np.asarray(params[_FUSE]["bias"], np.float32).reshape(1))
    return state


def seeded_reference_params(seed: int) -> Dict[str, Dict[str, np.ndarray]]:
    """Random weights of the shipped model's shapes (4,513 floats), in the
    converter's numpy layout, made from ``seed`` with numpy alone.

    Kernels are normal with std 1.5/sqrt(fan_in) (6/sqrt(160) for the
    fuse) and biases N(0, 0.01), so that the reflectance of a natural
    photo spreads over much of (0, 1) and the ``floor(r*255)`` byte path
    crosses many levels."""
    rng = np.random.RandomState(seed)
    f = REFERENCE_CONFIG.num_filters
    out = {}
    ci = 3
    for name in _LAYERS:
        out[name] = {
            "kernel": (rng.randn(1, 1, ci, f) * 1.5 / np.sqrt(ci)
                       ).astype(np.float32),
            "bias": (rng.randn(f) * 0.1).astype(np.float32),
        }
        ci = f
    fan = f * REFERENCE_CONFIG.num_layers
    out[_FUSE] = {
        "kernel": (rng.randn(1, 1, fan, 1) * 6.0 / np.sqrt(fan)
                   ).astype(np.float32),
        "bias": (rng.randn(1) * 0.1).astype(np.float32),
    }
    return out


# ---------------------------------------------------------------------------
# Training factories: primitives
# ---------------------------------------------------------------------------

def xavier_uniform(shape_hwio: Sequence[int], generator: torch.Generator,
                   device=None) -> torch.Tensor:
    """Caffe's 'xavier' filler: U(-a, a), a = sqrt(3 / fan_in), fan_in =
    KhKwCi.  Same distribution as the JAX package's; the numbers differ
    (another generator)."""
    kh, kw, ci, _ = shape_hwio
    a = float(np.sqrt(3.0 / (kh * kw * ci)))
    u = torch.rand(tuple(shape_hwio), generator=generator,
                   dtype=torch.float32)
    return ((u * 2.0 - 1.0) * a).to(device)


def _conv_init(generator, kh, kw, ci, co, device) -> Dict[str, torch.Tensor]:
    return {"kernel": xavier_uniform((kh, kw, ci, co), generator, device),
            "bias": torch.zeros((co,), dtype=torch.float32, device=device)}


@contextlib.contextmanager
def matmul_precision(name: str):
    """Scope the float32 matmul/convolution precision of the plain path
    ('highest': full float32; 'high' and 'default': TF32 on the card).
    The fused trunk K7 always runs plain f32 FMAs and ignores this."""
    if name.lower() not in ("default", "high", "highest"):
        raise ValueError("matmul precision must be default, high or "
                         "highest, got {}".format(name))
    tf32 = name.lower() != "highest"
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def conv2d(params: Dict[str, torch.Tensor], x: torch.Tensor, *,
           pad: int = 0, stride: int = 1, dilation: int = 1) -> torch.Tensor:
    """NHWC conv with an HWIO kernel and zero padding (caffe Convolution),
    plus ``params["bias"]`` where there is one; a 1x1 kernel at stride 1
    without padding is a per-pixel matmul.  The convolutions (cuDNN's on a
    card), not the matmuls, count on ``conv2d.launches``, replays of a
    captured step included."""
    k, bias = params["kernel"], params.get("bias")
    if k.shape[0] == 1 and k.shape[1] == 1 and pad == 0 and stride == 1:
        y = x @ k[0, 0]
        return y if bias is None else y + bias
    _build.count(conv2d)
    y = F.conv2d(x.permute(0, 3, 1, 2), k.permute(3, 2, 0, 1), bias,
                 stride=stride, padding=pad, dilation=dilation)
    return y.permute(0, 2, 3, 1)


def deconv2d(params: Dict[str, torch.Tensor], x: torch.Tensor, *,
             stride: int = 2, pad: int = 0) -> torch.Tensor:
    """Caffe Deconvolution (uNet's up path: kernel = stride, pad 0; pix2pix's:
    4x4, stride 2, pad 1), plus ``params["bias"]`` where there is one: the
    JAX package's ``lax.conv_transpose`` of an HWIO kernel without
    ``transpose_kernel`` does not flip the kernel and
    ``F.conv_transpose2d`` does, so the kernel is flipped spatially here
    and laid out [in, out, kh, kw].  Tap a of the kernel (K below) then
    reaches output row s i + (kh - 1 - a) - pad from input row i: the
    output is the correlation of the input spread s apart (zeros between)
    with K, zero-padded by kh - 1 - pad.  Counts on ``deconv2d.launches``,
    as :func:`conv2d` does."""
    k = params["kernel"].flip(0, 1).permute(2, 3, 0, 1)
    _build.count(deconv2d)
    y = F.conv_transpose2d(x.permute(0, 3, 1, 2), k, params.get("bias"),
                           stride=stride, padding=pad)
    return y.permute(0, 2, 3, 1)


conv2d.launches = 0
deconv2d.launches = 0


def bn_init(channels: int, device=None) -> Dict[str, torch.Tensor]:
    return {"mean": torch.zeros((channels,), dtype=torch.float32,
                                device=device),
            "var": torch.ones((channels,), dtype=torch.float32,
                              device=device)}


BN_MOMENTUM = 0.999  # caffe moving_average_fraction default


def _global_mean(x: torch.Tensor, group, size: int) -> torch.Tensor:
    """The channel mean of NHWC ``x`` over the batch of every rank in
    ``group`` (equal rows on each), differentiable through the all-reduce."""
    from torch.distributed.nn.functional import all_reduce
    return all_reduce(x.mean(dim=(0, 1, 2)), group=group) / size


# PyTorch's BatchNorm2d default, pix2pix's normalization
TORCH_BN_MOMENTUM = 0.1


def batch_norm(params: Dict[str, torch.Tensor], x: torch.Tensor, *,
               train: bool, eps: float = 1e-5, group=None):
    """Caffe BatchNorm (no learned scale or shift: the reference never
    pairs it with a Scale layer) over NHWC -> (y, the statistics used).

    Training normalises with the batch's mean and population variance
    (ddof 0, as ``jnp.var``) and the caller folds them into the running
    statistics (:func:`update_bn_stats`); eval uses the running ones, as
    caffe's TEST phase does.  Under a process ``group`` (the data-parallel
    step, each rank holding equal rows of the batch) the moments are the
    global batch's, as the JAX package's sharded step normalises over the
    whole batch: all-reduced, with autograd through the reduction.

    With ``gamma`` and ``beta`` in ``params`` it is PyTorch's
    ``BatchNorm2d`` instead (:func:`_affine_batch_norm`), which returns
    no statistics: it updates the running ones itself."""
    if "gamma" in params:
        if group is not None:
            raise NotImplementedError(
                "the affine batch norm has no data-parallel form: each "
                "rank would move its running statistics apart")
        return _affine_batch_norm(params, x, train=train, eps=eps), None
    if train and group is not None:
        import torch.distributed as dist
        size = dist.get_world_size(group)
        mean = _global_mean(x, group, size)
        var = _global_mean((x - mean) ** 2, group, size)
    elif train:
        mean = x.mean(dim=(0, 1, 2))
        var = torch.var(x, dim=(0, 1, 2), unbiased=False)
    else:
        mean, var = params["mean"], params["var"]
    y = (x - mean) * torch.rsqrt(var + eps)
    return y, {"mean": mean, "var": var}


def _affine_batch_norm(params: Dict[str, torch.Tensor], x: torch.Tensor, *,
                       train: bool, eps: float) -> torch.Tensor:
    """PyTorch's ``BatchNorm2d`` over NHWC: (x - mean) / sqrt(var + eps)
    * gamma + beta.  Training normalises with the batch's mean and
    population variance and moves the running ones in place, running =
    0.9 running + 0.1 batch, with the batch's unbiased variance (so each
    replay of a captured step moves them); eval normalises with the
    running ones.  It runs ATen's own kernels (``native_batch_norm``,
    which ``torch.batch_norm`` would pass over for cuDNN's on a card),
    reading the NHWC activations where they lie as a channels-last
    tensor, and counts one launch on ``batch_norm.launches`` a call,
    replays included, as :func:`conv2d` counts."""
    _build.count(batch_norm)
    # the running statistics are leaves of the params, which may require
    # grad; the kernel writes them through a view that does not
    y, _, _ = torch.native_batch_norm(
        x.permute(0, 3, 1, 2), params["gamma"], params["beta"],
        params["mean"].detach(), params["var"].detach(), train,
        TORCH_BN_MOMENTUM, eps)
    return y.permute(0, 2, 3, 1)


batch_norm.launches = 0


def update_bn_stats(params: Params, bn_stats: Dict[str, Any],
                    momentum: float = BN_MOMENTUM) -> Params:
    """EMA-fold a step's batch statistics into the bn* params: running =
    momentum * running + (1 - momentum) * batch.  In place, as the
    optimizer updates the port's params, with the statistics detached;
    returns ``params``."""
    with torch.no_grad():
        for name, stats in bn_stats.items():
            for part in ("mean", "var"):
                old = params[name][part]
                old.copy_(momentum * old
                          + (1 - momentum) * stats[part].detach())
    return params


# ---------------------------------------------------------------------------
# Architecture bodies.  Each init returns a params dict; each apply maps
# (params, images NHWC) -> dict of named blobs ending in 'RS_est'.
# ---------------------------------------------------------------------------

def _init_conv_static_like(gen, cfg: NetworkConfig, device) -> Params:
    """convStatic / convStaticWithSigmoid: numLayers convs (and bn), then a
    1x1 head whatever the trunk's kernel."""
    params: Params = {}
    k = cfg.kernel
    if cfg.num_layers >= 1:
        ci = 3
        for i in range(cfg.num_layers):
            params["conv{}".format(i)] = _conv_init(gen, k, k, ci,
                                                    cfg.num_filters, device)
            if cfg.use_batch_normalization:
                params["bn{}".format(i)] = bn_init(cfg.num_filters, device)
            ci = cfg.num_filters
        params["conv{}".format(cfg.num_layers)] = _conv_init(
            gen, 1, 1, ci, cfg.num_output_final, device)
    else:
        params["conv0"] = _conv_init(gen, k, k, 3, cfg.num_output_final,
                                     device)
    return params


def _apply_conv_static(params, images, cfg: NetworkConfig, *, sigmoid: bool,
                       train: bool) -> Dict[str, Any]:
    blobs: Dict[str, Any] = {"__bn_stats__": {}}
    x = images
    if cfg.num_layers >= 1:
        for i in range(cfg.num_layers):
            x = conv2d(params["conv{}".format(i)], x, pad=cfg.pad,
                       dilation=cfg.dilation)
            if cfg.use_batch_normalization:
                name = "bn{}".format(i)
                x, blobs["__bn_stats__"][name] = batch_norm(
                    params[name], x, train=train)
            x = torch.relu(x)
        x = conv2d(params["conv{}".format(cfg.num_layers)], x)
    else:
        x = conv2d(params["conv0"], x, pad=cfg.pad, dilation=cfg.dilation)
    if sigmoid:
        blobs["RS_est_before_sigmoid"] = x
        x = torch.sigmoid(x)
    blobs["RS_est"] = x
    return blobs


def _init_skip_layers(gen, cfg: NetworkConfig, device, suffix: str = "",
                      in_channels: int = 3) -> Params:
    """convStaticSkipLayers body: numLayers convs (and bn), all outputs
    concatenated, fused by a 1x1 conv."""
    params: Params = {}
    k = cfg.kernel
    if cfg.num_layers >= 1:
        ci = in_channels
        for i in range(cfg.num_layers):
            params["conv{}{}".format(i, suffix)] = _conv_init(
                gen, k, k, ci, cfg.num_filters, device)
            if cfg.use_batch_normalization:
                params["bn{}{}".format(i, suffix)] = bn_init(
                    cfg.num_filters, device)
            ci = cfg.num_filters
        params[_FUSE + suffix] = _conv_init(
            gen, 1, 1, cfg.num_filters * cfg.num_layers,
            cfg.num_output_final, device)
    else:
        params["conv0" + suffix] = _conv_init(
            gen, k, k, in_channels, cfg.num_output_final, device)
    return params


def _apply_skip_layers(params: Params, images: torch.Tensor,
                       cfg: NetworkConfig, *, train: bool, kernels: bool,
                       suffix: str = "", input_grad: bool = False,
                       bn_group=None) -> Dict[str, Any]:
    """``input_grad``: set only when ``images`` is itself a function of
    the params (the cascade's level-1 trunk); K7's backward then computes
    the input cotangent, which a leaf input does not need.  ``bn_group``:
    batch norm's process group (:func:`batch_norm`)."""
    blobs: Dict[str, Any] = {"__bn_stats__": {}}
    if cfg.num_layers >= 1:
        if (kernels and images.device.type == "cuda"
                and fits_fused_trunk(cfg, images.shape[-1])):
            # the fused trunk K7, forward and backward
            pre = skip_trunk_pre(params, images, num_layers=cfg.num_layers,
                                 suffix=suffix, input_grad=input_grad)
            blobs["RS_est_before_sigmoid" + suffix] = pre
            blobs["RS_est" + suffix] = torch.sigmoid(pre)
            return blobs
        x = images
        skips = []
        for i in range(cfg.num_layers):
            x = conv2d(params["conv{}{}".format(i, suffix)], x,
                       pad=cfg.pad, dilation=cfg.dilation)
            if cfg.use_batch_normalization:
                name = "bn{}{}".format(i, suffix)
                x, blobs["__bn_stats__"][name] = batch_norm(
                    params[name], x, train=train, group=bn_group)
            x = torch.relu(x)
            skips.append(x)
        cat = torch.cat(skips, dim=-1)
        blobs["concat_skip_layers" + suffix] = cat
        pre = conv2d(params[_FUSE + suffix], cat)
    else:
        pre = conv2d(params["conv0" + suffix], images, pad=cfg.pad,
                     dilation=cfg.dilation)
    blobs["RS_est_before_sigmoid" + suffix] = pre
    blobs["RS_est" + suffix] = torch.sigmoid(pre)
    return blobs


def _apply_cascade(params: Params, images: torch.Tensor, cfg: NetworkConfig,
                   *, train: bool, kernels: bool,
                   bn_group=None) -> Dict[str, Any]:
    """cascadeSkipLayers: a skip-layer trunk on the images, the level-0
    reflectance recovered from it, a second trunk on that reflectance."""
    blobs = _apply_skip_layers(params, images, cfg, train=train,
                               kernels=kernels, suffix="_level0",
                               bn_group=bn_group)
    # the reference's recover layer has no rDirectly mode and falls back to
    # rRelMax, so the level-1 trunk always receives a 3-channel reflectance
    recover_mode = cfg.rs_est_mode
    if recover_mode.split("-")[0] == "rDirectly":
        recover_mode = "rRelMax"
    refl0, shad0 = recover_reflectance_shading(blobs["RS_est_level0"],
                                               images, recover_mode)
    blobs["reflectance_level0"] = refl0
    blobs["shading_level0"] = shad0
    bn0 = blobs["__bn_stats__"]
    # refl0 depends on the level-0 params: its cotangent must reach them
    blobs.update(_apply_skip_layers(params, refl0, cfg, train=train,
                                    kernels=kernels, suffix="_level1",
                                    input_grad=True, bn_group=bn_group))
    blobs["__bn_stats__"].update(bn0)
    blobs["RS_est"] = blobs.pop("RS_est_level1")
    blobs["RS_est_before_sigmoid"] = blobs.pop("RS_est_before_sigmoid_level1")
    return blobs


def _init_simple_conv_relu(gen, cfg: NetworkConfig, device) -> Params:
    """simpleConvolutionsRelu: 16, [32] * numLayers, 16, head."""
    k = cfg.kernel
    params: Params = {"conv_in": _conv_init(gen, k, k, 3, 16, device)}
    ci = 16
    for i in range(cfg.num_layers):
        params["conv_mid{}".format(i)] = _conv_init(gen, k, k, ci, 32,
                                                    device)
        ci = 32
    params["conv_narrow"] = _conv_init(gen, k, k, ci, 16, device)
    params["conv_head"] = _conv_init(gen, k, k, 16, cfg.num_output_final,
                                     device)
    return params


def _apply_simple_conv_relu(params, images, cfg: NetworkConfig):
    p = cfg.kernel_pad
    x = torch.relu(conv2d(params["conv_in"], images, pad=p))
    for i in range(cfg.num_layers):
        x = torch.relu(conv2d(params["conv_mid{}".format(i)], x, pad=p))
    x = torch.relu(conv2d(params["conv_narrow"], x, pad=p))
    return {"RS_est": conv2d(params["conv_head"], x, pad=p)}


def _init_conv_increasing(gen, cfg: NetworkConfig, device) -> Params:
    """convIncreasing: 2^f, 2^(f+1), ... filters, then a 1x1 head."""
    params: Params = {}
    k = cfg.kernel
    if cfg.num_layers >= 1:
        ci, co = 3, cfg.num_filters
        for i in range(cfg.num_layers):
            params["conv{}".format(i)] = _conv_init(gen, k, k, ci, co, device)
            ci, co = co, co * 2
        params["conv_head"] = _conv_init(gen, 1, 1, ci, cfg.num_output_final,
                                         device)
    else:
        params["conv_head"] = _conv_init(gen, k, k, 3, cfg.num_output_final,
                                         device)
    return params


def _apply_conv_increasing(params, images, cfg: NetworkConfig):
    p = cfg.kernel_pad
    if cfg.num_layers >= 1:
        x = images
        for i in range(cfg.num_layers):
            x = torch.relu(conv2d(params["conv{}".format(i)], x, pad=p))
        x = conv2d(params["conv_head"], x)
    else:
        x = conv2d(params["conv_head"], images, pad=p)
    return {"RS_est": x}


# uNet: the JAX package's local/global two-stream U-Net (the reference's
# uNet leans on two PythonLayers whose sources it does not ship); the
# global path runs on a fixed 256x256 resize of the input and its 1x1
# output is broadcast over the local feature map.
_UNET_GLOBAL_SIZE = 256


def _init_unet(gen, cfg: NetworkConfig, device) -> Params:
    params: Params = {}
    k, n = cfg.kernel, cfg.num_layers

    def conv(name, kk, ci, co):
        params[name] = _conv_init(gen, kk, kk, ci, co, device)

    def block(name, ci, co):
        for i in range(n):
            conv("{}_{}".format(name, i), k, ci if i == 0 else co, co)

    # down path
    conv("Conv1", 3, 3, 16)
    block("d1", 16, 16)
    conv("Conv2", 3, 16, 32)
    block("d2", 32, 32)
    conv("Conv3", 3, 32, 64)
    block("d3", 64, 64)
    conv("Conv4", 7, 64, 64)
    block("d4", 64, 64)
    # global path
    conv("Conv5", 5, 3, 32)
    conv("Conv6", 5, 32, 32)
    conv("Conv7", 5, 32, 32)
    conv("Conv8", 3, 32, 64)
    # local and global combined
    block("comb", 128, 64)
    conv("comb_final", 3, 128 if n == 0 else 64, 64)
    # up path
    conv("up3", 2, 64, 64)
    block("r2", 32 + 64, 32)
    conv("r2_final", 3, 32 + 64 if n == 0 else 32, 32)
    conv("up2", 2, 32, 16)
    block("r1", 16 + 16, 16)
    conv("r1_final", 3, 16 + 16 if n == 0 else 16, 16)
    conv("up1", 2, 16, 3)
    block("out", 3 + 3, 3)
    conv("head", 3, 3 + 3 if n == 0 else 3, cfg.num_output_final)
    return params


def _apply_unet(params, images, cfg: NetworkConfig):
    """The spans ``unet.local``, ``unet.global`` and ``unet.up`` time the
    streams' issue in eager calls; a captured step records them once, at
    its capture (under ``fit.capture``), and its replays issue none."""
    p, n = cfg.kernel_pad, cfg.num_layers

    def block(name, x):
        for i in range(n):
            x = conv2d(params["{}_{}".format(name, i)], torch.relu(x), pad=p)
        return x

    def stage(name, x):
        for i in range(n):
            x = torch.relu(conv2d(params["{}_{}".format(name, i)], x, pad=p))
        return torch.relu(conv2d(params[name + "_final"], x, pad=1))

    # down path (stride-2 convs)
    with span("unet.local"):
        l1 = torch.relu(block("d1", conv2d(params["Conv1"], images, pad=1,
                                           stride=2)))
        l2 = torch.relu(block("d2", conv2d(params["Conv2"], l1, pad=1,
                                           stride=2)))
        l3 = torch.relu(block("d3", conv2d(params["Conv3"], l2, pad=1,
                                           stride=2)))
        local = torch.relu(block("d4", conv2d(params["Conv4"], l3, pad=3)))

    # global path on a fixed-size resize of the input: bilinear with
    # half-pixel centres, antialiased when it shrinks, as jax.image.resize
    with span("unet.global"):
        g = F.interpolate(images.permute(0, 3, 1, 2),
                          size=(_UNET_GLOBAL_SIZE, _UNET_GLOBAL_SIZE),
                          mode="bilinear", align_corners=False,
                          antialias=True).permute(0, 2, 3, 1)
        g = torch.relu(conv2d(params["Conv5"], g, pad=2, stride=4))
        g = torch.relu(conv2d(params["Conv6"], g, pad=2, stride=4))
        g = torch.relu(conv2d(params["Conv7"], g, pad=2, stride=4))
        g = torch.relu(conv2d(params["Conv8"], g))
        g = g.mean(dim=(1, 2), keepdim=True).expand(
            tuple(local.shape[:3]) + (g.shape[-1],))

    with span("unet.up"):
        r3 = stage("comb", torch.cat([local, g], dim=-1))
        r2 = stage("r2", torch.cat([l2, deconv2d(params["up3"], r3)], dim=-1))
        r1 = stage("r1", torch.cat([l1, deconv2d(params["up2"], r2)], dim=-1))
        x = torch.cat([images, deconv2d(params["up1"], r1)], dim=-1)
        for i in range(n):
            x = torch.relu(conv2d(params["out_{}".format(i)], x, pad=p))
        return {"RS_est": conv2d(params["head"], x, pad=1)}


# pix2pix's U-Net generator (Isola et al., CVPR 2017, arXiv:1611.07004;
# ``UnetGenerator`` of github.com/junyanz/pytorch-CycleGAN-and-pix2pix with
# --norm batch): num_downs = numLayers 4x4 stride-2 convolutions down to
# 1x1, as many 4x4 stride-2 transposed convolutions back, each block's
# input concatenated before its up path's output.  Widths: ngf, 2 ngf,
# 4 ngf, then 8 ngf (ngf = 2**num_filters_log).
P2P_MIN_DOWNS = 5
P2P_KERNEL = 4
P2P_INIT_STD = 0.02      # pix2pix's init_type normal, gain 0.02


def _p2p_widths(cfg: NetworkConfig) -> List[int]:
    """The output width of each down convolution, outermost first."""
    if cfg.num_layers < P2P_MIN_DOWNS:
        raise ValueError(
            "pix2pixUnet needs numLayers (num_downs) of at least {}, got "
            "{}".format(P2P_MIN_DOWNS, cfg.num_layers))
    return [cfg.num_filters * min(2 ** i, 8) for i in range(cfg.num_layers)]


def _init_pix2pix(gen, cfg: NetworkConfig, device) -> Params:
    """``down1..downN`` and ``up1..upN`` {"kernel": HWIO}, ``up1`` with a
    bias; ``down2_bn..down{N-1}_bn`` and ``up2_bn..upN_bn`` {"gamma",
    "beta", "mean", "var"}.  pix2pix's init: kernels N(0, 0.02), gamma
    N(1, 0.02), beta and the bias 0, running mean 0 and variance 1."""
    widths, k = _p2p_widths(cfg), P2P_KERNEL
    n = len(widths)

    def normal(shape, mean=0.0):
        return (torch.randn(shape, generator=gen, dtype=torch.float32)
                * P2P_INIT_STD + mean).to(device)

    def norm(name, c):
        params[name] = {"gamma": normal((c,), 1.0),
                        "beta": torch.zeros((c,), device=device),
                        **bn_init(c, device)}

    params: Params = {}
    for i, co in enumerate(widths, start=1):
        ci = 3 if i == 1 else widths[i - 2]
        params["down{}".format(i)] = {"kernel": normal((k, k, ci, co))}
        if 1 < i < n:
            norm("down{}_bn".format(i), co)
    for i in range(n, 0, -1):
        ci = widths[i - 1] * (1 if i == n else 2)
        co = cfg.num_output_final if i == 1 else widths[i - 2]
        params["up{}".format(i)] = {"kernel": normal((k, k, ci, co))}
        if i > 1:
            norm("up{}_bn".format(i), co)
    params["up1"]["bias"] = torch.zeros((cfg.num_output_final,),
                                        device=device)
    return params


def _apply_pix2pix(params, images, cfg: NetworkConfig, *, train: bool,
                   bn_group=None):
    """The down path: down1 on the images, then LeakyReLU(0.2), a down
    convolution and batch norm (none on the innermost); the up path:
    ReLU, an up convolution, batch norm, and the concatenation [the down
    path's map of that scale, it]; the outermost up convolution (bias) and
    tanh.  pix2pix's in-place LeakyReLU overwrites each block's input
    before the concatenation reads it, and the ReLU after makes that
    ReLU(LeakyReLU(x)) = ReLU(x): the concatenation carries the map as it
    was.  The head maps tanh's t to the estimate (1 + t) / 2 in (0, 1),
    as pix2pix maps its output to an image.  The spans ``p2p.down`` and
    ``p2p.up`` time the paths' issue in eager calls; a captured step
    records them once, at its capture, and its replays issue none."""
    n = len(_p2p_widths(cfg))

    def norm(name, x):
        return batch_norm(params[name], x, train=train, group=bn_group)[0]

    skips = []
    with span("p2p.down"):
        x = conv2d(params["down1"], images, pad=1, stride=2)
        for i in range(2, n + 1):
            skips.append(x)
            x = conv2d(params["down{}".format(i)], F.leaky_relu(x, 0.2),
                       pad=1, stride=2)
            if i < n:
                x = norm("down{}_bn".format(i), x)
    with span("p2p.up"):
        for i in range(n, 1, -1):
            x = norm("up{}_bn".format(i), deconv2d(
                params["up{}".format(i)], torch.relu(x), pad=1))
            x = torch.cat([skips.pop(), x], dim=-1)
        t = torch.tanh(deconv2d(params["up1"], torch.relu(x), pad=1))
    return {"RS_est": (1.0 + t) * 0.5}


# ---------------------------------------------------------------------------
# Public factory
# ---------------------------------------------------------------------------

def _force_bn_off(cfg: NetworkConfig) -> NetworkConfig:
    """convStatic / convStaticWithSigmoid hardcode batch normalization off
    in the reference whatever --use_batch_normalization says, so these
    types cannot grow an architecture the reference could not.  (The
    description string still encodes the flag, as the reference's does.)"""
    return dataclasses.replace(cfg, use_batch_normalization=False)


def _check_type(cfg: NetworkConfig) -> None:
    if cfg.network_type not in NETWORK_TYPES:
        raise ValueError("networkType '{}' not known".format(
            cfg.network_type))


def init_network(cfg: NetworkConfig, generator: Optional[torch.Generator]
                 = None, device=None, in_channels: int = 3) -> Params:
    """Fresh parameters of a config: caffe xavier kernels, zero biases,
    running mean 0 and variance 1 for batch normalization (pix2pixUnet:
    its published normal init, :func:`_init_pix2pix`), drawn from
    ``generator`` (a new one seeded 0 when None), on ``device``.
    ``in_channels`` is the input width of a convStaticSkipLayers trunk."""
    _check_type(cfg)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    t = cfg.network_type
    if t in ("convStatic", "convStaticWithSigmoid"):
        return _init_conv_static_like(generator, _force_bn_off(cfg), device)
    if t == "convStaticSkipLayers":
        return _init_skip_layers(generator, cfg, device,
                                 in_channels=in_channels)
    if t == "cascadeSkipLayers":
        params = _init_skip_layers(generator, cfg, device, suffix="_level0")
        params.update(_init_skip_layers(generator, cfg, device,
                                        suffix="_level1"))
        return params
    if t == "simpleConvolutionsRelu":
        return _init_simple_conv_relu(generator, cfg, device)
    if t == "convIncreasing":
        return _init_conv_increasing(generator, cfg, device)
    if t == "pix2pixUnet":
        return _init_pix2pix(generator, cfg, device)
    return _init_unet(generator, cfg, device)


def apply_network(params: Params, images: torch.Tensor, cfg: NetworkConfig,
                  *, train: bool = False, kernels: bool = True,
                  bn_group=None) -> Dict[str, Any]:
    """Run the network: images NHWC float32 -> blob dict with 'RS_est'.
    ``train`` normalises with batch statistics (returned under
    '__bn_stats__' for :func:`update_bn_stats`), else with the running
    ones; under ``bn_group`` (a process group, the data-parallel step) the
    batch statistics are the global batch's.  cascadeSkipLayers also
    returns 'RS_est_level0', 'reflectance_level0' and 'shading_level0'.
    ``kernels=False`` takes the plain per-layer path on any device (the
    reference run on the card)."""
    _check_type(cfg)
    t = cfg.network_type
    if t in ("convStatic", "convStaticWithSigmoid"):
        return _apply_conv_static(params, images, _force_bn_off(cfg),
                                  sigmoid=t == "convStaticWithSigmoid",
                                  train=train)
    if t == "convStaticSkipLayers":
        return _apply_skip_layers(params, images, cfg, train=train,
                                  kernels=kernels, bn_group=bn_group)
    if t == "cascadeSkipLayers":
        return _apply_cascade(params, images, cfg, train=train,
                              kernels=kernels, bn_group=bn_group)
    if t == "simpleConvolutionsRelu":
        return _apply_simple_conv_relu(params, images, cfg)
    if t == "convIncreasing":
        return _apply_conv_increasing(params, images, cfg)
    if t == "pix2pixUnet":
        return _apply_pix2pix(params, images, cfg, train=train,
                              bn_group=bn_group)
    return _apply_unet(params, images, cfg)


def params_to_torch(params: Dict, device=None) -> Params:
    """The JAX package's params pytree (numpy or array leaves) -> the
    port's: the same nesting, float32 tensors on ``device``."""
    return {name: {part: torch.tensor(np.asarray(v, np.float32),
                                      device=device)
                   for part, v in layer.items()}
            for name, layer in params.items()}


def params_to_numpy(params: Params) -> Dict[str, Dict[str, np.ndarray]]:
    """The port's params -> the JAX package's pytree layout as numpy."""
    return {name: {part: v.detach().cpu().numpy().astype(np.float32)
                   for part, v in layer.items()}
            for name, layer in params.items()}
