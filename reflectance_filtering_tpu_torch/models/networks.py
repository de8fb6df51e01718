"""Reflectance networks in PyTorch (port of
reflectance_filtering_tpu/models/networks.py).

Two faces of the same numbers:

* ``ReflectanceNet`` is the shipped model for serving (:632-674): a
  per-pixel MLP 3 -> 32 -> 32 -> 32 -> 32 -> 32 with ReLU, skip-concat of
  the five activations to 160 channels, 160 -> 1 fuse, sigmoid — 4,513
  parameters, kept as plain ``[in, out]`` matrices so the module, the CUDA
  kernel K1 (ops/cnn_kernel.py) and the JAX package read the same numbers
  in the same order.
* ``init_network`` / ``apply_network`` are the training factories for
  ``convStaticSkipLayers`` (:286-352): parameters are the JAX package's
  pytree as torch tensors, ``{"conv0": {"kernel": HWIO, "bias": [out]},
  ..., "fuse_skip_layers": {...}}``, and images are NHWC.  A CUDA tensor
  whose config passes ``fits_fused_trunk`` runs the fused trunk K7
  (ops/cnn_train_kernel.py); every other config takes the plain per-layer
  path, the JAX package's own XLA path for such configs.  The other six
  architectures, batch normalization and the cascade are not ported yet
  (ROADMAP module queue item 10).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.cnn_train_kernel import fits_fused_trunk, skip_trunk_pre

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
)

_NOT_PORTED = ("not ported yet (ROADMAP module queue item 10: the other "
               "network factories, batch normalization and the cascade)")


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
# Training factories (convStaticSkipLayers)
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


def _require_ported(cfg: NetworkConfig) -> None:
    if cfg.network_type != "convStaticSkipLayers":
        if cfg.network_type not in NETWORK_TYPES:
            raise ValueError("networkType '{}' not known".format(
                cfg.network_type))
        raise NotImplementedError("networkType '{}' is {}".format(
            cfg.network_type, _NOT_PORTED))
    if cfg.use_batch_normalization:
        raise NotImplementedError("batch normalization is " + _NOT_PORTED)


def init_network(cfg: NetworkConfig, generator: Optional[torch.Generator]
                 = None, device=None, in_channels: int = 3) -> Params:
    """Fresh parameters of a config (convStaticSkipLayers: the JAX
    package's _init_skip_layers): caffe xavier kernels, zero biases, drawn
    from ``generator`` (a new one seeded 0 when None), on ``device``."""
    _require_ported(cfg)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    params: Params = {}
    k = cfg.kernel
    if cfg.num_layers >= 1:
        ci = in_channels
        for i in range(cfg.num_layers):
            params["conv{}".format(i)] = _conv_init(
                generator, k, k, ci, cfg.num_filters, device)
            ci = cfg.num_filters
        params[_FUSE] = _conv_init(generator, 1, 1,
                                   cfg.num_filters * cfg.num_layers,
                                   cfg.num_output_final, device)
    else:
        params["conv0"] = _conv_init(generator, k, k, in_channels,
                                     cfg.num_output_final, device)
    return params


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
           pad: int = 0, dilation: int = 1) -> torch.Tensor:
    """NHWC conv with an HWIO kernel and zero padding (caffe Convolution);
    a 1x1 kernel is a per-pixel matmul."""
    k = params["kernel"]
    if k.shape[0] == 1 and k.shape[1] == 1 and pad == 0:
        return x @ k[0, 0] + params["bias"]
    y = F.conv2d(x.permute(0, 3, 1, 2), k.permute(3, 2, 0, 1),
                 params["bias"], padding=pad, dilation=dilation)
    return y.permute(0, 2, 3, 1)


def _apply_skip_layers(params: Params, images: torch.Tensor,
                       cfg: NetworkConfig, kernels: bool) -> Dict[str, Any]:
    blobs: Dict[str, Any] = {}
    if cfg.num_layers >= 1:
        if (kernels and images.device.type == "cuda"
                and fits_fused_trunk(cfg, images.shape[-1])):
            # the fused trunk K7, forward and backward; the images are a
            # leaf, so its backward skips the input cotangent
            pre = skip_trunk_pre(params, images, num_layers=cfg.num_layers,
                                 input_grad=False)
            blobs["RS_est_before_sigmoid"] = pre
            blobs["RS_est"] = torch.sigmoid(pre)
            return blobs
        x = images
        skips = []
        for i in range(cfg.num_layers):
            x = torch.relu(conv2d(params["conv{}".format(i)], x,
                                  pad=cfg.pad, dilation=cfg.dilation))
            skips.append(x)
        cat = torch.cat(skips, dim=-1)
        blobs["concat_skip_layers"] = cat
        pre = conv2d(params[_FUSE], cat)
    else:
        pre = conv2d(params["conv0"], images, pad=cfg.pad,
                     dilation=cfg.dilation)
    blobs["RS_est_before_sigmoid"] = pre
    blobs["RS_est"] = torch.sigmoid(pre)
    return blobs


def apply_network(params: Params, images: torch.Tensor, cfg: NetworkConfig,
                  *, train: bool = False, kernels: bool = True
                  ) -> Dict[str, Any]:
    """Run the trunk: images NHWC float32 -> blob dict with 'RS_est' (and
    'RS_est_before_sigmoid').  ``train`` only matters for batch
    normalization, which is not ported.  ``kernels=False`` takes the plain
    per-layer path on any device (the reference run on the card)."""
    del train
    _require_ported(cfg)
    return _apply_skip_layers(params, images, cfg, kernels)


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
