"""The flagship reflectance network as a PyTorch module (port of
reflectance_filtering_tpu/models/networks.py:101-108, 632-674).

The shipped model (network_definition.prototxt) is a per-pixel MLP:
3 -> 32 -> 32 -> 32 -> 32 -> 32 with ReLU, skip-concat of the five
activations to 160 channels, 160 -> 1 fuse, sigmoid — 4,513 parameters.
Only this configuration is ported; the other six architectures of the
JAX package wait for the training slice.

Weights are kept as plain ``[in, out]`` matrices (the HWIO kernels'
``[0, 0]`` slice), so the module, the CUDA kernel (ops/cnn_kernel.py) and
the JAX package all read the same numbers in the same order.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence

import numpy as np
import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class NetworkConfig:
    """The network-shaping subset of the reference's flags."""

    network_type: str = "convStaticSkipLayers"
    num_layers: int = 5
    num_filters_log: int = 5           # 2**k filters
    kernel_pad: int = 0                # kernel = 2p+1
    rs_est_mode: str = "rDirectly"

    @property
    def num_filters(self) -> int:
        return 2 ** self.num_filters_log


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
                "only the shipped convStaticSkipLayers n5 f32 k1 rDirectly "
                "network is ported (ROADMAP module queue item 10)")
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
