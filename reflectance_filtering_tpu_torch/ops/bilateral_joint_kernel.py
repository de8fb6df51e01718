"""K6: the joint bilateral filter family (csrc/bilateral_joint.cu), its
plain PyTorch versions and their wrappers.

Ports of reflectance_filtering_tpu/ops/bilateral_pallas.py, under the same
names so that each counterpart is easy to find:

  * ``joint_bilateral_planar_batched`` (TPU kernel 7, ``_kernel``): float
    values, joint [N, cj, H, W], src [N, cs, H, W];
  * ``bilateral_color_self_batched`` (kernels 8 and 9, ``_kernel_color_self``
    and its lane-packed twin): cv2.bilateralFilter on u8-valued color
    planes [N, 3, H, W];
  * ``bilateral_packed_joint_batched`` (kernels 10 and 11,
    ``_kernel_packed_joint`` and its lane-packed twin): u8-valued joint !=
    src, with ``joint_reps``;
  * ``joint_bilateral_filter_fast``, the HWC adapter over the first.

Each computes, for every pixel p over OpenCV's disk of radius r, with
``D = sum_c |J_c(q) - J_c(p)|``, ``out_c = sum w S_c(q) / sum w`` with
reflect-101 borders, and a weight whose form follows the wrapper:

  * ``joint_bilateral_planar_batched`` (float values): the TPU kernel's
    ``w = exp(D^2 * gcc * reps^2 + (dx^2 + dy^2) * gsc)``;
  * the two u8 wrappers (integer levels): cv2's table form, ``w =
    sw[dx^2 + dy^2] * cw[D]`` with cw the float64-built color_weight of
    :func:`~.bilateral.range_weights` over the joint planes (``joint_reps``
    folded in: cw[i] = exp((reps i)^2 gcc)) and sw its space_weight
    (:func:`~.bilateral.space_weights`).

On integer levels the two forms differ only in float32 rounding.  The TPU
wrappers' ``th``, ``pack`` and ``auto_pack`` choose tile heights and
mantissa or lane packings that compute this same function; they have no
counterpart here.  The plain version loops over the disk's taps on whole
planes in the kernel's tap order with the same weight form; the kernel
fuses multiply and add, so the two agree to float32 rounding (the uint8
gate), not bitwise.

A CPU tensor runs the plain version; a CUDA tensor launches the kernel or
raises.  The u8 wrappers take float32 tensors that hold integers 0-255 (the
JAX wrappers' contract) and the kernel packs each pixel's levels into one
32-bit tile word; the float wrapper keeps floats.  A tile and its halo (and,
in the table form, the range table) must fit one block's shared memory:
:func:`max_radius` gives the largest radius of each pairing (every radius
of the repo's sweeps, up to 33, fits them all).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from . import _build
from .bilateral import (opencv_bilateral_coeffs, pad_reflect101,
                        range_weights, space_weights)
from .bilateral_kernel import _tables

TILE_H, TILE_W = 16, 32               # the float form's kTileH, kTileW
# the uint8 form (csrc/bilateral_joint_u8.cuh): 8 pixels a thread, 32 rows
# of threads, the range table in 2^4 copies
U8_PIX, U8_ROWS, U8_TABLE_SHIFT = 8, 32, 4
SMEM_LIMIT = 232448                   # shared memory one H100 block can take
_GRID_LIMIT = 65535
_CHANNELS = (1, 3)


def _align4(n: int) -> int:
    return (n + 3) // 4 * 4


def smem_bytes(cj: int, cs: int, self_guided: bool, u8: bool,
               radius: int) -> int:
    """Shared memory of one block of the kernel.  Float form: the 16 x 32
    tile and its halo, for each joint and src plane.  uint8 form
    (``Geometry`` in csrc/bilateral_joint_u8.cuh): the range table, the
    spatial weights and the word tile, 128 x 32 pixels with its halo (64 x
    32 and two word arrays for cj = cs = 3 with joint != src), each row 8
    runs of ceil(cols / 8) words padded to a pitch congruent to the threads
    across a row modulo 32."""
    if not u8:
        return ((cj + cs) * (TILE_H + 2 * radius) * (TILE_W + 2 * radius)
                * 4)
    split = not self_guided and cj + cs > 4
    threads_x = 8 if split else 16
    cols = threads_x * U8_PIX + 2 * radius
    seg = (cols + 7) // 8
    pitch = 8 * seg + (threads_x - 8 * seg) % 32
    rows = U8_ROWS + 2 * radius
    return 4 * (_align4((255 * cj + 1) << U8_TABLE_SHIFT)
                + _align4(radius * radius + 1)
                + (2 if split else 1) * rows * pitch)


def max_radius(cj: int, cs: int, self_guided: bool, u8: bool) -> int:
    """The largest radius whose tile fits :data:`SMEM_LIMIT`."""
    r = 0
    while smem_bytes(cj, cs, self_guided, u8, r + 1) <= SMEM_LIMIT:
        r += 1
    return r


def check_channels(cj: int, cs: int) -> None:
    """Raise unless the joint and src plane counts have a kernel."""
    if cj not in _CHANNELS or cs not in _CHANNELS:
        raise ValueError("the joint bilateral kernels take 1 or 3 joint and "
                         "src planes, got {} and {}".format(cj, cs))


def bilateral_joint_plain(joint: torch.Tensor, src: torch.Tensor,
                          radius: int, gcc: float, gsc: float,
                          joint_reps: int = 1, u8: bool = False
                          ) -> torch.Tensor:
    """Plain version of K6: a loop over the disk's taps on whole planes, in
    the kernel's order (row by row, dx ascending).  joint [N, cj, H, W],
    src [N, cs, H, W] -> [N, cs, H, W].  ``u8``: cv2's table form on
    integer levels (the two u8 wrappers), else the exp form with ``gcc *
    joint_reps^2`` (the float wrapper)."""
    n, cj, h, w = joint.shape
    jp = pad_reflect101(joint, radius)
    sp = jp if src is joint else pad_reflect101(src, radius)
    acc = torch.zeros_like(src)
    wsum = torch.zeros((n, 1, h, w), dtype=torch.float32, device=src.device)
    if u8:
        cw = torch.from_numpy(range_weights(gcc, joint_reps, cj)).to(
            src.device)
        sw = space_weights(radius, gsc)
        center, jpl = joint.long(), jp.long()
    else:
        g2 = np.float32(gcc * float(joint_reps * joint_reps))
        gsc = np.float32(gsc)
    for dy in range(-radius, radius + 1):
        dxmax = math.isqrt(radius * radius - dy * dy)
        for dx in range(-dxmax, dxmax + 1):
            ys = slice(radius + dy, radius + dy + h)
            xs = slice(radius + dx, radius + dx + w)
            if u8:
                diff = (jpl[:, :, ys, xs] - center).abs().sum(
                    dim=1, keepdim=True)
                wgt = cw[diff] * float(sw[dy * dy + dx * dx])
            else:
                diff = (jp[:, :, ys, xs] - joint).abs().sum(dim=1,
                                                            keepdim=True)
                # the spatial term in f32, as the kernel computes it
                wgt = torch.exp(diff * diff * g2
                                + np.float32(dy * dy + dx * dx) * gsc)
            acc += wgt * sp[:, :, ys, xs]
            wsum += wgt
    return acc / wsum


def _filter(wrapper, joint, src, self_guided, u8, d, sigma_color,
            sigma_space, joint_reps=1):
    """Check the planes, then run the plain version (CPU) or launch the
    kernel (CUDA) and count the launch on ``wrapper``."""
    name = wrapper.__name__
    _build.check_tensor(joint, "joint", torch.float32, 4)
    _build.check_tensor(src, "src", torch.float32, 4)
    n, cj, h, w = joint.shape
    cs = src.shape[1]
    check_channels(cj, cs)
    if self_guided and cj != 3:
        raise ValueError("{}: x must be [N, 3, H, W], got {}".format(
            name, tuple(joint.shape)))
    if src.shape[0] != n or src.shape[2:] != joint.shape[2:]:
        raise ValueError("joint [N, cj, H, W] and src [N, cs, H, W] must "
                         "share N, H, W; got {} and {}".format(
                             tuple(joint.shape), tuple(src.shape)))
    if src.device != joint.device:
        raise ValueError("joint and src must share a device")
    radius, gcc, gsc = opencv_bilateral_coeffs(d, sigma_color,
                                               sigma_space)
    if joint.device.type == "cpu":
        return bilateral_joint_plain(joint, src, radius, gcc, gsc,
                                     joint_reps, u8)
    _build.require_cuda(joint, name)
    need = smem_bytes(cj, cs, self_guided, u8, radius)
    if need > SMEM_LIMIT:
        raise ValueError(
            "{}: radius {} needs {} bytes of shared memory per block, more "
            "than the {} a block can take; the largest radius for cj={}, "
            "cs={} is {}".format(name, radius, need, SMEM_LIMIT, cj, cs,
                                 max_radius(cj, cs, self_guided, u8)))
    if n > _GRID_LIMIT:
        raise ValueError("{}: batch {} exceeds the kernel's grid limit of "
                         "{}".format(name, n, _GRID_LIMIT))
    tables = (_tables(joint.device, radius, joint_reps, gcc, gsc, cj)
              if u8 else None)
    out = torch.empty_like(src)
    if out.numel():
        _build.launch("rf_bilateral_joint", joint.device, joint.data_ptr(),
                      src.data_ptr(), out.data_ptr(),
                      tables.data_ptr() if u8 else None, n, cj, cs, h, w,
                      int(self_guided), int(u8), radius,
                      gcc * float(joint_reps * joint_reps), gsc)
        wrapper.launches += 1
    return out


def joint_bilateral_planar_batched(joint: torch.Tensor, src: torch.Tensor,
                                   d: int = -1, sigma_color: float = 20.0,
                                   sigma_space: float = 22.0
                                   ) -> torch.Tensor:
    """Float joint bilateral (TPU kernel 7): joint [N, cj, H, W], src
    [N, cs, H, W] float32, any values, cj and cs in {1, 3} ->
    [N, cs, H, W].  The JAX wrapper takes a 3-plane joint only; a 1-plane
    joint here is cv2's 1-channel rule."""
    return _filter(joint_bilateral_planar_batched, joint, src, False, False,
                   d, sigma_color, sigma_space)


def bilateral_color_self_batched(x: torch.Tensor, d: int = -1,
                                 sigma_color: float = 20.0,
                                 sigma_space: float = 22.0) -> torch.Tensor:
    """Self-guided color bilateral (TPU kernels 8 and 9,
    cv2.bilateralFilter semantics): x [N, 3, H, W] float32 holding u8
    integers -> [N, 3, H, W]."""
    return _filter(bilateral_color_self_batched, x, x, True, True, d,
                   sigma_color, sigma_space)


def bilateral_packed_joint_batched(joint: torch.Tensor, src: torch.Tensor,
                                   d: int = -1, sigma_color: float = 20.0,
                                   sigma_space: float = 22.0,
                                   joint_reps: int = 1) -> torch.Tensor:
    """u8 joint != src (TPU kernels 10 and 11): joint [N, cj, H, W], src
    [N, cs, H, W] float32 holding u8 integers, cj and cs in {1, 3} ->
    [N, cs, H, W].  ``joint_reps=k``: each joint plane stands for k
    identical channels (diff = k |delta|, cv2's summed |delta| over
    replicated channels); 1: the planes are the channels."""
    return _filter(bilateral_packed_joint_batched, joint, src, False, True,
                   d, sigma_color, sigma_space, joint_reps)


def joint_bilateral_filter_fast(joint, src, d: int = -1,
                                sigma_color: float = 20.0,
                                sigma_space: float = 22.0) -> torch.Tensor:
    """HWC adapter over :func:`joint_bilateral_planar_batched`: joint and
    src [H, W, C] or [H, W] (tensors or arrays) -> float32 of src's shape,
    on src's device.  A 2-D joint is one plane, cv2's 1-channel rule (the
    JAX adapter replicates it 3x with 3x sigma_color, the same function to
    float32 rounding)."""
    src = torch.as_tensor(src).to(torch.float32)
    joint = torch.as_tensor(joint).to(device=src.device, dtype=torch.float32)
    jp = joint[None] if joint.dim() == 2 else joint.permute(2, 0, 1)
    sp = src[None] if src.dim() == 2 else src.permute(2, 0, 1)
    out = joint_bilateral_planar_batched(
        jp[None].contiguous(), sp[None].contiguous(), d, sigma_color,
        sigma_space)[0]
    return out[0] if src.dim() == 2 else out.permute(1, 2, 0)


joint_bilateral_planar_batched.launches = 0
bilateral_color_self_batched.launches = 0
bilateral_packed_joint_batched.launches = 0
