"""Spatial sharding with halo exchange: single large frames across ranks
(port of reflectance_filtering_tpu/parallel/spatial.py).

A 4K+ frame is split along its width over the ranks of a
:class:`~.mesh.Mesh`; a windowed filter needs ``halo`` neighbour columns on
each side, which the ranks exchange.  The global borders are made locally
on the edge ranks (a shard always owns more than ``halo`` columns), and
each rank runs the port's single-device filter on its haloed block (the
CUDA kernel on the card, its plain version on the CPU), then crops it.

The exchange is one ``all_gather`` of every rank's two edge strips, not a
ring of ``send``/``recv``: gloo's point-to-point calls take CPU tensors
only, while its all_gather takes CUDA tensors too, so the same exchange
runs under NCCL and under gloo on the card or the CPU.  It moves
``size x 2 x H x halo x C`` values to each rank, the ring's amount at two
ranks.

Halo widths: the bilateral filters need r (one windowed pass); the guided
filter's two box stages compose to 2r; the iterated chain's n filters to
n 2r, in one exchange.

The frame API is the JAX package's: arrays [H, W, C] (or [H, W] where the
JAX function takes one) go in whole on every rank and the whole result
comes back on every rank (gathered).  W divides by the mesh size.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..ops.bilateral import opencv_bilateral_params
from .mesh import Mesh


def exchange_halos_w(local: torch.Tensor, halo: int, mesh: Mesh,
                     border: str = "reflect101") -> torch.Tensor:
    """[left_halo | local | right_halo] along axis 1 (width) of this rank's
    block ``local`` [H, W_shard, C].  Neighbour columns come from the
    neighbouring ranks; the outermost ranks make the global border from
    their own columns (border='reflect101': ...c b | a b c, OpenCV's
    BORDER_REFLECT_101; 'reflect': ...b a | a b c, BORDER_REFLECT)."""
    if border == "reflect101":
        # global column -k maps to column k
        reflect_left = local[:, 1:halo + 1].flip(1)
        reflect_right = local[:, -halo - 1:-1].flip(1)
    elif border == "reflect":
        # symmetric: global column -k maps to column k-1
        reflect_left = local[:, :halo].flip(1)
        reflect_right = local[:, -halo:].flip(1)
    else:
        raise ValueError("unknown border {}".format(border))
    # every rank's (left edge, right edge), in rank order
    edges = mesh.all_gather(torch.stack([local[:, :halo],
                                         local[:, -halo:]]))
    left = reflect_left if mesh.rank == 0 else edges[mesh.rank - 1][1]
    right = (reflect_right if mesh.rank == mesh.size - 1
             else edges[mesh.rank + 1][0])
    return torch.cat([left, local, right], dim=1)


def sharded_apply_overlap(fn: Callable, halo: int, mesh: Mesh,
                          border: str = "reflect101"):
    """Lift a local windowed op into a width-sharded op with halo exchange.

    fn maps ([H, W_shard + 2*halo, C], ...) -> [H, W_shard + 2*halo, C']
    (shape-preserving along W); the wrapper crops the halo off and gathers
    the ranks' columns.  Every array argument is split on width.  Raises
    ValueError when W does not divide by the mesh size or a shard is
    narrower than halo + 1 (reflect101: the edge rank makes the border
    from the columns past its first) or halo (reflect)."""
    if halo < 0:
        raise ValueError("halo must be >= 0, got {}".format(halo))

    def wrapper(*arrays):
        arrays = [torch.as_tensor(a, device=mesh.device) for a in arrays]
        w = arrays[0].shape[1]
        if w % mesh.size:
            raise ValueError("W = {} not divisible by the mesh size "
                             "{}".format(w, mesh.size))
        ws = w // mesh.size
        need = halo + 1 if border == "reflect101" else halo
        if halo and ws < need:
            raise ValueError(
                "W/mesh = {} < {} — shards too narrow to synthesize the "
                "halo-{} {} border (use fewer shards)".format(
                    ws, need, halo, border))
        blocks = [a[:, mesh.rank * ws:(mesh.rank + 1) * ws] for a in arrays]
        if halo == 0:
            out = fn(*blocks)
        else:
            out = fn(*[exchange_halos_w(b, halo, mesh, border)
                       for b in blocks])[:, halo:halo + ws]
        return mesh.gather(out.contiguous(), dim=1)

    return wrapper


def _planar(blk: torch.Tensor) -> torch.Tensor:
    """[H, W, C] -> [1, C, H, W] float32, contiguous."""
    return blk.permute(2, 0, 1)[None].to(torch.float32).contiguous()


def _hwc(planes: torch.Tensor) -> torch.Tensor:
    """[1, C, H, W] -> [H, W, C]."""
    return planes[0].permute(1, 2, 0)


def sharded_box_filter(x, radius: int, mesh: Mesh,
                       border: str = "reflect101"):
    """Width-sharded normalized box filter (halo = radius) through K4
    (``box_filter_planar``) on each rank's block.  x: [H, W, C] with W
    divisible by the mesh size and W/mesh >= radius + 1 (reflect101).
    Each block is filtered with its own border, which reaches only the
    cropped halo columns."""
    from ..ops.box_kernel import box_filter_planar

    def blk(b):
        return _hwc(box_filter_planar(_planar(b)[0], radius, border)[None])

    return sharded_apply_overlap(blk, radius, mesh, border)(x)


def sharded_joint_bilateral(joint, src, mesh: Mesh, d: int = -1,
                            sigma_color: float = 20.0,
                            sigma_space: float = 22.0):
    """Width-sharded joint bilateral filter, OpenCV's reflect-101 borders,
    through K6 on each rank's block: float input takes its float form
    (``joint_bilateral_planar_batched``, TPU kernel 7), uint8 levels
    (both joint and src uint8) its table form
    (``bilateral_packed_joint_batched``, kernels 10-11).  joint [H, W, cj],
    src [H, W, cs], cj and cs in {1, 3} -> float32 [H, W, cs]; W divisible
    by the mesh size, W/mesh > radius."""
    from ..ops.bilateral_joint_kernel import (bilateral_packed_joint_batched,
                                              joint_bilateral_planar_batched)
    radius = opencv_bilateral_params(d, sigma_color, sigma_space)[0]
    u8 = (torch.as_tensor(joint).dtype == torch.uint8
          and torch.as_tensor(src).dtype == torch.uint8)
    filt = (bilateral_packed_joint_batched if u8
            else joint_bilateral_planar_batched)

    def blk(joint_blk, src_blk):
        return _hwc(filt(_planar(joint_blk), _planar(src_blk), d,
                         sigma_color, sigma_space))

    return sharded_apply_overlap(blk, radius, mesh, "reflect101")(joint, src)


def sharded_bilateral_gray_self(x, mesh: Mesh, d: int = -1,
                                sigma_color: float = 20.0,
                                sigma_space: float = 22.0, reps: int = 1):
    """Width-sharded self-guided gray bilateral through K2
    (``bilateral_gray_self``) on each rank's block: the BF(CNN,CNN) -r.png
    case with the frame's width split over the ranks.

    x: [H, W] uint8 levels (K2's table form) or float32 in 0-255 (its exp
    form); ``reps`` = the replicated channel count of the original image (3
    for a decoded -r.png: cv2's range argument sums |delta| over channels).
    Returns float32 [H, W].  W divisible by the mesh; W/mesh >= radius + 1
    (the reflect-101 edge needs one column beyond the halo)."""
    from ..ops.bilateral_kernel import bilateral_gray_self
    radius = opencv_bilateral_params(d, sigma_color, sigma_space)[0]
    x = torch.as_tensor(x)
    if x.dtype != torch.uint8:
        x = x.to(torch.float32)

    def blk(b):
        return bilateral_gray_self(b[..., 0][None].contiguous(), d,
                                   sigma_color, sigma_space,
                                   reps=reps)[0][..., None]

    out = sharded_apply_overlap(blk, radius, mesh, "reflect101")(x[..., None])
    return out[..., 0]


def sharded_bilateral_color_self(img, mesh: Mesh, d: int = -1,
                                 sigma_color: float = 20.0,
                                 sigma_space: float = 22.0):
    """Width-sharded self-guided color bilateral (cv2.bilateralFilter
    semantics: the image filters itself) through K6's color-self form
    (``bilateral_color_self_batched``, cv2's table form) on each rank's
    block.  img: [H, W, 3] uint8, or float holding uint8 levels (integers
    0-255, every decoded image) -> float32 [H, W, 3].  W divisible by the
    mesh; W/mesh >= radius + 1."""
    from ..ops.bilateral_joint_kernel import bilateral_color_self_batched
    radius = opencv_bilateral_params(d, sigma_color, sigma_space)[0]

    def blk(b):
        return _hwc(bilateral_color_self_batched(_planar(b), d, sigma_color,
                                                 sigma_space))

    return sharded_apply_overlap(blk, radius, mesh, "reflect101")(img)


def _guide_src(guide, src):
    guide, src = torch.as_tensor(guide), torch.as_tensor(src)
    squeeze = src.dim() == 2
    return (guide.dim() == 2, squeeze,
            guide[..., None] if guide.dim() == 2 else guide,
            src[..., None] if squeeze else src)


def sharded_guided_filter(guide, src, radius: int, eps, mesh: Mesh):
    """Width-sharded guided filter, matching ops.guided.guided_filter, with
    OpenCV guidedFilter's BORDER_REFLECT and a 2r halo (the means of a and
    b compose two box passes).  A color guide [H, W, 3] runs K5
    (``guided_filter_planar``) on each rank's block, a gray guide [H, W]
    the scalar formulas over K4.  src [H, W, C] or [H, W]; W divisible by
    the mesh size and W/mesh >= 2r."""
    from ..ops.guided import guided_filter, guided_filter_planar
    gray, squeeze, guide3, src3 = _guide_src(guide, src)

    def blk(guide_blk, src_blk):
        if gray:
            return guided_filter(guide_blk[..., 0], src_blk, radius, eps)
        return _hwc(guided_filter_planar(_planar(guide_blk),
                                         _planar(src_blk), radius, eps))

    out = sharded_apply_overlap(blk, 2 * radius, mesh, "reflect")(guide3, src3)
    return out[..., 0] if squeeze else out


def sharded_guided_filter_iterated(guide, src, radius: int, eps,
                                   iterations: int, mesh: Mesh,
                                   guide_u8: bool = False):
    """Width-sharded iterated guided-filter chain (the 3x GF on 4K+ frames)
    in ONE halo exchange of ``iterations * 2 * radius`` columns: each rank
    then runs the whole chain on its block, a color guide through K9
    (``guided_filter_iterated(planar=True)``: the guide's statistics once,
    ``iterations`` applications), a gray one through the repeated scalar
    filter, and crops.

    One GF has a 2r receptive field, so a block's own reflect border
    corrupts at most 2r columns an iteration and n iterations the n 2r
    columns cropped; at the global borders the reflect halo reproduces the
    whole chain's border (each iteration's q is reflect-symmetric about
    the edge).  guide [H, W, 3] or [H, W]; src [H, W, C] or [H, W]; W
    divisible by the mesh size and W/mesh >= iterations * 2 * radius.
    ``guide_u8`` is accepted for the JAX signature and changes nothing."""
    from ..ops.guided import guided_filter, guided_filter_iterated
    del guide_u8
    halo = 2 * radius * iterations
    w_shard = torch.as_tensor(guide).shape[1] // mesh.size
    if w_shard < halo:
        raise ValueError(
            "W/mesh = {} < iterations*2*radius = {} — shards too narrow "
            "to carry the chain's halo (use fewer shards or fewer "
            "iterations per exchange)".format(w_shard, halo))
    gray, squeeze, guide3, src3 = _guide_src(guide, src)

    def blk(guide_blk, src_blk):
        if gray:
            q = src_blk
            for _ in range(iterations):
                q = guided_filter(guide_blk[..., 0], q, radius, eps)
            return q
        return _hwc(guided_filter_iterated(
            _planar(guide_blk), _planar(src_blk), radius, eps, iterations,
            planar=True))

    out = sharded_apply_overlap(blk, halo, mesh, "reflect")(guide3, src3)
    return out[..., 0] if squeeze else out
