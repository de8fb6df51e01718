"""K7: the fused skip-layer trunk for training (csrc/cnn_train.cu), forward
and backward, their plain PyTorch versions and the wrappers.

Port of reflectance_filtering_tpu/ops/cnn_train_pallas.py
(``skip_trunk_pre``, ``fits_fused_trunk``).  The trunk maps images
[..., ci] to the pre-sigmoid head [..., cout] through n 1x1 convs of width f
with ReLU, the skip concat and the fuse conv.  On a CUDA tensor the forward
and the backward are one kernel launch each (plus the backward's fixed-order
sum of per-block partials); the backward rematerialises the activations
instead of storing them and returns every parameter gradient and,
optionally, the input cotangent.  The forward runs f32 FMAs; the
backward runs its matrix products (the rematerialisation, the chain and
the weight gradients) as 3xTF32 on the tensor cores, Hopper's TF32 pieces
in place of the TPU kernel's bf16x3 splits (its arithmetic is emulated on
the CPU in tests/test_torch_cnn_train_tf32.py).

``trunk_backward_variant`` runs the backward's timing variants (the port
of scripts/measure_train_bwd_split.py, TPU kernel 19): the same kernel with
phases removed, whose time differences split the backward's time by phase
(reflectance_filtering_tpu_torch/scripts/measure_train_bwd_split.py).

Parameters are the JAX package's pytree as torch tensors:
``{"conv0": {"kernel": [1, 1, ci, f], "bias": [f]}, ..., "fuse_skip_layers":
{"kernel": [1, 1, n*f, cout], "bias": [cout]}}`` (HWIO kernels).  The
kernels read them as one flat vector (:func:`pack`), in the order
W_0, b_0, ..., W_{n-1}, b_{n-1}, W_f, b_f with each W as [in, out].
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Sequence, Tuple

import torch

from . import _build

Shape = Tuple[int, int, int, int]   # (n, ci, f, cout)


def fits_fused_trunk(cfg, in_channels: int) -> bool:
    """Eligibility: 1x1 kernels, no padding, no batch-norm, small channel
    counts (the whole flagship family)."""
    return (cfg.kernel == 1 and cfg.pad == 0
            and not cfg.use_batch_normalization
            and cfg.num_layers >= 1 and in_channels <= 8
            and cfg.num_filters % 8 == 0 and 8 <= cfg.num_filters <= 256
            and cfg.num_output_final <= 8)


def layer_names(num_layers: int, suffix: str = "") -> List[str]:
    return (["conv{}{}".format(i, suffix) for i in range(num_layers)]
            + ["fuse_skip_layers" + suffix])


def _matrices(params: Dict, num_layers: int, suffix: str):
    """The [in, out] weight matrices and biases of the trunk, as views of
    the HWIO kernels (so gradients flow back to them)."""
    names = layer_names(num_layers, suffix)
    return ([params[m]["kernel"][0, 0] for m in names],
            [params[m]["bias"] for m in names])


def _offsets(shape: Shape) -> List[Tuple[int, int, int]]:
    """(offset, fan_in, fan_out) of each W in the flat vector; its bias
    follows it."""
    n, ci, f, cout = shape
    out, off = [], 0
    for fin, fout in [(ci, f)] + [(f, f)] * (n - 1) + [(n * f, cout)]:
        out.append((off, fin, fout))
        off += fin * fout + fout
    return out


def num_params(shape: Shape) -> int:
    off, fin, fout = _offsets(shape)[-1]
    return off + fin * fout + fout


def pack(weights: Sequence[torch.Tensor], biases: Sequence[torch.Tensor]
         ) -> torch.Tensor:
    """The flat f32 vector the kernels read (a new contiguous tensor)."""
    parts = []
    for w, b in zip(weights, biases):
        parts += [w.reshape(-1), b.reshape(-1)]
    return torch.cat([p.to(torch.float32) for p in parts]).contiguous()


def unpack(flat: torch.Tensor, shape: Shape
           ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Views of ``flat`` as the per-layer [in, out] matrices and biases."""
    ws, bs = [], []
    for off, fin, fout in _offsets(shape):
        ws.append(flat[off:off + fin * fout].reshape(fin, fout))
        bs.append(flat[off + fin * fout:off + fin * fout + fout])
    return ws, bs


def _activations(x: torch.Tensor, weights: Sequence[torch.Tensor],
                 biases: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """x [P, ci] -> the conv layers' activations h_0 .. h_{n-1}, each
    [P, f] (x @ W + b, ReLU; the fuse's W and b, last, are not read)."""
    skips = []
    h = x
    for w, b in zip(weights[:-1], biases[:-1]):
        h = torch.relu(h @ w + b)
        skips.append(h)
    return skips


def _trunk_math(x: torch.Tensor, weights: Sequence[torch.Tensor],
                biases: Sequence[torch.Tensor]) -> torch.Tensor:
    """x [P, ci] -> pre [P, cout]: per-layer x @ W + b, ReLU, the skip
    concat, the fuse."""
    skips = _activations(x, weights, biases)
    cat = skips[0] if len(skips) == 1 else torch.cat(skips, dim=-1)
    return cat @ weights[-1] + biases[-1]


def skip_trunk_pre_plain(params: Dict, images: torch.Tensor, *,
                         num_layers: int, suffix: str = "") -> torch.Tensor:
    """Plain version of K7: images [..., ci] -> pre [..., cout], every step
    an ordinary differentiable torch op (its backward is torch autograd)."""
    ws, bs = _matrices(params, num_layers, suffix)
    lead = images.shape[:-1]
    pre = _trunk_math(images.reshape(-1, images.shape[-1]), ws, bs)
    return pre.reshape(lead + (pre.shape[-1],))


def trunk_forward_plain(x: torch.Tensor, flat: torch.Tensor,
                        shape: Shape) -> torch.Tensor:
    """Plain version of the forward launch: x [P, ci], flat -> [P, cout]."""
    return _trunk_math(x, *unpack(flat, shape))


def trunk_backward_plain(x: torch.Tensor, g: torch.Tensor,
                         flat: torch.Tensor, shape: Shape, input_grad: bool
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the backward launch: autograd of
    :func:`trunk_forward_plain`; (flat gradient, dx or None)."""
    with torch.enable_grad():
        xd = x.detach().requires_grad_(input_grad)
        fd = flat.detach().requires_grad_(True)
        pre = trunk_forward_plain(xd, fd, shape)
        grads = torch.autograd.grad(pre, [fd, xd] if input_grad else [fd], g)
    return grads[0], (grads[1] if input_grad else None)


def _check(x: torch.Tensor, flat: torch.Tensor, shape: Shape,
           g: torch.Tensor = None) -> None:
    n, ci, f, cout = shape
    _build.check_tensor(x, "x", torch.float32, 2)
    _build.check_tensor(flat, "flat", torch.float32, 1)
    if x.shape[1] != ci or flat.numel() != num_params(shape):
        raise ValueError("expected x [P, {}] and {} parameters, got {} and "
                         "{}".format(ci, num_params(shape), tuple(x.shape),
                                     flat.numel()))
    if flat.device != x.device:
        raise ValueError("x and the parameters must share a device")
    if g is not None:
        _build.check_tensor(g, "g", torch.float32, 2)
        if g.shape != (x.shape[0], cout) or g.device != x.device:
            raise ValueError("g must be [P, cout] = [{}, {}] on the device "
                             "of x, got {}".format(x.shape[0], cout,
                                                   tuple(g.shape)))


def _require_kernel_shape(shape: Shape) -> None:
    n, ci, f, cout = shape
    if not (n >= 1 and 1 <= ci <= 8 and f % 8 == 0 and 8 <= f <= 256
            and 1 <= cout <= 8):
        raise ValueError("the fused trunk kernel takes n >= 1, ci <= 8, f a "
                         "multiple of 8 in 8..256 and cout <= 8 "
                         "(fits_fused_trunk); got (n, ci, f, cout) = "
                         "{}".format(shape))


def trunk_forward(x: torch.Tensor, flat: torch.Tensor,
                  shape: Shape) -> torch.Tensor:
    """Forward launch: x [P, ci] f32, flat parameters -> pre [P, cout].

    A CPU tensor runs :func:`trunk_forward_plain`; a CUDA tensor launches
    the kernel."""
    _check(x, flat, shape)
    if x.device.type == "cpu":
        return trunk_forward_plain(x, flat, shape)
    _build.require_cuda(x, "trunk_forward")
    _require_kernel_shape(shape)
    n, ci, f, cout = shape
    pre = torch.empty((x.shape[0], cout), dtype=torch.float32,
                      device=x.device)
    if x.shape[0]:
        _build.launch("rf_cnn_train_fwd", x.device, x.data_ptr(),
                      flat.data_ptr(), pre.data_ptr(), n, ci, f, cout,
                      x.shape[0])
        trunk_forward.launches += 1
    return pre


trunk_forward.launches = 0


@functools.lru_cache(maxsize=64)
def _plan(device_index: int, shape: Shape, p: int) -> Tuple[int, int]:
    """(blocks, workspace floats) of the backward on a device."""
    out = (ctypes.c_int64 * 2)()
    handle = _build.lib()
    with torch.cuda.device(device_index):
        rc = handle.rf_cnn_train_plan(*shape, p, ctypes.addressof(out))
    if rc != 0:
        raise RuntimeError("rf_cnn_train_plan failed: CUDA error {} "
                           "({})".format(rc, handle.rf_error_string(rc)
                                         .decode()))
    return int(out[0]), int(out[1])


def trunk_backward(x: torch.Tensor, g: torch.Tensor, flat: torch.Tensor,
                   shape: Shape, input_grad: bool
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Backward launch: the cotangent g [P, cout] of the forward's output ->
    (the flat parameter gradient summed over all pixels, dx [P, ci] or None
    when ``input_grad`` is false).

    A CPU tensor runs :func:`trunk_backward_plain`; a CUDA tensor launches
    the kernel (a persistent grid of a fixed block count, then a fixed-order
    sum of the blocks' partials: bitwise repeatable)."""
    _check(x, flat, shape, g)
    if x.device.type == "cpu":
        return trunk_backward_plain(x, g, flat, shape, input_grad)
    _build.require_cuda(x, "trunk_backward")
    _require_kernel_shape(shape)
    p = x.shape[0]
    if not p:
        return torch.zeros_like(flat), (torch.zeros_like(x) if input_grad
                                        else None)
    # the kernels write every entry of grad and dx
    grad = torch.empty_like(flat)
    dx = torch.empty_like(x) if input_grad else None
    work = backward_workspace(x, shape)
    _build.launch("rf_cnn_train_bwd", x.device, x.data_ptr(), g.data_ptr(),
                  flat.data_ptr(), grad.data_ptr(),
                  dx.data_ptr() if input_grad else None, work.data_ptr(),
                  *shape, p, work.shape[0])
    trunk_backward.launches += 1
    trunk_backward.dx_launches += int(input_grad)
    return grad, dx


trunk_backward.launches = 0
trunk_backward.dx_launches = 0    # of the launches, those that computed dx


def row_stride(shape: Shape) -> int:
    """Floats per block row of the backward's partial gradients (the
    parameter count rounded up to 4)."""
    return (num_params(shape) + 3) // 4 * 4


def backward_workspace(x: torch.Tensor, shape: Shape) -> torch.Tensor:
    """A fresh workspace of the backward for x [P, ci] on its CUDA device:
    [blocks, floats per block], blocks the persistent grid's.  Its first
    blocks * row_stride floats are the blocks' partial gradient rows."""
    return torch.empty(_workspace_shape(x, shape), dtype=torch.float32,
                       device=x.device)


def _workspace_shape(x: torch.Tensor, shape: Shape) -> Tuple[int, int]:
    index = (x.device.index if x.device.index is not None
             else torch.cuda.current_device())
    blocks, floats = _plan(index, shape, x.shape[0])
    return blocks, floats // blocks


# ---------------------------------------------------------------------------
# The backward split by phase (TPU kernel 19): timing variants
# ---------------------------------------------------------------------------

# The phases of the backward: the bits of its template mask in
# csrc/cnn_train.cu (kRemat, kHead, kChain, kWeightGrad)
REMAT, HEAD, CHAIN, WEIGHT_GRAD = 1, 2, 4, 8
# The variants of the backward, in the order of the split: each drops one
# more phase; the last sums the blocks' rows alone.
BWD_VARIANTS = ("full", "-dw", "-dw-chain", "-dw-chain-head", "empty",
                "block sum")
# the phase mask that each of variants 0-4 runs
BWD_MASKS = (REMAT | HEAD | CHAIN | WEIGHT_GRAD, REMAT | HEAD | CHAIN,
             REMAT | HEAD, REMAT, 0)
TILE = 128  # pixels per tile of the backward (kBTile); the floor is per tile


def block_sum_plain(work: torch.Tensor, shape: Shape) -> torch.Tensor:
    """The blocks' partial rows in ``work`` [blocks, ...] summed in block
    order (the backward's last launch, alone)."""
    blocks, stride, np_ = work.shape[0], row_stride(shape), num_params(shape)
    rows = work.reshape(-1)[:blocks * stride].view(blocks, stride)[:, :np_]
    out = torch.zeros(np_, dtype=torch.float32, device=work.device)
    for b in range(blocks):
        out = out + rows[b]
    return out


def trunk_backward_variant_plain(x: torch.Tensor, g: torch.Tensor,
                                 flat: torch.Tensor, shape: Shape,
                                 variant: int, work: torch.Tensor = None
                                 ) -> torch.Tensor:
    """Plain version of a variant launch: the flat vector that variant
    ``variant`` (an index into BWD_VARIANTS) computes, its terms written
    out from the trunk's pieces (a variant that drops the chain's term is
    no gradient, so no autograd):

    * full: every gradient;
    * -dw: dW_l zero;
    * -dw-chain: also dz_l = [h_l > 0] (g W_f,l^T), no W_{l+1} term, so
      db_l is the sum of that;
    * -dw-chain-head: also dW_fuse zero;
    * empty: only db_fuse, each entry the sum over the TILE-pixel tiles of
      x[tile's first pixel, 0] + g[tile's first pixel, 0];
    * block sum: the rows of ``work`` summed in block order."""
    n, ci, f, cout = shape
    if variant == 5:
        if work is None:
            raise ValueError("the block sum reads a workspace: pass work")
        return block_sum_plain(work, shape)
    mask = BWD_MASKS[variant]
    grad = torch.zeros_like(flat)
    gws, gbs = unpack(grad, shape)
    if not mask & REMAT:
        gbs[-1].fill_((x[::TILE, 0] + g[::TILE, 0]).sum())
        return grad
    ws, bs = unpack(flat, shape)
    hs = _activations(x, ws, bs)
    gbs[-1].copy_(g.sum(0))
    if mask & HEAD:
        gws[-1].copy_(torch.cat(hs, dim=-1).T @ g)
    dz = None
    for l in range(n - 1, -1, -1):
        dh = g @ ws[-1][l * f:(l + 1) * f].T
        if mask & CHAIN and l < n - 1:
            dh = dh + dz @ ws[l + 1].T
        dz = torch.where(hs[l] > 0, dh, torch.zeros_like(dh))
        gbs[l].copy_(dz.sum(0))
        if mask & WEIGHT_GRAD:
            gws[l].copy_((x if l == 0 else hs[l - 1]).T @ dz)
    return grad


def trunk_backward_variant(x: torch.Tensor, g: torch.Tensor,
                           flat: torch.Tensor, shape: Shape, variant: int,
                           work: torch.Tensor) -> torch.Tensor:
    """A timing variant of the backward launch (BWD_VARIANTS[variant]) ->
    its flat vector; no dx.  ``work`` is ``backward_workspace(x, shape)``.
    Variants 0-4 run the backward with the phases of BWD_MASKS[variant],
    at the product's block count and shared-memory layout, leaving the
    blocks' rows in ``work``, then the block sum; variant 0 is the
    product's gradient bit for bit.  Variant 5 runs the block sum alone
    over the rows an earlier variant launch left in ``work``.

    A CPU tensor runs :func:`trunk_backward_variant_plain`; a CUDA tensor
    launches the kernel."""
    _check(x, flat, shape, g)
    if variant not in range(len(BWD_VARIANTS)):
        raise ValueError("variant must be 0..{}, got {}".format(
            len(BWD_VARIANTS) - 1, variant))
    if x.device.type == "cpu":
        return trunk_backward_variant_plain(x, g, flat, shape, variant, work)
    _build.require_cuda(x, "trunk_backward_variant")
    _require_kernel_shape(shape)
    if not x.shape[0]:
        raise ValueError("trunk_backward_variant needs at least one pixel")
    _build.check_tensor(work, "work", torch.float32, 2)
    if (tuple(work.shape) != _workspace_shape(x, shape)
            or work.device != x.device):
        raise ValueError("work must be backward_workspace(x, shape)")
    sum_only = variant == len(BWD_MASKS)
    grad = torch.empty_like(flat)
    _build.launch("rf_cnn_train_bwd_variant", x.device, x.data_ptr(),
                  g.data_ptr(), flat.data_ptr(), grad.data_ptr(),
                  work.data_ptr(), *shape, x.shape[0], work.shape[0],
                  0 if sum_only else BWD_MASKS[variant], int(sum_only))
    trunk_backward_variant.launches += 1
    return grad


trunk_backward_variant.launches = 0


class _Trunk(torch.autograd.Function):
    """The trunk as one differentiable op: the forward launch going forward,
    the backward launch going back (each dispatching on the device)."""

    @staticmethod
    def forward(ctx, x, shape, input_grad, *leaves):
        flat = pack(leaves[0::2], leaves[1::2])
        ctx.save_for_backward(x, flat)
        ctx.shape, ctx.input_grad = shape, input_grad
        return trunk_forward(x, flat, shape)

    @staticmethod
    def backward(ctx, g):
        x, flat = ctx.saved_tensors
        want_dx = ctx.input_grad and ctx.needs_input_grad[0]
        grad, dx = trunk_backward(x, g.contiguous(), flat, ctx.shape, want_dx)
        if dx is None and ctx.needs_input_grad[0]:
            dx = torch.zeros_like(x)      # input_grad=False: a zero cotangent
        ws, bs = unpack(grad, ctx.shape)
        leaves = []
        for w, b in zip(ws, bs):
            leaves += [w, b]
        return (dx, None, None, *leaves)


def skip_trunk_pre(params: Dict, images: torch.Tensor, *, num_layers: int,
                   suffix: str = "", input_grad: bool = True
                   ) -> torch.Tensor:
    """Fused pre-sigmoid forward of the skip-layers trunk, differentiable
    with respect to the params and the images: images [..., ci] f32 -> pre
    [..., cout] f32.  ``input_grad=False`` skips the backward's dx work and
    gives the images a zero cotangent: pass it when the images are a leaf.

    The forward and backward each launch K7 on a CUDA tensor and run the
    plain versions on a CPU tensor."""
    ws, bs = _matrices(params, num_layers, suffix)
    ci, f = ws[0].shape
    shape = (num_layers, ci, f, ws[-1].shape[1])
    lead = images.shape[:-1]
    x = images.reshape(-1, ci).to(torch.float32).contiguous()
    leaves = []
    for w, b in zip(ws, bs):
        leaves += [w, b]
    pre = _Trunk.apply(x, shape, input_grad, *leaves)
    return pre.reshape(lead + (shape[3],))
