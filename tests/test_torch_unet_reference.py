"""The port's uNet as the benchmark trains it (numLayers 2, kernel 3,
rRelMax: ``models/networks.py`` through ``train/loop.py::make_train_step``)
against the plain reference ``benchmark/reference/unet.py``, on the CPU,
from seeded ``init_network`` weights, at 2 x 64x64 (the global stream's
256x256 resize enlarges) and 2 x 264x272 (it shrinks).

Tolerances, each against the largest gap measured over 4 weight seeds:

* the head's estimate within 2e-6 of its largest value: the port's convs
  run on NHWC views and the reference's on NCHW tensors, so float32 sums
  in another order (3.6e-7 measured);
* the loss within 1e-6 relative (the same float32 sum on both sides: 0);
* the gradient, leaf by leaf, against the reference in float64, within
  1e-3 of the larger of the leaf's and the median leaf's norm, past the
  part that float32 leaves undetermined (the reference's
  ``undetermined`` and ``gradient_gaps``): rRelMax floors the estimate
  at eps and the shading's boundary loss weighs a pixel by
  1 / estimate^2, so pixels within a few eps of the floor move a leaf far
  more than float32 rounding moves their estimate (0 measured, every
  leaf's gap within its typical move, over both frames, with and without
  the boundary term; the reference one precision step lower reads 0.0149
  and up where the term is not 0); the
  gradient of the WHDR term alone (the boundary weight 0) likewise;
* each parameter's change within 1e-4 (leaf norms, as the gradient) of
  Adam's first step, written out, on the port's own gradient: float32
  arithmetic against float64 (6.8e-6 measured).  Against the reference's
  gradient it is not compared: a first change is lr x g / (|g| + 1e-8),
  and an element whose gradient float32 leaves near 0 flips by 2 lr.
"""
import numpy as np
import pytest
import torch

from benchmark.reference import unet as ref
from reflectance_filtering_tpu_torch.models import networks as tn
from reflectance_filtering_tpu_torch.train import loop
from tests.test_whdr import make_blob, random_comps

CFG = tn.NetworkConfig(network_type="uNet", num_layers=2, kernel_pad=1,
                       rs_est_mode="rRelMax")
FRAMES = [(64, 64), (264, 272)]
LR = 1e-3
# convolutions and deconvolutions of one forward: 12 local, 4 global, 3
# combining, 3 + 3 up, 2 + 1 at full resolution; 3 deconvolutions
CONVS, DECONVS = 28, 3


def _data(frame, seed=0, batch=2):
    rng = np.random.RandomState(seed)
    images = (rng.rand(batch, *frame, 3) * 0.8 + 0.1).astype(np.float32)
    comps = np.stack([make_blob(random_comps(rng, 40))
                      for _ in range(batch)]).astype(np.float32)
    return torch.from_numpy(images), torch.from_numpy(comps)


def _params(seed):
    return tn.init_network(CFG, torch.Generator().manual_seed(seed))


def _double(params):
    return {n: {k: v.double() for k, v in p.items()}
            for n, p in params.items()}


def _leaf_gaps(got, want):
    norms = {(n, k): float(want[n][k].double().norm())
             for n in want for k in want[n]}
    median = sorted(norms.values())[len(norms) // 2]
    return {key: float((got[key[0]][key[1]].double()
                        - want[key[0]][key[1]].double()).norm())
            / max(norms[key], median) for key in norms}


def test_reference_layers_are_the_ports():
    want = {n: tuple(p["kernel"].shape) for n, p in _params(0).items()}
    assert ref.param_shapes(2, 3) == want


@pytest.mark.parametrize("frame", FRAMES)
@pytest.mark.parametrize("seed", [0, 2])
def test_forward_matches_the_reference(frame, seed):
    params = _params(seed)
    images, _ = _data(frame, seed)
    with torch.no_grad():
        got = tn.apply_network(params, images, CFG)["RS_est"]
        want = ref.estimate(params, images, 2, 1)
    assert got.shape == (2,) + frame + (1,)
    gap = (got.permute(0, 3, 1, 2) - want).abs().max()
    assert gap <= 2e-6 * want.abs().max()


@pytest.mark.parametrize("frame", FRAMES)
@pytest.mark.parametrize("seed", [0, 2])
def test_adam_step_matches_the_reference(frame, seed):
    """One make_train_step step: the loss, every gradient leaf (as the
    step left it in ``.grad``) and every parameter's change."""
    params = _params(seed)
    images, comps = _data(frame, seed)
    leaves = loop.trainable(params, "cpu")
    opt = loop.make_optimizer("ADAM", LR, leaves)
    metrics = loop.make_train_step(CFG, loop.LossConfig(), leaves,
                                   opt)(images, comps)
    value, _, _, _ = ref.adam_step(params, {}, images, comps, LR, 2, 1)
    assert abs(float(metrics["loss_total"]) - value) <= 1e-6 * abs(value)
    # the gradient against the reference in float64: the float32
    # reference's own bias sums miss by up to 6.7e-3 of a leaf here
    _, grad, _, _ = ref.adam_step(_double(params), {}, images.double(),
                                  comps.double(), LR, 2, 1)

    g = {n: {k: leaves[n][k].grad for k in grad[n]} for n in grad}
    band = ref.undetermined(params, images, comps, 2, 1)
    assert max(ref.gradient_gaps(g, grad, band).values()) <= 1e-3
    change = {n: {k: leaves[n][k].detach() - params[n][k] for k in grad[n]}
              for n in grad}
    adam = {n: {k: -LR * g[n][k] / (g[n][k].abs() + ref.ADAM_EPS)
                for k in grad[n]} for n in grad}
    assert max(_leaf_gaps(change, adam).values()) <= 1e-4


def test_one_eager_step_counts_its_convolutions():
    """Every conv of the forward is a convolution (no 1x1 at stride 1 takes
    the matmul route) and counts once; the backward's count nothing."""
    params = _params(0)
    images, comps = _data((64, 64))
    leaves = loop.trainable(params, "cpu")
    step = loop.make_train_step(CFG, loop.LossConfig(), leaves,
                                loop.make_optimizer("ADAM", LR, leaves))
    before = tn.conv2d.launches, tn.deconv2d.launches
    step(images, comps)
    assert (tn.conv2d.launches - before[0],
            tn.deconv2d.launches - before[1]) == (CONVS, DECONVS)


@pytest.mark.parametrize("frame", FRAMES)
def test_whdr_gradient_matches_the_reference(frame):
    """The gradient of the loss with the boundary weight 0 (10 x the WHDR
    hinge, through the port's hinge kernel's backward) against the
    reference's in float64."""
    params = _params(1)
    images, comps = _data(frame, 1)
    leaves = loop.trainable(params, "cpu")
    losses = loop.LossConfig(loss_scale_boundaries01=0.0)
    total, _ = loop.compute_losses(leaves, images, comps, CFG, losses)
    total.backward()
    _, want = ref.gradient(_double(params), images.double(), comps.double(),
                           2, 1, boundaries=0.0)
    got = {n: {k: leaves[n][k].grad for k in want[n]} for n in want}
    band = ref.undetermined(params, images, comps, 2, 1, boundaries=0.0)
    assert max(ref.gradient_gaps(got, want, band).values()) <= 1e-3
