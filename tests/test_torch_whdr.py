"""Port WHDR (losses/whdr.py) and point-pair gather (ops/whdr_gather.py)
against numpy indexing and the JAX package (its MXU gather kernel in
TPU-interpret mode, its WHDR functions on the CPU)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from reflectance_filtering_tpu.losses.whdr import (
    comparisons_to_pixel_indices as j_indices, whdr as j_whdr,
    whdr_batch as j_whdr_batch, whdr_per_image as j_whdr_per_image)
from reflectance_filtering_tpu.ops.whdr_gather_pallas import (
    gather_pairs as jax_gather_pairs)
from reflectance_filtering_tpu_torch.losses import whdr as tw
from reflectance_filtering_tpu_torch.ops.whdr_gather import (
    gather_pairs, gather_pairs_plain)
from reflectance_filtering_tpu_torch.utils.testimages import (
    make_synthetic_comps)


def _indices(rng, b, k, h, w):
    return [rng.randint(0, n, (b, k)).astype(np.int32) for n in (h, w, h, w)]


def test_gather_pairs_bitwise_vs_numpy_and_pallas(rng):
    b, h, w, k = 3, 21, 37, 300
    plane = rng.rand(b, h, w).astype(np.float32)
    y1, x1, y2, x2 = _indices(rng, b, k, h, w)
    got = gather_pairs(torch.from_numpy(plane), *map(torch.from_numpy,
                                                     (y1, x1, y2, x2)))
    bi = np.arange(b)[:, None]
    np.testing.assert_array_equal(got[0].numpy(), plane[bi, y1, x1])
    np.testing.assert_array_equal(got[1].numpy(), plane[bi, y2, x2])
    with pltpu.force_tpu_interpret_mode():
        exp = jax_gather_pairs(jnp.asarray(plane), *map(
            jnp.asarray, (y1, x1, y2, x2)))
    for g, e in zip(got, exp):
        np.testing.assert_array_equal(g.numpy(), np.asarray(e))


def test_gather_wrapper_checks_and_cpu_dispatch(rng):
    plane = torch.rand(2, 5, 6)
    idx = [torch.from_numpy(i) for i in _indices(rng, 2, 7, 5, 6)]
    before = gather_pairs.launches
    for g, e in zip(gather_pairs(plane, *idx),
                    gather_pairs_plain(plane, *idx)):
        assert torch.equal(g, e)
    assert gather_pairs.launches == before
    with pytest.raises(TypeError):
        gather_pairs(plane, idx[0].long(), *idx[1:])
    with pytest.raises(ValueError):
        gather_pairs(plane, idx[0][:, :3].contiguous(), *idx[1:])
    with pytest.raises(ValueError):
        gather_pairs(plane[:1], *idx)


@pytest.mark.parametrize("case", ["plain", "requires_grad"])
def test_gather_cpu_never_reaches_launch(case, rng, monkeypatch):
    """CPU tensors take the indexing path, with and without autograd: the
    kernel launcher is never reached, and the result is bitwise indexing
    (its one-pass checks keep every raise: a non-tensor, a strided index
    and an index on another device)."""
    from reflectance_filtering_tpu_torch.ops import _build

    def no_launch(*args, **kwargs):
        raise AssertionError("_build.launch reached for CPU tensors")

    monkeypatch.setattr(_build, "launch", no_launch)
    plane = torch.rand(3, 9, 11, requires_grad=case == "requires_grad")
    idx = [torch.from_numpy(i) for i in _indices(rng, 3, 40, 9, 11)]
    got = gather_pairs(plane, *idx)
    bi = torch.arange(3)[:, None]
    for g, (y, x) in zip(got, ((idx[0], idx[1]), (idx[2], idx[3]))):
        assert torch.equal(g, plane[bi, y.long(), x.long()])
    if case == "requires_grad":
        (got[0] + 2.0 * got[1]).sum().backward()
        assert plane.grad.sum().item() == 3 * 40 * 3
    with pytest.raises(TypeError):
        gather_pairs(plane, idx[0].numpy(), *idx[1:])
    with pytest.raises(ValueError, match="contiguous"):
        gather_pairs(plane, idx[0].t().contiguous().t(), *idx[1:])
    with pytest.raises(ValueError, match="share a device"):
        gather_pairs(plane, idx[0].to("meta"), *idx[1:])


def _comps(seed, k, b, valid=None):
    """Synthetic blob; with ``valid`` each image keeps only that many rows
    and the rest are NaN-padded, as the dataset builder pads them."""
    c = make_synthetic_comps(seed, k, batch=b)
    if valid is not None:
        for i, n in enumerate(valid):
            c[i, n:k] = np.nan
            c[i, k, 0] = n
    return c


@pytest.mark.parametrize("channels", [None, 1, 3])
@pytest.mark.parametrize("valid", [None, (120, 0, 299)])
def test_whdr_batch_matches_jax(channels, valid, rng):
    b, h, w, k = 3, 24, 31, 300
    refl = rng.rand(b, h, w).astype(np.float32)
    if channels:
        refl = rng.rand(b, h, w, channels).astype(np.float32)
    comps = _comps(7, k, b, valid)
    got = tw.whdr_batch(torch.from_numpy(refl), torch.from_numpy(comps))
    exp = j_whdr_batch(jnp.asarray(refl), jnp.asarray(comps))
    assert abs(got.item() - float(exp)) <= 1e-6
    per = tw.whdr_per_image(torch.from_numpy(refl), torch.from_numpy(comps))
    exp_per = np.asarray(j_whdr_per_image(jnp.asarray(refl),
                                          jnp.asarray(comps)))
    np.testing.assert_allclose(per.numpy(), exp_per, rtol=0, atol=1e-6)
    if valid:
        assert per[1].item() == 0.0            # no comparisons -> 0


def test_whdr_single_image_matches_jax(rng):
    refl = rng.rand(19, 26, 3).astype(np.float32)
    refl[3:9, 4:12] = 0.0                      # exercises the EPS floor
    comps = _comps(3, 250, 1, valid=(200,))[0]
    got = tw.whdr(torch.from_numpy(refl), torch.from_numpy(comps))
    exp = j_whdr(jnp.asarray(refl), jnp.asarray(comps))
    assert abs(got.item() - float(exp)) <= 1e-6
    for g, e in zip(tw.comparisons_to_pixel_indices(
                        torch.from_numpy(comps), 19, 26),
                    j_indices(jnp.asarray(comps), 19, 26)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(e))
