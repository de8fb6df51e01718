"""The port's pix2pix U-Net generator (``pix2pixUnet``: ``models/networks.py``
through ``train/loop.py``) against the plain reference
``benchmark/reference/pix2pix.py`` and against a transcription of the
published ``UnetSkipConnectionBlock`` / ``UnetGenerator``
(github.com/junyanz/pytorch-CycleGAN-and-pix2pix, models/networks.py), on
the CPU, from seeded ``init_network`` weights, at ngf 4 with num_downs 5
(4 x 32x32, the smallest U-Net the published code builds) and num_downs 8
(2 x 256x256, the published depth).

Tolerances, each against the largest gap measured over 4 weight seeds at
both sizes, with one thread and with eight (float32 sums in an order that
follows the thread count):

* the head's estimate within 5e-6 of its largest value, against the
  reference and against the published blocks: the port's convolutions run
  on NHWC views and the others' on NCHW tensors, and the reference writes
  the transposed convolution out tap by tap (1.2e-6 measured);
* the network's gradient in float64, every trained leaf (gamma and beta
  among them) within 1e-9 of the larger of the leaf's and the median
  leaf's norm of the reference's, and the running statistics it moves
  within 1e-12 (8.1e-15 and 1.8e-15 measured): both sides compute the
  same function in float64, where no ReLU input falls on the other side
  of 0;
* one float32 training step: the loss within 2e-6 relative (8.6e-7
  measured); the gradient within 1e-2 of the leaf norms above, as a ReLU
  or LeakyReLU input within float32's rounding of 0 flips its slope and
  moves every leaf below it by about 1 / sqrt(its map's elements) (4.6e-3
  measured, one seed with one thread; 1.7e-5 without a flip); the running
  statistics within 3e-5 of each leaf's largest value (6.4e-6 measured);
  each parameter's change within 2e-4 (leaf norms) of Adam's first step,
  written out, on the port's own gradient: float32 arithmetic against
  float64 (4.2e-5 measured).
"""
import copy

import numpy as np
import pytest
import torch
from torch import nn

from benchmark.reference import pix2pix as ref
from benchmark.reference.unet import floored, loss_of
from reflectance_filtering_tpu_torch.models import draw
from reflectance_filtering_tpu_torch.models import networks as tn
from reflectance_filtering_tpu_torch.train import description, loop
from reflectance_filtering_tpu_torch.utils.testimages import (
    make_synthetic_comps)

LR = 1e-3
# (num_downs, frame, batch)
SIZES = [(5, 32, 4), (8, 256, 2)]
PUBLISHED = dict(network_type="pix2pixUnet", num_layers=8,
                 num_filters_log=6, rs_est_mode="rRelMax")


def _cfg(num_downs):
    return tn.NetworkConfig(network_type="pix2pixUnet", num_layers=num_downs,
                            num_filters_log=2, rs_est_mode="rRelMax")


def _params(num_downs, seed):
    return tn.init_network(_cfg(num_downs),
                           torch.Generator().manual_seed(seed))


def _data(frame, seed=0, batch=2):
    rng = np.random.RandomState(seed)
    images = (rng.rand(batch, frame, frame, 3) * 0.8 + 0.1).astype(
        np.float32)
    comps = make_synthetic_comps(seed, 40, batch=batch)
    return torch.from_numpy(images), torch.from_numpy(comps)


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


# the published blocks, transcribed (models/networks.py of
# pytorch-CycleGAN-and-pix2pix, --norm batch, without dropout)
class UnetSkipConnectionBlock(nn.Module):
    def __init__(self, outer_nc, inner_nc, input_nc=None, submodule=None,
                 outermost=False, innermost=False,
                 norm_layer=nn.BatchNorm2d):
        super().__init__()
        self.outermost = outermost
        use_bias = norm_layer == nn.InstanceNorm2d
        if input_nc is None:
            input_nc = outer_nc
        downconv = nn.Conv2d(input_nc, inner_nc, kernel_size=4, stride=2,
                             padding=1, bias=use_bias)
        downrelu = nn.LeakyReLU(0.2, True)
        downnorm = norm_layer(inner_nc)
        uprelu = nn.ReLU(True)
        upnorm = norm_layer(outer_nc)
        if outermost:
            upconv = nn.ConvTranspose2d(inner_nc * 2, outer_nc,
                                        kernel_size=4, stride=2, padding=1)
            model = [downconv, submodule, uprelu, upconv, nn.Tanh()]
        elif innermost:
            upconv = nn.ConvTranspose2d(inner_nc, outer_nc, kernel_size=4,
                                        stride=2, padding=1, bias=use_bias)
            model = [downrelu, downconv, uprelu, upconv, upnorm]
        else:
            upconv = nn.ConvTranspose2d(inner_nc * 2, outer_nc,
                                        kernel_size=4, stride=2, padding=1,
                                        bias=use_bias)
            model = [downrelu, downconv, downnorm, submodule, uprelu, upconv,
                     upnorm]
        self.model = nn.Sequential(*model)

    def forward(self, x):
        if self.outermost:
            return self.model(x)
        return torch.cat([x, self.model(x)], 1)


class UnetGenerator(nn.Module):
    def __init__(self, input_nc, output_nc, num_downs, ngf=64,
                 norm_layer=nn.BatchNorm2d):
        super().__init__()
        block = UnetSkipConnectionBlock(ngf * 8, ngf * 8, innermost=True,
                                        norm_layer=norm_layer)
        for _ in range(num_downs - 5):
            block = UnetSkipConnectionBlock(ngf * 8, ngf * 8,
                                            submodule=block,
                                            norm_layer=norm_layer)
        block = UnetSkipConnectionBlock(ngf * 4, ngf * 8, submodule=block,
                                        norm_layer=norm_layer)
        block = UnetSkipConnectionBlock(ngf * 2, ngf * 4, submodule=block,
                                        norm_layer=norm_layer)
        block = UnetSkipConnectionBlock(ngf, ngf * 2, submodule=block,
                                        norm_layer=norm_layer)
        self.model = UnetSkipConnectionBlock(output_nc, ngf,
                                             input_nc=input_nc,
                                             submodule=block, outermost=True,
                                             norm_layer=norm_layer)

    def forward(self, x):
        return self.model(x)


def _published(params, num_downs, ngf=4):
    """The published generator holding the port's parameters: a
    ConvTranspose2d reads its kernel front to back, the port's back to
    front (``deconv2d``), so it gets the kernel flipped."""
    gen = UnetGenerator(3, 1, num_downs, ngf)
    block, k = gen.model, 1
    with torch.no_grad():
        while block is not None:
            inner, up = None, False
            for m in block.model:
                if isinstance(m, nn.Conv2d):
                    m.weight.copy_(params["down{}".format(k)]["kernel"]
                                   .permute(3, 2, 0, 1))
                elif isinstance(m, nn.ConvTranspose2d):
                    up = True
                    p = params["up{}".format(k)]
                    m.weight.copy_(p["kernel"].flip(0, 1).permute(2, 3, 0, 1))
                    if m.bias is not None:
                        m.bias.copy_(p["bias"])
                elif isinstance(m, nn.BatchNorm2d):
                    p = params["{}{}_bn".format("up" if up else "down", k)]
                    m.weight.copy_(p["gamma"])
                    m.bias.copy_(p["beta"])
                    m.running_mean.copy_(p["mean"])
                    m.running_var.copy_(p["var"])
                elif isinstance(m, UnetSkipConnectionBlock):
                    inner = m
            block, k = inner, k + 1
    return gen


def _published_running(gen):
    """The running statistics of the published generator's batch norms, in
    the order the port's ``_published`` reads them."""
    return [(m.running_mean, m.running_var) for m in gen.modules()
            if isinstance(m, nn.BatchNorm2d)]


def _port_running(params, num_downs):
    order = (["down{}_bn".format(k) for k in range(2, num_downs)]
             + ["up{}_bn".format(k) for k in range(num_downs, 1, -1)])
    return [(params[name]["mean"], params[name]["var"]) for name in order]


def test_reference_layers_are_the_ports():
    for n in (5, 8):
        want = {a: {k: tuple(v.shape) for k, v in q.items()}
                for a, q in _params(n, 0).items()}
        assert ref.param_shapes(n, 4) == want


def test_published_parameter_count_and_init():
    """54,409,857 trained parameters at num_downs 8, ngf 64, one output
    channel; kernels N(0, 0.02), gamma N(1, 0.02), beta and the bias 0,
    running mean 0 and variance 1."""
    params = tn.init_network(tn.NetworkConfig(**PUBLISHED),
                             torch.Generator().manual_seed(0))
    assert sum(v.numel() for q in params.values() for k, v in q.items()
               if k not in ("mean", "var")) == 54_409_857
    assert ref.param_shapes(8, 64) == {
        a: {k: tuple(v.shape) for k, v in q.items()}
        for a, q in params.items()}
    kernels = torch.cat([q["kernel"].reshape(-1) for q in params.values()
                         if "kernel" in q])
    assert abs(float(kernels.std()) - 0.02) < 1e-4
    assert abs(float(kernels.mean())) < 1e-5
    bns = [q for name, q in params.items() if name.endswith("_bn")]
    assert len(bns) == 13
    gammas = torch.cat([q["gamma"] for q in bns])
    assert abs(float(gammas.mean()) - 1.0) < 2e-3
    assert 0.015 < float(gammas.std()) < 0.025
    for q in bns:
        assert float(q["beta"].abs().max()) == 0
        assert float(q["mean"].abs().max()) == 0
        assert float((q["var"] - 1).abs().max()) == 0
    assert float(params["up1"]["bias"].abs().max()) == 0
    assert [name for name, q in params.items() if "bias" in q] == ["up1"]


@pytest.mark.parametrize("num_downs, frame, batch", SIZES)
@pytest.mark.parametrize("seed", [0, 2])
def test_forward_matches_the_reference(num_downs, frame, batch, seed):
    params = _params(num_downs, seed)
    images, _ = _data(frame, seed, batch)
    with torch.no_grad():
        got = tn.apply_network(copy.deepcopy(params), images,
                               _cfg(num_downs), train=True)["RS_est"]
        want, _ = ref.forward(params, images)
    assert got.shape == (batch, frame, frame, 1)
    gap = (got.permute(0, 3, 1, 2) - want).abs().max()
    assert gap <= 5e-6 * want.abs().max()


@pytest.mark.parametrize("num_downs, frame, batch", SIZES)
def test_forward_matches_the_published_blocks(num_downs, frame, batch):
    """The published generator in train mode, with its in-place
    LeakyReLU: the skip order, the layers without a bias, the outermost's
    bias and tanh, and every running statistic after one forward."""
    params = _params(num_downs, 1)
    images, _ = _data(frame, 1, batch)
    gen = _published(params, num_downs).train()
    mine = copy.deepcopy(params)
    with torch.no_grad():
        want = (1.0 + gen(images.permute(0, 3, 1, 2))) * 0.5
        got = tn.apply_network(mine, images, _cfg(num_downs),
                               train=True)["RS_est"]
    assert (got.permute(0, 3, 1, 2) - want).abs().max() \
        <= 5e-6 * want.abs().max()
    published = _published_running(gen)
    assert len(published) == 2 * num_downs - 3
    for (gm, gv), (wm, wv) in zip(_port_running(mine, num_downs), published):
        assert (gm - wm).abs().max() <= 3e-5 * wm.abs().max()
        assert (gv - wv).abs().max() <= 3e-5 * wv.abs().max()
    # the running statistics moved from their start
    assert float(mine["up2_bn"]["mean"].abs().max()) > 0
    assert float((mine["up2_bn"]["var"] - 1).abs().max()) > 0


@pytest.mark.parametrize("num_downs, frame, batch", SIZES)
@pytest.mark.parametrize("seed", [0, 3])
def test_network_gradient_matches_in_float64(num_downs, frame, batch, seed):
    """The port's network in float64 under the reference's loss: every
    trained leaf's gradient, gamma and beta among them, and the running
    statistics its batch norms move, against the reference's."""
    params = _double(_params(num_downs, seed))
    images, comps = (t.double() for t in _data(frame, seed, batch))
    leaves = {n: {k: v.clone().requires_grad_(k not in ref.RUNNING)
                  for k, v in p.items()} for n, p in params.items()}
    est = tn.apply_network(leaves, images, _cfg(num_downs),
                           train=True)["RS_est"].permute(0, 3, 1, 2)
    keys = ref.trainable(leaves)
    got = torch.autograd.grad(loss_of(floored(est), images, comps),
                              [leaves[n][k] for n, k in keys])
    value, want, stats = ref.gradient(params, images, comps)
    assert {k for _, k in keys} == {"kernel", "bias", "gamma", "beta"}
    nested = {}
    for (n, k), g in zip(keys, got):
        nested.setdefault(n, {})[k] = g
    assert max(_leaf_gaps(nested, want).values()) <= 1e-9
    for name, moved in ref.running_statistics(params, stats).items():
        for part, v in moved.items():
            assert (leaves[name][part] - v).abs().max() \
                <= 1e-12 * v.abs().max(), (name, part)


@pytest.mark.parametrize("num_downs, frame, batch", SIZES)
@pytest.mark.parametrize("seed", [0, 3])
def test_adam_step_matches_the_reference(num_downs, frame, batch, seed):
    """One float32 make_train_step step: the loss, every trained leaf's
    gradient (as the step left it in ``.grad``; gamma and beta among
    them), the running statistics after it, and every parameter's
    change."""
    cfg = _cfg(num_downs)
    params = _params(num_downs, seed)
    images, comps = _data(frame, seed, batch)
    leaves = loop.trainable(params, "cpu")
    opt = loop.make_optimizer("ADAM", LR, leaves)
    metrics = loop.make_train_step(cfg, loop.LossConfig(), leaves,
                                   opt)(images, comps)
    value, grad, after, _ = ref.adam_step(_double(params), {},
                                          images.double(), comps.double(),
                                          LR)
    assert abs(float(metrics["loss_total"]) - value) <= 2e-6 * abs(value)
    g = {n: {k: leaves[n][k].grad for k in grad[n]} for n in grad}
    assert max(_leaf_gaps(g, grad).values()) <= 1e-2
    for name in (n for n in after if n.endswith("_bn")):
        for part in ref.RUNNING:
            want = after[name][part]
            gap = (leaves[name][part].detach().double() - want).abs().max()
            assert gap <= 3e-5 * want.abs().max(), (name, part)
    change = {n: {k: leaves[n][k].detach() - params[n][k] for k in grad[n]}
              for n in grad}
    adam = {n: {k: -LR * g[n][k] / (g[n][k].abs() + ref.ADAM_EPS)
                for k in grad[n]} for n in grad}
    assert max(_leaf_gaps(change, adam).values()) <= 2e-4
    # Adam holds no state for the running statistics: they get no gradient
    assert all(leaves[n][k].grad is None for n in leaves
               for k in ref.RUNNING if k in leaves[n])


def test_reference_one_step_lower_misses_the_gradient():
    """The control: the reference on TF32-rounded operands misses the
    float64 gradient by more than 1e-3 of a leaf, where the port in
    float64 agrees within 1e-9."""
    params = _params(8, 0)
    images, comps = _data(256, 0, 2)
    _, want, _ = ref.gradient(_double(params), images.double(),
                              comps.double())
    _, low, _ = ref.gradient(params, images, comps, low=True)
    assert max(_leaf_gaps(low, want).values()) > 1e-3


def test_one_eager_step_counts_its_launches():
    """num_downs 8: 8 convolutions, 8 transposed convolutions and 13 batch
    norms a forward, each counted once; the backward counts none."""
    cfg = _cfg(8)
    images, comps = _data(256, 0, 2)
    leaves = loop.trainable(_params(8, 0), "cpu")
    step = loop.make_train_step(cfg, loop.LossConfig(), leaves,
                                loop.make_optimizer("ADAM", LR, leaves))
    fns = (tn.conv2d, tn.deconv2d, tn.batch_norm)
    before = [f.launches for f in fns]
    step(images, comps)
    assert [f.launches - b for f, b in zip(fns, before)] == [8, 8, 13]


def test_eval_normalises_with_the_running_statistics():
    """train=False reads the running statistics and leaves them as they
    are; the published generator in eval mode agrees."""
    params = _params(5, 4)
    images, _ = _data(32, 4, 4)
    cfg = _cfg(5)
    trained = copy.deepcopy(params)
    with torch.no_grad():
        tn.apply_network(trained, images, cfg, train=True)
        frozen = copy.deepcopy(trained)
        got = tn.apply_network(trained, images[:1], cfg)["RS_est"]
        want = (1.0 + _published(frozen, 5).eval()(
            images[:1].permute(0, 3, 1, 2))) * 0.5
    assert (got.permute(0, 3, 1, 2) - want).abs().max() \
        <= 5e-6 * want.abs().max()
    for name, q in frozen.items():
        for part, v in q.items():
            assert torch.equal(trained[name][part], v), (name, part)


def test_deconv2d_pad_is_the_spread_input_correlated():
    """The port's tap convention: a transposed convolution of kernel k,
    stride s and padding p is the correlation of the input spread s apart
    (zeros between) with the HWIO kernel as it is, zero-padded by
    k - 1 - p; pad 0, the uNet's 2x2 case, is unchanged."""
    g = torch.Generator().manual_seed(5)
    x = torch.randn(2, 5, 7, 3, generator=g)
    for kernel, pad in ((4, 1), (2, 0), (4, 0)):
        p = {"kernel": torch.randn(kernel, kernel, 3, 6, generator=g)}
        got = tn.deconv2d(p, x, pad=pad).permute(0, 3, 1, 2)
        spread = torch.zeros(2, 3, 9, 13)
        spread[:, :, ::2, ::2] = x.permute(0, 3, 1, 2)
        want = torch.nn.functional.conv2d(spread, p["kernel"].permute(
            3, 2, 0, 1), padding=kernel - 1 - pad)
        assert torch.allclose(got, want, atol=1e-5)
    p = {"kernel": torch.randn(2, 2, 3, 6, generator=g),
         "bias": torch.randn(6, generator=g)}
    no_bias = tn.deconv2d({"kernel": p["kernel"]}, x)
    assert torch.allclose(tn.deconv2d(p, x), no_bias + p["bias"])


def test_conv2d_without_a_bias():
    g = torch.Generator().manual_seed(6)
    x = torch.randn(1, 8, 8, 3, generator=g)
    for kernel, stride, pad in ((4, 2, 1), (1, 1, 0)):
        k = torch.randn(kernel, kernel, 3, 5, generator=g)
        b = torch.randn(5, generator=g)
        assert torch.allclose(
            tn.conv2d({"kernel": k}, x, pad=pad, stride=stride) + b,
            tn.conv2d({"kernel": k, "bias": b}, x, pad=pad, stride=stride),
            atol=1e-6)


def test_too_shallow_and_data_parallel_are_refused():
    with pytest.raises(ValueError, match="at least 5"):
        tn.init_network(_cfg(4))
    with pytest.raises(NotImplementedError, match="data-parallel"):
        tn.apply_network(_params(5, 0), torch.rand(2, 32, 32, 3), _cfg(5),
                         train=True, bn_group=object())


def test_batch_norm_flag_is_ignored():
    """The type always has its batch norm, whatever the flag says."""
    on = tn.init_network(tn.NetworkConfig(**dict(
        PUBLISHED, num_filters_log=2, use_batch_normalization=True)))
    off = tn.init_network(tn.NetworkConfig(**dict(
        PUBLISHED, num_filters_log=2)))
    assert sorted(on) == sorted(off)
    assert sum(name.endswith("_bn") for name in off) == 13


def test_drawn_and_named():
    """The network graph holds every layer, and the experiment name
    round-trips; the train CLI accepts the type."""
    from reflectance_filtering_tpu_torch.cli.train import build_parser
    cfg = _cfg(5)
    nodes, edges = draw.network_graph(cfg)
    ids = {node[0] for node in nodes}
    assert {"down{}".format(i) for i in range(1, 6)} <= ids
    assert {"up{}".format(i) for i in range(1, 6)} <= ids
    assert all(a in ids and b in ids for a, b in edges)
    args = build_parser().parse_args(
        ["--networkType", "pix2pixUnet", "--numLayers", "8",
         "--num_filters_log", "6"])
    args.height, args.width = 256, 256
    _, desc = description.get_description(args)
    back = description.parse_description(desc + "_barrista_iter_20")
    assert (back["networkType"], back["numLayers"],
            back["num_filters_log"]) == ("pix2pixUnet", 8, 6)


def test_drawing_renders(tmp_path):
    path = draw.render_network_graph(_cfg(5), str(tmp_path / "p2p.png"))
    assert (tmp_path / "p2p.png").stat().st_size > 0 and path


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the captured step runs on a card)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_captured_replays_follow_the_eager_steps(dev):
    """make_train_chunk on the card (one eager step, the capture, the rest
    replays) against make_train_step's eager steps on the same rows, at
    num_downs 5, ngf 4, 4 x 32x32, under matmul_precision('highest'):
    chunks of 1, 1, 1 and 6 steps, so that each of the first replays is
    seen alone.  Every step's metrics and the parameters after within
    1e-5 relative (cuDNN may pick other algorithms in a capture, which sum
    in another order); the running statistics move in every replay, as in
    every eager step; the counters count every replay's launches."""
    cfg, lcfg, n, bs = _cfg(5), loop.LossConfig(), 12, 4
    rng = np.random.RandomState(3)
    images = rng.rand(n, 32, 32, 3).astype(np.float32) * 0.8 + 0.1
    comps = make_synthetic_comps(2, 300, batch=n)
    im_d, cp_d = (torch.from_numpy(np.concatenate([a, a[:bs - 1]])).to(dev)
                  for a in (images, comps))
    init = _params(5, 7)
    pa, pb = loop.trainable(init, dev), loop.trainable(init, dev)
    fns = (tn.conv2d, tn.deconv2d, tn.batch_norm)
    stacked, eager, moved = [], [], []
    with tn.matmul_precision("highest"):
        chunk = loop.make_train_chunk(cfg, lcfg, pa, loop.make_optimizer(
            "ADAM", LR, pa), im_d, cp_d, cp_d, bs)
        step = loop.make_train_step(cfg, lcfg, pb, loop.make_optimizer(
            "ADAM", LR, pb))
        before = [f.launches for f in fns]
        s = 0
        for k in (1, 1, 1, 6):
            was = pa["up2_bn"]["mean"].clone(), pa["down2_bn"]["var"].clone()
            stacked.append(chunk(s, (s * bs) % n, k).cpu().numpy())
            moved.append(min(
                float((pa["up2_bn"]["mean"] - was[0]).abs().max()),
                float((pa["down2_bn"]["var"] - was[1]).abs().max())))
            s += k
        assert [f.launches - b for f, b in zip(fns, before)] == [
            5 * s, 5 * s, 7 * s]
        for j in range(s):
            cursor = (j * bs) % n
            met = step(im_d[cursor:cursor + bs], cp_d[cursor:cursor + bs])
            eager.append([met[key].item() for key in chunk.keys])
    assert all(m > 0 for m in moved), moved
    np.testing.assert_allclose(np.concatenate(stacked),
                               np.array(eager, np.float32), rtol=1e-5,
                               atol=1e-7)
    for layer in pb:
        for part in pb[layer]:
            want = pb[layer][part]
            gap = (pa[layer][part] - want).abs().max().item()
            assert gap <= 1e-5 * max(want.abs().max().item(), 1e-3), (
                layer, part, gap)
