"""Network-graph rendering: the layer DAG of a NetworkConfig as a PNG (port
of reflectance_filtering_tpu/models/draw.py).

The reference draws its caffe net next to the prototxt for every
experiment (``training/networks.py:148-152``: barrista's
``draw_net_to_file`` into ``networks/<desc>.png``).  The architecture
lives in a NetworkConfig, so the drawing is derived from the same
init/apply topology the trainer executes: layer names, kernel sizes and
channel widths are read off the freshly initialized params
(``models/networks.py::init_network``).

Pure matplotlib, imported inside ``render_network_graph`` (no graphviz).
Failure to render must never kill a training run; callers wrap
``render_network_graph`` accordingly.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from .networks import NetworkConfig, init_network

Node = Tuple[str, str, str, int, int]      # id, label, kind, col, lane
Edge = Tuple[str, str]

# fill colors per node kind
_KIND_FACE = {
    "data": "#dfe9f5",
    "conv": "#f5e9d0",
    "op": "#e4f0de",
    "out": "#e8def0",
}


def _conv_label(params: Dict, name: str, extra: str = "") -> str:
    kh, kw, ci, co = tuple(params[name]["kernel"].shape)
    return "{}\n{}x{}, {}→{}{}".format(name, kh, kw, ci, co, extra)


def _chain(nodes: List[Node], edges: List[Edge], params, names,
           col0: int, lane: int, prev: str, cfg: NetworkConfig,
           relu: bool = True) -> Tuple[str, int]:
    """Append a conv chain; returns (last id, next free column)."""
    col = col0
    for name in names:
        extra = ""
        if relu:
            extra = ("\n+BN, ReLU" if cfg.use_batch_normalization
                     and ("bn" + name[4:]) in params else "\nReLU")
        nodes.append((name, _conv_label(params, name, extra),
                      "conv", col, lane))
        edges.append((prev, name))
        prev = name
        col += 1
    return prev, col


def network_graph(cfg: NetworkConfig):
    """(nodes, edges) of the layer DAG, matching apply_network's
    topology for every networkType (models/networks.py)."""
    params = init_network(cfg)
    t = cfg.network_type
    n = cfg.num_layers
    nodes: List[Node] = [("data", "data\n[B,H,W,3]", "data", 0, 0)]
    edges: List[Edge] = []

    def out(prev, col, lane=0, name="RS_est"):
        nodes.append((name, name, "out", col, lane))
        edges.append((prev, name))

    if t in ("convStatic", "convStaticWithSigmoid"):
        # _apply_conv_static: n convs(+ReLU) then a head conv, sigmoid
        # only for the WithSigmoid variant (ref networks.py:556,637)
        if n >= 1:
            prev, col = _chain(nodes, edges, params,
                               ["conv{}".format(i) for i in range(n)],
                               1, 0, "data", cfg)
            nodes.append(("head", _conv_label(params, "conv{}".format(n)),
                          "conv", col, 0))
            edges.append((prev, "head"))
            prev, col = "head", col + 1
        else:
            nodes.append(("conv0", _conv_label(params, "conv0"),
                          "conv", 1, 0))
            edges.append(("data", "conv0"))
            prev, col = "conv0", 2
        if t == "convStaticWithSigmoid":
            nodes.append(("sigmoid", "sigmoid", "op", col, 0))
            edges.append((prev, "sigmoid"))
            prev, col = "sigmoid", col + 1
        out(prev, col)

    elif t in ("convStaticSkipLayers", "cascadeSkipLayers"):
        suffixes = ([""] if t == "convStaticSkipLayers"
                    else ["_level0", "_level1"])
        prev_in, col = "data", 1
        for li, sfx in enumerate(suffixes):
            if n >= 1:
                prev, col = _chain(
                    nodes, edges, params,
                    ["conv{}{}".format(i, sfx) for i in range(n)],
                    col, 0, prev_in, cfg)
                cat = "concat" + sfx
                nodes.append((cat, "concat\n[{}]".format(
                    cfg.num_filters * n), "op", col, 1))
                for i in range(n):
                    edges.append(("conv{}{}".format(i, sfx), cat))
                fuse = "fuse_skip_layers" + sfx
                nodes.append((fuse, _conv_label(params, fuse),
                              "conv", col + 1, 0))
                edges.append((cat, fuse))
                sig = "sigmoid" + sfx
                nodes.append((sig, "sigmoid", "op", col + 2, 0))
                edges.append((fuse, sig))
                prev, col = sig, col + 3
            else:
                cname = "conv0" + sfx
                nodes.append((cname, _conv_label(params, cname),
                              "conv", col, 0))
                edges.append((prev_in, cname))
                sig = "sigmoid" + sfx
                nodes.append((sig, "sigmoid", "op", col + 1, 0))
                edges.append((cname, sig))
                prev, col = sig, col + 2
            if t == "cascadeSkipLayers" and li == 0:
                # level-0 head feeds the recover op (rDirectly falls
                # back to rRelMax, ref recover_..._layer.py:104-109)
                mode = cfg.rs_est_mode
                if mode.split("-")[0] == "rDirectly":
                    mode = "rRelMax"
                out(prev, col, lane=1, name="RS_est_level0")
                rec = "recover_level0"
                nodes.append((rec, "recover\n({})".format(mode),
                              "op", col, 0))
                edges.append((prev, rec))
                edges.append(("data", rec))
                prev_in, col = rec, col + 1
        out(prev, col)

    elif t == "simpleConvolutionsRelu":
        names = (["conv_in"] + ["conv_mid{}".format(i) for i in range(n)]
                 + ["conv_narrow"])
        prev, col = _chain(nodes, edges, params, names, 1, 0, "data", cfg)
        nodes.append(("conv_head", _conv_label(params, "conv_head"),
                      "conv", col, 0))
        edges.append((prev, "conv_head"))
        out("conv_head", col + 1)

    elif t == "convIncreasing":
        if n >= 1:
            prev, col = _chain(nodes, edges, params,
                               ["conv{}".format(i) for i in range(n)],
                               1, 0, "data", cfg)
        else:
            prev, col = "data", 1
        nodes.append(("conv_head", _conv_label(params, "conv_head"),
                      "conv", col, 0))
        edges.append((prev, "conv_head"))
        out("conv_head", col + 1)

    elif t == "uNet":
        # coarse block-level drawing of _apply_unet: stride-2 down path
        # (lane 0), fixed-256 global path (lane 2), combine, deconv up
        # path with skip concats back to l2 / l1 / data
        def node(nid, label, kind, col, lane, src=None):
            nodes.append((nid, label, kind, col, lane))
            if src is not None:
                edges.append((src, nid))

        blk = "" if n == 0 else "\n+{} conv{}".format(
            n, "" if n == 1 else "s")
        node("Conv1", _conv_label(params, "Conv1", "\ns2" + blk),
             "conv", 1, 0, "data")
        node("Conv2", _conv_label(params, "Conv2", "\ns2" + blk),
             "conv", 2, 0, "Conv1")
        node("Conv3", _conv_label(params, "Conv3", "\ns2" + blk),
             "conv", 3, 0, "Conv2")
        node("Conv4", _conv_label(params, "Conv4", blk),
             "conv", 4, 0, "Conv3")
        node("resize", "resize\n256x256", "op", 1, 2, "data")
        node("Conv5", _conv_label(params, "Conv5", "\ns4"),
             "conv", 2, 2, "resize")
        node("Conv6", _conv_label(params, "Conv6", "\ns4"),
             "conv", 3, 2, "Conv5")
        node("Conv7", _conv_label(params, "Conv7", "\ns4"),
             "conv", 4, 2, "Conv6")
        node("Conv8", _conv_label(params, "Conv8"), "conv", 5, 2, "Conv7")
        node("gap", "mean+\nbroadcast", "op", 6, 2, "Conv8")
        node("cat3", "concat", "op", 6, 1, "Conv4")
        edges.append(("gap", "cat3"))
        node("comb", "comb block" + blk, "conv", 7, 1, "cat3")
        node("up3", _conv_label(params, "up3", "\ndeconv"),
             "conv", 8, 1, "comb")
        node("cat2", "concat\n(skip l2)", "op", 9, 1, "up3")
        edges.append(("Conv2", "cat2"))
        node("r2", "r2 block" + blk, "conv", 10, 1, "cat2")
        node("up2", _conv_label(params, "up2", "\ndeconv"),
             "conv", 11, 1, "r2")
        node("cat1", "concat\n(skip l1)", "op", 12, 1, "up2")
        edges.append(("Conv1", "cat1"))
        node("r1", "r1 block" + blk, "conv", 13, 1, "cat1")
        node("up1", _conv_label(params, "up1", "\ndeconv"),
             "conv", 14, 1, "r1")
        node("cat0", "concat\n(skip in)", "op", 15, 1, "up1")
        edges.append(("data", "cat0"))
        node("head", _conv_label(params, "head"), "conv", 16, 1, "cat0")
        out("head", 17, lane=1)

    elif t == "pix2pixUnet":
        # _apply_pix2pix: the down path on lane 0 (4x4 stride-2 convs), the
        # up path back on lane 1, each up conv's output concatenated with
        # the down path's map of its scale
        def norm(name):
            return "\n+BN" if name + "_bn" in params else ""

        prev = "data"
        for i in range(1, n + 1):
            name = "down{}".format(i)
            act = "" if i == 1 else "LReLU 0.2,\n"
            nodes.append((name, _conv_label(params, name, "\n" + act + "s2"
                                            + norm(name)), "conv", i, 0))
            edges.append((prev, name))
            prev = name
        for i in range(n, 0, -1):
            name = "up{}".format(i)
            col = 2 * n + 1 - i
            nodes.append((name, _conv_label(params, name, "\nReLU, deconv s2"
                                            + (norm(name) if i > 1
                                               else ", tanh")),
                          "conv", col, 1))
            edges.append((prev, name))
            prev = name
            if i > 1:
                cat = "cat{}".format(i - 1)
                nodes.append((cat, "concat\n(skip down{})".format(i - 1),
                              "op", col, 2))
                edges.append((name, cat))
                edges.append(("down{}".format(i - 1), cat))
                prev = cat
        nodes.append(("head", "(1 + t) / 2", "op", 2 * n + 1, 1))
        edges.append((prev, "head"))
        out("head", 2 * n + 2, lane=1)

    else:
        raise ValueError("networkType '{}' not known".format(t))

    return nodes, edges


def render_network_graph(cfg: NetworkConfig, path: str) -> str:
    """Draw the layer DAG to ``path`` (PNG).  Returns the path."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.patches import FancyBboxPatch

    nodes, edges = network_graph(cfg)
    xs = {nid: col for nid, _, _, col, _ in nodes}
    ys = {nid: -lane for nid, _, _, _, lane in nodes}
    ncols = max(xs.values()) + 1
    nlanes = max(lane for _, _, _, _, lane in nodes) + 1

    fig, ax = plt.subplots(
        figsize=(max(2.2 * ncols, 4), max(2.2 * nlanes, 2.8)))
    ax.set_xlim(-0.6, ncols - 0.4)
    ax.set_ylim(-nlanes + 0.4, 0.6)
    ax.axis("off")
    ax.set_title("{} (numLayers={}, filters={}, kernel={}, {})".format(
        cfg.network_type, cfg.num_layers, cfg.num_filters,
        cfg.kernel, cfg.rs_est_mode), fontsize=11)

    for a, b in edges:
        ax.annotate(
            "", xy=(xs[b], ys[b]), xytext=(xs[a], ys[a]),
            arrowprops=dict(arrowstyle="-|>", color="#666666",
                            lw=1.1, shrinkA=24, shrinkB=24,
                            connectionstyle="arc3,rad=0.08"))
    for nid, label, kind, col, lane in nodes:
        ax.add_patch(FancyBboxPatch(
            (col - 0.36, -lane - 0.22), 0.72, 0.44,
            boxstyle="round,pad=0.02,rounding_size=0.06",
            linewidth=1.0, edgecolor="#444444",
            facecolor=_KIND_FACE[kind], zorder=3))
        ax.text(col, -lane, label, ha="center", va="center",
                fontsize=7.5, zorder=4)
    fig.savefig(path, dpi=110, bbox_inches="tight")
    plt.close(fig)
    return path
