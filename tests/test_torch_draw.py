"""The port's network drawing (reflectance_filtering_tpu_torch/models/
draw.py) against the JAX package's: the same nodes (ids, labels with
kernel sizes and widths, kinds, places) and edges for all seven network
types, with and without batch normalization, and a PNG written."""
import os

import pytest

from reflectance_filtering_tpu.models import draw as jd
from reflectance_filtering_tpu.models import networks as jn
from reflectance_filtering_tpu_torch.models import draw as td
from reflectance_filtering_tpu_torch.models import networks as tn

TYPES = ["uNet", "simpleConvolutionsRelu", "convStatic", "convIncreasing",
         "convStaticWithSigmoid", "convStaticSkipLayers",
         "cascadeSkipLayers"]


@pytest.mark.parametrize("bn", [False, True])
@pytest.mark.parametrize("kind", TYPES)
def test_graph_equals_jax(kind, bn):
    kw = dict(network_type=kind, num_layers=2, kernel_pad=1,
              use_batch_normalization=bn)
    got = td.network_graph(tn.NetworkConfig(**kw))
    want = jd.network_graph(jn.NetworkConfig(**kw))
    assert got == want


@pytest.mark.parametrize("kw", [dict(), dict(num_layers=0),
                                dict(network_type="convStatic",
                                     num_layers=0),
                                dict(network_type="cascadeSkipLayers",
                                     num_layers=3, rs_est_mode="rDirectly")])
def test_graph_equals_jax_off_the_defaults(kw):
    assert (td.network_graph(tn.NetworkConfig(**kw))
            == jd.network_graph(jn.NetworkConfig(**kw)))


def test_render_writes_png(tmp_path):
    p = td.render_network_graph(tn.NetworkConfig(), str(tmp_path / "n.png"))
    assert p == str(tmp_path / "n.png")
    assert os.path.getsize(p) > 1000
    with open(p, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"
