"""The batched serving pipelines (port of reflectance_filtering_tpu/
utils/serving.py:36-118, ``_pipeline_fn``).

``pipeline_fn(kind, net, device)`` returns a callable from a uint8 planar
BGR batch [B, 3, H, W] to [B, H, W] on ``device``:

  * ``"cnn"`` -> the reflectance intensity in (0, 1) (K1);
  * ``"bf"``  -> BF(CNN,CNN): reflectance, the -r.png byte path
    ``floor(r*255)`` as uint8, the self-guided gray bilateral at
    sigma_c=20, sigma_s=22 with reps=3 (-r.png reads back as three equal
    channels; K2 in cv2's table form), then the product's uint8 write path ``clip(rint(q), 0, 255)``,
    returned as uint8-valued float32;
  * ``"gf"``  -> GF(CNN, image): the same ``floor(r*255)`` reflectance,
    guided-filtered at r=45, eps=3 with the photo (RGB, 0-255 floats) as
    the color guide (K5), then ``clip(rint(q), 0, 255)`` (q = a*I + b
    overshoots [0, 255]).

The JAX package's ``jax.export`` artifacts (``export_flagship``,
``load_flagship``; ``torch.export`` here) are the one part of the JAX
package not ported yet: each kernel on the exported path must first be a
``torch.library`` custom op, since ``torch.export`` cannot trace a ctypes
launch.
"""
from __future__ import annotations

import torch

from ..cli.decompose import decompose_planar
from ..models.networks import ReflectanceNet
from ..ops.bilateral_kernel import bilateral_gray_self
from ..ops.cnn_kernel import pack_weights
from ..ops.guided import guided_filter_planar


def pipeline_fn(kind: str, net: ReflectanceNet, device):
    """Serving callable for ``kind`` in {"cnn", "bf", "gf"}; ``net``'s
    weights are packed onto ``device`` once, here."""
    if kind not in ("cnn", "bf", "gf"):
        raise ValueError("unknown pipeline '{}'".format(kind))
    weights = pack_weights(net).to(torch.device(device))

    def cnn(img_bgr_u8_planar: torch.Tensor) -> torch.Tensor:
        return decompose_planar(weights, img_bgr_u8_planar)

    if kind == "cnn":
        return cnn

    def pipeline(img_bgr_u8_planar: torch.Tensor) -> torch.Tensor:
        # the -r.png byte path: floor(r*255) (a sigmoid < 1 never triggers
        # imwrite's percentile normalize)
        r_u8 = torch.floor(cnn(img_bgr_u8_planar) * 255.0)
        if kind == "bf":
            # as uint8 levels (exact: they lie in 0-254), K2's table form
            q = bilateral_gray_self(r_u8.to(torch.uint8), -1, 20.0, 22.0,
                                    reps=3)
        else:
            # guidance = the original photo (RGB planar, 0-255)
            guide = img_bgr_u8_planar.to(r_u8.device).flip(1).to(
                torch.float32)
            q = guided_filter_planar(guide, r_u8[:, None], 45, 3.0)[:, 0]
        return torch.clamp(torch.round(q), 0.0, 255.0)

    return pipeline
