"""The batched serving pipelines and their export for serving (port of
reflectance_filtering_tpu/utils/serving.py).

``pipeline_fn(kind, net, device)`` returns a callable (a
:class:`FlagshipModule`) from a uint8 planar BGR batch [B, 3, H, W] to
[B, H, W] on ``device``:

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

``export_flagship`` serializes one of them, the packed weights baked in,
as a ``torch.export`` artifact (``.pt2``); ``load_flagship(path)`` gives
it back as a callable.  The kernels on the exported path are the
``torch.library`` operators ``rf::cnn_fwd`` (K1), ``rf::bilateral_gray_self``
(K2) and ``rf::guided_filter`` (K5): the artifact records their calls, and
at run time each dispatches on its tensors' device as the wrappers do (the
kernel on CUDA, the plain version on the CPU).  So an artifact exported on
the card runs the same kernels on the same inputs as ``pipeline_fn`` and
gives its bytes.  Unlike the JAX package's artifacts, which need only jax
and the file, a consumer needs torch and this package: importing this
module registers the operators, and the kernels are built at first use.

Build an artifact:
    python -m reflectance_filtering_tpu_torch.utils.serving \\
        --out flagship_b16_256.pt2 --batch 16 --height 256 --width 256 \\
        [--pipeline cnn|bf|gf] [--symbolic] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import os

import torch

from ..cli import add_device_flag, resolve_device
from ..cli.decompose import ReflectanceCNN, decompose_planar
from ..models.networks import ReflectanceNet
from ..ops import _build
from ..ops.bilateral_kernel import bilateral_gray_self
from ..ops.cnn_kernel import pack_weights
from ..ops.guided import guided_filter_planar
from .profiling import span

KINDS = ("cnn", "bf", "gf")


def _check_kind(kind: str) -> None:
    if kind not in KINDS:
        raise ValueError("unknown pipeline '{}'".format(kind))


class FlagshipModule(torch.nn.Module):
    """The ``kind`` pipeline as a module: the flat weights of
    ``ops.cnn_kernel.pack_weights`` are a buffer (they name the device,
    and ``torch.export`` saves them into the artifact)."""

    def __init__(self, kind: str, weights: torch.Tensor):
        super().__init__()
        _check_kind(kind)
        self.kind = kind
        self.register_buffer("weights", weights)

    def forward(self, img_bgr_u8_planar: torch.Tensor) -> torch.Tensor:
        with span("serve.forward"):
            with span("serve.cnn"):
                r = decompose_planar(self.weights, img_bgr_u8_planar)
            if self.kind == "cnn":
                return r
            with span("serve.filter"):
                # the -r.png byte path: floor(r*255) (a sigmoid < 1 never
                # triggers imwrite's percentile normalize)
                r_u8 = torch.floor(r * 255.0)
                if self.kind == "bf":
                    # as uint8 levels (exact: they lie in 0-254), K2's
                    # table form
                    q = bilateral_gray_self(r_u8.to(torch.uint8), -1, 20.0,
                                            22.0, reps=3)
                else:
                    # guidance = the original photo (RGB planar, 0-255)
                    guide = img_bgr_u8_planar.to(r_u8.device).flip(1).to(
                        torch.float32)
                    q = guided_filter_planar(guide, r_u8[:, None], 45,
                                             3.0)[:, 0]
            with span("serve.round"):
                return torch.clamp(torch.round(q), 0.0, 255.0)


def pipeline_fn(kind: str, net: ReflectanceNet, device) -> FlagshipModule:
    """Serving callable for ``kind`` in {"cnn", "bf", "gf"}; ``net``'s
    weights are packed onto ``device`` once, here."""
    return FlagshipModule(kind, pack_weights(net).to(torch.device(device)))


def export_flagship(path: str, batch: int, height: int, width: int,
                    device="cuda", pipeline: str = "cnn",
                    symbolic: bool = False, weights_path: str = None,
                    params=None) -> int:
    """Serialize a flagship pipeline to ``path`` (``torch.export.save``);
    returns the artifact's size in bytes.  Input: uint8 [batch, 3, height,
    width] planar BGR on ``device``.  pipeline: 'cnn' (reflectance map),
    'bf' (BF(CNN,CNN) c20 s22) or 'gf' (GF(CNN, image) r45 e3).  Weights,
    as ``cli.decompose.ReflectanceCNN`` takes them: the caffemodel at
    ``weights_path`` (default: the trained model's place,
    ``models.caffe_io.REFERENCE_CAFFEMODEL``) or ``params`` in the
    converter's numpy layout.

    ``device`` defaults to the card; without a GPU, "cuda" raises
    RuntimeError (never a CPU artifact in its place).  The artifact runs
    on the device it was exported on.

    symbolic=True exports ONE any-shape artifact (batch, height and width
    symbolic; ``batch``, ``height`` and ``width`` are not read), for
    pipeline='cnn' only, as the JAX package's export allows: the filtered
    pipelines are served per shape."""
    device = _build.target_device(device)
    _check_kind(pipeline)
    if symbolic and pipeline != "cnn":
        raise ValueError("symbolic export supports pipeline='cnn' "
                         "only (the filtered pipelines are exported per "
                         "shape)")
    weights = ReflectanceCNN(weights_path, params, device=device).weights
    module = FlagshipModule(pipeline, weights)
    if symbolic:
        # the example's sizes are above 1, as export's tracing requires;
        # the K1 operator checks the batch against the kernel's grid
        # limit when it runs
        example = torch.zeros((2, 3, 16, 16), dtype=torch.uint8,
                              device=device)
        dims = {0: torch.export.Dim("b"), 2: torch.export.Dim("h"),
                3: torch.export.Dim("w")}
        dynamic_shapes = {"img_bgr_u8_planar": dims}
    else:
        example = torch.zeros((batch, 3, height, width), dtype=torch.uint8,
                              device=device)
        dynamic_shapes = None
    with torch.no_grad():
        program = torch.export.export(module, (example,),
                                      dynamic_shapes=dynamic_shapes)
    # not saved: the example batch (zeros), 6.3 MB at 32 x 256x256
    program.example_inputs = None
    torch.export.save(program, path)
    return os.path.getsize(path)


def load_flagship(path: str):
    """Deserialize an exported artifact -> callable (uint8 [B, 3, H, W]
    planar BGR on the artifact's device -> [B, H, W] float32).  The
    ``rf::`` operators it calls are registered by this module's
    imports."""
    return torch.export.load(path).module()


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Export the flagship reflectance forward as a "
                    "serving artifact (torch.export).")
    p.add_argument("--out", required=True)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--height", type=int, default=256)
    p.add_argument("--width", type=int, default=256)
    p.add_argument("--pipeline", default="cnn", choices=KINDS,
                   help="cnn = reflectance map; bf = BF(CNN,CNN) c20 "
                        "s22; gf = GF(CNN, image) r45 e3")
    p.add_argument("--symbolic", action="store_true",
                   help="one any-shape artifact (cnn only)")
    add_device_flag(p)
    args = p.parse_args(argv)
    device = resolve_device(p, args.device)
    n = export_flagship(args.out, args.batch, args.height, args.width,
                        device=device, pipeline=args.pipeline,
                        symbolic=args.symbolic)
    print("wrote", args.out, "({} bytes, device: {}, pipeline: {})"
          .format(n, device, args.pipeline))


if __name__ == "__main__":
    main()
