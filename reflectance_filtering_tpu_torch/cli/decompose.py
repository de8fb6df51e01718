"""Intrinsic image decomposition with the reflectance CNN (port of
reflectance_filtering_tpu/cli/decompose.py).

Same flags (--filename_in, --path_out) plus --device, the same output
names ({base}-r.png linear, {base}-r_colorized.png / {base}-s_colorized.png
in sRGB) and the same pipeline quirks (colorize on the RAW uint8 BGR
image; percentile-normalized write).  Every forward, single image or
batch, is the planar uint8 -> float -> BGR flip -> K1 (sRGB gamma fused)
path of ``decompose_planar``; on the CPU K1's wrapper runs its plain
version.

  python -m reflectance_filtering_tpu_torch.cli.decompose \\
      --filename_in photo.png --path_out out/ [--device cpu] \\
      [--profile_dir trace/]

``--profile_dir`` writes a torch.profiler trace (Chrome format) of the
decomposition (``utils/profiling.py::device_trace``).
"""
from __future__ import annotations

import argparse
import contextlib
import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..models.caffe_io import load_reference_weights
from ..models.networks import ReflectanceNet, params_from_numpy
from ..ops.cnn_kernel import pack_weights, reflectance_cnn
from ..utils import image as iu
from . import add_device_flag, resolve_device


def decompose_planar(weights: torch.Tensor,
                     img_bgr_u8_planar: torch.Tensor) -> torch.Tensor:
    """uint8 BGR [B, 3, H, W] -> reflectance intensity [B, H, W] through
    K1, on the device of ``weights`` (the flat vector of
    ``ops.cnn_kernel.pack_weights``)."""
    b, c, h, w = img_bgr_u8_planar.shape
    x = img_bgr_u8_planar.to(weights.device).flip(1)  # BGR -> RGB
    x = x.to(torch.float32) / 255.0
    return reflectance_cnn(x.reshape(b, c, h * w), weights,
                           srgb_input=True).reshape(b, h, w)


class ReflectanceCNN:
    """The loaded model on one device; callable on images of any size.

    Weights come from a caffemodel (``weights_path``, default the trained
    model's place in the repository, see ``caffe_io.REFERENCE_CAFFEMODEL``)
    or directly as ``params`` in the converter's numpy layout (e.g.
    ``networks.seeded_reference_params``)."""

    def __init__(self, weights_path: Optional[str] = None,
                 params: Optional[Dict] = None, device="cuda"):
        if params is None:
            params = load_reference_weights(weights_path)
        self.device = torch.device(device)
        self.net = ReflectanceNet()
        self.net.load_state_dict(params_from_numpy(params))
        self.net.to(self.device)
        self.weights = pack_weights(self.net)

    def reflectance_planar(self, img_bgr_u8_planar) -> torch.Tensor:
        """uint8 BGR [B, 3, H, W] -> reflectance [B, H, W] on the device."""
        return decompose_planar(self.weights,
                                torch.as_tensor(img_bgr_u8_planar))

    def reflectance_intensity(self, img_bgr_u8: np.ndarray) -> np.ndarray:
        """uint8 BGR HWC -> linear reflectance intensity HW in (0,1)."""
        planar = torch.from_numpy(
            np.ascontiguousarray(np.moveaxis(img_bgr_u8, -1, 0))[None])
        return self.reflectance_planar(planar)[0].cpu().numpy()


def _write_outputs(path_out: str, basename: str, gray: np.ndarray,
                   image_bgr_u8: np.ndarray) -> None:
    """The three-output contract: -r.png linear, -r_colorized and
    -s_colorized sRGB — colorize works on the RAW uint8 input image
    (reference quirk)."""
    iu.imwrite(os.path.join(path_out, basename + "-r.png"), gray)
    reflectance, shading = iu.colorize(gray, image_bgr_u8)
    iu.imwrite(os.path.join(path_out, basename + "-r_colorized.png"),
               reflectance, sRGB=True)
    iu.imwrite(os.path.join(path_out, basename + "-s_colorized.png"),
               shading, sRGB=True)


def decompose_image(filename_in: str, path_out: str,
                    net: Optional[ReflectanceCNN] = None) -> np.ndarray:
    """Reference-compatible single-image decompose."""
    if net is None:
        net = ReflectanceCNN()
    image = iu.imread(filename_in)
    basename = os.path.splitext(os.path.basename(filename_in))[0]
    reflectance_gray = net.reflectance_intensity(image)
    _write_outputs(path_out, basename, reflectance_gray, image)
    return reflectance_gray


def decompose_images(filenames: Sequence[str], path_out: str,
                     net: Optional[ReflectanceCNN] = None,
                     batch_size: int = 16) -> Dict[str, np.ndarray]:
    """Batched multi-image mode: images are read through the native
    thread-pool decoder (``data/native_loader.read_images_rgb``: a header
    probe, one batch decode per same-size group, bit-exact against cv2 for
    PNG; a file nothing can read is reported and skipped), grouped by
    (H, W), and each group runs through K1 in planar batches of
    ``batch_size``."""
    from ..data.native_loader import read_images_rgb

    if net is None:
        net = ReflectanceCNN()
    items, failed = read_images_rgb(filenames)
    for fn in failed:
        print("Decomposing file", fn, "was not possible")
    groups: Dict = {}
    for fn, rgb in items:
        # the decoder gives RGB; the pipeline's contract is cv2's BGR
        img = np.ascontiguousarray(rgb[:, :, ::-1])
        groups.setdefault(img.shape, []).append((fn, img))
    out = {}
    for items in groups.values():
        for s in range(0, len(items), batch_size):
            chunk = items[s:s + batch_size]
            planar = np.ascontiguousarray(
                np.moveaxis(np.stack([im for _, im in chunk]), -1, 1))
            grays = net.reflectance_planar(torch.from_numpy(planar))
            for (fn, img), gray in zip(chunk, grays.cpu().numpy()):
                basename = os.path.splitext(os.path.basename(fn))[0]
                _write_outputs(path_out, basename, gray, img)
                out[fn] = gray
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="""Decompose an image with the direct reflectance
                       prediction CNN.""")
    parser.add_argument("--filename_in",
                        help="""Filename of the image which should be
                                decomposed.""")
    parser.add_argument("--path_out",
                        help="""Where the resulting decompositions should be
                                saved.""")
    parser.add_argument("--profile_dir", default=None,
                        help="""Write a torch.profiler trace (Chrome
                                format) of the decomposition here.""")
    add_device_flag(parser)
    args = parser.parse_args(argv)
    if args.filename_in and args.path_out:
        device = resolve_device(parser, args.device)
        net = ReflectanceCNN(device=device)
        trace = contextlib.nullcontext()
        if args.profile_dir:
            from ..utils.profiling import device_trace
            trace = device_trace(args.profile_dir)
        with trace:
            decompose_image(args.filename_in, args.path_out, net)
    else:
        parser.print_help()


if __name__ == "__main__":
    main()
