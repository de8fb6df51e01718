"""Reflectance filtering CLI (port of reflectance_filtering_tpu/cli/
filter.py).

Same flags (--filename_in --guidance_in --path_out --sigma_color
--sigma_spatial --filter_type --subsample --grid_ss --grid_sr) plus
--device, the same parameter semantics (bilateral: d=-1/sigmaColor/
sigmaSpace; guided: radius=int(sigma_spatial), eps=sigma_color), the same
output naming ``{base}_{type}_c{sc}s{ss}.png`` (``_guided_sub{n}_...`` for
the ``--subsample`` fast mode, ``_bilateral_grid_...`` for the grid) and
the same no-args help with suggested parameter combinations.  Filtering
happens in uint8 0-255 space, as in the reference.

Filter types: ``bilateral``, for every pairing of input and guidance (the
-r.png by itself, a color photo by itself as cv2.bilateralFilter, the
-r.png guided by the photo, gray or color either way), each on a CUDA
kernel (K2 or K6) on ``--device cuda``; ``guided`` (exact, and
``--subsample N``, the Fast Guided Filter); and ``bilateral_grid``, the
approximate grid bilateral (``--grid_ss``, ``--grid_sr``; plain torch ops
on the device), which prints its caveat to stderr.

  python -m reflectance_filtering_tpu_torch.cli.filter \\
      --filter_type=bilateral --sigma_color=20 --sigma_spatial=22 \\
      --filename_in out/photo-r.png --guidance_in out/photo-r.png \\
      --path_out out/ [--device cpu]
"""
from __future__ import annotations

import argparse
import os
import sys

from ..ops._build import target_device
from ..ops.bilateral import joint_bilateral_filter_u8
from ..ops.guided import fast_guided_filter_u8, guided_filter_u8
from ..utils import image as iu
from . import add_device_flag, resolve_device

_GRID_CAVEAT = (
    "bilateral_grid is an APPROXIMATE speed mode (bilateral-grid splat/"
    "blur/slice): ~0.4 uint8 levels mean / ~2 levels p99 vs the exact "
    "filter at the default cells; use --filter_type=bilateral for the "
    "reference-parity output.")

_SUBSAMPLE_CAVEAT = (
    "--subsample>1 runs the Fast Guided Filter (He & Sun 2015) — an "
    "APPROXIMATE speed mode, typically <1 uint8 level mean error at "
    "subsample=4; drop --subsample for the reference-parity output.")


def apply_filter(filter_type, image, joint, sigma_color, sigma_spatial,
                 subsample: int = 1, grid_ss=None, grid_sr=None,
                 device="cuda"):
    """Apply the joint-bilateral or guided filter on ``device`` (the card
    unless the caller asks for the CPU).

    Beyond the reference surface (opt-in speed modes):
    filter_type='bilateral_grid' runs the approximate grid bilateral
    (ops/bilateral_grid.py; grid_ss/grid_sr tune the cells), and
    subsample > 1 with filter_type='guided' runs the Fast Guided Filter."""
    device = target_device(device)
    if (sigma_color is None or sigma_spatial is None
            or sigma_color <= 0 or sigma_spatial <= 0):
        raise ValueError("Parameters are expected to be positive.")
    if filter_type == "bilateral":
        return joint_bilateral_filter_u8(joint, image, d=-1,
                                         sigma_color=sigma_color,
                                         sigma_space=sigma_spatial,
                                         device=device)
    elif filter_type == "bilateral_grid":
        from ..ops.bilateral_grid import bilateral_grid_u8
        print(_GRID_CAVEAT, file=sys.stderr)
        return bilateral_grid_u8(joint, image, sigma_color=sigma_color,
                                 sigma_space=sigma_spatial, ss=grid_ss,
                                 sr=grid_sr, device=device)
    elif filter_type == "guided":
        if subsample and subsample > 1:
            print(_SUBSAMPLE_CAVEAT, file=sys.stderr)
            return fast_guided_filter_u8(joint, image,
                                         radius=int(sigma_spatial),
                                         eps=sigma_color,
                                         subsample=subsample, device=device)
        return guided_filter_u8(joint, image, radius=int(sigma_spatial),
                                eps=sigma_color, device=device)
    raise ValueError("filter_type must be 'bilateral', 'guided' or "
                     "'bilateral_grid'.")


def read_filter_write(filter_type, filename_in, guidance_in,
                      sigma_color, sigma_spatial, path_out,
                      subsample: int = 1, grid_ss=None, grid_sr=None,
                      device="cuda"):
    """Read input + guidance, filter on ``device`` (the card unless the
    caller asks for the CPU), write with the reference's naming; the opt-in
    speed modes get distinct names (``_bilateral_grid_...``,
    ``_guided_sub{n}_...``) so they can never be mistaken for (or
    overwrite) a parity output."""
    device = target_device(device)
    basename = os.path.splitext(os.path.basename(filename_in))[0]
    image = iu.imread(filename_in)
    joint = iu.imread(guidance_in)

    filtered = apply_filter(filter_type, image, joint,
                            sigma_color, sigma_spatial,
                            subsample=subsample, grid_ss=grid_ss,
                            grid_sr=grid_sr, device=device)

    name_type = filter_type
    if filter_type == "guided" and subsample and subsample > 1:
        name_type = "guided_sub{}".format(subsample)
    params = "_{}_c{}s{}".format(name_type, sigma_color, sigma_spatial)
    filename = os.path.join(path_out, basename + params + ".png")
    iu.imwrite(filename, filtered)
    return filtered


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="""Filter reflectance prediction with a bilateral/guided
                       filter, to enhance piecewise constant reflectance
                       prior.""")
    parser.add_argument("--filename_in",
                        help="""Filename of the image which should be
                                filtered.""")
    parser.add_argument("--guidance_in",
                        help="""Filename of the guidance image which should be
                                used for filtering.""")
    parser.add_argument("--path_out",
                        help="""Where the resulting decompositions should be
                                saved.""")
    parser.add_argument("--sigma_color", type=float,
                        help="color parameter")
    parser.add_argument("--sigma_spatial", type=float,
                        help="spatial parameter")
    parser.add_argument("--filter_type",
                        help="""Which filter to choose,
                                the guided filter (guided) or
                                the joint bilateral filter (bilateral;
                                any gray or color input and guidance).
                                bilateral_grid selects the approximate
                                grid bilateral (opt-in fast mode, a few
                                uint8 levels of error).""")
    parser.add_argument("--subsample", type=int, default=1,
                        help="""guided only: >1 runs the Fast Guided
                                Filter (He & Sun 2015) with coefficients
                                computed at 1/subsample resolution —
                                opt-in approximate fast mode.""")
    parser.add_argument("--grid_ss", type=int, default=None,
                        help="""bilateral_grid only: spatial cell size in
                                pixels (default ~sigma_spatial/3).""")
    parser.add_argument("--grid_sr", type=int, default=None,
                        help="""bilateral_grid only: range cell size in
                                intensity levels (default
                                ~1.2*sigma_color).""")
    add_device_flag(parser)
    args = parser.parse_args(argv)
    effective_argv = argv if argv is not None else sys.argv[1:]
    if len(effective_argv) > 0:
        device = resolve_device(parser, args.device)
        read_filter_write(args.filter_type,
                          args.filename_in, args.guidance_in,
                          args.sigma_color, args.sigma_spatial,
                          args.path_out, subsample=args.subsample,
                          grid_ss=args.grid_ss, grid_sr=args.grid_sr,
                          device=device)
    else:
        parser.print_help()
        print("If you do not have any idea what parameters to choose, " +
              "try one of the following combinations:")
        print("--filter_type=bilateral --sigma_color=20 --sigma_spatial=22")
        print("--filter_type=guided --sigma_color=7 --sigma_spatial=52")
        print("--filter_type=guided --sigma_color=3 --sigma_spatial=45")


if __name__ == "__main__":
    main()
