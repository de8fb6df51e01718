"""Experiment description strings — config-in-filename encode/decode.

A copy of reflectance_filtering_tpu/train/description.py (pure Python):
the port keeps its own so that it never imports the JAX package.

The reference encodes the full hyperparameter set into checkpoint filenames
(train_with_barrista_helper.py:80-118) and *parses it back* in predict mode
(helper:369-392).  Both directions are preserved here so checkpoints remain
self-describing, e.g.:

  convStaticSkipLayers_n5_f32_k1_d1_bn0_rDirectly_wdm0.1_0.05_1.0_1_
  loss[w1.0E+01,l0]_ADAM0.001_comparisons_h256w256iiw
"""
from __future__ import annotations

import re
from typing import Tuple

import numpy as np


def _loss_format(l) -> str:
    """helper:92-103 — scientific format, or raw python repr for tiny/zero."""
    if l:
        form = "{:.1E},"
        formatted = form.format(l)
        if formatted != form.format(0):
            return formatted
        return str(l)  # significant digits lost in .1E -> python notation
    return "0,"


def get_description(args) -> Tuple[str, str]:
    """(net_params, description) for a config namespace (helper:80-118)."""
    net_params = (args.networkType + "_" +
                  "n" + str(args.numLayers) + "_" +
                  "f" + str(2 ** args.num_filters_log) + "_" +
                  "k" + str(2 * args.kernel_pad + 1) + "_" +
                  "d" + str(args.dilation) + "_" +
                  "bn" + str(int(args.use_batch_normalization)) + "_" +
                  args.RS_est_mode + "_" +
                  "wdm" + args.whdr_delta_margin_ratio_dense)

    losses = ("loss[" +
              "w" + _loss_format(args.loss_scale_whdr) +
              "l" + _loss_format(args.loss_scale_lambert))
    losses = losses[:-1] + "]"

    data_params = ("h" + str(args.height) + "w" + str(args.width) +
                   args.dataset)

    description = (net_params + "_" +
                   losses + "_" +
                   args.solverType + str(args.base_lr) + "_" +
                   args.comparisonsType + "_" +
                   data_params)
    return net_params, description


def parse_description(checkpoint_name: str):
    """Recover hyperparameters from a checkpoint filename (helper:369-392).

    Accepts '<description>_barrista_iter_<N>.<ext>' (any extension).
    Returns a dict with the fields predict mode needs.

    Beyond the reference's parse (network fields only), this also
    recovers the solver, comparisons type and the data params
    (height/width/dataset) — they are in the filename, and without them
    a predict-and-score run loads val data at the CLI default
    resolution and fails (or scores the wrong split) whenever the
    checkpoint was trained at another size.  Found by the round-5
    on-chip fit->predict drive at h32w32.
    """
    base = checkpoint_name
    # strip the extension only when the last dot follows the last
    # underscore (i.e. it sits in the '..._iter_<N>.<ext>' tail) — a
    # name passed WITHOUT an extension contains dots inside the lr
    # digits ('ADAM0.001') and rfind('.') would truncate mid-field
    if "." in base and base.rfind(".") > base.rfind("_"):
        base = base[:base.rfind(".")]
    desc_split = base.split("_")
    out = {
        "networkType": desc_split[0],
        "numLayers": int(desc_split[1][1:]),
        "num_filters_log": int(np.log2(int(desc_split[2][1:]))),
        "kernel_pad": int((int(desc_split[3][1:]) - 1) / 2),
        "dilation": int(desc_split[4][1:]),
        "use_batch_normalization": int(desc_split[5][2:]),
        "RS_est_mode": desc_split[6],
        "whdr_delta_margin_ratio_dense": (desc_split[7][3:] + "_" +
                                          desc_split[8] + "_" +
                                          desc_split[9] + "_" +
                                          desc_split[10]),
        "iterations": int(desc_split[-1]),
    }
    # tail layout (get_description): ..._<SOLVER><lr>_<comparisonsType>_
    # h<H>w<W><dataset>_barrista_iter_<N>
    m = re.match(r"^h(\d+)w(\d+)(.+)$", desc_split[-4])
    if m:
        out["height"] = int(m.group(1))
        out["width"] = int(m.group(2))
        out["dataset"] = m.group(3)
    out["comparisonsType"] = desc_split[-5]
    ms = re.match(r"^([A-Z]+)([0-9.eE+-]+)$", desc_split[-6])
    if ms:
        out["solverType"] = ms.group(1)
        out["base_lr"] = float(ms.group(2))
    return out
