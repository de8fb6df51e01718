"""Command-line entry points (decompose, filter)."""
from __future__ import annotations

import argparse

import torch


def add_device_flag(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--device", default="cuda",
                        help="""torch device to run on (default: cuda);
                                --device cpu runs the plain PyTorch
                                versions of the kernels.""")


def resolve_device(parser: argparse.ArgumentParser,
                   name: str) -> torch.device:
    """The ``--device`` flag as a torch.device; exits with a usage error
    (never a quiet drop to the CPU) when CUDA is asked for and absent."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        parser.error("--device {}: CUDA is not available here; pass "
                     "--device cpu to run on the CPU".format(name))
    return device
