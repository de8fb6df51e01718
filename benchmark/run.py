"""Run one cell of the port's benchmark once:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout.  It measures reflectance_filtering_tpu_torch
on the CUDA devices of this machine (it exits nonzero, printing no result,
without as many as the cell asks for), checks what the timed path produced
against the plain reference, and prints the numbers compared beside their
limits as the last lines of standard error and one JSON object as the last
line of standard output: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer metrics), ``device``, with ``--trace 1`` ``breakdown``, and
``checks`` last.

The kernels build once into ``build/`` inside the checkout; the run points
Triton's and PyTorch's extension caches and Python's compiled modules
there too.
"""
import argparse
import json
import os
import sys
import time

_T0 = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _age_s() -> float:
    """Seconds since this process started (its start time in /proc, at the
    kernel's clock-tick resolution)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        return (time.clock_gettime(time.CLOCK_BOOTTIME)
                - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


def main(argv=None) -> int:
    started = _T0 - _age_s()
    p = argparse.ArgumentParser(description="Run one benchmark cell once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    for var, sub in (("TRITON_CACHE_DIR", "triton_cache"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = os.path.join(ROOT, "build", sub)
    # Python's compiled modules too, torch's among them where its own
    # directory is not writable: only a checkout's first run compiles them
    sys.pycache_prefix = os.path.join(ROOT, "build", "pycache")
    sys.path.insert(0, ROOT)
    import torch

    from benchmark import harness

    cell = harness.by_name(harness.manifest(ROOT)["workloads"],
                           args.workload, "workload")
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print("run.py: the cell needs {} CUDA device(s); this machine has "
              "{}".format(cell["chips"], torch.cuda.device_count()
                          if torch.cuda.is_available() else 0),
              file=sys.stderr)
        return 2
    result = harness.run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), torch.device("cuda", 0),
                              started)
    found = harness.forbidden_modules()
    if found:
        print("run.py: JAX or the JAX package was loaded: {}".format(
            ", ".join(found)), file=sys.stderr)
        return 3
    for name, check in result["checks"].items():
        print("check {}: {!r} (limit {!r})".format(name, check["value"],
                                                  check["limit"]),
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
