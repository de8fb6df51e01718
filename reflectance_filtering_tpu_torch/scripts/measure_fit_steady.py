"""fit()'s steady-state time per training step on the card, the whole loop
(batches, the step, the metrics' copies and the host fan-out), at the JAX
bench's training shape: the flagship, Adam, batch 20 of 256x256, K = 1181
(the port of scripts/measure_fit_steady.py).

    python -m reflectance_filtering_tpu_torch.scripts.measure_fit_steady \
        [--seed N] [--compare LABEL]

A set of N seeded images trains STEPS steps a run, in turns (resident,
host-fed, host-fed, resident, over ROUNDS pairs; medians):

* resident: the set fits DEVICE_FEED_BUDGET_BYTES, so fit takes its chunked
  trainer (TRAIN_CHUNK_STEPS steps a chunk, each step a replay of one
  captured CUDA graph, one host wait a chunk);
* host-fed: DEVICE_FEED_BUDGET_BYTES = 0, the per-step trainer (each batch
  copied from the host, each step dispatched eagerly).

A run's ms per step is the host clock's slope over the progress callbacks
from the last step of the second chunk (SKIP_STEPS: the warm-up steps and
the capture are behind it) to the last step; both trainers stamp a step
when its metrics reach the host, after the card ran it.  Beside them, the
host's ms to issue one step with the card idle: an eager
``make_train_step`` call, and one replay of ``make_train_chunk``'s graph
(a chunk of TRAIN_CHUNK_STEPS replays over its length).

``--compare LABEL`` prints one JSON line of the two fits' ms per step
alone, through ``fit`` only, so that the script runs in an older tree too:
copy it into an unpacked parent (git archive) and run it there and here in
turns (parent, change, change, parent) in one call.

Needs a CUDA device: without one it exits nonzero.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from typing import Dict

import numpy as np
import torch

from ..models.networks import NetworkConfig, init_network
from ..train import loop
from ..utils.testimages import make_synthetic_comps

N, H, W, K, B = 120, 256, 256, 1181, 20
STEPS, SKIP_STEPS, ROUNDS, HOST_REPS = 320, 64, 2, 20


def make_set(seed: int) -> Dict[str, np.ndarray]:
    """N seeded images in [0, 1) and K synthetic comparisons each, in the
    loader's NHWC layout."""
    rng = np.random.RandomState(seed)
    return {"images": rng.rand(N, H, W, 3).astype(np.float32),
            "comparisons": make_synthetic_comps(seed + 1, K, batch=N)}


def fit_ms_per_step(device, data, host_fed: bool, seed: int) -> float:
    """One fit of STEPS steps on ``device``; its steady ms per step."""
    stamps = []
    budget = loop.DEVICE_FEED_BUDGET_BYTES
    if host_fed:
        loop.DEVICE_FEED_BUDGET_BYTES = 0
    try:
        loop.fit(NetworkConfig(), loop.LossConfig(), data, STEPS * B, B,
                 random_seed=seed, device=device,
                 progress=lambda s, n, m: stamps.append(
                     (time.perf_counter(), s)))
    finally:
        loop.DEVICE_FEED_BUDGET_BYTES = budget
    (t_a, s_a), (t_b, s_b) = stamps[SKIP_STEPS - 1], stamps[-1]
    return (t_b - t_a) / (s_b - s_a) * 1e3


def compare(device, seed: int = 0) -> Dict[str, float]:
    """{"resident": ms, "host-fed": ms} per step, medians of the turns."""
    data = make_set(seed)
    times = {"resident": [], "host-fed": []}
    for r in range(ROUNDS):
        order = [False, True] if r % 2 == 0 else [True, False]
        for host_fed in order:
            times["host-fed" if host_fed else "resident"].append(
                fit_ms_per_step(device, data, host_fed, seed))
    return {name: statistics.median(ms) for name, ms in times.items()}


def host_issue_ms(device, data, seed: int) -> Dict[str, float]:
    """Host ms to issue one step, the card idle at the start (medians of
    HOST_REPS): {"eager step": ms, "replayed step": ms}."""
    cfg, lcfg = NetworkConfig(), loop.LossConfig()
    sets = [torch.from_numpy(np.concatenate([a, a[:B - 1]])).to(device)
            for a in (data["images"], data["comparisons"])]
    init = init_network(cfg, torch.Generator().manual_seed(seed))
    pa, pb = loop.trainable(init, device), loop.trainable(init, device)
    step = loop.make_train_step(cfg, lcfg, pa,
                                loop.make_optimizer("ADAM", 1e-3, pa))
    chunk = loop.make_train_chunk(cfg, lcfg, pb, loop.make_optimizer(
        "ADAM", 1e-3, pb), sets[0], sets[1], sets[1], B)

    def issue(fn) -> float:
        fn()       # the eager step's first call; the chunk's warm-up, capture
        out = []
        for _ in range(HOST_REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            out.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        return statistics.median(out) * 1e3

    return {"eager step": issue(lambda: step(sets[0][:B], sets[1][:B])),
            "replayed step": issue(lambda: chunk(
                0, 0, loop.TRAIN_CHUNK_STEPS)) / loop.TRAIN_CHUNK_STEPS}


def measure(device, seed: int = 0) -> Dict[str, Dict[str, float]]:
    """{"fit": compare(...), "issue": host_issue_ms(...)}."""
    return {"fit": compare(device, seed),
            "issue": host_issue_ms(device, make_set(seed), seed)}


def card() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def print_table(result: Dict[str, Dict[str, float]]) -> None:
    fit, issue = result["fit"], result["issue"]
    print("fit steady state, {} x {}x{}, K={}, {} steps a run ({}, "
          "medians of {} turns each):".format(B, H, W, K, STEPS, card(),
                                              ROUNDS))
    for name, what in (("resident", "chunked, graph replays"),
                       ("host-fed", "per-step, batches from the host")):
        print("  fit, {} set ({}): {:.4f} ms per step = {:.1f} "
              "images/s".format(name, what, fit[name], B / fit[name] * 1e3))
    print("  host ms to issue one step: eager {:.4f}, replayed {:.4f}".format(
        issue["eager step"], issue["replayed step"]))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--compare", metavar="LABEL")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("measure_fit_steady: needs a CUDA device (it times the "
                 "trainer on the card; there is no CPU version)")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    if args.compare:
        print(json.dumps({"tree": args.compare, "device": card(),
                          "ms per step": compare(dev, args.seed)}))
        return 0
    print_table(measure(dev, args.seed))
    return 0


if __name__ == "__main__":
    sys.exit(main())
