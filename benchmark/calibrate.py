"""The readings that a cell's limits are set from, in one process:

    python3 benchmark/calibrate.py --workload <cell> --seeds 12 \\
        --first-seed <n> --seconds 2 --control 3 [--faults half,answer]

For each of ``--seeds`` seeds the program runs the cell's set-up and a
window of ``--seconds``, and its sampled outputs are compared with the
reference (the lower readings).  On the first ``--control`` seeds the
control (the reference one precision step lower, in the program's place)
is compared instead, on the same sampled requests (the upper readings);
each named fault, one of those the cell's entry declares (``FAULTS``,
``faults.py``), is planted under the timed path and read on the first
``--control`` seeds too.  Prints one JSON line a reading and a
summary: each number's largest program reading and smallest control and
fault readings.  The benchmark's own runs never run this.
"""
import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--first-seed", type=int, default=2 ** 31 + 1)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--faults", default="")
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from benchmark import faults, harness

    if not torch.cuda.is_available():
        print("calibrate.py: needs a CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = harness.Cell.load(args.workload)
    entry = cell.entry()
    planted = list(filter(None, args.faults.split(",")))
    unknown = [f for f in planted if f not in entry.FAULTS]
    if unknown:
        print("calibrate.py: entry '{}' takes no fault {}".format(
            cell.traffic["entry"], ", ".join(unknown)), file=sys.stderr)
        return 2
    seeds = [args.first_seed + 7919 * i for i in range(args.seeds)]
    table = {}

    def read(kind, seed, control=False):
        session = entry.Session(cell.config, cell.traffic, seed, device)
        session.window(args.seconds)
        got = session.release()
        del session
        outputs = got["outputs"]
        if control:
            outputs = entry.control_outputs(cell.config, cell.traffic,
                                            got["inputs"], outputs, device)
        readings = entry.judge(cell.config, cell.traffic, got["inputs"],
                               outputs, device)
        print(json.dumps({"kind": kind, "seed": seed, **readings}),
              flush=True)
        for k, v in readings.items():
            if isinstance(v, (int, float)):
                table.setdefault(kind, {}).setdefault(k, []).append(v)
        torch.cuda.empty_cache()

    for seed in seeds:
        read("program", seed)
    for seed in seeds[:args.control]:
        read("control", seed, control=True)
    for fault in planted:
        for seed in seeds[:args.control]:
            with faults.plant(cell.traffic["entry"], fault):
                read("fault:" + fault, seed)
    summary = {kind: {k: (max(v) if kind == "program" else min(v))
                      for k, v in numbers.items()}
               for kind, numbers in table.items()}
    print(json.dumps({"summary": summary, "card": torch.cuda.get_device_name(
        device)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
