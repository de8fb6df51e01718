"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program: top-level module names compared
whole (the port's name begins with the JAX package's)."""
import ast
import glob
import json
import os
import subprocess
import sys

from benchmark import harness

BENCH = harness.BENCH_DIR
FORBIDDEN = {"jax", "jaxlib", "flax", "reflectance_filtering_tpu"}
PROGRAM = "reflectance_filtering_tpu_torch"


def _sources():
    for dirpath, dirs, files in os.walk(BENCH):
        dirs[:] = [d for d in dirs if d not in ("__pycache__", "tests")]
        for name in files:
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)


def _top_level_imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_file_imports_jax_and_the_reference_not_the_program():
    for path in _sources():
        names = set(_top_level_imports(path))
        assert not names & FORBIDDEN, (path, names & FORBIDDEN)
        if os.sep + "reference" + os.sep in path:
            assert PROGRAM not in names, path


def test_loaded_modules_hold_no_jax():
    """Import the runner, every module of the benchmark, every entry that
    a traffic mix names and every module of the program that an entry
    uses, in a fresh process."""
    code = """
import glob, importlib, json, os, sys
sys.path.insert(0, {root!r})
import benchmark.run
from benchmark import harness
for path in glob.glob(os.path.join(harness.BENCH_DIR, "traffic", "*.json")):
    harness.load_entry(harness.load_json(path)["entry"])
for m in harness.manifest()["per_layer"]:
    harness.load_metric(m["name"])
import benchmark.calibrate, benchmark.faults
import reflectance_filtering_tpu_torch.utils.serving
import reflectance_filtering_tpu_torch.losses.whdr
import reflectance_filtering_tpu_torch.ops.guided
import reflectance_filtering_tpu_torch.train.loop
print(json.dumps(sorted(sys.modules)))
""".format(root=harness.ROOT)
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    loaded = json.loads(proc.stdout.strip().splitlines()[-1])
    tops = {name.split(".")[0] for name in loaded}
    assert not tops & FORBIDDEN, tops & FORBIDDEN
    entries = {"benchmark.entries." + harness.load_json(path)["entry"]
               for path in glob.glob(os.path.join(BENCH, "traffic",
                                                  "*.json"))}
    assert entries | {"benchmark.reference.train"} <= set(loaded)
    assert PROGRAM in tops
