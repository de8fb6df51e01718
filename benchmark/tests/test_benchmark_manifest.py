"""BENCHMARK.json against the benchmark's contract, and the layout that
finds every configuration, traffic mix, cell and metric by name."""
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from benchmark import harness

ROOT = harness.ROOT
SPEC = harness.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source"},
        "per_layer": {"name", "unit", "better", "source", "layer",
                      "moves"}}


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert SPEC["paths"] == ["benchmark"]
    assert isinstance(SPEC["run_seconds"], int)
    assert 1 <= SPEC["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 65536


@pytest.mark.parametrize("kind", sorted(KEYS))
def test_entries_keys_names_and_units(kind):
    names = [e["name"] for e in SPEC[kind]]
    assert len(names) == len(set(names))
    for e in SPEC[kind]:
        extra = {"workloads"} if kind in ("end_to_end", "per_layer") else set()
        assert KEYS[kind] <= set(e) <= KEYS[kind] | extra, e["name"]
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
            assert e["source"] in ("device_trace", "program_span",
                                   "program_counter", "host_clock")
        for key in ("why", "layer", "source"):
            if key in e and kind != "end_to_end" and kind != "per_layer":
                assert _line(e[key]), (e["name"], key)
        if kind == "per_layer":
            assert _line(e["layer"])
        if kind == "configs":
            assert all(NAME.match(k) for k in e["reduced"])
            assert len(e["reduced"]) <= 16


def test_metric_names_are_unique_across_kinds():
    names = [m["name"] for kind in ("end_to_end", "per_layer")
             for m in SPEC[kind]]
    assert len(names) == len(set(names))


def test_end_to_end_bounds_and_sources():
    names = {m["name"] for m in SPEC["end_to_end"]}
    assert "setup_s" in names
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert harness.by_name(SPEC["end_to_end"], "setup_s",
                           "metric")["bound"] == 0.25


def test_each_per_layer_metric_moves_one_metric_its_cells_report():
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    cells = {w["name"] for w in SPEC["workloads"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        for cell in m.get("workloads", cells):
            assert cell in cells
            reported = {x["name"] for x in harness.cell_metrics(
                SPEC, cell, "end_to_end")}
            assert m["moves"] in reported, (m["name"], cell)


def test_each_cell_reports_enough_and_each_config_keeps_a_cell():
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in SPEC["workloads"]:
        assert w["chips"] in (1, 4) and _line(w["why"])
        e2e = {m["name"] for m in harness.cell_metrics(SPEC, w["name"],
                                                       "end_to_end")}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert harness.cell_metrics(SPEC, w["name"], "per_layer")


def test_layer_names_and_metric_files_agree():
    used = set()
    for m in SPEC["per_layer"]:
        module = harness.load_metric(m["name"])
        assert module.LAYER == m["layer"], m["name"]
        used.add(os.path.basename(module.__file__))
    readers = {f for f in os.listdir(os.path.join(ROOT, "benchmark",
                                                  "metrics"))
               if f.endswith(".py") and not f.startswith("_")}
    assert readers == used


def test_metrics_of_one_kind_share_a_reader():
    """A cell's own name for a metric of a kind that has a reader needs no
    file: ``<kind>.<cell>`` is read by ``<kind>.py``."""
    for kind in ("idle_share", "mfu", "host_issue_ms", "k1_roofline"):
        got = harness.load_metric(kind + ".some_later_cell")
        assert os.path.basename(got.__file__) == kind + ".py"
    with pytest.raises(FileNotFoundError):
        harness.load_metric("no_such_kind.serve_bf")


def test_every_cell_file_exists_and_is_read():
    for w in SPEC["workloads"]:
        cell = harness.Cell.load(w["name"])
        assert cell.limits and cell.traffic["entry"]
        assert cell.entry().TRAFFIC
    for c in SPEC["configs"]:
        path = os.path.join(ROOT, c["file"])
        assert path.startswith(os.path.join(ROOT, "benchmark") + os.sep)
        assert harness.load_json(path)["reduced"] == c["reduced"]


def _traffic_entries():
    """entry -> the cells whose mix names it, for every mix in
    ``traffic/``."""
    out = {}
    for name in sorted(os.listdir(os.path.join(harness.BENCH_DIR,
                                               "traffic"))):
        if name.endswith(".json"):
            traffic = harness.load_json(os.path.join(harness.BENCH_DIR,
                                                     "traffic", name))
            out.setdefault(traffic["entry"], []).extend(
                w["name"] for w in SPEC["workloads"]
                if w["traffic"] == name[:-len(".json")])
    return out


@pytest.mark.parametrize("entry, cells", sorted(_traffic_entries().items()))
def test_each_entry_declares_its_faults_and_cpu_sizes(entry, cells):
    """What the tests need of an entry is in the entry's module: the
    faults its cells take, and the sizes they take on the CPU, each a key
    its traffic mixes and configurations have."""
    module = harness.load_entry(entry)
    assert module.FAULTS and all(callable(f) for f in module.FAULTS.values())
    assert set(module.CPU_SIZES) == {"traffic", "config"}
    assert module.CPU_SIZES["traffic"]
    assert set(module.CPU_SIZES["traffic"]) <= set(module.TRAFFIC)
    for name in cells:
        cell = harness.Cell.load(name)
        assert set(module.CPU_SIZES["traffic"]) <= set(cell.traffic)
        assert set(module.CPU_SIZES["config"]) <= set(cell.config)


@pytest.mark.parametrize("name", [w["name"] for w in SPEC["workloads"]])
def test_a_traffic_key_no_entry_reads_is_refused(name):
    """A mix that asks for something its entry does not do (another loop,
    more clients) never runs as the mix the entry implements."""
    cell = harness.Cell.load(name)
    cell.entry()
    cell.traffic["loop"] = "open"
    with pytest.raises(ValueError, match="loop"):
        cell.entry()
    with pytest.raises(ValueError, match="loop"):
        harness.run_cell(name, 1, 0.1, False, None, 0.0, cell=cell)


def test_paths_hold_only_the_benchmark_and_names_are_plain():
    for dirpath, dirs, files in os.walk(os.path.join(ROOT, "benchmark")):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for name in files + dirs:
            rel = os.path.relpath(os.path.join(dirpath, name), ROOT)
            assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", rel), rel


def test_run_refuses_without_a_card():
    """This machine has no CUDA device: the run prints no result and exits
    nonzero."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "serve_bf_b32",
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def _copy_benchmark(dest):
    shutil.copytree(os.path.join(ROOT, "benchmark"),
                    os.path.join(dest, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), dest)


def test_run_fails_with_only_the_benchmark(tmp_path):
    """In a directory holding only BENCHMARK.json and the benchmark's
    files, a run fails: the program is not there."""
    _copy_benchmark(str(tmp_path))
    code = ("import sys, torch; sys.path.insert(0, '.'); "
            "from benchmark import harness; "
            "harness.run_cell('serve_gf_b32', 1, 0.1, False, "
            "torch.device('cpu'), 0.0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "reflectance_filtering_tpu_torch" in proc.stderr


DUMMY_METRIC = '''"""A metric added as a file alone."""
LAYER = "serving"
MOVES = "serve_gf_images_per_s"


def read(run):
    return run.window["requests"] * 1.0
'''


def test_added_files_are_found_without_an_edit(tmp_path):
    """A configuration, a traffic mix, a cell and a metric added as files
    (and entries of BENCHMARK.json) run with no edit to existing code."""
    _copy_benchmark(str(tmp_path))
    bench = tmp_path / "benchmark"
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    config = json.loads((bench / "configs" / "flagship.json").read_text())
    config["name"] = "dummy_config"
    (bench / "configs" / "dummy_config.json").write_text(json.dumps(config))
    traffic = json.loads((bench / "traffic" / "gf_b32_closed.json")
                         .read_text())
    traffic.update(batch=2, height=24, width=32, pool=2, warmup=1, sample=2)
    (bench / "traffic" / "dummy_traffic.json").write_text(
        json.dumps(traffic))
    (bench / "workloads" / "dummy_cell.json").write_text(json.dumps(
        {"limits": {"level_mean_gap": 0.01, "whdr_gap": 1e-3}}))
    (bench / "metrics" / "dummy_metric.py").write_text(DUMMY_METRIC)
    spec["configs"].append({"name": "dummy_config", "source": "a test",
                            "file": "benchmark/configs/dummy_config.json",
                            "reduced": config["reduced"], "why": "a test"})
    spec["workloads"].append({"name": "dummy_cell", "config": "dummy_config",
                              "traffic": "dummy_traffic", "chips": 1,
                              "why": "a test"})
    for m in spec["end_to_end"]:
        if "workloads" in m and "serve_gf_b32" in m["workloads"]:
            m["workloads"].append("dummy_cell")
    spec["per_layer"].append({"name": "dummy_metric", "unit": "n",
                              "better": "higher", "source": "host_clock",
                              "layer": "serving",
                              "moves": "serve_gf_images_per_s",
                              "workloads": ["dummy_cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    code = """
import json, sys, torch
sys.path.insert(0, '.')
sys.path.append({root!r})
from benchmark import harness
cell = harness.Cell.load('dummy_cell', '.', 'benchmark')
out = harness.run_cell('dummy_cell', 5, 0.2, False, torch.device('cpu'),
                       0.0, cell=cell)
run = harness.Run(cell.config, cell.traffic, {{'requests': 3}})
value = harness.load_metric('dummy_metric', 'benchmark').read(run)
print(json.dumps({{'correct': out['correct'], 'metric': value,
                  'module': harness.__file__}}))
""".format(root=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["correct"] and got["metric"] == 3.0
    assert got["module"].startswith(str(tmp_path))
