"""The readers of the program's spans on a scripted run and scripted span
records: the median of the last ``len(run.calls)`` records of the span,
None where there are fewer, and an error from a program that records no
spans or whose profiling module fails to import."""
import types

import pytest

from benchmark import harness
from benchmark.metrics import _spans

READERS = {"forward_issue_ms.serve_bf": "serve.forward",
           "forward_issue_ms.serve_gf": "serve.forward",
           "whdr_issue_ms.serve_bf": "whdr.per_image",
           "whdr_issue_ms.serve_gf": "whdr.per_image",
           "chain_issue_ms": "guided.stats"}


def _record(name, ms):
    return types.SimpleNamespace(name=name, start_ns=10 ** 9,
                                 end_ns=10 ** 9 + int(ms * 1e6))


def _run(calls):
    return harness.Run({}, {}, {}, [object()] * calls if calls else None)


@pytest.fixture
def scripted(monkeypatch):
    """Make the program's spans the scripted records."""
    records = []
    monkeypatch.setattr(_spans, "program_spans", lambda name: [
        r for r in records if r.name == name])
    return records


@pytest.mark.parametrize("metric", sorted(READERS))
def test_reader_takes_the_median_of_the_traced_calls_records(metric,
                                                             scripted):
    span = READERS[metric]
    # lead calls' records first, then the 3 traced calls' (and another
    # span's, which the reader skips)
    scripted.extend(_record(span, ms) for ms in (90.0, 80.0, 2.0, 7.0, 3.0))
    scripted.append(_record("other.span", 50.0))
    reader = harness.load_metric(metric)
    assert reader.read(_run(3)) == pytest.approx(3.0)
    assert reader.read(_run(6)) is None          # fewer records than calls
    assert reader.read(_run(0)) is None          # no traced call


def test_readers_give_none_from_a_program_without_spans(monkeypatch):
    """No reader gives None for a program whose ``profiling`` has no
    ``spans``: the program has had them since the spans were added, so
    the reader fails, and the traced run with it."""
    from reflectance_filtering_tpu_torch.utils import profiling
    monkeypatch.delattr(profiling, "spans")
    for metric in READERS:
        with pytest.raises(AttributeError, match="spans"):
            harness.load_metric(metric).read(_run(2))


def test_readers_raise_where_the_programs_profiling_fails_to_import(
        monkeypatch):
    """A ``profiling`` module that cannot be imported fails the reader,
    and the traced run with it."""
    import importlib
    import sys
    from reflectance_filtering_tpu_torch import utils
    monkeypatch.delattr(utils, "profiling")
    monkeypatch.setitem(sys.modules,
                        "reflectance_filtering_tpu_torch.utils.profiling",
                        None)
    monkeypatch.delitem(sys.modules, "benchmark.metrics._spans")
    with pytest.raises(ImportError):
        importlib.import_module("benchmark.metrics._spans")
    with pytest.raises(ImportError):
        harness.load_metric("forward_issue_ms.serve_bf").read(_run(2))


def test_readers_read_the_programs_ring():
    """Spans recorded under a profiler session reach the readers."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from reflectance_filtering_tpu_torch.utils import profiling
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(2):
            with profiling.span("guided.stats"):
                torch.ones(4).sum()
    got = profiling.spans("guided.stats")[-2:]
    want = sorted(r.end_ns - r.start_ns for r in got)
    assert harness.load_metric("chain_issue_ms").read(_run(2)) == \
        pytest.approx(1e-6 * sum(want) / 2)
