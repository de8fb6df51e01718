"""utils/profiling.py on the CPU.

``profile_calls`` on a scripted profiler: each call's device events told
apart by the marker kernels on the card's timeline, the calls just before
the last kept, and a profile whose kept calls differ (lost records) taken
again with more lead calls, then refused.

The program's spans: recorded only under a profiler session, nested by
thread, bounded, on the profiler's clock; those of the served pipelines,
the guided chain and ``fit``; none in an exported graph; the device
trace's span track and its idle time by span."""
import collections
import contextlib
import json
import os
import threading
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from reflectance_filtering_tpu_torch.models.networks import (
    NetworkConfig, ReflectanceNet)
from reflectance_filtering_tpu_torch.utils import profiling
from reflectance_filtering_tpu_torch.utils.testimages import (
    make_synthetic_comps)

CUDA = torch.autograd.DeviceType.CUDA
CPU = torch.autograd.DeviceType.CPU


def _event(name, start, end, device=CUDA, annotation=False):
    return types.SimpleNamespace(
        name=name, device_type=device, is_user_annotation=annotation,
        time_range=types.SimpleNamespace(start=start, end=end))


def _call(t0, kernels=("flip", "k2")):
    """One call at t0: its marker and kernels on the card, a launch and a
    step annotation on the host, a user annotation on the card."""
    out = [_event("ProfilerStep*", t0, t0 + 100, CPU, True),
           _event("cudaLaunchKernel", t0 + 1, t0 + 2, CPU),
           _event("Optimizer.step#Adam.step", t0, t0 + 90, CUDA, True),
           _event("void at::cuda::(anonymous namespace)::spin_kernel(long)",
                  t0 + 3, t0 + 4)]
    out += [_event(name, t0 + 10 + 20 * i, t0 + 25 + 20 * i)
            for i, name in enumerate(kernels)]
    return out


def _profile(*calls):
    return [e for i, kernels in enumerate(calls)
            for e in _call(1000 * i, kernels)]


@pytest.fixture
def scripted(monkeypatch):
    """Make torch.profiler return the scripted event lists in turn."""
    profiles, made, launched = [], [], []

    class FakeProfile:
        def __init__(self, activities, schedule):
            made.append(schedule)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def step(self):
            pass

        def events(self):
            return profiles.pop(0)

    monkeypatch.setattr(torch.profiler, "profile", FakeProfile)
    monkeypatch.setattr(torch.profiler, "schedule", lambda **kw: kw)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(torch.cuda, "_sleep", launched.append)
    return profiles, made, launched


FULL = ("flip", "k2")


def test_profile_calls_tells_calls_apart_by_their_markers(scripted):
    profiles, made, launched = scripted
    profiles.append(_profile(FULL, FULL, FULL, FULL, FULL))
    calls = []
    per_call, events = profiling.profile_calls(lambda: calls.append(1), 2)
    lead, warmup = (profiling.PROFILE_LEAD_CALLS[0],
                    profiling.PROFILE_WARMUP_CALLS)
    assert len(calls) == len(launched) == warmup + lead + 2 + 1
    assert made == [dict(wait=0, warmup=warmup, active=lead + 3, repeat=1)]
    assert per_call == [[("flip", 2010, 2025), ("k2", 2030, 2045)],
                        [("flip", 3010, 3025), ("k2", 3030, 3045)]]
    assert len(events) == 30


def test_profile_calls_keeps_the_calls_before_the_last(scripted):
    """Records lost at the start of the profile (a partial call, calls
    with no marker left) and at its end do not count against it: the kept
    calls are those just before the last."""
    profiles, made, _ = scripted
    lost_start = [e for e in _profile(FULL, ("k2",), FULL, FULL, ())
                  if e.time_range.start >= 1010]
    profiles.append(lost_start)
    per_call, _ = profiling.profile_calls(lambda: None, 2)
    assert len(made) == 1 and [len(c) for c in per_call] == [2, 2]


def test_profile_calls_retakes_a_profile_short_of_records(scripted):
    """A profile whose kept calls differ is taken again with more lead
    calls; when every attempt is short, RuntimeError."""
    profiles, made, _ = scripted
    lossy = _profile(FULL, FULL, ("k2",), FULL, FULL)
    profiles.extend([lossy, _profile(FULL, FULL, FULL, FULL, FULL)])
    per_call, _ = profiling.profile_calls(lambda: None, 2)
    assert [m["active"] for m in made] == [
        lead + 3 for lead in profiling.PROFILE_LEAD_CALLS[:2]]
    assert [len(c) for c in per_call] == [2, 2]
    profiles.extend([lossy] * len(profiling.PROFILE_LEAD_CALLS))
    with pytest.raises(RuntimeError, match="lost device records"):
        profiling.profile_calls(lambda: None, 2)
    assert not profiles

# µs a span's ends may lie from the first and last op it encloses
SPAN_SLACK_US = 50.0


@pytest.fixture
def ring():
    """The span ring, empty before and after the test."""
    profiling._RING.clear()
    yield profiling._RING
    profiling._RING.clear()


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def test_spans_record_nothing_without_a_profiler(ring):
    with profiling.span("outer") as s:
        with profiling.span("inner"):
            torch.ones(4).sum()
    assert s.seconds > 0 and s.name == "outer"
    assert profiling.spans() == []


def test_nested_spans_record_parent_and_trace(ring):
    seen = {}

    def other_thread():
        with profiling.span("thread.root"):
            pass
        seen["id"] = threading.get_native_id()

    with _cpu_profile():
        with profiling.span("a"):
            with profiling.span("a.b"):
                with profiling.span("a.b.c"):
                    pass
                worker = threading.Thread(target=other_thread)
                worker.start()
                worker.join(timeout=30)
            with profiling.span("a.d"):
                pass
        with profiling.span("e"):
            pass
    assert not worker.is_alive()
    got = {r.name: r for r in profiling.spans()}
    assert [r.name for r in profiling.spans()] == [
        "a.b.c", "thread.root", "a.b", "a.d", "a", "e"]
    a = got["a"]
    assert a.parent is None and a.trace == a.id
    assert got["a.b"].parent == a.id and got["a.d"].parent == a.id
    assert got["a.b.c"].parent == got["a.b"].id
    assert {got[n].trace for n in ("a.b", "a.b.c", "a.d")} == {a.id}
    root = got["thread.root"]
    assert root.parent is None and root.trace == root.id
    assert root.thread == seen["id"] != a.thread
    assert got["e"].parent is None and got["e"].trace == got["e"].id
    for r in got.values():
        assert r.start_ns <= r.end_ns
    assert profiling.spans("a.d") == [got["a.d"]]


def test_ring_drops_the_oldest_record_past_its_bound(ring):
    n = profiling.SPAN_RING_SIZE
    assert ring.maxlen == n == 65536
    with _cpu_profile():
        for i in range(n + 3):
            with profiling.span("s{}".format(i)):
                pass
    got = profiling.spans()
    assert len(got) == n
    assert got[0].name == "s3" and got[-1].name == "s{}".format(n + 2)


X = torch.ones(8)
REPEATS = 12


def _work():
    return torch.add(X, X)


def _offsets(spans, ops):
    """µs from each span's start to its op's start and from the op's end
    to the span's end (the i-th span encloses the i-th op)."""
    assert len(spans) == len(ops) == REPEATS
    return [(o0 - s0, s1 - o1) for (s0, s1), (o0, o1) in zip(spans, ops)]


def _check_offsets(offsets):
    """Each span starts before its op and ends after it, on one clock,
    and a span (the median, past a session's slow first calls) lies
    within SPAN_SLACK_US of its op."""
    assert all(head >= 0 and tail >= -1e-3 for head, tail in offsets)
    assert sorted(max(o) for o in offsets)[REPEATS // 2] <= SPAN_SLACK_US, \
        offsets


@pytest.fixture
def warm_profiler():
    """A profiler session over some ops first: a process's first session
    records its first ops slowly (tens of µs each on a shared host)."""
    with _cpu_profile():
        for _ in range(4 * REPEATS):
            _work()


def test_a_span_lies_within_50us_of_the_ops_it_encloses(ring,
                                                        warm_profiler):
    """On the profile's timeline (its trace_start_ns subtracted)."""
    with _cpu_profile() as prof:
        for _ in range(REPEATS):
            with profiling.span("work"):
                _work()
    results = prof.profiler.kineto_results
    t0 = results.trace_start_ns()
    ops = sorted((e.start_ns() - t0, e.end_ns() - t0)
                 for e in results.events() if e.name() == "aten::add")
    spans = [(r.start_ns - t0, r.end_ns - t0)
             for r in profiling.spans("work")]
    _check_offsets([(h / 1e3, t / 1e3) for h, t in _offsets(spans, ops)])


def _net():
    torch.manual_seed(0)
    return ReflectanceNet()


def _tree(records):
    """name -> the name of its parent record (None for a root)."""
    by_id = {r.id: r for r in records}
    return {r.name: by_id[r.parent].name if r.parent else None
            for r in records}


@pytest.mark.parametrize("kind", ["bf", "gf"])
def test_served_pipeline_records_its_spans(ring, kind):
    from reflectance_filtering_tpu_torch.losses.whdr import whdr_per_image
    from reflectance_filtering_tpu_torch.utils.serving import pipeline_fn

    module = pipeline_fn(kind, _net(), "cpu")
    img = torch.randint(0, 256, (2, 3, 20, 24), dtype=torch.uint8,
                        generator=torch.Generator().manual_seed(1))
    comps = torch.from_numpy(make_synthetic_comps(2, 30, batch=2))
    with _cpu_profile():
        q = module(img)
        whdr_per_image(q / 255.0, comps)
    got = profiling.spans()
    assert _tree(got) == {"serve.forward": None,
                          "serve.cnn": "serve.forward",
                          "serve.filter": "serve.forward",
                          "serve.round": "serve.forward",
                          "whdr.per_image": None}
    assert [r.name for r in got] == ["serve.cnn", "serve.filter",
                                     "serve.round", "serve.forward",
                                     "whdr.per_image"]
    forward = got[3]
    for r in got[:3]:
        assert forward.start_ns <= r.start_ns <= r.end_ns <= forward.end_ns


def test_guided_chain_records_its_span(ring):
    from reflectance_filtering_tpu_torch.ops.guided import (
        guided_filter_iterated)

    gen = torch.Generator().manual_seed(2)
    guide = torch.rand(1, 3, 30, 34, generator=gen) * 255
    src = torch.rand(1, 1, 30, 34, generator=gen) * 255
    with _cpu_profile():
        guided_filter_iterated(guide, src, 4, 3.0, 2, planar=True)
    stats, chain = profiling.spans()
    assert chain.name == "guided.iterated" and chain.parent is None
    # the statistics pass, up to the frame's first launch, inside it
    assert stats.name == "guided.stats" and stats.parent == chain.id
    assert chain.start_ns <= stats.start_ns <= stats.end_ns <= chain.end_ns


def test_cpu_fit_records_dispatch_and_wait(ring):
    from reflectance_filtering_tpu_torch.train import loop

    rng = np.random.RandomState(0)
    data = {"images": rng.rand(6, 16, 16, 3).astype(np.float32),
            "comparisons": make_synthetic_comps(3, 12, batch=6)}
    cfg = NetworkConfig(network_type="convStaticSkipLayers", kernel_pad=0,
                        num_layers=2, num_filters_log=3,
                        rs_est_mode="rDirectly")
    with _cpu_profile():
        loop.fit(cfg, loop.LossConfig(), data, 12, 2, random_seed=0,
                 device="cpu")
    # one chunk of 6 steps: its dispatch and its wait; no span inside the
    # step, which a card captures (the CPU captures no graph)
    names = collections.Counter(r.name for r in profiling.spans())
    assert names == {"fit.dispatch": 1, "fit.wait": 1}
    tree = _tree(profiling.spans())
    assert tree["fit.dispatch"] is None and tree["fit.wait"] is None


def test_export_gives_the_same_graph_and_records_nothing(ring, monkeypatch):
    """The spans enter no exported graph: the artifact's graph is the one
    exported with every span taken out, and an export under a profiler
    records none."""
    from reflectance_filtering_tpu_torch.utils import serving

    weights = serving.pipeline_fn("gf", _net(), "cpu").weights
    example = torch.zeros((2, 3, 16, 16), dtype=torch.uint8)

    def graph():
        with torch.no_grad():
            program = torch.export.export(
                serving.FlagshipModule("gf", weights), (example,))
        return str(program.graph)

    with _cpu_profile():
        spanned = graph()
    assert profiling.spans() == []
    monkeypatch.setattr(serving, "span",
                        lambda name: contextlib.nullcontext())
    assert spanned == graph()


def test_device_trace_writes_the_span_track_and_idle_file(ring, tmp_path,
                                                         warm_profiler):
    with profiling.device_trace(str(tmp_path)):
        with profiling.span("outer"):
            for _ in range(REPEATS):
                with profiling.span("outer.work"):
                    _work()
    names = sorted(os.listdir(str(tmp_path)))
    assert len(names) == 2
    idle_name, trace_name = names
    assert idle_name.startswith("idle_") and trace_name.startswith("trace_")
    assert idle_name[len("idle_"):] == trace_name[len("trace_"):]
    with open(str(tmp_path / trace_name)) as f:
        events = json.load(f)["traceEvents"]
    track = [e for e in events if e.get("pid") == profiling.SPAN_TRACK_PID]
    assert track[0]["args"]["name"] == "program spans"
    drawn = [e for e in track if e.get("ph") == "X"]
    assert collections.Counter(e["name"] for e in drawn) == {
        "outer": 1, "outer.work": REPEATS}
    outer = drawn[-1]
    assert outer["name"] == "outer"
    assert {e["args"]["parent"] for e in drawn[:-1]} == {outer["args"]["id"]}
    # on the trace's own timeline, each around the ATen op it encloses
    spans = [(e["ts"], e["ts"] + e["dur"]) for e in drawn[:-1]]
    ops = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                 if e.get("name") == "aten::add")
    _check_offsets(_offsets(spans, ops))
    with open(str(tmp_path / idle_name)) as f:
        idle = json.load(f)
    assert idle["trace"] == trace_name
    assert sum(idle["idle_us_by_span"].values()) == pytest.approx(
        idle["idle_us"], abs=1e-6)
    assert idle["busy_us"] + idle["idle_us"] == pytest.approx(
        idle["window_us"])


def _op(name, ts, dur, corr, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 0, "tid": 7, "args": {"correlation": corr}}


def _launch(ts, corr, tid=11, name="cudaLaunchKernel", cat="cuda_runtime"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": 2,
            "pid": 1, "tid": tid, "args": {"correlation": corr}}


def _record(name, start_us, end_us, thread=11, base_ns=10 ** 9):
    return profiling.SpanRecord(name, base_ns + int(start_us * 1e3),
                                base_ns + int(end_us * 1e3), 0, None, 0,
                                thread)


def test_idle_by_span_on_a_scripted_trace():
    """Gaps charged to the innermost span open at the launch of the op
    ending them; to OUTSIDE past every span; to UNMATCHED where that op
    has no launch record or a launch since the op before the gap lost its
    device record; the parts sum to the idle time."""
    events = [
        _launch(0, 1), _op("k1", 10, 5, 1),            # opens the window
        _launch(12, 2), _op("k2", 20, 5, 2),           # gap 5: b (inner)
        _launch(14, 3, name="cuLaunchKernel", cat="cuda_driver"),
        _op("k3", 27, 3, 3),                           # gap 2: a
        _op("k4", 33, 2, 4),                           # gap 3: no launch
        _launch(31, 11), _op("k5", 35, 0.5, 11),       # ends no gap
        _launch(40, 5, cat="cuda_runtime", name="cudaMemcpyAsync"),
        _op("copy", 45, 5, 5, cat="gpu_memcpy"),       # gap 9.5: outside
        _launch(46, 6),                                # its kernel lost
        _launch(47, 7, name="cudaMemsetAsync"),
        _op("memset", 56, 4, 7, cat="gpu_memset"),     # gap 6: lost before
        _launch(50, 8, tid=12),
        _op("k8", 61, 1, 8),                           # gap 1: thread 12: c
        _launch(52, 9), _op("k9", 61.5, 0.5, 9),       # overlaps: no gap
        _launch(53, 10, name="cudaStreamSynchronize"),  # not a launch
        {"ph": "f", "cat": "ac2g", "ts": 10, "id": 1},
    ]
    records = [_record("a", 11, 39), _record("b", 11.5, 13),
               _record("c", 49, 51, thread=12), _record("d", 0, 100, 13)]
    got = profiling.idle_by_span(events, records, 10 ** 9)
    assert got["idle_us_by_span"] == {
        profiling.OUTSIDE: 9.5, profiling.UNMATCHED: 9.0, "b": 5.0,
        "a": 2.0, "c": 1.0}
    assert got["idle_us"] == 26.5 and got["gaps"] == 6
    assert got["window_us"] == 52.0 and got["busy_us"] == 25.5
    assert got["device_ops"] == 9
    assert got["device_ops_without_launch"] == 1
    assert got["launches_without_device_op"] == {"cudaLaunchKernel": 1}
    assert got["launches_without_device_op_before_the_window"] == 0
    assert list(got["idle_us_by_span"]) == [
        profiling.OUTSIDE, profiling.UNMATCHED, "b", "a", "c"]
    # a launch whose record is lost before the first operation's launch
    # lies before the window: it charges nothing
    early = profiling.idle_by_span([_launch(-5, 99)] + events, records,
                                   10 ** 9)
    assert early["idle_us_by_span"] == got["idle_us_by_span"]
    assert early["launches_without_device_op"] == {"cudaLaunchKernel": 2}
    assert early["launches_without_device_op_before_the_window"] == 1
    empty = profiling.idle_by_span([], records)
    assert empty["idle_us"] == empty["window_us"] == 0
    assert empty["idle_us_by_span"] == {}


def test_idle_by_span_charges_a_gap_after_an_op_without_launch_unmatched():
    """The op before a gap has no launch record: a launch lost since it
    cannot be ruled out, so the gap goes to UNMATCHED, though the op
    ending it was launched inside a span; the next gap, after an op with
    its launch, goes to the span again."""
    events = [_launch(0, 1), _op("k1", 10, 5, 1),
              _op("k2", 17, 3, 2),                     # gap 2: no launch
              _launch(12, 3), _op("k3", 25, 2, 3),     # gap 5: after k2
              _launch(14, 4), _op("k4", 30, 1, 4)]     # gap 3: a
    got = profiling.idle_by_span(events, [_record("a", 11, 15)], 10 ** 9)
    assert got["idle_us_by_span"] == {profiling.UNMATCHED: 7.0, "a": 3.0}
    assert got["device_ops_without_launch"] == 1
    assert got["launches_without_device_op"] == {}
