"""utils/profiling.py::profile_calls on a scripted profiler: each call's
device events told apart by the marker kernels on the card's timeline,
the calls just before the last kept, and a profile whose kept calls
differ (lost records) taken again with more lead calls, then refused."""
import types

import pytest
import torch

from reflectance_filtering_tpu_torch.utils import profiling

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
