"""``seld_tpu_torch.utils.profiling.device_events`` on the CPU, with the
profiler and the card's calls replaced by fakes: a capture is returned only
where its first and last device events in time are bracket kernels, else it
is taken again, at most ``CAPTURE_TRIES`` times, and ``CAPTURES`` counts both."""

import collections
from types import SimpleNamespace

import pytest
import torch
from torch.autograd import DeviceType

from seld_tpu_torch.utils import profiling

BRACKET = f"at::cuda::(anonymous namespace)::{profiling.BRACKET_KERNEL}(long)"
KERNEL = "(anonymous namespace)::flash_fwd_tc_kernel<64, 48>(...)"
HOST = "aten::mm"

# captures as (name, start) device events, listed out of time order; a host
# op runs beside every one
WHOLE = [(BRACKET, 3), (KERNEL, 2), (BRACKET, 1)]
KERNEL_FIRST = [(KERNEL, 0), (BRACKET, 1), (KERNEL, 2), (BRACKET, 3)]
LEAD_DROPPED = [(KERNEL, 2), (BRACKET, 3)]
TRAIL_MISSING = [(BRACKET, 1), (KERNEL, 2)]
EMPTY = []


class FakeProfile:
    """torch.profiler.profile's surface that device_events reads."""

    captures, seen = [], []

    def __init__(self, activities=()):
        self.device = self.captures.pop(0)
        self.seen.append(list(activities))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def events(self):
        return ([SimpleNamespace(name=n, time_range=SimpleNamespace(start=t),
                                 device_type=DeviceType.CUDA) for n, t in self.device]
                + [SimpleNamespace(name=HOST, time_range=SimpleNamespace(start=5),
                                   device_type=DeviceType.CPU)])

    def key_averages(self):
        counts = collections.Counter(n for n, _ in self.device)
        return ([SimpleNamespace(key=n, count=c, device_type=DeviceType.CUDA)
                 for n, c in counts.items()]
                + [SimpleNamespace(key=HOST, count=1, device_type=DeviceType.CPU)])


@pytest.mark.parametrize("captures, calls, whole", [
    ([WHOLE], 1, True),
    ([EMPTY, WHOLE], 2, True),
    ([KERNEL_FIRST, WHOLE], 2, True),
    ([LEAD_DROPPED, TRAIL_MISSING, KERNEL_FIRST, WHOLE], 4, True),
    ([EMPTY, LEAD_DROPPED, TRAIL_MISSING, KERNEL_FIRST, LEAD_DROPPED], 5, False),
], ids=["whole", "empty-then-whole", "kernel-first-then-whole", "three-then-whole",
                       "never-whole"])
def test_device_events_takes_a_capture_again_until_it_is_whole(monkeypatch, captures, calls,
                                                              whole):
    sleeps, runs = [], []
    monkeypatch.setattr(FakeProfile, "captures", list(captures))
    monkeypatch.setattr(FakeProfile, "seen", [])
    monkeypatch.setattr(profiling, "CAPTURES", collections.Counter())
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "_sleep", sleeps.append)
    monkeypatch.setattr(torch.profiler, "profile", FakeProfile)
    run = lambda: runs.append(1)
    if whole:
        events, wall_ms = profiling.device_events(run, cpu=True)
        assert [(e.key, e.count) for e in events] == [(KERNEL, 1)]
        assert wall_ms >= 0.0
    else:
        with pytest.raises(RuntimeError, match=f"no whole capture in {profiling.CAPTURE_TRIES} tries: 0 device events; "
                                               "2 device events, first .*flash_fwd_tc_kernel"):
            profiling.device_events(run)
    assert len(runs) == calls and not FakeProfile.captures
    assert profiling.CAPTURES == collections.Counter(whole=int(whole),
                                                     retaken=calls - int(whole))
    leads = sum(profiling.LEAD_BRACKETS * 2 ** i for i in range(calls))
    assert sleeps == [profiling.BRACKET_CYCLES] * (leads + calls)
    want = ([torch.profiler.ProfilerActivity.CPU] if whole else []) + [
        torch.profiler.ProfilerActivity.CUDA]
    assert FakeProfile.seen == [want] * calls


# ---- chip_smoke.py's watch groups: each device kernel in one group at most ----

def _csrc_kernel_keys():
    """Profiler-style names of every kernel in ``seld_tpu_torch/csrc`` at a few
    template arguments, and of K9's B1 before it became the walker
    (``ct_sel_stats_kernel<float>``, whose name ends as K5's B1 does)."""
    import re
    from pathlib import Path

    csrc = Path(profiling.__file__).resolve().parents[1] / "csrc"
    decl = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(")
    names = {n for src in csrc.glob("*.cu*") for n in decl.findall(src.read_text())}
    assert {"sel_stats_kernel", "ct_route_stats_kernel", "ct_route_gz_kernel"} <= names
    args = ("", "<float>", "<__nv_bfloat16>", "<32>", "<16>", "<8>", "<float, 1>",
            "<__nv_bfloat16, 2>")
    keys = [f"void (anonymous namespace)::{n}{a}(float const*, int)" for n in sorted(names)
            for a in args]
    return keys + ["void (anonymous namespace)::ct_sel_stats_kernel<float>(float const*, int)"]


@pytest.mark.parametrize("watch", ["PROFILE_WATCH", "F32_STEP_WATCH", "SERVING_WATCH"])
def test_watch_groups_count_each_kernel_once(watch):
    """``chip_smoke.watched`` anchors each stem at the start of a name: no
    kernel falls in two groups of a watch, K5's B1 (``sel_stats_kernel<float>``)
    is not found in K9's old ``ct_sel_stats_kernel<float>``, and K9's B1 and
    g_z (the walker's two kernels) have groups of their own."""
    import chip_smoke

    groups = getattr(chip_smoke, watch)
    for key in _csrc_kernel_keys():
        assert len(chip_smoke.watched(key, groups)) <= 1, (key, chip_smoke.watched(key, groups))
    if watch == "F32_STEP_WATCH":
        k = "void (anonymous namespace)::{}(float const*, int)".format
        assert chip_smoke.watched(k("sel_stats_kernel<float>"), groups) == ["K5 B1"]
        assert chip_smoke.watched(k("ct_sel_stats_kernel<float>"), groups) == []
        assert chip_smoke.watched(k("ct_route_stats_kernel<float, 1>"), groups) == ["K9 B1"]
        assert chip_smoke.watched(k("ct_route_gz_kernel<float, 2>"), groups) == ["K9 g_z"]
