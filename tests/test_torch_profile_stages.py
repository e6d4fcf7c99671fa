"""The port's per-stage profiler (``python -m seld_tpu_torch.profile_stages``)
on the CPU at tiny shapes: every row of every section runs and prints a
time (the host clock's; the card's rows are timed with CUDA events), no
kernel launches on CPU tensors, a row that runs out of device memory prints
FAILED without stopping the profile, and the CLI's last line is the launch
counts' JSON.
"""

import json

import pytest
import torch

from seld_tpu_torch import profile_stages as prof
from seld_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

# the flagship's frequency path (its config's 256 bins) at 32 frames, narrow CNN
# and TCN sections; the v3 section builds the full-width flagship
TINY = dict(prof.FLAGSHIP, samples=12800, frames=32, filters=16, tcn_width=16, dilation=3)
# attn: four rows at the flagship's head dim and at each of prof.ATTN_WIDE_DIMS;
# f32: four attention rows at the flagship's head dim and at prof.F32_WIDE_DIM, K7
# and addmm, K9's dW, K5's F1, K2 at stage 1 (K5's F2) and K5's B2 with the
# wgrads, K2w at stage 1, K10a and
# cuDNN's conv at each of the three stages, K3, K10b and K9's F1 at stage 2, and
# K9's dh at stages 2 and 3; train and f32 end with K9's B1 and g_z at stages 2
# and 3; walls: the K7 wrapper calls, a serve request, two apply forwards and a
# training step, at full width like v3
ROWS = {"noop": 1, "stft": 3, "cnn": 5, "tcn": 3, "fused": 12, "qmm": 9, "train": 9,
        "attn": 4 * (1 + len(prof.ATTN_WIDE_DIMS)), "f32": 33, "v3": 5, "walls": 5}


@pytest.mark.parametrize("section", sorted(prof.SECTIONS))
def test_section_rows_print_a_time(section, capsys):
    reset_launch_counts()
    results = prof.run([section], 1, torch.device("cpu"), TINY, iters=1)
    out = capsys.readouterr().out.splitlines()
    want = ROWS[section] + (ROWS["noop"] if section != "noop" else 0)
    assert len(results) == len(out) == want, out
    assert all(isinstance(v, float) and v >= 0 for v in results.values()), results
    assert all(line.endswith(" ms") and "FAILED" not in line for line in out), out
    assert not any(launch_counts.values()), launch_counts


def test_a_row_out_of_device_memory_fails_alone(monkeypatch, capsys):
    def oom(batch, device, shapes=prof.FLAGSHIP):
        def fail(t):
            raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 9 GiB")
        yield "too big", fail, (torch.zeros(1),)
        yield "fits", lambda t: t + 1, (torch.zeros(1),)

    monkeypatch.setitem(prof.SECTIONS, "oom", oom)
    results = prof.run(["oom"], 1, torch.device("cpu"), TINY, iters=1)
    out = capsys.readouterr().out
    assert results["too big"] is None and results["fits"] >= 0
    assert "too big" in out and "FAILED: CUDA out of memory" in out


def test_cli_on_the_cpu(monkeypatch, capsys):
    """``--device=cpu``: the device line, the noop row, the launch counts;
    exit 0. A failed row makes it exit 1; an unknown section raises."""
    monkeypatch.setenv("PROF_BATCH", "1")
    monkeypatch.setenv("PROF_SECTIONS", "noop")
    assert prof.main(["--device=cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("device cpu (host clock") and "batch=1" in out[0]
    assert out[1].startswith("noop") and out[1].endswith(" ms")
    assert json.loads(out[-1]) == {"launch_counts": {k: 0 for k in launch_counts}}

    monkeypatch.setitem(prof.SECTIONS, "noop", lambda b, d, s=None: iter(
        [("noop", lambda: (_ for _ in ()).throw(torch.cuda.OutOfMemoryError("oom")), ())]))
    assert prof.main(["--device=cpu"]) == 1
    monkeypatch.setenv("PROF_SECTIONS", "noop,xla_dft")
    with pytest.raises(ValueError, match="xla_dft"):
        prof.main(["--device=cpu"])
