"""The port's A/B runner (``python -m seld_tpu_torch.ab_variants``) on the
CPU: both copies are made, the patch lands in the patched one only, the
profiler runs in each copy in the order base, patched, patched, base, and a
patch that does not match exactly once is refused.
"""

import pytest

from seld_tpu_torch import ab_variants as ab

ITERS = ("profile_stages.py", "ITERS = 5", "ITERS = 1")


def test_runs_both_versions_in_turns(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(ab, "WORK", tmp_path)
    assert ab.main(["--sections", "noop", "--batch", "1", "--device=cpu",
                    "--patch", *ITERS]) == 0
    out = capsys.readouterr().out.splitlines()
    starts = [line.split("]")[0][1:] for line in out if "profile_stages exit 0" in line]
    assert starts == list(ab.ORDER)
    summary = [line for line in out if line.startswith("noop")]
    assert len(summary) == 1 and "base " in summary[0] and "patched " in summary[0], out
    assert summary[0].count(" / ") == 2   # two runs of each version
    prof = lambda v: (tmp_path / v / "seld_tpu_torch" / "profile_stages.py").read_text()
    assert "ITERS = 5" in prof("base") and "ITERS = 1" in prof("patched")
    assert (tmp_path / "patched" / "config").is_dir()


def test_a_patch_must_match_once(tmp_path):
    with pytest.raises(ValueError, match="occurs 0 times"):
        ab.make_copies([("profile_stages.py", "no such text", "x")], tmp_path)
