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


def test_base_tree_takes_its_package_and_this_profiler(tmp_path):
    """--base-tree: the base copy is the given tree's package (here a marker
    file stands for an earlier commit's sources) with this tree's
    profile_stages.py over it; the patched copy is this tree's."""
    tree = tmp_path / "earlier"
    (tree / "seld_tpu_torch").mkdir(parents=True)
    (tree / "seld_tpu_torch" / "marker.py").write_text("EARLIER = True\n")
    (tree / "seld_tpu_torch" / "profile_stages.py").write_text("# the earlier profiler\n")
    (tree / "config").mkdir()
    dirs = ab.make_copies([], tmp_path / "work", base_tree=tree)
    base, patched = (dirs[v] / "seld_tpu_torch" for v in ("base", "patched"))
    assert (base / "marker.py").exists() and not (patched / "marker.py").exists()
    here = (ab.ROOT / "seld_tpu_torch" / "profile_stages.py").read_text()
    assert (base / "profile_stages.py").read_text() == here
    assert (patched / "profile_stages.py").read_text() == here
