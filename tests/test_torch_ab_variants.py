"""The port's A/B runner (``python -m seld_tpu_torch.ab_variants``) on the
CPU: both copies are made, the patch lands in the patched one only, the
profiler runs in each copy in the order base, patched, patched, base, and a
patch that does not match exactly once is refused; ``--hashes`` finds the
cases whose outputs a patch changes (here through the plain versions), and
``--tests`` runs tests on each version's package.
"""

import re

import pytest
import torch

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


def test_hashes_equal_where_the_outputs_are(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(ab, "WORK", tmp_path)
    assert ab.main(["--hashes", "--device=cpu", "--patch", *ITERS]) == 0
    out = capsys.readouterr().out.splitlines()
    n = len(ab.hash_cases(torch.device("cpu")))
    assert out[-1] == f"hashes: {n} of {n} cases equal" and n >= 25, out[-1]
    for v in ("base", "patched"):
        lines = [line[len(v) + 3:] for line in out if line.startswith(f"[{v}] ")][1:]
        assert len(lines) == n, lines
        assert all(re.fullmatch(r".+\S +[0-9a-f]{16}", line) for line in lines), lines
        assert len({line.rsplit(None, 1)[0] for line in lines}) == n   # names unique


def test_hashes_name_the_cases_a_patch_changes(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(ab, "WORK", tmp_path)
    scale = ("ops/kernels/attention.py", "k.to(cdt)) * scale", "k.to(cdt)) * scale * 1.001")
    assert ab.main(["--hashes", "--device=cpu", "--patch", *scale]) == 1
    last = capsys.readouterr().out.splitlines()[-1]
    assert last.endswith("differ: K4 D 48 bf16, K6 D 48 bf16, K4 D 160 bf16, K6 D 160 bf16, "
                         "K4 D 160 f32, K6 D 160 f32, K4 D 48 f32"), last


def test_digest_needs_the_card_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device=cpu"):
        ab.main(["--digest"])


def test_tests_run_on_each_versions_package(tmp_path, monkeypatch, capsys):
    """A test of tf32.py's rounding passes on this tree's package and fails
    on a copy whose rounding the patch broke."""
    monkeypatch.setattr(ab, "WORK", tmp_path)
    half = ("ops/kernels/tf32.py", "_HALF = 0x1000", "_HALF = 0x0800")
    assert ab.main(["--tests", "tests/test_torch_tf32_split.py::test_ties_round_away_from_zero",
                    "--device=cpu", "--patch", *half]) == 0
    out = capsys.readouterr().out.splitlines()
    assert "[base] exit 0" in out and "[patched] exit 1" in out, out


def test_a_patch_must_match_once(tmp_path):
    with pytest.raises(ValueError, match="occurs 0 times"):
        ab.make_copies([("profile_stages.py", "no such text", "x")], tmp_path)


def test_base_tree_takes_its_package_and_this_profiler(tmp_path):
    """--base-tree: the base copy is the given tree's package (here a marker
    file stands for an earlier commit's sources) with this tree's
    profile_stages.py and ab_variants.py over it; the patched copy is this
    tree's."""
    tree = tmp_path / "earlier"
    (tree / "seld_tpu_torch").mkdir(parents=True)
    (tree / "seld_tpu_torch" / "marker.py").write_text("EARLIER = True\n")
    (tree / "seld_tpu_torch" / "profile_stages.py").write_text("# the earlier profiler\n")
    (tree / "config").mkdir()
    dirs = ab.make_copies([], tmp_path / "work", base_tree=tree)
    base, patched = (dirs[v] / "seld_tpu_torch" for v in ("base", "patched"))
    assert (base / "marker.py").exists() and not (patched / "marker.py").exists()
    for tool in ("profile_stages.py", "ab_variants.py"):
        here = (ab.ROOT / "seld_tpu_torch" / tool).read_text()
        assert (base / tool).read_text() == here and (patched / tool).read_text() == here
