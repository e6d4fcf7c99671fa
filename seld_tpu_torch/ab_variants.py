"""Time profiler sections over two versions of the package's sources, in turns.

    python -m seld_tpu_torch.ab_variants --sections train [--batch 2] \\
        --patch csrc/conv3x3_train.cu 'pf <= kGzStageRows' 'pf <= 0' [--patch ...] \\
        [--base-tree DIR] [--device=cpu]

Copies the package and ``config/`` twice under ``chip_tmp/ab_variants/``:
``base`` as it stands (or, with ``--base-tree DIR``, DIR's package, such as
an unpacked ``git archive`` of an earlier commit, with this tree's
``profile_stages.py`` over it, so that both versions time the same rows),
and ``patched`` with every ``--patch FILE OLD NEW`` applied (FILE a path
under ``seld_tpu_torch/``, OLD found there exactly once; none needed with
``--base-tree``). Builds both
copies' kernels at once, one process each, then runs ``python -m
seld_tpu_torch.profile_stages`` in each copy in the order base, patched,
patched, base (``PROF_BATCH``, ``PROF_SECTIONS``), so that drift on the card
falls on both alike. Each run's rows are printed under its version's name;
the last lines give each row's two times per version. Times of two calls are
not compared: the card's power limit and the shared host differ between
them.
"""

from __future__ import annotations

import argparse
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
WORK = ROOT / "chip_tmp" / "ab_variants"
ORDER = ("base", "patched", "patched", "base")
ROW = re.compile(r"^(.*\S)\s+(\d+\.\d+) ms$")


def make_copies(patches: list, work: Path | None = None, base_tree: Path | None = None) -> dict:
    """{version: directory holding its copy of seld_tpu_torch/ and config/}."""
    work = work or WORK
    shutil.rmtree(work, ignore_errors=True)
    dirs = {}
    for name in ("base", "patched"):
        d = work / name
        src = base_tree if name == "base" and base_tree is not None else ROOT
        for sub in ("seld_tpu_torch", "config"):
            shutil.copytree(src / sub, d / sub,
                            ignore=shutil.ignore_patterns("_build", "__pycache__"))
        if src != ROOT:
            shutil.copy2(ROOT / "seld_tpu_torch" / "profile_stages.py",
                         d / "seld_tpu_torch" / "profile_stages.py")
        dirs[name] = d
    for rel, old, new in patches:
        path = dirs["patched"] / "seld_tpu_torch" / rel
        text = path.read_text()
        if text.count(old) != 1:
            raise ValueError(f"--patch {rel}: {old!r} occurs {text.count(old)} times, not once")
        path.write_text(text.replace(old, new))
    return dirs


def _env(d: Path, batch: int, sections: str) -> dict:
    return {**os.environ, "PYTHONPATH": str(d), "PROF_BATCH": str(batch),
            "PROF_SECTIONS": sections}


def run(patches: list, sections: str, batch: int, device: str,
        base_tree: Path | None = None) -> dict:
    """Profile both versions in ORDER; returns {version: {row: [ms, ...]}}."""
    dirs = make_copies(patches, base_tree=base_tree)
    if device == "cuda":   # both builds at once: one nvcc process tree each
        builds = [subprocess.Popen([sys.executable, "-c",
                                    "from seld_tpu_torch import _build; _build.load()"],
                                   cwd=d, env=_env(d, batch, sections)) for d in dirs.values()]
        if any(p.wait() for p in builds):
            raise RuntimeError("a version's kernels did not build")
    times = {name: {} for name in dirs}
    for name in ORDER:
        d = dirs[name]
        proc = subprocess.run([sys.executable, "-m", "seld_tpu_torch.profile_stages",
                               f"--device={device}"], cwd=d, env=_env(d, batch, sections),
                              capture_output=True, text=True, timeout=900)
        print(f"[{name}] profile_stages exit {proc.returncode}", flush=True)
        for line in proc.stdout.splitlines():
            print(f"[{name}] {line}", flush=True)
            m = ROW.match(line)
            if m:
                times[name].setdefault(m.group(1), []).append(float(m.group(2)))
        if proc.returncode:
            raise RuntimeError(f"{name}: profile_stages failed:\n{proc.stderr[-3000:]}")
    return times


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--sections", required=True, help="PROF_SECTIONS of both runs")
    parser.add_argument("--batch", type=int, default=2, help="PROF_BATCH of both runs")
    parser.add_argument("--patch", nargs=3, action="append", default=[],
                        metavar=("FILE", "OLD", "NEW"), help="a change of the patched copy")
    parser.add_argument("--base-tree", type=Path, default=None,
                        help="a tree whose package the base version takes")
    parser.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = parser.parse_args(argv)
    if not args.patch and args.base_tree is None:
        parser.error("give at least one --patch, or --base-tree")
    times = run(args.patch, args.sections, args.batch, args.device, args.base_tree)
    for row in times["base"]:
        cells = "  ".join(f"{name} " + " / ".join(f"{ms:.3f}" for ms in times[name].get(row, []))
                          for name in times)
        print(f"{row:44s} {cells} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
