"""Time profiler sections over two versions of the package's sources, in turns.

    python -m seld_tpu_torch.ab_variants --sections train [--batch 2] \\
        --patch csrc/conv3x3_train.cu 'pf <= kGzStageRows' 'pf <= 0' [--patch ...] \\
        [--base-tree DIR] [--device=cpu]
    python -m seld_tpu_torch.ab_variants --hashes --base-tree DIR [--device=cpu]
    python -m seld_tpu_torch.ab_variants --tests tests/test_torch_cuda.py::NAME ... \\
        --patch ... [--base-tree DIR]

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

``--hashes`` runs, instead of the profiler, ``python -m
seld_tpu_torch.ab_variants --digest`` once in each copy (this tree's
``ab_variants.py`` goes over the base's, as the profiler does): one line
per case of :func:`hash_cases`, the first 16 hex digits of the sha256 of
the output's bytes, for every bfloat16 kernel, the split-TF32 wide kernels
past head dim 128 (D 160), the split-TF32 K4 (D 48) and K7, K5's
float32 F1 and B2 (F1, the g_z pass and the dW tile at Cin 8 and 10), the
conv-pool stages in float32 (K2, K2w, K3, K10a, K10b) and K9's float32
F1, B1, g_z and dh (B1, g_z and dh on a drawn pre; g_z also at T 515, pf
16 and at pf 1), on inputs from
one seeded generator on the device. Equal code gives equal bits (every kernel there
reduces in a fixed order); the runner exits 1 where a case differs.
``--tests`` runs the given tests (pytest node ids under ``tests/``) once in
each copy, each version's package imported in place of this tree's; a
mutated kernel that a precision gate must fail is checked this way. With
``--device=cpu`` the cases and tests run the plain versions, which checks
the runner, not the kernels.
"""

from __future__ import annotations

import argparse
import hashlib
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
            for tool in ("profile_stages.py", "ab_variants.py"):
                shutil.copy2(ROOT / "seld_tpu_torch" / tool, d / "seld_tpu_torch" / tool)
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


def _copies(patches: list, device: str, base_tree: Path | None, env) -> dict:
    dirs = make_copies(patches, base_tree=base_tree)
    if device == "cuda":   # both builds at once: one nvcc process tree each
        builds = [subprocess.Popen([sys.executable, "-c",
                                    "from seld_tpu_torch import _build; _build.load()"],
                                   cwd=d, env=env(d)) for d in dirs.values()]
        if any(p.wait() for p in builds):
            raise RuntimeError("a version's kernels did not build")
    return dirs


def run(patches: list, sections: str, batch: int, device: str,
        base_tree: Path | None = None) -> dict:
    """Profile both versions in ORDER; returns {version: {row: [ms, ...]}}."""
    dirs = _copies(patches, device, base_tree, lambda d: _env(d, batch, sections))
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


def run_once(patches: list, command: list, device: str,
             base_tree: Path | None = None) -> dict:
    """``python <command>`` once in each copy (base, then patched), its
    output printed under the version's name; returns {version: (exit code,
    stdout lines)}."""
    env = lambda d: {**os.environ, "PYTHONPATH": str(d)}
    dirs = _copies(patches, device, base_tree, env)
    done = {}
    for name, d in dirs.items():
        proc = subprocess.run([sys.executable, *command], cwd=d, env=env(d),
                              capture_output=True, text=True, timeout=1800)
        print(f"[{name}] exit {proc.returncode}", flush=True)
        for line in proc.stdout.splitlines():
            print(f"[{name}] {line}", flush=True)
        if proc.returncode:
            print(proc.stderr[-3000:], file=sys.stderr, flush=True)
        done[name] = (proc.returncode, proc.stdout.splitlines())
    return done


def digest(*tensors) -> str:
    """First 16 hex digits of the sha256 of the tensors' bytes."""
    import torch

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()[:16]


def hash_cases(device):
    """(name, fn) of every case of ``--hashes``; fn() returns the output
    tensors."""
    import torch

    from seld_tpu_torch.ops.kernels import conv2d_ct_train as k9
    from seld_tpu_torch.ops.kernels import conv2d_pool as pool
    from seld_tpu_torch.ops.kernels import conv2d_train as k5
    from seld_tpu_torch.ops.kernels.attention import flash_attention, flash_attention_bwd
    from seld_tpu_torch.ops.kernels.qmatmul import hamilton_matmul
    from seld_tpu_torch.ops.kernels.quant import int8_matmul, quantize_weight_per_channel
    from seld_tpu_torch.ops.kernels.stft import stft_mag

    gen = torch.Generator(device=device).manual_seed(0)
    bf16 = torch.bfloat16
    randn = lambda *s, dt=bf16, sc=1.0: (torch.randn(*s, generator=gen, device=device) * sc).to(dt)
    out = []
    audio = randn(2, 70_001, dt=torch.float32)
    out.append(("K1 stft_mag bf16", lambda: (stft_mag(audio, out_dtype=bf16),)))
    for cin, f, t, cout, pf in ((8, 32, 300, 80, 8), (24, 16, 129, 72, 4), (10, 16, 300, 64, 8),
                                (12, 8, 257, 72, 2)):
        x, w = randn(2, cin, f, t), randn(3, 3, cin, cout, sc=(9 * cin) ** -0.5)
        sc, bi = randn(cout, dt=torch.float32, sc=0.2) + 1.0, randn(cout, dt=torch.float32)
        # the serving route (K2, K2w, K3 or K10b by Cin), then K10a and K10b by name
        ops = {pool.frontend_stage_kernel(cin): pool.conv2d_bn_relu_fpool,
               "conv3x3_im2col": pool.conv2d_im2col_bn_relu_fpool,
               "conv3x3_windows": pool.conv2d_windows_bn_relu_fpool}
        if 3 * cin <= 32:
            ops["conv3x3_smallcin_wide"] = pool.conv2d_smallcin_wide_bn_relu_fpool
        for name, op in ops.items():
            for dt, tag in ((bf16, "bf16"), (torch.float32, "f32")):
                xd, wd = x.to(dt), w.to(dt)
                out.append((f"{name} Cin {cin} {tag}", lambda op=op, x=xd, w=wd, sc=sc, bi=bi,
                            pf=pf: (op(x, w, sc, bi, pf),)))
    # K5's bf16 passes at Cin 8, K9's at C 24
    x, w = randn(2, 8, 32, 300), randn(3, 3, 8, 72, sc=0.1)
    g = randn(2, 72, 4, 300)
    cols = [randn(72, dt=torch.float32, sc=0.1) + d for d in (1.0, 0.0, 0.0, 0.0)]
    b2 = (x, w, g, *cols, 8)
    out.append(("K5 F1 bf16", lambda: (k5.conv_train_stats(x, w, 8),)))
    out.append(("K5 g_z bf16", lambda: k5.conv_train_gz(*b2)))
    out.append(("K5 dW bf16", lambda: (k5.conv_train_dw_gz(x, k5.conv_train_gz(*b2)[0]),)))
    # K5's float32 F1, g_z pass and split-TF32 dW tile, at Cin 8 and 10
    for cin5 in (8, 10):
        x5, w5 = randn(2, cin5, 32, 300, dt=torch.float32), randn(3, 3, cin5, 72, dt=torch.float32,
                                                                   sc=0.1)
        b2f = (x5, w5, g.float(), *cols, 8)
        out.append((f"K5 F1 Cin {cin5} f32", lambda x5=x5, w5=w5: (
            k5.conv_train_stats(x5, w5, 8),)))
        out.append((f"K5 g_z Cin {cin5} f32", lambda b2f=b2f: k5.conv_train_gz(*b2f)))
        out.append((f"K5 dW Cin {cin5} f32", lambda x5=x5, b2f=b2f: (
            k5.conv_train_dw_gz(x5, k5.conv_train_gz(*b2f)[0]),)))
    h, w9 = randn(2, 24, 16, 300), randn(3, 3, 24, 72, sc=0.1)
    g9 = randn(2, 72, 4, 300)
    ccols = torch.stack([randn(72, dt=torch.float32, sc=0.1) + d
                         for d in (1.0, 0.0, 0.0, 1.0, 0.0, 0.0)])
    out.append(("K9 F1 bf16", lambda: k9.ct_train_stats(h, w9, 4)))
    pre = lambda: k9.ct_train_stats(h, w9, 4)[1]
    out.append(("K9 B1 bf16", lambda: (k9.ct_sel_stats(pre(), g9, ccols, 4),)))
    gz9 = lambda: k9.ct_gz(pre(), g9, ccols, 4)
    out.append(("K9 g_z bf16", lambda: (gz9(),)))
    out.append(("K9 dW bf16", lambda: (k9.ct_dw(h, gz9()),)))
    out.append(("K9 dh bf16", lambda: (k9.ct_dx(gz9(), w9),)))
    # K4 and K6: the flagship's D 48, and 160 (the bf16 and float32 wide kernels)
    def k6(q, k, v, do, scale):
        o, lse = flash_attention(q, k, v, scale)
        return flash_attention_bwd(q, k, v, o.contiguous(), do, lse.contiguous(), scale)

    for d, dt in ((48, bf16), (160, bf16), (160, torch.float32)):
        q, k, v, do = (randn(2, 200, 3, d, dt=dt) for _ in range(4))
        tag = f"D {d} {'bf16' if dt == bf16 else 'f32'}"
        out.append((f"K4 {tag}", lambda q=q, k=k, v=v, d=d: flash_attention(q, k, v, d ** -0.5)))
        out.append((f"K6 {tag}", lambda q=q, k=k, v=v, do=do, d=d: k6(q, k, v, do, d ** -0.5)))
    # K4 in float32 at D 48 (split TF32)
    q, k, v = (randn(2, 200, 3, 48, dt=torch.float32) for _ in range(3))
    out.append(("K4 D 48 f32", lambda: flash_attention(q, k, v, 48 ** -0.5)))
    xm, comps, bm = randn(1037, 8 * 48), randn(8, 48, 48, sc=48 ** -0.5), randn(8 * 48)
    out.append(("K7 bf16", lambda: (hamilton_matmul(xm, comps, bm, 8, False),)))
    xf, cf, bf = (a.float() for a in (xm, comps, bm))
    out.append(("K7 f32", lambda: (hamilton_matmul(xf, cf, bf, 8, False),)))
    w_q, w_s = quantize_weight_per_channel(randn(384, 384, dt=torch.float32, sc=384 ** -0.5))
    xq = randn(1200, 384)
    out.append(("K8 bf16", lambda: (int8_matmul(xq, w_q, w_s, None),)))
    # K9 in float32: F1 on the split-TF32 block tile, B1 and g_z on a drawn pre
    # (their routing alone, whatever F1 gives), dh on the same tile with the
    # drawn pre standing in for g_z
    h32, w32 = h.float(), w9.float()
    pre32, g32 = randn(2, 72, 16, 300, dt=torch.float32), g9.float()
    out.append(("K9 F1 f32", lambda: k9.ct_train_stats(h32, w32, 4)))
    out.append(("K9 B1 f32", lambda: (k9.ct_sel_stats(pre32, g32, ccols, 4),)))
    out.append(("K9 g_z f32", lambda: (k9.ct_gz(pre32, g32, ccols, 4),)))
    out.append(("K9 dh f32", lambda: (k9.ct_dx(pre32, w32),)))
    # K9's g_z beside the cases above (T 300, pf 4): one frame at a time (T 515)
    # with two chunks of rows (pf 16), and one row a window (pf 1)
    for t9, pf9 in ((515, 16), (300, 1)):
        pre9 = randn(2, 40, 16, t9, dt=torch.float32)
        cols9 = torch.stack([randn(40, dt=torch.float32, sc=0.1) + d
                             for d in (1.0, 0.0, 0.0, 1.0, 0.0, 0.0)])
        for dt, tag in ((bf16, "bf16"), (torch.float32, "f32")):
            g99 = randn(2, 40, 16 // pf9, t9, dt=dt)
            out.append((f"K9 g_z {tag} T {t9} pf {pf9}", lambda pre9=pre9, g99=g99, cols9=cols9,
                        pf9=pf9: (k9.ct_gz(pre9, g99, cols9, pf9),)))
    return out


def print_digests(device: str) -> int:
    """``--digest``: this package's hash of every case of :func:`hash_cases`."""
    import torch
    from seld_tpu_torch import disable_tf32

    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass --device=cpu to run the plain versions")
    disable_tf32()
    if device == "cpu":   # CPU matmuls may split their sums by the threads free at the time
        torch.set_num_threads(1)
    for name, fn in hash_cases(torch.device(device)):
        print(f"{name:32s} {digest(*fn())}", flush=True)
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--sections", help="PROF_SECTIONS of both runs")
    parser.add_argument("--batch", type=int, default=2, help="PROF_BATCH of both runs")
    parser.add_argument("--patch", nargs=3, action="append", default=[],
                        metavar=("FILE", "OLD", "NEW"), help="a change of the patched copy")
    parser.add_argument("--base-tree", type=Path, default=None,
                        help="a tree whose package the base version takes")
    parser.add_argument("--hashes", action="store_true",
                        help="compare the kernels' output hashes instead of profiling")
    parser.add_argument("--tests", nargs="+", default=None, metavar="NODEID",
                        help="run these tests in each version instead of profiling")
    parser.add_argument("--digest", action="store_true",
                        help="print this package's output hashes (what --hashes runs)")
    parser.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = parser.parse_args(argv)
    if args.digest:
        return print_digests(args.device)
    if not args.patch and args.base_tree is None:
        parser.error("give at least one --patch, or --base-tree")
    if args.hashes:
        done = run_once(args.patch, ["-m", "seld_tpu_torch.ab_variants", "--digest",
                                     f"--device={args.device}"], args.device, args.base_tree)
        if any(code for code, _ in done.values()):
            return 1
        base, patched = (done[v][1] for v in ("base", "patched"))
        differ = [a.rsplit(None, 1)[0] for a, b in zip(base, patched) if a != b]
        differ += ["(the versions print different numbers of cases)"] * (len(base) != len(patched))
        print(f"hashes: {len(base) - len(differ)} of {len(base)} cases equal"
              + (f"; differ: {', '.join(differ)}" if differ else ""))
        return 1 if differ else 0
    if args.tests:
        tests = [str(ROOT / t) for t in args.tests]
        run_once(args.patch, ["-m", "pytest", "--noconftest", "-p", "no:cacheprovider",
                              "--import-mode=importlib", "-q", "-s", *tests],
                 args.device, args.base_tree)
        return 0
    if not args.sections:
        parser.error("give --sections, --hashes or --tests")
    times = run(args.patch, args.sections, args.batch, args.device, args.base_tree)
    for row in times["base"]:
        cells = "  ".join(f"{name} " + " / ".join(f"{ms:.3f}" for ms in times[name].get(row, []))
                          for name in times)
        print(f"{row:44s} {cells} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
