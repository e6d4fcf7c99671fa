"""Build and load the package's CUDA kernels.

Each source under ``csrc/`` is compiled by its own ``nvcc`` process, all
started together, and the objects are linked into one shared library with a
plain C interface, ``_build/libseld_kernels_<hash>.so``, where the hash
covers the sources and the flags, so an edited source builds anew.
The build happens at first use on a CUDA host; the library is then loaded
with ``ctypes`` and every entry point gets its ``argtypes``: ``c_void_p`` for
pointers and the stream, ``c_int`` for integers, ``c_float`` for scales.

A missing ``nvcc`` raises: a CUDA tensor never silently takes a plain path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# name -> argtypes of each C entry point (all return a cudaError_t as int)
SIGNATURES = {
    # x, table, out, rows, n, n_frames, nperseg, hop, x_dtype, stream
    "seld_stft_mag": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # x, tiles, out, rows, n, n_frames, nperseg, hop, k_pad, x_dtype, stream
    "seld_stft_mag_tc": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # x, win, tw, out, rows, n, n_frames, nperseg, hop, x_dtype, stream
    "seld_stft_mag_fft": [_P] * 4 + [_I] * 6 + [_P],
    # x, w, scale, bias, out, batch, cin, f, t, cout, pf, chunk, dtype, stream
    "seld_conv3x3_smallcin": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # x, w, scale, bias, out, batch, cin, f, t, cout, pf, dtype, stream
    "seld_conv3x3_widecin": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "seld_conv3x3_windows": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # p0, wk, scale, bias, out, batch, kg, rows, f, t, tpad, cout, pf, dtype, stream
    "seld_conv3x3_smallcin_wide": [_P] * 5 + [_I] * 9 + [_P],
    # patches, w, scale, bias, out, batch, k, f, t, cout, pf, dtype, stream
    "seld_conv3x3_im2col": [_P] * 5 + [_I] * 7 + [_P],
    # x, patches, batch, cin, f, t, k_pad, dtype, stream
    "seld_im2col_patches": [_P, _P] + [_I] * 6 + [_P],
    # q, k, v, out, lse, batch, t, heads, d, group, scale, dtype, stream
    "seld_flash_attn_fwd": [_P] * 5 + [_I] * 5 + [_F, _I, _P],
    # q, k, v, out, dout, lse, delta, dq, dk, dv, batch, t, heads, d, group, scale, dtype,
    # stream
    "seld_flash_attn_bwd": [_P] * 10 + [_I] * 5 + [_F, _I, _P],
    # x, w, partials, sums, batch, cin, f, t, cout, pf, tiles_per_block, dtype, stream
    "seld_conv3x3_train_stats": [_P] * 4 + [_I] * 8 + [_P],
    # out, g, p, q, partials, sums, batch, cout, f_out, t, dtype, stream
    "seld_conv3x3_train_sel_stats": [_P] * 6 + [_I] * 5 + [_P],
    # x, w, scale, bias, a, b, g, gz, partials, sums, batch, cin, f, t, cout, pf,
    # tiles_per_block, dtype, stream
    "seld_conv3x3_train_gz": [_P] * 10 + [_I] * 8 + [_P],
    # x, gz, partials, sums, batch, cin, f, t, cout, rows_per_split, frames_per_split,
    # dtype, stream
    "seld_conv3x3_train_dw_tc": [_P] * 4 + [_I] * 8 + [_P],
    # h, w, pre, partials, sums, batch, cin, f, t, cout, pf, dtype, stream
    "seld_ct_train_stats": [_P] * 5 + [_I] * 7 + [_P],
    # pre, g, cols, partials, sums, batch, cout, f, t, pf, frames_per_span, blocks, dtype,
    # stream
    "seld_ct_train_sel_stats": [_P] * 5 + [_I] * 8 + [_P],
    # pre, g, cols, gz, batch, cout, f, t, pf, frames_per_span, blocks, dtype, stream
    "seld_ct_train_gz": [_P] * 4 + [_I] * 8 + [_P],
    # h, gz, partials, sums, batch, cin, f, t, cout, rows_per_split, frames_per_split,
    # dtype, stream
    "seld_ct_train_dw": [_P] * 4 + [_I] * 8 + [_P],
    # gz, w, dh, batch, cin, f, t, cout, dtype, stream
    "seld_ct_train_dx": [_P] * 3 + [_I] * 6 + [_P],
    # x, comps, bias, out, m, n_comp, cin_c, cout_c, linear_table, dtype, stream
    "seld_hamilton_matmul": [_P] * 4 + [_I] * 6 + [_P],
    # x, w_q, w_t, w_scale, bias, out, xq, xs, m, cin, k_pad, cout, bm, two_pass, dtype,
    # bias_dtype, stream
    "seld_int8_matmul": [_P] * 8 + [_I] * 7 + [_P],
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def find_nvcc() -> str:
    """Path of ``nvcc``: $CUDA_HOME/bin, then PATH, then /usr/local/cuda/bin."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    which = shutil.which("nvcc")
    if which:
        cands.append(Path(which))
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file():
            return str(c)
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and /usr/local/cuda/bin); "
        "the seld_tpu_torch CUDA kernels cannot be built"
    )


def library_path(nvcc: str) -> Path:
    h = hashlib.sha256()
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join([nvcc, *ARCH_FLAGS, *NVCC_FLAGS]).encode())
    return BUILD_DIR / f"libseld_kernels_{h.hexdigest()[:16]}.so"


def build(nvcc: str, out: Path) -> str:
    """Compile every ``csrc/*.cu`` (one nvcc each, in parallel) and link them
    into ``out``; returns nvcc's log (commands, ptxas' report, errors)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    obj_dir = out.with_suffix(f".{os.getpid()}.obj")
    obj_dir.mkdir(exist_ok=True)
    jobs = []
    for src in sorted(CSRC.glob("*.cu")):
        obj = obj_dir / f"{src.stem}.o"
        cmd = [nvcc, *ARCH_FLAGS, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for cmd, _, proc in jobs:
        text, _ = proc.communicate()
        log.append(" ".join(cmd) + "\n" + text)
        if proc.returncode != 0:
            failed.append(cmd[-1])
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    if not failed:
        cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *[str(o) for _, o, _ in jobs]]
        proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
        log.append(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed.append("link")
    text = "\n".join(log)
    out.with_suffix(".log").write_text(text)
    shutil.rmtree(obj_dir, ignore_errors=True)
    if failed:
        raise RuntimeError(f"nvcc failed ({', '.join(failed)}):\n{text}")
    os.replace(tmp, out)
    return text


def load() -> ctypes.CDLL:
    """The kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        nvcc = find_nvcc()
        path = library_path(nvcc)
        if not path.exists():
            build(nvcc, path)
        lib = ctypes.CDLL(str(path))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.seld_error_string.argtypes = [ctypes.c_int]
        lib.seld_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib


def check(err: int, name: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        text = _lib.seld_error_string(err).decode() if _lib is not None else "?"
        raise RuntimeError(f"{name} failed: CUDA error {err} ({text})")
