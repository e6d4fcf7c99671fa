"""Build and load the package's CUDA kernels.

All sources under ``csrc/`` are compiled by one ``nvcc`` call into a shared
library with a plain C interface, ``_build/libseld_kernels_<hash>.so``, where
the hash covers the sources and the flags, so an edited source builds anew.
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
NVCC_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# name -> argtypes of each C entry point (all return a cudaError_t as int)
SIGNATURES = {
    # x, table, out, rows, n, n_frames, nperseg, hop, x_dtype, out_dtype, stream
    "seld_stft_mag": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # x, w, scale, bias, out, batch, cin, f, t, cout, pf, dtype, stream
    "seld_conv3x3_smallcin": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "seld_conv3x3_widecin": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # q, k, v, out, lse, batch, t, heads, d, scale, dtype, stream
    "seld_flash_attn_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _P],
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
    """Compile every ``csrc/*.cu`` into ``out``; returns nvcc's log."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *ARCH_FLAGS, *NVCC_FLAGS, "-o", str(tmp),
           *[str(p) for p in sorted(CSRC.glob("*.cu"))]]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    log = proc.stdout + proc.stderr
    out.with_suffix(".log").write_text(" ".join(cmd) + "\n" + log)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
    os.replace(tmp, out)
    return log


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
