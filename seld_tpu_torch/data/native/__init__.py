"""The ``.seldpak`` dataset container: writer, C++ reader, batch gather.

The port's own copy of ``seld_tpu/data/native`` (the JAX package's,
``__init__.py:30-222``): ``pack_dataset`` converts the reference's six-pickle
layout into one flat container once; :class:`PakReader` memory-maps it (O(1)
startup against a full pickle load, reference train.py:226-237) and gathers
shuffled batches in C++ (``seldio_gather_rows``, ``loader.cc`` beside this
file). The on-disk format is the JAX package's (``SELDPAK1``, payloads
64-byte aligned), so a file written by either package reads in the other.

``loader.cc`` is compiled with ``g++`` at first use into
``seld_tpu_torch/_build/libseldio_<hash>.so`` (the hash covers the source and
the command, so an edited source builds anew). There is no fallback: a
failed build raises. :meth:`PakReader.gather_plain`, a numpy gather from a
memory map of the same file, is the plain version the tests hold the C++
gather to.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pickle
import shutil
import struct
import subprocess
import threading
from pathlib import Path
from typing import Sequence, Tuple

import numpy as np

MAGIC = b"SELDPAK1"
ALIGN = 64
MAX_DIMS = 8   # loader.cc's kMaxDims
SRC = Path(__file__).resolve().parent / "loader.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "_build"
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_lock = threading.Lock()
_lib = None


def library_path(cxx: str) -> Path:
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join([cxx, *CXX_FLAGS]).encode())
    return BUILD_DIR / f"libseldio_{h.hexdigest()[:16]}.so"


def build_library(cxx: str | None = None) -> Path:
    """Compile ``loader.cc`` with ``g++`` (or ``cxx``) unless this source's
    library is already built; returns its path. Raises if the compiler is
    missing or fails. Several processes may build at once: each writes a file
    of its own and renames it into place."""
    cxx = cxx or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found on PATH: the .seldpak reader cannot be built")
    out = library_path(cxx)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [cxx, *CXX_FLAGS, str(SRC), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    except OSError as e:
        raise RuntimeError(f"{' '.join(cmd)} could not run: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{' '.join(cmd)} failed ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def load_library() -> ctypes.CDLL:
    """The reader library, built on first use, with its entry points typed."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build_library()))
        i64, p = ctypes.c_int64, ctypes.c_void_p
        lib.seldio_open.restype = p
        lib.seldio_open.argtypes = [ctypes.c_char_p]
        lib.seldio_close.argtypes = [p]
        lib.seldio_num_tensors.restype = i64
        lib.seldio_num_tensors.argtypes = [p]
        lib.seldio_tensor_info.restype = ctypes.c_int
        lib.seldio_tensor_info.argtypes = [p, i64, ctypes.POINTER(i64), ctypes.POINTER(i64),
                                           ctypes.POINTER(i64)]
        lib.seldio_tensor_data.restype = p
        lib.seldio_tensor_data.argtypes = [p, i64]
        lib.seldio_gather_rows.restype = ctypes.c_int
        lib.seldio_gather_rows.argtypes = [p, i64, ctypes.POINTER(i64), i64, p]
        _lib = lib
        return lib


def write_pak(path: str, tensors: Sequence[np.ndarray]) -> None:
    """Write float32 tensors into the .seldpak container format."""
    tensors = [np.ascontiguousarray(t, dtype=np.float32) for t in tensors]
    if any(t.ndim > MAX_DIMS for t in tensors):
        raise ValueError(f"the container holds tensors of at most {MAX_DIMS} dimensions")
    header = bytearray(MAGIC) + struct.pack("<q", len(tensors))
    # the header's size first: a fixed record per tensor
    offset = len(header) + sum(8 + 8 * t.ndim + 8 * 3 for t in tensors)
    offsets = []
    for t in tensors:
        offset = (offset + ALIGN - 1) // ALIGN * ALIGN
        offsets.append(offset)
        offset += t.nbytes
    for t, off in zip(tensors, offsets):
        header += struct.pack(f"<q{t.ndim}q", t.ndim, *t.shape)
        header += struct.pack("<qqq", 0, off, t.nbytes)
    with open(path, "wb") as f:
        f.write(header)
        for t, off in zip(tensors, offsets):
            f.seek(off)
            f.write(t.tobytes())


def pack_dataset(cfg, out_path: str) -> str:
    """Convert the six-pickle Task-2 layout of ``cfg``'s ``*_path`` flags
    into one .seldpak file. Tensor order: train_x, train_y, val_x, val_y,
    test_x, test_y (:attr:`PakReader.SPLITS`)."""
    paths = [cfg.training_predictors_path, cfg.training_target_path,
             cfg.validation_predictors_path, cfg.validation_target_path,
             cfg.test_predictors_path, cfg.test_target_path]
    tensors = []
    for p in paths:
        with open(p, "rb") as f:
            tensors.append(np.asarray(pickle.load(f), dtype=np.float32))
    write_pak(out_path, tensors)
    return out_path


def read_header(path: str) -> list:
    """[(shape, byte offset, byte length)] of every tensor, read in Python."""
    with open(path, "rb") as f:
        if f.read(8) != MAGIC:
            raise ValueError(f"{path} is not a .seldpak file")
        (n,) = struct.unpack("<q", f.read(8))
        metas = []
        for _ in range(n):
            (ndim,) = struct.unpack("<q", f.read(8))
            shape = struct.unpack(f"<{ndim}q", f.read(8 * ndim))
            _, off, nbytes = struct.unpack("<qqq", f.read(24))
            metas.append((shape, off, nbytes))
    return metas


class PakReader:
    """A .seldpak file memory-mapped by the C++ reader, with its batch gather."""

    SPLITS = {"train": (0, 1), "val": (2, 3), "test": (4, 5)}

    def __init__(self, path: str):
        if not os.path.isfile(path):
            raise FileNotFoundError(f".seldpak file not found: {path!r}")
        self.path = str(path)
        self._lib = load_library()
        self._handle = self._lib.seldio_open(self.path.encode())
        if not self._handle:
            raise ValueError(f"{path} is not a readable .seldpak file (magic, header or "
                             "payloads past its end)")
        self._plain = None

    def num_tensors(self) -> int:
        return int(self._lib.seldio_num_tensors(self._handle))

    def _index(self, idx: int) -> int:
        if not 0 <= idx < self.num_tensors():
            raise IndexError(f"tensor {idx} of {self.num_tensors()}")
        return idx

    def shape(self, idx: int) -> Tuple[int, ...]:
        ndim, dtype = ctypes.c_int64(), ctypes.c_int64()
        shape = (ctypes.c_int64 * MAX_DIMS)()
        rc = self._lib.seldio_tensor_info(self._handle, self._index(idx), ctypes.byref(ndim),
                                          shape, ctypes.byref(dtype))
        if rc != 0:
            raise RuntimeError(f"seldio_tensor_info failed: {rc}")
        return tuple(shape[i] for i in range(ndim.value))

    def tensor(self, idx: int) -> np.ndarray:
        """Zero-copy view of a whole tensor, valid while this reader is open:
        copy (``np.array``) anything that must outlive it."""
        shape = self.shape(idx)
        ptr = self._lib.seldio_tensor_data(self._handle, idx)
        n = int(np.prod(shape))
        if n == 0:
            return np.empty(shape, np.float32)
        buf = (ctypes.c_float * n).from_address(ptr)
        return np.frombuffer(buf, dtype=np.float32).reshape(shape)

    def gather(self, idx: int, indices: np.ndarray) -> np.ndarray:
        """Rows ``indices`` of tensor ``idx`` into a fresh float32 buffer, by
        ``seldio_gather_rows``; a row out of range raises."""
        shape = self.shape(idx)
        indices = np.ascontiguousarray(indices, dtype=np.int64)
        out = np.empty((len(indices), *shape[1:]), dtype=np.float32)
        rc = self._lib.seldio_gather_rows(
            self._handle, idx, indices.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(indices), out.ctypes.data_as(ctypes.c_void_p))
        if rc != 0:
            raise IndexError(f"seldio_gather_rows failed ({rc}): rows {indices.tolist()} of "
                             f"tensor {idx} {shape}")
        return out

    def gather_plain(self, idx: int, indices: np.ndarray) -> np.ndarray:
        """The plain version of :meth:`gather`: ``np.take`` on a numpy memory
        map of the same file, its header read in Python."""
        if self._plain is None:
            mm = np.memmap(self.path, dtype=np.uint8, mode="r")
            self._plain = [mm[off:off + nbytes].view(np.float32).reshape(shape)
                           for shape, off, nbytes in read_header(self.path)]
        return np.take(self._plain[idx], np.asarray(indices, np.int64), axis=0)

    def split(self, name: str) -> Tuple[np.ndarray, np.ndarray]:
        """(x, y) views of split ``name`` ('train', 'val' or 'test')."""
        xi, yi = self.SPLITS[name]
        return self.tensor(xi), self.tensor(yi)

    def close(self) -> None:
        if self._handle:
            self._lib.seldio_close(self._handle)
            self._handle = None
        self._plain = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        if getattr(self, "_handle", None):
            self.close()
