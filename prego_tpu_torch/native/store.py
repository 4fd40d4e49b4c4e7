"""ctypes bindings for the native feature store (``feature_store.cc``), and
its build (port of prego_tpu/native/bindings.py).

The library is compiled with ``g++`` on first use, never at import, into
``build/native`` beside the package (a directory git ignores), named by a
hash of the source and the flags, and reused while both are unchanged. A
file lock keeps concurrent processes from building it twice. The flags
hold no ``-march=native``, so a library built on one host loads on any
other. A build that fails raises: nothing falls back to another data path.

Gathers write into a float32 CPU tensor that the caller may supply
(``out``): its data pointer goes to the native threads, so the caller
keeps the tensor alive, and does not touch it, until the gather's
``wait()`` returns.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

SOURCE = Path(__file__).resolve().with_name("feature_store.cc")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ["-O3", "-fPIC", "-shared", "-pthread", "-std=c++17", "-Wall"]

_lib: Optional[ctypes.CDLL] = None
_i32p = ctypes.POINTER(ctypes.c_int32)
_i64p = ctypes.POINTER(ctypes.c_int64)
_GATHER_ARGS = [ctypes.c_void_p, _i32p, _i64p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_void_p, ctypes.c_int32]


def _cxx() -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("g++ not found: the native feature store needs a C++ compiler to build")
    return cxx


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libprego_native-{h.hexdigest()[:16]}.so"


def build_library() -> Path:
    """Compile the library unless an up-to-date copy exists; raises on a
    failed build."""
    path = library_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "prego_native.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not path.exists():
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.run([_cxx(), *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"g++ failed for {SOURCE.name}:\n{proc.stdout}{proc.stderr}")
            os.replace(tmp, path)
    return path


def load_library() -> ctypes.CDLL:
    """The bound library, built first where needed."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build_library()))
    lib.fs_open.restype = ctypes.c_void_p
    lib.fs_open.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int32, _i32p]
    lib.fs_dims.argtypes = [ctypes.c_void_p, ctypes.c_int32, _i64p, _i64p]
    lib.fs_gather_windows.argtypes = _GATHER_ARGS
    lib.fs_gather_windows_async.restype = ctypes.c_void_p
    lib.fs_gather_windows_async.argtypes = _GATHER_ARGS
    lib.fs_gather_wait.argtypes = [ctypes.c_void_p]
    lib.fs_read_all.argtypes = [ctypes.c_void_p, ctypes.c_int32, ctypes.c_void_p]
    lib.fs_read_rows.argtypes = [ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64,
                                 ctypes.c_int64, ctypes.c_void_p]
    lib.fs_close.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


class PendingGather:
    """An in-flight background gather into ``out``."""

    def __init__(self, lib, ticket, out: torch.Tensor):
        self._lib = lib
        self._ticket = ticket
        self.out = out  # keeps the buffer alive while the native threads write it

    def wait(self) -> torch.Tensor:
        if self._ticket is not None:
            self._lib.fs_gather_wait(self._ticket)
            self._ticket = None
        return self.out

    def __del__(self):
        try:
            self.wait()  # never leave a thread writing into freed memory
        except Exception:
            pass


def _check_out(out: Optional[torch.Tensor], shape) -> torch.Tensor:
    if out is None:
        return torch.empty(shape, dtype=torch.float32)
    if (out.device.type != "cpu" or out.dtype != torch.float32 or not out.is_contiguous()
            or tuple(out.shape) != tuple(shape)):
        raise ValueError(f"out: expected a contiguous float32 CPU tensor of shape {tuple(shape)}, "
                         f"got {out.dtype} {tuple(out.shape)} on {out.device}")
    return out


class NativeFeatureStore:
    """mmap'd .npy files with native parallel window gathering."""

    def __init__(self, paths: Sequence[str], n_threads: int = 4):
        self._lib = load_library()
        self.n_threads = n_threads
        arr = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
        ok = (ctypes.c_int32 * len(paths))()
        self._handle = self._lib.fs_open(arr, len(paths), ok)
        self.ok = np.ctypeslib.as_array(ok).astype(bool).copy()
        self.paths = list(paths)
        self.cols = np.array([self.dims(i)[1] for i in range(len(paths))], np.int64)

    def dims(self, i: int):
        r, c = ctypes.c_int64(), ctypes.c_int64()
        self._lib.fs_dims(self._handle, i, ctypes.byref(r), ctypes.byref(c))
        return r.value, c.value

    def _gather_args(self, vid_idx, starts, window, dim, out):
        vid_idx = np.ascontiguousarray(vid_idx, np.int32)
        starts = np.ascontiguousarray(starts, np.int64)
        if len(vid_idx) != len(starts) or (len(vid_idx) and not (
                0 <= vid_idx.min() and vid_idx.max() < len(self.paths))):
            raise ValueError(f"gather: {len(vid_idx)} file indices in [0, {len(self.paths)}) "
                             f"and as many starts ({len(starts)}) expected")
        if np.any(self.cols[vid_idx] != dim):  # the native rows are written at width dim
            raise ValueError(f"gather: a file of the batch is not {dim} wide (or not mapped)")
        out = _check_out(out, (len(vid_idx), window, dim))
        # the index arrays are read (the async entry copies them) before the call returns
        args = (self._handle, vid_idx.ctypes.data_as(_i32p), starts.ctypes.data_as(_i64p),
                len(vid_idx), window, dim, out.data_ptr(), self.n_threads)
        return args, out

    def gather_windows(self, vid_idx: np.ndarray, starts: np.ndarray, window: int, dim: int,
                       out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Assemble (count, window, dim) float32 windows in parallel into
        ``out`` (allocated if None). Rows outside a file are zero-filled:
        the training zero prefix is a negative start."""
        args, out = self._gather_args(vid_idx, starts, window, dim, out)
        self._lib.fs_gather_windows(*args)
        return out

    def gather_windows_async(self, vid_idx: np.ndarray, starts: np.ndarray, window: int,
                             dim: int, out: Optional[torch.Tensor] = None) -> PendingGather:
        """Start the gather on a native thread and return at once; the
        caller's step runs meanwhile. ``wait()`` before touching ``out``."""
        args, out = self._gather_args(vid_idx, starts, window, dim, out)
        return PendingGather(self._lib, self._lib.fs_gather_windows_async(*args), out)

    def read_all(self, i: int) -> np.ndarray:
        rows, cols = self.dims(i)
        out = np.empty((rows, cols), np.float32)
        self._lib.fs_read_all(self._handle, i, out.ctypes.data)
        return out

    def read_rows(self, i: int, start: int, count: int) -> np.ndarray:
        """Rows [start, start+count) as f32; out-of-range rows zero-filled."""
        _, cols = self.dims(i)
        out = np.empty((count, cols), np.float32)
        self._lib.fs_read_rows(self._handle, i, start, count, out.ctypes.data)
        return out

    def close(self):
        if self._handle:
            self._lib.fs_close(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
