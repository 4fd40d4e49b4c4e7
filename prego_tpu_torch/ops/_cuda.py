"""Build and bind the port's CUDA kernels (``prego_tpu_torch/csrc``).

Each ``.cu`` file is compiled on first use with ``nvcc`` for ``sm_90a``
into its own shared library with a plain C interface, loaded with
``ctypes``: no PyTorch headers, so a build takes seconds. Libraries are
named by a hash of their sources and flags, go to ``build/kernels`` beside
the package (a directory git ignores), and are reused while the sources
are unchanged. A file lock keeps concurrent processes from building the
same library twice.

Every entry point returns the ``cudaError_t`` of its launches; ``call``
raises on anything but 0. Nothing here falls back to another path.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo",
]

c_ptr = ctypes.c_void_p
c_int = ctypes.c_int
c_float = ctypes.c_float


def _nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"), "/usr/local/cuda"):
        if home and Path(home, "bin", "nvcc").exists():
            return str(Path(home, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit to build")
    return found


class CudaKernel:
    """One kernel library: its source, its C entry points, and the count of
    launches the wrapper made through it (``launches``). ``instances`` holds
    every library made, so a caller can read all the counts."""

    instances: List["CudaKernel"] = []

    def __init__(self, name: str, source: str, functions: Dict[str, Sequence]):
        self.name = name
        self.source = CSRC / source
        self.functions = functions  # entry point -> ctypes argtypes
        self.launches = 0
        self.build_log = ""
        self._lib = None
        CudaKernel.instances.append(self)

    def _sources(self) -> List[Path]:
        return [self.source, *sorted(CSRC.glob("*.cuh"))]  # any header may be included

    def library_path(self) -> Path:
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for p in self._sources():
            h.update(p.read_bytes())
        return BUILD_DIR / f"lib{self.name}-{h.hexdigest()[:16]}.so"

    def build(self) -> Path:
        """Compile the library unless an up-to-date copy exists."""
        path = self.library_path()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with open(BUILD_DIR / f"{self.name}.lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if not path.exists():
                tmp = path.with_suffix(f".{os.getpid()}.tmp")
                proc = subprocess.run(
                    [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)],
                    capture_output=True, text=True,
                )
                self.build_log = proc.stdout + proc.stderr
                if proc.returncode != 0:
                    raise RuntimeError(f"nvcc failed for {self.source.name}:\n{self.build_log}")
                os.replace(tmp, path)
                path.with_suffix(".log").write_text(self.build_log)
            elif path.with_suffix(".log").exists():
                self.build_log = path.with_suffix(".log").read_text()
        return path

    def lib(self):
        if self._lib is None:
            lib = ctypes.CDLL(str(self.build()))
            for fn, argtypes in self.functions.items():
                getattr(lib, fn).argtypes = list(argtypes)
                getattr(lib, fn).restype = c_int
            lib.prego_error_string.argtypes = [c_int]
            lib.prego_error_string.restype = ctypes.c_char_p
            self._lib = lib
        return self._lib

    def call(self, fn: str, *args) -> None:
        lib = self.lib()
        err = getattr(lib, fn)(*args)
        if err != 0:
            msg = lib.prego_error_string(err).decode()
            raise RuntimeError(f"{self.name}: {fn} failed with CUDA error {err} ({msg})")


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


class Workspace:
    """Buffers that a kernel keeps between calls, one set per (device,
    stream): the calls on a stream use them in stream order. ``dtype`` and
    ``zero`` are one value for every buffer of a set, or a tuple with one
    value a buffer (say f32 partial sums beside int32 counters that must be
    zero). A set is allocated anew (zeroed where ``zero``; its kernel then
    leaves it zero) only when a call needs more elements than it holds.

    A CUDA graph keeps the addresses of the set it captured. A set that a
    capture has used is therefore never freed: when a later call outgrows
    it, it is kept in ``retired`` beside its successor, so that a replay
    still writes into memory of its own (and finds its counters as its
    kernels left them, zero)."""

    def __init__(self, dtype, zero=False):
        self.dtype = dtype
        self.zero = zero
        # (device, stream) -> (buffers, their sizes, whether a capture used them)
        self.held: Dict[Tuple[int, int], Tuple[List[torch.Tensor], Tuple[int, ...], bool]] = {}
        self.retired: List[List[torch.Tensor]] = []

    def get(self, device: torch.device, stream: int, *sizes: int) -> List[torch.Tensor]:
        key = (device.index, stream)
        bufs, held, captured = self.held.get(key, (None, (), False))
        if bufs is None or any(n > h for n, h in zip(sizes, held)):
            if captured:
                self.retired.append(bufs)
            held = tuple(max(n, h) for n, h in zip(sizes, held or (0,) * len(sizes)))
            per = lambda v, i: v[i] if isinstance(v, tuple) else v
            bufs = [(torch.zeros if per(self.zero, i) else torch.empty)(
                        n, dtype=per(self.dtype, i), device=device)
                    for i, n in enumerate(held)]
            captured = False
        self.held[key] = (bufs, held, captured or _capturing(device))
        return bufs


def _capturing(device: torch.device) -> bool:
    """Whether the current stream of ``device`` is capturing a CUDA graph."""
    return device.type == "cuda" and torch.cuda.is_current_stream_capturing()


def check_cuda_tensor(name: str, t: torch.Tensor, dtype: torch.dtype, shape=None) -> None:
    """Raise unless ``t`` is a contiguous, 16-byte aligned CUDA tensor of
    ``dtype`` and ``shape`` (the kernels read with vector loads)."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got one on {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: expected a 16-byte aligned tensor (a view at an offset?)")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
