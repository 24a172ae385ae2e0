"""Build the CUDA kernels with ``nvcc`` and bind them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain C interface (``nvcc -gencode arch=compute_90a,code=sm_90a -shared``)
under ``_build/`` beside this file, which git ignores. The library's name
carries a digest of its source, the shared ``csrc/*.cuh`` headers and the
flags, so an edited source or header is rebuilt and a stale library is
never loaded. Nothing is built when a module is
imported: a kernel builds at its first launch, or all at once, in parallel,
through :func:`build_all`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc_path() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin/nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin and PATH)")


class CudaKernel:
    """One ``csrc/*.cu`` library, its C entry points, and its launch count.

    ``launches`` is incremented by :meth:`launch` after the kernel was
    enqueued without error, and nowhere else.
    """

    def __init__(self, name: str, replaces: str,
                 funcs: dict[str, list]):
        self.name = name
        self.source = CSRC / f"{name}.cu"
        self.replaces = replaces
        self.funcs = funcs
        self.launches = 0
        self.build_log = ""
        self._lib = None

    @property
    def lib_path(self) -> Path:
        h = hashlib.sha256(self.source.read_bytes())
        for header in sorted(CSRC.glob("*.cuh")):
            h.update(header.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"{self.name}-{h.hexdigest()[:16]}.so"

    def start_build(self) -> subprocess.Popen | None:
        """Start ``nvcc`` for this library unless it is built already."""
        if self.lib_path.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = self.lib_path.with_suffix(f".{os.getpid()}.tmp")
        return subprocess.Popen(
            [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    def finish_build(self, proc: subprocess.Popen | None) -> None:
        if proc is None:
            return
        out, _ = proc.communicate()
        self.build_log = out
        tmp = Path(proc.args[proc.args.index("-o") + 1])
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed for {self.source.name} "
                               f"(exit {proc.returncode}):\n{out}")
        os.replace(tmp, self.lib_path)

    def load(self) -> ctypes.CDLL:
        if self._lib is None:
            self.finish_build(self.start_build())
            lib = ctypes.CDLL(str(self.lib_path))
            for fn, argtypes in self.funcs.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            lib.error_string.argtypes = [ctypes.c_int]
            lib.error_string.restype = ctypes.c_char_p
            self._lib = lib
        return self._lib

    def launch(self, fn: str, *args) -> None:
        """Call C entry point ``fn`` (which enqueues the kernel on the
        current stream and returns ``cudaGetLastError()``); raise if the
        launch was refused."""
        lib = self.load()
        err = getattr(lib, fn)(*args)
        if err != 0:
            raise RuntimeError(f"{self.name}: {fn} failed with CUDA error "
                               f"{err}: {lib.error_string(err).decode()}")
        self.launches += 1


def build_all(kernels) -> None:
    """Build every kernel library at once: one ``nvcc`` per source, all
    started together, then wait for each."""
    procs = [(k, k.start_build()) for k in kernels]
    for k, p in procs:
        k.finish_build(p)


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def check(cond: bool, msg: str) -> None:
    """Validate a wrapper's input; the kernel takes nothing it cannot run."""
    if not cond:
        raise ValueError(msg)
