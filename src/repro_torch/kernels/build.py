"""Build the port's CUDA kernels with ``nvcc`` into one shared library, on first use.

The library is compiled from the sources under ``csrc/`` for ``sm_90a`` with a
plain C interface and loaded with ``ctypes`` (no PyTorch headers, so a build
takes seconds).  Every source gets its own ``nvcc``, all started together,
and one more links the objects.  The output lands in ``build/kernels/<hash>/``
at the root of the checkout, keyed by a hash of the sources, the shared
headers and the flags, so an edited source rebuilds and an unchanged one
loads the library already there.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a source."""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise KernelBuildError("nvcc not found: put it on PATH or set CUDA_HOME")
    return str(path)


class Library:
    """One compiled shared library: its handle, path, build seconds and log."""

    def __init__(self, name: str, sources: tuple[str, ...]):
        self.name = name
        self.sources = sources
        self.handle: ctypes.CDLL | None = None
        self.path: Path | None = None
        self.build_seconds = 0.0
        self.log = ""
        self._functions: dict = {}

    def load(self) -> ctypes.CDLL:
        """Compile (unless an identical build exists) and load the library."""
        if self.handle is not None:
            return self.handle
        digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for src in (*self.sources, *sorted(p.name for p in CSRC.glob("*.cuh"))):
            digest.update(src.encode())
            digest.update((CSRC / src).read_bytes())
        out_dir = BUILD_ROOT / digest.hexdigest()[:16]
        self.path = out_dir / f"lib{self.name}.so"
        if not self.path.exists():
            out_dir.mkdir(parents=True, exist_ok=True)
            t0 = time.perf_counter()
            with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
                objs = [f"{tmp}/{Path(s).stem}.o" for s in self.sources]
                procs = [subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-c", "-o", o, str(CSRC / s)],
                                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                          text=True)
                         for s, o in zip(self.sources, objs)]
                self.log = "".join(p.communicate()[0] for p in procs)
                so = f"{tmp}/lib.so"
                ok = all(p.returncode == 0 for p in procs)
                if ok:
                    link = subprocess.run([_nvcc(), *NVCC_FLAGS[:2], "-shared", "-o", so, *objs],
                                          capture_output=True, text=True)
                    self.log += link.stdout + link.stderr
                    ok = link.returncode == 0
                if not ok:
                    raise KernelBuildError(f"nvcc failed:\n{self.log}")
                os.replace(so, self.path)        # atomic: a concurrent build is safe
            self.build_seconds = time.perf_counter() - t0
        self.handle = ctypes.CDLL(str(self.path))
        return self.handle

    def function(self, name: str, n_ptr: int, n_int: int):
        """The C entry point ``name`` (loading the library first), typed as
        ``n_ptr`` pointers, ``n_int`` ints and the stream, returning an int."""
        fn = self._functions.get(name)
        if fn is None:
            fn = getattr(self.load(), name)
            fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            self._functions[name] = fn
        return fn


KERNELS = Library("kernels", ("paged_decode_attention.cu", "decode_attention.cu",
                              "mamba_scan.cu", "mamba_scan_bwd.cu"))
