"""Build the port's CUDA kernels with ``nvcc`` into a shared library, on first use.

Each library is compiled from the sources under ``csrc/`` for ``sm_90a`` with a
plain C interface and loaded with ``ctypes`` (no PyTorch headers, so a build
takes seconds).  The output lands in ``build/kernels/<hash>/`` at the root of
the checkout, keyed by a hash of the sources and flags, so an edited source
rebuilds and an unchanged one loads the library already there.
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
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


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

    def load(self) -> ctypes.CDLL:
        """Compile (unless an identical build exists) and load the library."""
        if self.handle is not None:
            return self.handle
        digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for src in self.sources:
            digest.update(src.encode())
            digest.update((CSRC / src).read_bytes())
        out_dir = BUILD_ROOT / digest.hexdigest()[:16]
        self.path = out_dir / f"lib{self.name}.so"
        if not self.path.exists():
            out_dir.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
            os.close(fd)
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *(str(CSRC / s) for s in self.sources)]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True)
            self.build_seconds = time.perf_counter() - t0
            self.log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                os.unlink(tmp)
                raise KernelBuildError(f"nvcc failed ({proc.returncode}):\n{self.log}")
            os.replace(tmp, self.path)           # atomic: a concurrent build is safe
        self.handle = ctypes.CDLL(str(self.path))
        return self.handle


PAGED_DECODE = Library("paged_decode_attention", ("paged_decode_attention.cu",))
