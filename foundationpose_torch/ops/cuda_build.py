"""Build a CUDA source of csrc/ into a shared library at first use.

Each kernel file has a plain C interface and is loaded with ctypes (no
PyTorch headers, so `nvcc` takes seconds). The library lands in
build/foundationpose_torch/ at the repository root, named by a hash of
the source and the flags, so an edited source rebuilds and an unchanged
one loads. A failed build raises with the compiler's output.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "foundationpose_torch")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
BASE_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found on PATH or in /usr/local/cuda/bin")
    return nvcc


class KernelLibrary:
    """One csrc/*.cu file: built and loaded on first `lib()` call.

    `launches` counts kernel launches; the wrapper adds one where it
    launches and nowhere else."""

    def __init__(self, source: str, extra_flags: tuple[str, ...] = ()):
        self.source = source
        self.flags = ARCH_FLAGS + BASE_FLAGS + list(extra_flags)
        self.launches = 0
        self.ptxas_log = ""
        self._lib = None

    def path(self) -> str:
        with open(os.path.join(CSRC_DIR, self.source), "rb") as f:
            digest = hashlib.sha256(f.read() + " ".join(self.flags).encode()).hexdigest()
        stem = os.path.splitext(self.source)[0]
        return os.path.join(BUILD_DIR, f"{stem}-{digest[:16]}.so")

    def build(self) -> str:
        """Compile if the hashed library is missing; returns its path."""
        out = self.path()
        log = out[:-3] + ".log"
        if os.path.exists(out):
            if os.path.exists(log):
                with open(log) as f:
                    self.ptxas_log = f.read()
            return out
        os.makedirs(BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [find_nvcc(), *self.flags, "-o", tmp, os.path.join(CSRC_DIR, self.source)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(
                f"nvcc failed for {self.source} (rc {proc.returncode}):\n"
                f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}"
            )
        self.ptxas_log = proc.stdout + proc.stderr
        with open(log, "w") as f:
            f.write(self.ptxas_log)
        os.replace(tmp, out)
        return out

    def lib(self, declare) -> ctypes.CDLL:
        """The loaded library; `declare(lib)` sets argtypes/restype once."""
        if self._lib is None:
            lib = ctypes.CDLL(self.build())
            declare(lib)
            self._lib = lib
        return self._lib


def check_status(name: str, status: int) -> None:
    """Raise on a nonzero cudaError_t returned by a C launch entry."""
    if status != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {status}")
