"""Build and load the port's hand-written CUDA kernels.

Each source in ``repro_torch/csrc/`` is compiled at first use with
``nvcc`` for ``sm_90a`` into a shared library with a plain C interface,
under ``build/repro_torch/`` at the root of the checkout (ignored by
git), and bound with ``ctypes``.  A library's file name carries a hash of
its own source and of the flags, so an edit to one source rebuilds that
library alone.  Nothing here runs at import time: the CPU tests import
the kernel modules without a compiler.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parents[1] / "build" / "repro_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# argtypes/restype of each exported C function, by name
Signatures = Dict[str, Tuple[Sequence, object]]


def _nvcc() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    found = str(cand) if cand.exists() else shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return found


class CudaLibrary:
    """One ``csrc/<name>.cu`` source, its build and its loaded library.

    ``log`` keeps nvcc's ``-Xptxas -v`` report of the library's build
    (kept beside it, so a library found built has its report too) and
    ``build_s`` the build's seconds (0.0 when an up-to-date library was
    found).  ``source`` may also be a path outside ``csrc/`` (a timing
    script builds another tree's copy of a source)."""

    def __init__(self, source: str, signatures: Signatures):
        self.source = CSRC / source
        self.signatures = signatures
        self.lib: Optional[ctypes.CDLL] = None
        self.log = ""
        self.build_s = 0.0

    def path(self) -> Path:
        digest = hashlib.sha256(self.source.read_bytes()
                                + " ".join(NVCC_FLAGS).encode()).hexdigest()
        return BUILD_DIR / f"lib{self.source.stem}_{digest[:16]}.so"

    def load(self) -> ctypes.CDLL:
        """The loaded library, built first if need be."""
        if self.lib is not None:
            return self.lib
        self.build_s = 0.0
        if not self.path().exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = self.path().with_suffix(f".{os.getpid()}.tmp")
            t0 = time.perf_counter()
            proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                                   str(self.source)], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
            self.log = proc.stdout
            self.build_s = time.perf_counter() - t0
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {self.source}:\n"
                                   f"{self.log}")
            self.path().with_suffix(".log").write_text(self.log)
            os.replace(tmp, self.path())
        elif self.path().with_suffix(".log").exists():
            self.log = self.path().with_suffix(".log").read_text()
        lib = ctypes.CDLL(str(self.path()))
        for fn, (argtypes, restype) in self.signatures.items():
            getattr(lib, fn).argtypes = list(argtypes)
            getattr(lib, fn).restype = restype
        self.lib = lib
        return lib


def build(*libs: CudaLibrary) -> None:
    """Build and load every library in ``libs``, one thread each, so their
    nvcc runs overlap; each one's ``build_s`` says how long its nvcc
    took."""
    with ThreadPoolExecutor(max_workers=max(len(libs), 1)) as pool:
        list(pool.map(CudaLibrary.load, libs))


P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
