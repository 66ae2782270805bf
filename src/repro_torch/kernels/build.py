"""Build the CUDA kernels in ``csrc/`` with nvcc at first use, and load them.

Each ``csrc/*.cu`` file is compiled on its own into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds, not
minutes), all sources at once in parallel::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o <name>.so csrc/<name>.cu

The libraries go into ``build/repro_torch/<hash>/`` at the root of the
checkout (git-ignored), keyed by a hash of every source and the flags, so a
changed source rebuilds and an unchanged one is reused within a checkout.
ptxas's register and shared-memory report for each source is kept beside
its library as ``<name>.log``.  They are loaded with ``ctypes``; pointers
and the stream pass as ``c_void_p``, integers as ``c_int`` (strides as
``c_longlong``), and every entry point returns ``cudaGetLastError()``,
which :meth:`CudaKernel.call` turns into an exception.

Nothing is built or loaded at import: the CPU tests import every module.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

P = ctypes.c_void_p   # device pointer or stream
I = ctypes.c_int
L = ctypes.c_longlong   # a stride in elements


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the gang kernels are built from "
                           "source with the CUDA toolkit")
    return path


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.iterdir()):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build_dir() -> Path:
    return BUILD_ROOT / _digest()


def build_all() -> Path:
    """Compile every source not yet built for the current hash, all nvcc
    processes started together; raise with the compiler's output if any
    fails.  Returns the build directory."""
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    pending = []
    for src in sorted(CSRC.glob("*.cu")):
        lib = out / f"{src.stem}.so"
        if lib.exists():
            continue
        tmp = out / f"{src.stem}.{os.getpid()}.tmp.so"
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        pending.append((src, lib, tmp, proc))
    errors = []
    for src, lib, tmp, proc in pending:
        log, _ = proc.communicate()
        (out / f"{src.stem}.log").write_text(log)
        if proc.returncode != 0:
            errors.append(f"{src.name}: nvcc exited {proc.returncode}\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, lib)
    if errors:
        raise RuntimeError("kernel build failed:\n" + "\n".join(errors))
    return out


_LIBS: Dict[str, ctypes.CDLL] = {}


def library(stem: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<stem>.cu`` (built on first use)."""
    lib = _LIBS.get(stem)
    if lib is None:
        lib = _LIBS[stem] = ctypes.CDLL(str(build_all() / f"{stem}.so"))
    return lib


class CudaKernel:
    """One hand-written kernel: its source, its C entry points and the
    count of its launches.  The wrapper that launches the kernel bumps
    ``launches`` once per launch of it; nothing else does."""

    def __init__(self, name: str, source: str, replaces: str,
                 entries: Dict[str, Sequence]) -> None:
        self.name = name
        self.source = source          # path of the .cu in the repo
        self.replaces = replaces      # file:line of the TPU kernel
        self.launches = 0
        self._entries = {k: list(v) for k, v in entries.items()}
        self._fns: Dict[str, object] = {}

    def _fn(self, entry: str):
        fn = self._fns.get(entry)
        if fn is None:
            fn = getattr(library(Path(self.source).stem), entry)
            fn.argtypes = self._entries[entry]
            fn.restype = ctypes.c_int
            self._fns[entry] = fn
        return fn

    def call(self, entry: str, *args) -> None:
        rc = self._fn(entry)(*args)
        if rc != 0:
            raise RuntimeError(f"{self.name}: {entry} failed with cudaError "
                               f"{rc}")


def ptxas_reports() -> List[str]:
    """The ptxas lines (registers, shared memory, spills) of every built
    source, for printing from a chip run."""
    lines = []
    for log in sorted(build_dir().glob("*.log")):
        lines += [f"{log.stem}: {ln.strip()}" for ln in log.read_text().splitlines()
                  if "ptxas" in ln and ("Used" in ln or "spill" in ln)]
    return lines
