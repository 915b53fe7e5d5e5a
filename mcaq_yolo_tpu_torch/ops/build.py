"""
Build the port's CUDA kernels at first use.

Each `csrc/<name>.cu` exposes a plain C interface and is compiled by nvcc
into `build/kernels/lib<name>-<hash>.so` at the repository root, then
loaded with ctypes (no PyTorch headers, so a build takes seconds).  The
hash covers the source and the flags, so an edited source rebuilds and
`python3 chip_smoke.py` alone builds everything.  A failed build raises
with nvcc's output.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
KERNELS = ("spatial_quant",)

# -fmad=false: no FMA contraction anywhere in the kernel, so the f32
# arithmetic rounds after every operation exactly as the plain version's
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc for one source; returns (process, tmp path, final path) or
    None when the library is already built."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"tmp{os.getpid()}-{out.name}"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, tmp, out


def _finish(name: str, job) -> None:
    proc, tmp, out = job
    log, _ = proc.communicate()
    (BUILD_DIR / f"{name}.nvcc.log").write_text(log)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)


def build_all(names: Iterable[str] = KERNELS) -> Dict[str, Path]:
    """Build every kernel library that is missing, one nvcc per source, all
    started together.  Returns name -> library path."""
    names = list(names)
    with _lock:
        jobs = {n: _start(n) for n in names}
        try:
            for n, job in jobs.items():
                if job is not None:
                    _finish(n, job)
        finally:
            for job in jobs.values():
                if job is not None and job[0].poll() is None:
                    job[0].kill()
                    job[0].wait()
    return {n: library_path(n) for n in names}


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library for `name`, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        path = build_all([name])[name]
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                lib = ctypes.CDLL(str(path))
                _libs[name] = lib
    return lib


def build_log(name: str) -> str:
    """nvcc's output (including -Xptxas -v register counts) of the last
    build of `name`, or '' if it was not built in this checkout."""
    p = BUILD_DIR / f"{name}.nvcc.log"
    return p.read_text() if p.exists() else ""
