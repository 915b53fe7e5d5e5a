"""
Build the port's native libraries at first use.

Each `csrc/<name>.cu` (a CUDA kernel) or `csrc/<name>.cpp` (host code)
exposes a plain C interface and is compiled, by nvcc or by g++, into
`build/kernels/lib<name>-<hash>.so` at the repository root (for an
installed package, which ships `csrc/`, in the per-user cache), then loaded
with ctypes (no PyTorch headers, so a build takes seconds).  The hash
covers the source and the flags, so an edited source rebuilds and
`python3 chip_smoke.py` alone builds everything.  A failed build raises
with the compiler's output.  Nothing here runs at import time.
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


def build_dir(root: Path) -> Path:
    """`root/build/kernels` when `root` is a writable source checkout (it
    holds setup.py); otherwise, e.g. for an installed package, the per-user
    cache `$XDG_CACHE_HOME/mcaq_yolo_tpu_torch/kernels` (default ~/.cache)."""
    if (root / "setup.py").exists() and os.access(root, os.W_OK):
        return root / "build" / "kernels"
    cache = os.environ.get("XDG_CACHE_HOME") or Path.home() / ".cache"
    return Path(cache) / "mcaq_yolo_tpu_torch" / "kernels"


BUILD_DIR = build_dir(Path(__file__).resolve().parents[2])
KERNELS = ("spatial_quant", "morph_tiles", "bn_silu")  # CUDA sources, built by nvcc
HOST_LIBRARIES = ("dataio",)  # C++ sources, built by g++

# each kernel's own flags go between the target and the link flags; every
# kernel is held bitwise to a plain version that rounds after every f32
# operation, so none may contract a multiply and an add into an FMA
NVCC_TARGET = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3")
NVCC_LINK = ("-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
KERNEL_FLAGS = {"spatial_quant": ("-fmad=false",), "morph_tiles": ("--fmad=false",),
                "bn_silu": ("--fmad=false",)}
# spatial_quant's flags, unchanged since its first build (its library hash)
NVCC_FLAGS = NVCC_TARGET + KERNEL_FLAGS["spatial_quant"] + NVCC_LINK
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

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


def _cxx() -> str:
    found = shutil.which("g++") or shutil.which("c++")
    if not found:
        raise RuntimeError("g++ not found: the port's host library csrc/dataio.cpp "
                           "needs a C++ compiler")
    return found


def nvcc_flags(name: str) -> tuple:
    """nvcc's flags for the kernel `name`."""
    return NVCC_TARGET + KERNEL_FLAGS[name] + NVCC_LINK


def _source_and_flags(name: str):
    if name in HOST_LIBRARIES:
        return CSRC / f"{name}.cpp", CXX_FLAGS
    return CSRC / f"{name}.cu", nvcc_flags(name)


def library_path(name: str) -> Path:
    src, flags = _source_and_flags(name)
    h = hashlib.sha256(src.read_bytes() + " ".join(flags).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start the compiler for one source; returns (process, tmp path, final
    path) or None when the library is already built."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"tmp{os.getpid()}-{out.name}"
    src, flags = _source_and_flags(name)
    compiler = _cxx() if name in HOST_LIBRARIES else _nvcc()
    cmd = [compiler, *flags, "-o", str(tmp), str(src)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, tmp, out


def _finish(name: str, job) -> None:
    proc, tmp, out = job
    log, _ = proc.communicate()
    (BUILD_DIR / f"{name}.build.log").write_text(log)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        src = _source_and_flags(name)[0].name
        raise RuntimeError(f"the build of {src} failed (exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)


def build_all(names: Iterable[str] = KERNELS) -> Dict[str, Path]:
    """Build every library of `names` that is missing, one compiler per
    source, all started together.  Returns name -> library path."""
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
    """The compiler's output (for a kernel, with -Xptxas -v register
    counts) of the last build of `name`, or '' if it was not built in this
    checkout."""
    p = BUILD_DIR / f"{name}.build.log"
    return p.read_text() if p.exists() else ""
