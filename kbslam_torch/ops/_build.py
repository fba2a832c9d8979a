"""Build the port's CUDA kernels at first use and load them with ctypes.

``kbslam_torch/csrc/*.cu`` compile with ``nvcc`` for ``sm_90a``, one
``nvcc`` process per source, all started together, and link into one
shared library with a plain C interface, under ``build/kbslam_torch/``
at the repository root. The file name carries a hash of the sources and
flags, so an edit rebuilds and an unchanged tree loads the cached
library. A machine with a CUDA device but no ``nvcc`` gets an error:
there is no fallback.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import NamedTuple

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kbslam_torch"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                 "-Xptxas", "-v")
LINK_FLAGS = (*ARCH_FLAGS, "-shared")


class BuildResult(NamedTuple):
    """The loaded library, with how it was obtained (for reports)."""

    lib: ctypes.CDLL
    path: Path
    seconds: float
    cached: bool
    log: str        # nvcc's output (register use), empty when cached


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH, else the toolkit
    PyTorch itself found; raises when there is none."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        candidates.append(Path(CUDA_HOME) / "bin" / "nvcc")
    for c in candidates:
        if c.is_file() and os.access(c, os.X_OK):
            return str(c)
    raise RuntimeError(
        "kbslam_torch needs nvcc to build its CUDA kernels "
        "(kbslam_torch/csrc/*.cu); set CUDA_HOME or put nvcc on PATH")


def _sources():
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def _digest(nvcc: str) -> str:
    h = hashlib.sha256()
    h.update(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode())
    h.update(nvcc.encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.kbslam_extract_patches.argtypes = [p, p, p, p, p, i, i, i, i, i, p]
    lib.kbslam_extract_patches.restype = i
    lib.kbslam_describe_keypoints.argtypes = [p, p, p, p, p, p, p,
                                              i, i, i, i, i, i, p]
    lib.kbslam_describe_keypoints.restype = i
    f, ll = ctypes.c_float, ctypes.c_longlong
    lib.kbslam_icp_fetch.argtypes = [p, p, i, ll, p, i, p, p, p, p, i, p, p,
                                     i, i, i, f, f, f, f, f, f, p, p, p, p,
                                     p, p]
    lib.kbslam_icp_fetch.restype = i
    lib.kbslam_stage_mark.argtypes = [p, i, p]
    lib.kbslam_stage_mark.restype = i
    lib.kbslam_cuda_error_string.argtypes = [i]
    lib.kbslam_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _compile_and_link(nvcc: str, tmp: Path) -> str:
    """Every .cu to an object, in parallel, then one shared library
    ``tmp/lib.so``; returns nvcc's output."""
    jobs = []
    for src in (s for s in _sources() if s.suffix == ".cu"):
        obj = tmp / f"{src.stem}.o"
        jobs.append((obj, subprocess.Popen(
            [nvcc, *COMPILE_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = "", []
    for obj, proc in jobs:
        log += proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(obj.stem)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
    link = subprocess.run([nvcc, *LINK_FLAGS, "-o", str(tmp / "lib.so"),
                           *(str(obj) for obj, _ in jobs)],
                          capture_output=True, text=True)
    log += link.stdout + link.stderr
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{log}")
    return log


@functools.lru_cache(maxsize=None)
def build() -> BuildResult:
    """Compile (or reuse) and load the kernel library."""
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    target = BUILD_DIR / f"libkbslam_torch-{_digest(nvcc)}.so"
    t0 = time.perf_counter()
    log = ""
    cached = target.exists()
    if not cached:
        # build in a private directory, then rename: concurrent builders
        # (several test processes) never load a half-written library
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            log = _compile_and_link(nvcc, Path(tmp))
            os.replace(Path(tmp) / "lib.so", target)
    lib = _declare(ctypes.CDLL(str(target)))
    return BuildResult(lib, target, time.perf_counter() - t0, cached, log)
