"""Build and load the port's CUDA kernels.

Each kernel source in ``kaldi_tpu_torch/csrc/`` exposes a plain C
function.  On first use it is compiled with nvcc for sm_90a into a
shared library under ``build/kaldi_tpu_torch/`` at the repository root
(listed in .gitignore) and loaded with ctypes, the way
``kaldi_tpu_torch.native`` loads its C++.  The headers in csrc/
(``*.cuh``) count as sources of every library: an edit to one rebuilds
them all.  A failed build raises: there is no fallback for a CUDA
tensor.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Sequence, Tuple

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kaldi_tpu_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
# every kernel library of the port: name → sources under csrc/
KERNELS: Dict[str, Tuple[str, ...]] = {"kt_fbank": ("fbank.cu",),
                                       "kt_gmm": ("gmm.cu",),
                                       "kt_chain_den": ("chain_den.cu",)}

_LOCK = threading.Lock()
_NAME_LOCKS: Dict[str, threading.Lock] = {}
_LIBS: Dict[str, ctypes.CDLL] = {}
# compiler output (ptxas register / shared-memory report) of each build
BUILD_LOG: Dict[str, str] = {}


def nvcc_path() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def load_library(name: str, sources: Sequence[str]) -> ctypes.CDLL:
    """Compile ``sources`` (file names under csrc/) into
    lib<name>.so unless an up-to-date build exists, then load it.
    Libraries of different names build concurrently."""
    with _LOCK:
        lock = _NAME_LOCKS.setdefault(name, threading.Lock())
    with lock:
        lib = _LIBS.get(name)
        if lib is not None:
            return lib
        srcs = [os.path.join(CSRC_DIR, s) for s in sources]
        deps = srcs + glob.glob(os.path.join(CSRC_DIR, "*.cuh"))
        so = os.path.join(BUILD_DIR, f"lib{name}.so")
        if (not os.path.exists(so)
                or os.path.getmtime(so) < max(map(os.path.getmtime, deps))):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{so}.{os.getpid()}.tmp"
            res = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", tmp, *srcs],
                                 capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(f"nvcc failed for {name}:\n{res.stderr}")
            os.replace(tmp, so)
            BUILD_LOG[name] = res.stderr
        lib = ctypes.CDLL(so)
        _LIBS[name] = lib
        return lib


def load_all() -> Dict[str, ctypes.CDLL]:
    """Build (one nvcc per library, all started together) and load
    every kernel library."""
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        futs = {n: pool.submit(load_library, n, s)
                for n, s in KERNELS.items()}
        return {n: f.result() for n, f in futs.items()}
