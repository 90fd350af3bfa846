"""Diagonal-GMM log-likelihoods: the CUDA kernel's wrapper and its plain
version.

Port of kaldi_tpu/ops/pallas_gmm.py.  ``CudaGmm`` holds one model's
natural parameters on one device.  Called on a CUDA tensor it launches
``kt_gmm_loglikes`` (csrc/gmm.cu) on the current stream, reading the
layout that the constructor built once (``kernel_layout``: per pdf tile
and slot, the parameters split into TF32 hi/lo in the order the kernel's
tensor-core products read them); called on a CPU tensor it runs
``gmm_loglikes_reference``.  There is no fallback
between the two.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from kaldi_tpu_torch.device import resolve_device
from kaldi_tpu_torch.ops import build
from kaldi_tpu_torch.ops.tf32 import split_tf32

# the sentinel gconst of unused mixture slots (kaldi_tpu.am.gmm _NEG_INF)
NEG = -1.0e30
# csrc/gmm.cu GMM_DMAX: the largest feature dimension the kernel takes
MAX_DIM = 64
# csrc/gmm.cu GMM_PT: pdfs per block
TILE_P = 64


def gmm_loglikes_reference(x: torch.Tensor, gconst: torch.Tensor,
                           mean_invvar: torch.Tensor,
                           inv_var: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel (``gmm_loglikes_xla`` of the
    original): x (T, D), gconst (P, M), mean_invvar / inv_var (P, M, D)
    → (T, P)."""
    P, M, D = mean_invvar.shape
    a = mean_invvar.reshape(P * M, D)
    b = (-0.5 * inv_var).reshape(P * M, D)
    quad = x @ a.T + (x * x) @ b.T
    comp = quad.reshape(-1, P, M) + gconst[None]
    return torch.logsumexp(comp, dim=2)


def kernel_layout(gconst: torch.Tensor, mean_invvar: torch.Tensor,
                  inv_var: torch.Tensor):
    """The kernel's parameter layout, built once per model.  Per tile of
    TILE_P pdfs and slot m, W_m = [a_m; b_m] (K × TILE_P) with a = μ/σ²
    and b = −½/σ² (D zero-padded to Dp, a multiple of 8; K = 2·Dp; pdfs
    past P zero), split into TF32 hi/lo; per k-step of 8 the hi tile then
    the lo tile, each as wgmma's K-major core matrices: [pdf group of 8]
    [k half of 4][pdf][k] (csrc/tf32x3.cuh).  w (P_tiles, M, K/8 · 1024).
    g (P_tiles, M, TILE_P) is gconst, NEG past P.  Both contiguous, on the
    parameters' device."""
    P, M, D = mean_invvar.shape
    Dp = -(-D // 8) * 8
    NPT = -(-P // TILE_P)
    W = mean_invvar.new_zeros((M, 2 * Dp, NPT * TILE_P))
    W[:, :D, :P] = mean_invvar.permute(1, 2, 0)
    W[:, Dp:Dp + D, :P] = (-0.5 * inv_var).permute(1, 2, 0)
    # (M, k-step, k half, k, pdf tile, pdf group, pdf) → (pdf tile, M,
    # k-step, pdf group, k half, pdf, k)
    W = W.reshape(M, Dp // 4, 2, 4, NPT, TILE_P // 8, 8) \
        .permute(4, 0, 1, 5, 2, 6, 3)
    hi, lo = split_tf32(W)
    w = torch.stack([hi, lo], dim=3).reshape(NPT, M, -1).contiguous()
    g = gconst.new_full((M, NPT * TILE_P), NEG)
    g[:, :P] = gconst.T
    return w, g.reshape(M, NPT, TILE_P).permute(1, 0, 2).contiguous()


# guards the ctypes declaration and the launch counts: the servers'
# handler threads launch the kernel concurrently
_LOCK = threading.Lock()


def _load():
    lib = build.load_library("kt_gmm", build.KERNELS["kt_gmm"])
    fn = lib.kt_gmm_loglikes
    with _LOCK:
        if fn.argtypes is None:
            # pointers and the stream as c_void_p (see ops/fbank.py)
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 \
                + [ctypes.c_void_p]
    return fn


class CudaGmm:
    """Per-pdf GMM log-likelihoods of features (T, D) float32 → (T, P).
    ``launches`` counts this instance's kernel launches and the class's
    ``total_launches`` those of every instance (a training run rebuilds
    its tables after every update)."""

    total_launches = 0

    def __init__(self, gconst: np.ndarray, mean_invvar: np.ndarray,
                 inv_var: np.ndarray, device: torch.device | str = "cuda"):
        P, M, D = mean_invvar.shape
        if gconst.shape != (P, M) or inv_var.shape != (P, M, D):
            raise ValueError(f"parameter shapes {gconst.shape}, "
                             f"{mean_invvar.shape}, {inv_var.shape}")
        if torch.device(device).type == "cuda" and D > MAX_DIM:
            raise ValueError(f"the GMM kernel takes feature dims up to "
                             f"{MAX_DIM}, got {D}")
        self.device = resolve_device(device)

        def dev(arr):
            return torch.from_numpy(np.ascontiguousarray(
                arr, dtype=np.float32)).to(self.device)

        self.num_pdfs, self.max_mix, self.dim = P, M, D
        self.gconst = dev(gconst)
        self.mean_invvar = dev(mean_invvar)
        self.inv_var = dev(inv_var)
        # "cuda" → "cuda:<current>", so that it compares equal to the
        # device of a tensor moved there
        self.device = self.gconst.device
        self.w = self.g = None
        if self.device.type == "cuda":
            self.w, self.g = kernel_layout(self.gconst, self.mean_invvar,
                                           self.inv_var)
        self.launches = 0

    def reference(self, x: torch.Tensor) -> torch.Tensor:
        """The plain version on this model's tables."""
        return gmm_loglikes_reference(x, self.gconst, self.mean_invvar,
                                      self.inv_var)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() != 2 or x.shape[1] != self.dim:
            raise ValueError(f"features must be (T, {self.dim}), got "
                             f"{tuple(x.shape)}")
        if x.dtype != torch.float32:
            raise TypeError(f"features must be float32, got {x.dtype}")
        if x.device != self.device:
            raise ValueError(f"features on {x.device}, model on "
                             f"{self.device}")
        if x.device.type == "cpu":
            return self.reference(x)
        if x.device.type != "cuda":
            raise ValueError(f"unsupported device {x.device}")
        if not x.is_contiguous():
            raise ValueError("features must be contiguous")
        fn = _load()
        T = x.shape[0]
        out = torch.empty((T, self.num_pdfs), dtype=torch.float32,
                          device=x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), self.w.data_ptr(), self.g.data_ptr(),
                out.data_ptr(), T, self.dim, -(-self.dim // 8) * 8,
                self.num_pdfs, self.max_mix, stream)
        if rc != 0:
            raise RuntimeError(f"kt_gmm_loglikes failed: cudaError {rc}")
        with _LOCK:
            self.launches += 1
            CudaGmm.total_launches += 1
        return out
