"""Chain denominator forward-backward: the CUDA kernels' wrapper and
their plain version.

Replaces the XLA program of kaldi_tpu/am/chain.py ``denominator_logprob``
(a log-space lax.scan differentiated by jax.grad; no Pallas kernel) on
the card.  ``CudaChainDen`` holds one denominator graph packed once on
one device: incoming arcs grouped by destination (CSR, for the forward)
and outgoing arcs grouped by source (for the backward), each arc as
(state | pdf << 16, exp(logw)), with the per-state initial and final
probabilities and self/entry pdfs.  Called on a CUDA tensor it runs
``ChainDenFn``: ``kt_chain_den_forward`` (csrc/chain_den.cu) gives log Z
and keeps each frame's normalized α, max score and normalizer, and the
backward is ``kt_chain_den_backward``, which writes d log Z / d scores.
Called on a CPU tensor it runs ``ChainDenPlainFn``, the same scaled
linear-space recursion and its β pass in plain PyTorch on the same packed
arrays, so the CPU tests hold the kernels' arithmetic against the JAX
package.  There is no fallback between the two.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from kaldi_tpu_torch.core.logging import KaldiError
from kaldi_tpu_torch.device import resolve_device
from kaldi_tpu_torch.ops import build

# csrc/chain_den.cu: an arc packs its state and pdf into 16 bits each
MAX_ID = 65535
# csrc/chain_den.cu DEN_RED: shared floats of the block reductions
_RED = 17


def pack_csr(key: np.ndarray, other: np.ndarray, pdf: np.ndarray,
             w: np.ndarray, num_states: int):
    """Arcs grouped by ``key`` (stable, so each row keeps the arcs'
    order): (row pointers (S + 1,) int32, other | pdf << 16 as int32
    bits, weights float32)."""
    order = np.argsort(key, kind="stable")
    ptr = np.zeros(num_states + 1, np.int64)
    ptr[1:] = np.cumsum(np.bincount(key, minlength=num_states))
    packed = (other[order].astype(np.uint32)
              | (pdf[order].astype(np.uint32) << np.uint32(16)))
    return (ptr.astype(np.int32), packed.view(np.int32),
            w[order].astype(np.float32))


def _unpack(ptr: torch.Tensor, packed: torch.Tensor):
    """(row index, other state, pdf) of every packed arc, int64."""
    counts = (ptr[1:] - ptr[:-1]).long()
    rows = torch.repeat_interleave(
        torch.arange(len(counts), device=ptr.device), counts)
    p = packed.long()
    return rows, p & 0xFFFF, (p >> 16) & 0xFFFF


def _load():
    lib = build.load_library("kt_chain_den", build.KERNELS["kt_chain_den"])
    fwd, bwd = lib.kt_chain_den_forward, lib.kt_chain_den_backward
    if fwd.argtypes is None:
        # pointers and the stream as c_void_p (see ops/fbank.py)
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fwd.restype = bwd.restype = ctypes.c_int
        fwd.argtypes = [P] * 9 + [I] * 4 + [F, F] + [P] * 5 + [P]
        bwd.argtypes = [P] * 9 + [I] * 4 + [F] + [P] * 6 + [P]
        lib.kt_chain_den_smem_limit.restype = ctypes.c_int
        lib.kt_chain_den_smem_limit.argtypes = [I]
    return lib


class ChainDenFn(torch.autograd.Function):
    """log Z (B,) of scores (B, T, P) through the two kernels."""

    @staticmethod
    def forward(ctx, scores, mask, k, leak):
        logz, saved = k._forward(scores, mask, leak)
        ctx.k, ctx.leak = k, leak
        ctx.save_for_backward(scores, mask, *saved)
        return logz

    @staticmethod
    def backward(ctx, gout):
        scores, mask, *saved = ctx.saved_tensors
        grad = ctx.k._backward(scores, mask, saved, gout.contiguous(),
                               ctx.leak)
        return grad, None, None, None


class ChainDenPlainFn(torch.autograd.Function):
    """The kernels' recursion in plain PyTorch (CPU tensors)."""

    @staticmethod
    def forward(ctx, scores, mask, k, leak):
        logz, saved = k._forward_plain(scores, mask, leak)
        ctx.k, ctx.leak = k, leak
        ctx.save_for_backward(scores, mask, *saved)
        return logz

    @staticmethod
    def backward(ctx, gout):
        scores, mask, *saved = ctx.saved_tensors
        return (ctx.k._backward_plain(scores, mask, saved, gout, ctx.leak),
                None, None, None)


class CudaChainDen:
    """One denominator graph packed for the forward-backward kernels.
    ``launches`` counts kernel launches (forward and backward)."""

    def __init__(self, num_states: int, src, dst, pdf, logw, initial,
                 final, self_pdf, entry_pdf,
                 device: torch.device | str = "cuda"):
        self.device = resolve_device(device)
        S = int(num_states)
        src, dst, pdf = (np.asarray(a, np.int64) for a in (src, dst, pdf))
        self_pdf = np.asarray(self_pdf, np.int64)
        entry_pdf = np.asarray(entry_pdf, np.int64)
        self.max_pdf = int(max(pdf.max(), self_pdf.max(), entry_pdf.max()))
        if S > MAX_ID or self.max_pdf > MAX_ID:
            raise KaldiError(f"chain den kernel: {S} states, pdf ids up to "
                             f"{self.max_pdf}; the kernel packs both into "
                             f"16 bits (at most {MAX_ID})")
        w = np.exp(np.asarray(logw, np.float64))
        init = np.exp(np.asarray(initial, np.float64))
        self.num_states = S
        self.init_sum = float(init.astype(np.float32).sum(dtype=np.float64))

        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

        self.in_ptr, self.in_sp, self.in_w = map(
            dev, pack_csr(dst, src, pdf, w, S))
        self.out_ptr, self.out_dp, self.out_w = map(
            dev, pack_csr(src, dst, pdf, w, S))
        self.init = dev(init.astype(np.float32))
        self.fin = dev(np.exp(np.asarray(final, np.float64))
                       .astype(np.float32))
        self.self_pdf = dev(self_pdf.astype(np.int32))
        self.entry_pdf = dev(entry_pdf.astype(np.int32))
        # "cuda" → "cuda:<current>", so that it compares equal to the
        # device of a tensor moved there
        self.device = self.init.device
        self.smem_limit = None
        if self.device.type == "cuda":
            self.smem_limit = _load().kt_chain_den_smem_limit(
                self.device.index)
        self.launches = 0

    def smem_bytes(self, P: int) -> int:
        """Shared memory of the larger (backward) kernel's block."""
        return 4 * (2 * self.num_states + 2 * P + _RED)

    def __call__(self, scores: torch.Tensor, mask: torch.Tensor = None,
                 leak: float = 0.0) -> torch.Tensor:
        """log Z (B,) of scores (B, T, P) float32 under mask (B, T) (None
        = every frame) and leaky-HMM coefficient ``leak``;
        differentiable."""
        if scores.dim() != 3 or scores.shape[2] <= self.max_pdf:
            raise ValueError(f"scores must be (B, T, P > {self.max_pdf}), "
                             f"got {tuple(scores.shape)}")
        if scores.dtype != torch.float32:
            raise TypeError(f"scores must be float32, got {scores.dtype}")
        if scores.device != self.device:
            raise ValueError(f"scores on {scores.device}, graph on "
                             f"{self.device}")
        B, T, P = scores.shape
        if mask is None:
            mask = torch.ones((B, T), dtype=torch.uint8, device=self.device)
        elif mask.shape != (B, T) or mask.device != self.device:
            raise ValueError(f"mask must be ({B}, {T}) on {self.device}, "
                             f"got {tuple(mask.shape)} on {mask.device}")
        else:
            mask = (mask != 0).to(torch.uint8).contiguous()
        if self.device.type == "cpu":
            return ChainDenPlainFn.apply(scores, mask, self, float(leak))
        if self.device.type != "cuda":
            raise ValueError(f"unsupported device {self.device}")
        need = self.smem_bytes(P)
        if need > self.smem_limit:
            raise KaldiError(
                f"chain den kernel: {self.num_states} states and {P} pdfs "
                f"need {need} bytes of shared memory per block, above this "
                f"card's limit of {self.smem_limit}")
        return ChainDenFn.apply(scores.contiguous(), mask, self, float(leak))

    # -- the kernels -------------------------------------------------------
    def _forward(self, scores, mask, leak):
        B, T, P = scores.shape
        S = self.num_states
        f32 = dict(dtype=torch.float32, device=scores.device)
        alpha = torch.empty((B, T, S), **f32)
        zt, mt = torch.empty((B, T), **f32), torch.empty((B, T), **f32)
        fsum, logz = torch.empty(B, **f32), torch.empty(B, **f32)
        stream = torch.cuda.current_stream(scores.device).cuda_stream
        rc = _load().kt_chain_den_forward(
            scores.data_ptr(), mask.data_ptr(), self.in_ptr.data_ptr(),
            self.in_sp.data_ptr(), self.in_w.data_ptr(),
            self.init.data_ptr(), self.fin.data_ptr(),
            self.self_pdf.data_ptr(), self.entry_pdf.data_ptr(), B, T, S, P,
            leak, 1.0 + leak * self.init_sum, alpha.data_ptr(),
            zt.data_ptr(), mt.data_ptr(), fsum.data_ptr(), logz.data_ptr(),
            stream)
        if rc != 0:
            raise RuntimeError(f"kt_chain_den_forward failed: cudaError {rc}")
        self.launches += 1
        return logz, (alpha, zt, mt, fsum)

    def _backward(self, scores, mask, saved, gout, leak):
        alpha, zt, mt, fsum = saved
        B, T, P = scores.shape
        grad = torch.empty_like(scores)
        stream = torch.cuda.current_stream(scores.device).cuda_stream
        rc = _load().kt_chain_den_backward(
            scores.data_ptr(), mask.data_ptr(), self.out_ptr.data_ptr(),
            self.out_dp.data_ptr(), self.out_w.data_ptr(),
            self.init.data_ptr(), self.fin.data_ptr(),
            self.self_pdf.data_ptr(), self.entry_pdf.data_ptr(), B, T,
            self.num_states, P, leak, alpha.data_ptr(), zt.data_ptr(),
            mt.data_ptr(), fsum.data_ptr(), gout.data_ptr(),
            grad.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(f"kt_chain_den_backward failed: cudaError {rc}")
        self.launches += 1
        return grad

    # -- the plain version: the same recursion on the packed arrays --------
    def _forward_plain(self, scores, mask, leak):
        B, T, P = scores.shape
        dst, src, pdf = _unpack(self.in_ptr, self.in_sp)
        init, S = self.init, self.num_states
        sp, ep = self.self_pdf.long(), self.entry_pdf.long()
        alpha = scores.new_empty((B, T, S))
        zt, mt = scores.new_ones((B, T)), scores.new_zeros((B, T))
        logc = torch.zeros(B, dtype=torch.float64)
        a = None
        for t in range(T):
            act = (torch.ones(B, dtype=torch.bool) if t == 0
                   else mask[:, t].bool())
            m = scores[:, t].amax(dim=1)
            e = torch.exp(scores[:, t] - m[:, None])
            if t == 0:
                u = init * (e[:, sp] + e[:, ep])
            else:
                u = scores.new_zeros((B, S)).index_add_(
                    1, dst, a[:, src] * self.in_w * e[:, pdf])
            tot = u.sum(dim=1)
            Z = tot * (1.0 + leak * self.init_sum)
            new = (u + (leak * tot)[:, None] * init) / Z[:, None]
            a = new if t == 0 else torch.where(act[:, None], new, a)
            alpha[:, t] = a
            zt[:, t] = torch.where(act, Z, 1.0)
            mt[:, t] = torch.where(act, m, 0.0)
            logc += torch.where(act, m.double() + torch.log(Z.double()), 0.0)
        fsum = (a * self.fin).sum(dim=1)
        logz = (logc + torch.log(fsum.double())).to(scores.dtype)
        return logz, (alpha, zt, mt, fsum)

    def _backward_plain(self, scores, mask, saved, gout, leak):
        alpha, zt, mt, fsum = saved
        B, T, P = scores.shape
        src, dst, pdf = _unpack(self.out_ptr, self.out_dp)
        init = self.init
        sp, ep = self.self_pdf.long(), self.entry_pdf.long()
        grad = scores.new_zeros((B, T, P))
        beta = self.fin[None, :] / fsum[:, None]
        for t in range(T - 1, -1, -1):
            if t > 0 and not bool(mask[:, t].any()):
                continue
            act = (torch.ones(B, dtype=torch.bool) if t == 0
                   else mask[:, t].bool())
            gam = beta + leak * (beta * init).sum(dim=1, keepdim=True)
            e = torch.exp(scores[:, t] - mt[:, t, None])
            inv_z = (1.0 / zt[:, t])[:, None]
            g = scores.new_zeros((B, P))
            if t == 0:
                c = init * gam * inv_z
                g.index_add_(1, sp, c * e[:, sp])
                g.index_add_(1, ep, c * e[:, ep])
            else:
                v = self.out_w * e[:, pdf] * gam[:, dst]
                g.index_add_(1, pdf, alpha[:, t - 1][:, src] * v * inv_z)
                nb = scores.new_zeros(beta.shape).index_add_(1, src, v) * inv_z
                beta = torch.where(act[:, None], nb, beta)
            grad[:, t] = torch.where(act[:, None], g, 0.0) * gout[:, None]
        return grad
