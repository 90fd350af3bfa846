"""Chain denominator forward-backward: the CUDA kernels' wrapper and
their plain version.

Replaces the XLA program of kaldi_tpu/am/chain.py ``denominator_logprob``
(a log-space lax.scan differentiated by jax.grad; no Pallas kernel) on
the card.  ``CudaChainDen`` holds one denominator graph packed once on
one device: its arcs sorted by destination (the forward's table) and by
source (the backward's), each arc as (key, other state | pdf << 16,
exp(logw)) with the key the state it is sorted by, padded with
zero-weight arcs to the kernels' stride; and the per-state initial and
final probabilities and self/entry pdfs.  Called on a CUDA tensor it
runs ``ChainDenFn``: ``kt_chain_den_forward`` (csrc/chain_den.cu) gives
log Z and keeps each frame's normalized α, max score and normalizer, and
the backward is ``kt_chain_den_backward``, which writes d log Z /
d scores.  Each kernel runs one sequence a block; ``den_plan`` picks,
from the graph's shape and the card's shared memory, whether it
prefetches the next frame's scores.
Called on a CPU tensor it runs ``ChainDenPlainFn``, the same scaled
linear-space recursion and its β pass in plain PyTorch on the same packed
arrays, so the CPU tests hold the kernels' arithmetic against the JAX
package.  There is no fallback between the two.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from kaldi_tpu_torch.core.logging import KaldiError
from kaldi_tpu_torch.device import resolve_device
from kaldi_tpu_torch.ops import build

# csrc/chain_den.cu's layout of the arc tables (tests/test_torch_chain.py
# holds these against the source): an arc packs its states and pdf into
# 16 bits each (KEY_MASK); DEN_STRIDE, the arcs a block streams per step
# (4 a thread); the scan bits of a key word (KEY_SCAN, KEY_CARRY,
# KEY_TAIL)
MAX_ID = 0xFFFF
ARC_STRIDE = 2048
KEY_SCAN = 16
KEY_CARRY = 1 << 21
KEY_TAIL = 1 << 22


def pack_arcs(key: np.ndarray, other: np.ndarray, pdf: np.ndarray,
              w: np.ndarray):
    """Arcs sorted by ``key`` (stable, so each key's run keeps the arcs'
    order), padded to a multiple of ARC_STRIDE with zero-weight arcs on
    the last key: (key words, other | pdf << 16, weights float32; both
    int32 bits of uint32).  A key word holds the key in bits 0-15; the
    first word of each thread's 4 arcs (csrc/chain_den.cu ``sum_by_key``)
    also holds the warp scan's steps over the threads' last runs (bit
    KEY_SCAN + i: the lane 2^i below, and every lane between, continue
    this lane's first key, each holding only that key), KEY_CARRY where
    the thread holds two keys or more and its first continues the lane
    below's last, KEY_TAIL where the thread's last key's run ends in the
    warp."""
    order = np.argsort(key, kind="stable")
    n = len(order)
    A = max(1, -(-n // ARC_STRIDE)) * ARC_STRIDE
    k = np.full(A, key[order][-1] if n else 0, np.uint32)
    k[:n] = key[order]
    kc = k.reshape(-1, 4)
    k0, k3 = kc[:, 0], kc[:, 3]
    split = (kc[:, 1:] != kc[:, :-1]).any(axis=1)
    lane = np.arange(len(kc)) % 32
    joins = (lane > 0) & (k0 == np.roll(k3, 1))
    cont = (joins & ~split).reshape(-1, 32)
    run = np.zeros(cont.shape, np.int64)   # lanes in a row that continue
    for j in range(1, 32):
        run[:, j] = np.where(cont[:, j], run[:, j - 1] + 1, 0)
    run = run.reshape(-1)
    bits = np.zeros(len(kc), np.uint32)
    for i in range(5):
        bits |= (run >= 1 << i).astype(np.uint32) << np.uint32(KEY_SCAN + i)
    bits |= np.where(joins & split, KEY_CARRY, 0).astype(np.uint32)
    tail = (lane == 31) | (np.roll(k0, -1) != k3)
    bits |= np.where(tail, KEY_TAIL, 0).astype(np.uint32)
    words = k.copy()
    words[0::4] |= bits
    op = np.zeros(A, np.uint32)
    op[:n] = (other[order].astype(np.uint32)
              | (pdf[order].astype(np.uint32) << np.uint32(16)))
    ww = np.zeros(A, np.float32)
    ww[:n] = w[order]
    return words.view(np.int32), op.view(np.int32), ww


def _unpack(key: torch.Tensor, packed: torch.Tensor):
    """(key, other state, pdf) of every packed arc, int64."""
    p = packed.long()
    return (key.long() & MAX_ID, p & MAX_ID, (p >> 16) & MAX_ID)


@dataclasses.dataclass(frozen=True)
class DenPlan:
    """Whether each kernel prefetches the next frame's scores."""
    fwd_pref: bool
    bwd_pref: bool


def den_plan(S: int, P: int, smem_limit: int, smem_bytes) -> DenPlan:
    """For each kernel, the score prefetch where its block's shared
    memory with it, ``smem_bytes(backward, S, P, pref)`` (on the card
    the library's ``kt_chain_den_smem_bytes``), fits in ``smem_limit``.
    Raises KaldiError where not even the block without it fits."""

    def pick(backward):
        for pref in (1, 0):
            if smem_bytes(backward, S, P, pref) <= smem_limit:
                return bool(pref)
        raise KaldiError(
            f"chain den kernel: {S} states and {P} pdfs need "
            f"{smem_bytes(backward, S, P, 0)} bytes of shared memory "
            f"per block, above this card's limit of {smem_limit}")

    return DenPlan(pick(0), pick(1))


def _load():
    lib = build.load_library("kt_chain_den", build.KERNELS["kt_chain_den"])
    fwd, bwd = lib.kt_chain_den_forward, lib.kt_chain_den_backward
    if fwd.argtypes is None:
        # pointers and the stream as c_void_p (see ops/fbank.py)
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fwd.restype = bwd.restype = ctypes.c_int
        fwd.argtypes = [P] * 5 + [I] + [P] * 4 + [I] * 4 + [F, F, I] \
            + [P] * 5 + [P]
        bwd.argtypes = [P] * 5 + [I] + [P] * 4 + [I] * 4 + [F, I] \
            + [P] * 6 + [P]
        lib.kt_chain_den_smem_limit.restype = ctypes.c_int
        lib.kt_chain_den_smem_limit.argtypes = [I]
        lib.kt_chain_den_smem_bytes.restype = ctypes.c_int
        lib.kt_chain_den_smem_bytes.argtypes = [I] * 4
    return lib


class ChainDenFn(torch.autograd.Function):
    """log Z (B,) of scores (B, T, P) through the two kernels, with the
    score prefetch of ``plan`` (None: the wrapper's ``den_plan``)."""

    @staticmethod
    def forward(ctx, scores, mask, k, leak, plan=None):
        logz, saved = k._forward(scores, mask, leak, plan)
        ctx.k, ctx.leak, ctx.plan = k, leak, plan
        ctx.save_for_backward(scores, mask, *saved)
        return logz

    @staticmethod
    def backward(ctx, gout):
        scores, mask, *saved = ctx.saved_tensors
        grad = ctx.k._backward(scores, mask, saved, gout.contiguous(),
                               ctx.leak, ctx.plan)
        return grad, None, None, None, None


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
    ``launches`` counts kernel launches (forward and backward), and the
    class's ``total_launches`` those of every instance (a recipe builds
    its own den graph)."""

    total_launches = 0

    def __init__(self, num_states: int, src, dst, pdf, logw, initial,
                 final, self_pdf, entry_pdf,
                 device: torch.device | str = "cuda"):
        self.device = resolve_device(device)
        S = int(num_states)
        src, dst, pdf = (np.asarray(a, np.int64) for a in (src, dst, pdf))
        self_pdf = np.asarray(self_pdf, np.int64)
        entry_pdf = np.asarray(entry_pdf, np.int64)
        self.max_pdf = int(max(pdf.max(), self_pdf.max(), entry_pdf.max()))
        # the pdfs below max_pdf that the graph does not read (on an arc,
        # or as a state's self or entry pdf at frame 0): mask_unused
        used = np.zeros(self.max_pdf + 1, bool)
        used[np.concatenate([pdf, self_pdf, entry_pdf])] = True
        unused = np.nonzero(~used)[0]
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

        self.num_arcs = len(src)
        # forward: keyed by destination, other = source; backward: the
        # transpose
        self.in_key, self.in_op, self.in_w = map(
            dev, pack_arcs(dst, src, pdf, w))
        self.out_key, self.out_op, self.out_w = map(
            dev, pack_arcs(src, dst, pdf, w))
        self.init = dev(init.astype(np.float32))
        self.fin = dev(np.exp(np.asarray(final, np.float64))
                       .astype(np.float32))
        self.self_pdf = dev(self_pdf.astype(np.int32))
        self.entry_pdf = dev(entry_pdf.astype(np.int32))
        self.unused_pdfs = dev(unused.astype(np.int64))
        # "cuda" → "cuda:<current>", so that it compares equal to the
        # device of a tensor moved there
        self.device = self.init.device
        self.smem_limit = None
        if self.device.type == "cuda":
            self.smem_limit = _load().kt_chain_den_smem_limit(
                self.device.index)
        self.launches = 0

    def plan(self, P: int) -> DenPlan:
        """The kernels' score prefetch for P pdfs on this card."""
        return den_plan(self.num_states, P, self.smem_limit,
                        _load().kt_chain_den_smem_bytes)

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
        scores = self.mask_unused(scores)
        if self.device.type == "cpu":
            return ChainDenPlainFn.apply(scores, mask, self, float(leak))
        if self.device.type != "cuda":
            raise ValueError(f"unsupported device {self.device}")
        self.plan(P)              # raises where the graph does not fit
        return ChainDenFn.apply(scores.contiguous(), mask, self, float(leak))

    def mask_unused(self, scores: torch.Tensor) -> torch.Tensor:
        """scores with the pdfs no arc or state of the graph reads set to
        -inf (differentiable; their gradient is 0).  log Z does not
        depend on them, but both recursions scale each frame by its
        largest score: an unread pdf whose score lies 104 nats or more
        above every read one (nothing in training holds it down) would
        underflow every e_t to 0 and make Z_t 0 (a left-biphone tree can
        have a leaf that no context of the phone LM reaches).  Adds no
        operation where the graph reads every pdf."""
        n = self.max_pdf + 1
        if self.unused_pdfs.numel():
            scores = scores.index_fill(2, self.unused_pdfs, float("-inf"))
        if scores.shape[2] > n:
            scores = torch.cat([scores[..., :n], torch.full_like(
                scores[..., n:], float("-inf"))], dim=2)
        return scores

    # -- the kernels -------------------------------------------------------
    def _forward(self, scores, mask, leak, plan: DenPlan = None):
        B, T, P = scores.shape
        S = self.num_states
        plan = plan or self.plan(P)
        f32 = dict(dtype=torch.float32, device=scores.device)
        alpha = torch.empty((B, T, S), **f32)
        zt, mt = torch.empty((B, T), **f32), torch.empty((B, T), **f32)
        fsum, logz = torch.empty(B, **f32), torch.empty(B, **f32)
        stream = torch.cuda.current_stream(scores.device).cuda_stream
        rc = _load().kt_chain_den_forward(
            scores.data_ptr(), mask.data_ptr(), self.in_key.data_ptr(),
            self.in_op.data_ptr(), self.in_w.data_ptr(), self.in_w.numel(),
            self.init.data_ptr(), self.fin.data_ptr(),
            self.self_pdf.data_ptr(), self.entry_pdf.data_ptr(),
            B, T, S, P, leak, 1.0 + leak * self.init_sum,
            int(plan.fwd_pref), alpha.data_ptr(),
            zt.data_ptr(), mt.data_ptr(), fsum.data_ptr(), logz.data_ptr(),
            stream)
        if rc != 0:
            raise RuntimeError(f"kt_chain_den_forward failed: cudaError {rc}")
        self.launches += 1
        CudaChainDen.total_launches += 1
        return logz, (alpha, zt, mt, fsum)

    def _backward(self, scores, mask, saved, gout, leak,
                  plan: DenPlan = None):
        alpha, zt, mt, fsum = saved
        B, T, P = scores.shape
        plan = plan or self.plan(P)
        grad = torch.empty_like(scores)
        stream = torch.cuda.current_stream(scores.device).cuda_stream
        rc = _load().kt_chain_den_backward(
            scores.data_ptr(), mask.data_ptr(), self.out_key.data_ptr(),
            self.out_op.data_ptr(), self.out_w.data_ptr(),
            self.out_w.numel(), self.init.data_ptr(), self.fin.data_ptr(),
            self.self_pdf.data_ptr(), self.entry_pdf.data_ptr(),
            B, T, self.num_states, P, leak,
            int(plan.bwd_pref), alpha.data_ptr(),
            zt.data_ptr(),
            mt.data_ptr(), fsum.data_ptr(), gout.data_ptr(),
            grad.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(f"kt_chain_den_backward failed: cudaError {rc}")
        self.launches += 1
        CudaChainDen.total_launches += 1
        return grad

    # -- the plain version: the same recursion on the packed arrays --------
    def _forward_plain(self, scores, mask, leak):
        B, T, P = scores.shape
        dst, src, pdf = _unpack(self.in_key, self.in_op)
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
        src, dst, pdf = _unpack(self.out_key, self.out_op)
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
