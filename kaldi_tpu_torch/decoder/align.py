"""Batched exact Viterbi forced alignment on the model's device.

Port of kaldi_tpu/decoder/align.py (parity target
src/gmmbin/gmm-align-compiled.cc: FasterDecoder over a per-utterance
training graph).  Training graphs are tiny (linear transcripts), so the
alignment is *exact* dense Viterbi in the formulation of
decoder/dense.py: arcs packed by DESTINATION state, so recombination is
a gather and a min-reduce, the ε-closure a fixed number of sweeps, and
the backtrace a reverse loop on the device, so that only (B, T) tids
leave it.

What changed from the original: the ``vmap`` over utterances is a
leading batch axis, each utterance with its own padded graph; the
``lax.scan`` is a Python loop over frames that issues only device work
(no ``.item()``, no boolean-mask indexing), so the frame loop never
waits for the device; ``jnp.argmin`` becomes ``torch.min(dim)``, which
also returns the first minimum, and the ε sweep keeps the original's
rule (a state keeps its own cost where ``alpha <= best``).  There is no
per-bucket compile cache and no padding of T to 16: PyTorch compiles
nothing.  The graph packers are the original's numpy, copied
(``pack_dense`` and ``degrees`` live in decoder/dense.py).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from kaldi_tpu_torch.core.logging import KaldiError, get_logger
from kaldi_tpu_torch.decoder.beam import _f32
from kaldi_tpu_torch.decoder.dense import (DenseGraph, degrees,  # noqa: F401
                                           pack_dense)
from kaldi_tpu_torch.device import resolve_device
from kaldi_tpu_torch.fst.csr import _eps_depth
from kaldi_tpu_torch.fst.fst import EPS, VectorFst

log = get_logger(__name__)

BIG = 1e30


# Copied from kaldi_tpu/decoder/align.py DenseRGraph.
@dataclasses.dataclass
class DenseRGraph:
    """Arcs grouped by DESTINATION (the aligner/decoder fast path)."""
    num_states: int
    start: int
    e_src: np.ndarray     # (S, Ae) int32
    e_il: np.ndarray      # (S, Ae) int32
    e_w: np.ndarray       # (S, Ae) f32 BIG-padded
    n_src: np.ndarray     # (S, An) int32
    n_w: np.ndarray       # (S, An) f32 BIG-padded
    final: np.ndarray     # (S,) f32
    eps_depth: int


# Copied from kaldi_tpu/decoder/align.py pack_dense_reverse.
def pack_dense_reverse(fst: VectorFst, s_pad: int, ae_pad: int, an_pad: int
                       ) -> DenseRGraph:
    S = fst.num_states
    if S > s_pad:
        raise KaldiError(f"pack_dense_reverse: {S} states > pad {s_pad}")
    e_src = np.zeros((s_pad, ae_pad), np.int32)
    e_il = np.zeros((s_pad, ae_pad), np.int32)
    e_w = np.full((s_pad, ae_pad), 1e30, np.float32)
    n_src = np.zeros((s_pad, an_pad), np.int32)
    n_w = np.full((s_pad, an_pad), 1e30, np.float32)
    final = np.full(s_pad, 1e30, np.float32)
    e_cnt = np.zeros(s_pad, np.int64)
    n_cnt = np.zeros(s_pad, np.int64)
    n_off = np.zeros(S + 1, np.int64)
    n_flat = []
    for s in range(S):
        n_off[s] = len(n_flat)
        for a in fst.arcs[s]:
            d = a.nextstate
            if a.ilabel != EPS:
                k = e_cnt[d]
                if k >= ae_pad:
                    raise KaldiError("pack_dense_reverse: in-degree overflow")
                e_src[d, k] = s
                e_il[d, k] = a.ilabel
                e_w[d, k] = a.weight
                e_cnt[d] += 1
            else:
                k = n_cnt[d]
                if k >= an_pad:
                    raise KaldiError("pack_dense_reverse: eps in-degree "
                                     "overflow")
                n_src[d, k] = s
                n_w[d, k] = a.weight
                n_cnt[d] += 1
                n_flat.append(d)
    n_off[S] = len(n_flat)
    depth = _eps_depth(S, n_off, np.asarray(n_flat, np.int64))
    for s, w in fst.finals.items():
        final[s] = w
    return DenseRGraph(S, fst.start, e_src, e_il, e_w, n_src, n_w, final,
                       depth)


# Copied from kaldi_tpu/decoder/align.py in_degrees.
def in_degrees(fst: VectorFst) -> Tuple[int, int]:
    """Max IN-degrees (emitting, eps)."""
    e = np.zeros(fst.num_states, np.int64)
    n = np.zeros(fst.num_states, np.int64)
    for arcs in fst.arcs:
        for a in arcs:
            if a.ilabel != EPS:
                e[a.nextstate] += 1
            else:
                n[a.nextstate] += 1
    return int(e.max(initial=0)), int(n.max(initial=0))


def _round_up(x: int, m: int = 8) -> int:
    return ((max(x, 1) + m - 1) // m) * m


def pack_training_graphs(graphs: Sequence[VectorFst]) -> List[DenseRGraph]:
    """Each training graph packed by destination at the batch's common
    state count and in-degrees (the recipes' and gmm-align-compiled's
    packing)."""
    ae = max(max(in_degrees(g)[0] for g in graphs), 1)
    an = max(max(in_degrees(g)[1] for g in graphs), 1)
    smax = max(g.num_states for g in graphs)
    return [pack_dense_reverse(g, smax, ae, an) for g in graphs]


class DenseAligner:
    """Viterbi forced alignment of a batch of utterances, each on its own
    training graph, on ``device``."""

    def __init__(self, tid_to_pdf: np.ndarray, acoustic_scale: float = 1.0,
                 device: torch.device | str = "cuda"):
        self.device = resolve_device(device)
        self.tid2pdf = torch.as_tensor(np.asarray(tid_to_pdf, np.int64)
                                       ).to(self.device)
        self.acoustic_scale = acoustic_scale

    # -- host side ---------------------------------------------------------
    def prepare(self, graphs: Sequence[DenseRGraph], loglikes_list
                ) -> Dict[str, torch.Tensor]:
        """The batch's graphs padded to a shared shape (as the original's
        ``align_batch`` pads them) and its log-likelihoods (numpy or
        tensors, each (T_b, P)) zero-padded to (B, T, P), all on the
        aligner's device."""
        B = len(graphs)
        S = _round_up(max(g.e_src.shape[0] for g in graphs))
        Ae = max(g.e_src.shape[1] for g in graphs)
        An = max(max(g.n_src.shape[1] for g in graphs), 1)

        def padded(name, shape, fill, dtype):
            out = np.full((B,) + shape, fill, dtype)
            for b, g in enumerate(graphs):
                a = getattr(g, name)
                out[(b,) + tuple(slice(0, n) for n in a.shape)] = a
            return torch.from_numpy(out).to(self.device)

        lens = [int(ll.shape[0]) for ll in loglikes_list]
        lls = torch.nn.utils.rnn.pad_sequence(
            [torch.as_tensor(ll, dtype=torch.float32).to(self.device)
             for ll in loglikes_list], batch_first=True)
        return {
            "e_src": padded("e_src", (S, Ae), 0, np.int64),
            "e_il": padded("e_il", (S, Ae), 0, np.int64),
            "e_w": padded("e_w", (S, Ae), 1e30, np.float32),
            "n_src": padded("n_src", (S, An), 0, np.int64),
            "n_w": padded("n_w", (S, An), 1e30, np.float32),
            "final": padded("final", (S,), 1e30, np.float32),
            "start": torch.tensor([g.start for g in graphs],
                                  dtype=torch.int64).to(self.device),
            "lens": torch.tensor(lens, dtype=torch.int64).to(self.device),
            "loglikes": lls,
            "eps_depth": max(g.eps_depth for g in graphs),
        }

    # -- device side -------------------------------------------------------
    def align_device(self, b: Dict[str, torch.Tensor]
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The frame loop and the backtrace of a prepared batch, on the
        device and with no host sync → (tids (B, T) int64, 0 past each
        utterance's end; best costs (B,) float32)."""
        e_src, e_il, e_w = b["e_src"], b["e_il"], b["e_w"]
        n_src, n_w = b["n_src"], b["n_w"]
        lls, lens, E = b["loglikes"], b["lens"], b["eps_depth"]
        B, S, Ae = e_src.shape
        An = n_src.shape[2]
        T = lls.shape[1]
        e_pdf = self.tid2pdf[e_il].reshape(B, S * Ae)
        e_src_f = e_src.reshape(B, S * Ae)
        n_src_f = n_src.reshape(B, S * An)
        scale = _f32(-self.acoustic_scale)

        def eps_sweep(alpha):
            cand = torch.gather(alpha, 1, n_src_f).view(B, S, An) + n_w
            best, arg = torch.min(cand, dim=2)
            keep = alpha <= best
            return torch.minimum(alpha, best), torch.where(keep, -1, arg)

        alpha = torch.full((B, S), BIG, dtype=torch.float32,
                           device=lls.device)
        alpha.scatter_(1, b["start"][:, None], 0.0)
        for _ in range(E):
            alpha, _ = eps_sweep(alpha)
        # per frame: the emitting in-arc slot of each state's winner,
        # then each ε sweep's (−1 where a state kept its own cost)
        bps = torch.empty((T, E + 1, B, S), dtype=torch.int64,
                          device=lls.device)
        for t in range(T):
            ac = torch.gather(lls[:, t], 1, e_pdf).view(B, S, Ae) * scale
            cand = torch.gather(alpha, 1, e_src_f).view(B, S, Ae) + e_w + ac
            new, bp = torch.min(cand, dim=2)
            bps[t, 0] = bp
            for e in range(E):
                new, bps[t, e + 1] = eps_sweep(new)
            alpha = torch.where((lens > t)[:, None], new, alpha)
        total = alpha + b["final"]
        best_cost, s = torch.min(total, dim=1)

        # backtrace; frames past an utterance's end leave its state
        # alone and emit tid 0
        tids = torch.zeros((T, B), dtype=torch.int64, device=lls.device)
        rows = torch.arange(B, device=lls.device)
        for t in range(T - 1, -1, -1):
            act = lens > t
            for e in range(E, 0, -1):
                slot = bps[t, e, rows, s]
                take = (slot >= 0) & act
                s = torch.where(take, n_src[rows, s, slot.clamp_min(0)], s)
            slot0 = bps[t, 0, rows, s]
            tids[t] = torch.where(act, e_il[rows, s, slot0], 0)
            s = torch.where(act, e_src[rows, s, slot0], s)
        return tids.T, best_cost

    def align_batch(self, graphs: Sequence[DenseRGraph], loglikes_list
                    ) -> List[Tuple[List[int], float]]:
        """Align a batch: per utterance (tids, best cost).  One copy to
        the host at the end."""
        batch = self.prepare(graphs, loglikes_list)
        tids, cost = self.align_device(batch)
        tids, cost = tids.cpu().numpy(), cost.cpu().numpy()
        lens = batch["lens"].cpu().numpy()
        results = []
        for b in range(len(graphs)):
            c = float(cost[b])
            if c >= 1e29:
                raise KaldiError(f"align: no path for utterance {b}")
            row = [int(t) for t in tids[b][:int(lens[b])]]
            if any(t == 0 for t in row):
                raise KaldiError("align: broken backpointer")
            results.append((row, c))
        return results
