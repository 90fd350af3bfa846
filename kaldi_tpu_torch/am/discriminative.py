# Port of kaldi_tpu/am/discriminative.py (host copies and ports marked).
"""Discriminative sequence training objectives: MMI and sMBR over
denominator lattices.

Parity target: the reference's lattice-based sequence training —
nnet1's sMBR/MMI (src/nnet/nnet-loss.h roles) and nnet3's
discriminative training (src/nnet3/nnet-discriminative-training.h,
src/lat/lattice-functions.h LatticeForwardBackward{,Mpe}Variants):
  MMI  objf = κ·num-path score − log Z_den
  sMBR objf = E_den[frame accuracy]
with gradients wrt the per-frame pdf log-likelihood matrix.

The host part is the original's numpy code, copied: the denominator
lattice is converted once into a TIME-SYNCHRONOUS dense form
(``DenseLattice``: states bucketed by frame, arcs padded to a fixed
width), by ``lattice_to_dense``, ``remove_eps_arcs`` and
``den_lattice_from_decoder``; ``frame_accuracy`` builds sMBR's per-arc
accuracies.

The objectives run on the scores' device as a frame loop of tensor ops,
differentiated by autograd (the original's ``lax.scan`` and
``jax.grad``).  Each frame gathers α at the arcs' sources, takes a
segment max by destination (``scatter_reduce`` "amax", detached: its
gradient is zero analytically, and torch's amax backward splits ties
where ``segment_max``'s does not), then ``exp``, a segment sum
(``index_add``) and a ``where``.  sMBR carries the expectation semiring
beside α.  Padded arcs (mask 0) add ``(1 − m)·NEG_INF`` and are masked
out of the sums, so they contribute nothing to the value or the
gradient.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from kaldi_tpu_torch.core.logging import get_logger

log = get_logger(__name__)

NEG_INF = -1e30


# Copied from kaldi_tpu/am/discriminative.py DenseLattice.
@dataclasses.dataclass
class DenseLattice:
    """Time-synchronous padded lattice.

    T frames; ≤K states per frame boundary (boundary 0 = before frame
    0, boundary T = after the last frame); ≤A arcs per frame.
    Arc j of frame t goes from state src[t, j] (boundary t) to
    dst[t, j] (boundary t+1) emitting pdf[t, j] with graph weight
    w[t, j] (log domain, negated costs).  Padded arcs have mask 0.
    final[k]: log final weight of boundary-T state k (NEG_INF if not
    final).  start state is boundary-0 index 0.  The fields are numpy
    arrays on the host, or tensors on a device (``lattice_to``).
    """

    src: np.ndarray        # (T, A) int32
    dst: np.ndarray        # (T, A) int32
    pdf: np.ndarray        # (T, A) int32
    w: np.ndarray          # (T, A) float32
    mask: np.ndarray       # (T, A) float32
    final: np.ndarray      # (K,) float32
    num_states: np.ndarray  # (T+1,) int32 (diagnostic)

    @property
    def T(self) -> int:
        return self.src.shape[0]

    @property
    def K(self) -> int:
        return self.final.shape[0]


# Copied from kaldi_tpu/am/discriminative.py lattice_to_dense.
def lattice_to_dense(lat, tid_to_pdf: np.ndarray,
                     acoustic_scale_in_w: bool = False,
                     K: Optional[int] = None,
                     A: Optional[int] = None) -> DenseLattice:
    """Raw state-level Lattice → DenseLattice.

    Every arc must be emitting (ilabel != 0); the decoder's raw
    lattices satisfy this (ε arcs are pre-composed away).  Arc weight
    = −graph_cost (+ −acoustic_cost if acoustic_scale_in_w; normally
    the acoustic score is re-derived from the CURRENT model's `scores`
    inside the objective, the lattice only contributes graph weights —
    matching the reference, which recomputes acoustics each pass).
    """
    n = lat.num_states
    # frame time of each state
    time = np.full(n, -1, np.int64)
    time[lat.start] = 0
    for s in lat.top_order():
        if time[s] < 0:
            continue
        for a in lat.arcs[s]:
            if a.ilabel == 0:
                raise ValueError("lattice_to_dense: ε arc (run "
                                 "eps-removal first)")
            t2 = time[s] + 1
            if time[a.nextstate] >= 0 and time[a.nextstate] != t2:
                raise ValueError("lattice not time-synchronous")
            time[a.nextstate] = t2
    T = int(time.max())
    # renumber states within each frame boundary
    idx = np.zeros(n, np.int64)
    counts = np.zeros(T + 1, np.int64)
    for s in range(n):
        if time[s] >= 0:
            idx[s] = counts[time[s]]
            counts[time[s]] += 1
    Kmax = int(counts.max()) if K is None else K
    arcs_per_t = np.zeros(T, np.int64)
    for s in range(n):
        if 0 <= time[s] < T:
            arcs_per_t[time[s]] += len(lat.arcs[s])
    Amax = int(arcs_per_t.max()) if A is None else A

    src = np.zeros((T, Amax), np.int32)
    dst = np.zeros((T, Amax), np.int32)
    pdf = np.zeros((T, Amax), np.int32)
    w = np.zeros((T, Amax), np.float32)
    mask = np.zeros((T, Amax), np.float32)
    fill = np.zeros(T, np.int64)
    for s in range(n):
        t = time[s]
        if not (0 <= t < T):
            continue
        for a in lat.arcs[s]:
            j = fill[t]
            src[t, j] = idx[s]
            dst[t, j] = idx[a.nextstate]
            pdf[t, j] = tid_to_pdf[a.ilabel]
            w[t, j] = -a.graph_cost - (a.acoustic_cost
                                       if acoustic_scale_in_w else 0.0)
            mask[t, j] = 1.0
            fill[t] += 1
    final = np.full(Kmax, NEG_INF, np.float32)
    for s, (gc, ac) in lat.finals.items():
        if time[s] == T:
            final[idx[s]] = -gc - (ac if acoustic_scale_in_w else 0.0)
    return DenseLattice(src=src, dst=dst, pdf=pdf, w=w, mask=mask,
                        final=final,
                        num_states=counts.astype(np.int32))


# Copied from kaldi_tpu/am/discriminative.py remove_eps_arcs.
def remove_eps_arcs(lat):
    """Path-sum-preserving ε-removal on a raw lattice (the decoder's
    raw lattices carry within-frame ε arcs from graph ε transitions).

    Processing states in reverse topological order, each ε arc s→m is
    replaced by copies of m's (already ε-free) outgoing arcs with the
    ε weight folded into the graph cost, and m's final weight folded
    into s's (log-sum of totals).  Path sums — hence forward-backward
    posteriors — are exactly preserved; duplicate arcs simply
    enumerate distinct original paths.  Word olabels are kept
    best-effort (ε-arc olabel wins when the follower has none); this
    utility serves the discriminative objectives, which ignore
    olabels."""
    from kaldi_tpu_torch.lattice.lattice import Lattice, LatticeArc
    order = lat.top_order()
    arcs: List[List] = [list(a) for a in lat.arcs]
    final_total = {s: -(gc + ac) for s, (gc, ac) in lat.finals.items()}
    for s in reversed(order):
        out = []
        for a in arcs[s]:
            if a.ilabel != 0:
                out.append(a)
                continue
            m = a.nextstate
            for b in arcs[m]:
                out.append(LatticeArc(
                    b.ilabel, a.olabel if a.olabel else b.olabel,
                    a.graph_cost + a.acoustic_cost + b.graph_cost,
                    b.acoustic_cost, b.nextstate))
            if m in final_total:
                w = final_total[m] - a.graph_cost - a.acoustic_cost
                if s in final_total:
                    final_total[s] = float(np.logaddexp(final_total[s], w))
                else:
                    final_total[s] = w
        arcs[s] = out
    out_lat = Lattice()
    for _ in range(lat.num_states):
        out_lat.add_state()
    out_lat.start = lat.start
    for s, alist in enumerate(arcs):
        out_lat.arcs[s] = alist
    for s, ft in final_total.items():
        out_lat.set_final(s, -ft, 0.0)
    return out_lat


# Copied from kaldi_tpu/am/discriminative.py den_lattice_from_decoder.
def den_lattice_from_decoder(decoder, loglikes) -> DenseLattice:
    """Decode one utterance into a pruned raw lattice and convert it
    for the sequence-training objectives (ε-removed, graph weights
    only — acoustics are re-derived from the model inside the
    objective, as the reference recomputes them each pass).
    ``loglikes`` is a numpy array or a tensor (the port's
    ``DenseDecoder`` takes either, on its own device)."""
    if not isinstance(loglikes, torch.Tensor):
        loglikes = np.asarray(loglikes, np.float32)
    raw, _best = decoder.decode_lattice(loglikes)
    return lattice_to_dense(remove_eps_arcs(raw),
                            decoder.tid_to_pdf)


def lattice_to(lat: DenseLattice, device) -> DenseLattice:
    """``lat`` with its arrays as tensors on ``device`` (index arrays
    int64), moved once so that each objective call gathers on the
    device.  A lattice already there is returned as it is."""
    def t(x, dtype):
        return torch.as_tensor(np.asarray(x) if not isinstance(
            x, torch.Tensor) else x).to(device, dtype)
    return DenseLattice(src=t(lat.src, torch.int64),
                        dst=t(lat.dst, torch.int64),
                        pdf=t(lat.pdf, torch.int64),
                        w=t(lat.w, torch.float32),
                        mask=t(lat.mask, torch.float32),
                        final=t(lat.final, torch.float32),
                        num_states=lat.num_states)


def _on(lat: DenseLattice, scores: torch.Tensor) -> DenseLattice:
    dev = scores.device
    if isinstance(lat.src, torch.Tensor) and lat.src.device == dev \
            and lat.src.dtype == torch.int64:
        return lat
    return lattice_to(lat, dev)


# Port of kaldi_tpu/am/discriminative.py _arc_scores.
def _arc_scores(lat: DenseLattice, scores: torch.Tensor, acoustic_scale):
    """(T, A) total arc log-weights under the current model."""
    t_idx = torch.arange(lat.T, device=scores.device)[:, None]
    am = scores[t_idx, lat.pdf]                      # (T, A)
    return lat.w + acoustic_scale * am


def _forward_frame(alpha, aw_t, src_t, dst_t, m_t, K):
    """One frame of the masked log-sum recursion: → (new α, each arc's
    weight relative to its destination's max (masked), the per-state
    sums)."""
    contrib = alpha[src_t] + aw_t + (1.0 - m_t) * NEG_INF
    nxt = torch.full((K,), float("-inf"), dtype=contrib.dtype,
                     device=contrib.device).scatter_reduce(
        0, dst_t, contrib.detach(), "amax")
    p = torch.exp(contrib - nxt[dst_t]) * m_t
    tot = torch.zeros(K, dtype=contrib.dtype,
                      device=contrib.device).index_add(0, dst_t, p)
    new = torch.where(tot > 0, nxt + torch.log(torch.clamp_min(tot, 1e-30)),
                      torch.full_like(tot, NEG_INF))
    return new, p, tot


def _alpha0(K: int, like: torch.Tensor) -> torch.Tensor:
    """α at boundary 0: the start state (index 0) at 0, the rest NEG_INF;
    filled on the device (no host copy, so a step can be captured into a
    CUDA graph)."""
    alpha = torch.full((K,), NEG_INF, dtype=like.dtype, device=like.device)
    alpha[:1].fill_(0.0)
    return alpha


# Port of kaldi_tpu/am/discriminative.py lattice_logz.
def lattice_logz(lat: DenseLattice, scores: torch.Tensor,
                 acoustic_scale: float = 1.0) -> torch.Tensor:
    """log Σ_paths exp(total path weight) — the denominator log-Z.  Its
    gradient wrt ``scores`` is the per-(t, pdf) den occupancy γ_den
    times acoustic_scale."""
    lat = _on(lat, scores)
    aw = _arc_scores(lat, scores, acoustic_scale)
    K = lat.K
    alpha = _alpha0(K, aw)
    for t in range(lat.T):
        alpha, _, _ = _forward_frame(alpha, aw[t], lat.src[t], lat.dst[t],
                                     lat.mask[t], K)
    return torch.logsumexp(alpha + lat.final, dim=0)


# Port of kaldi_tpu/am/discriminative.py mmi_objf.
def mmi_objf(lat: DenseLattice, scores: torch.Tensor, num_pdf,
             acoustic_scale: float = 1.0) -> torch.Tensor:
    """MMI per-utterance objective κ·Σ_t s(t, num_pdf_t) − log Z_den.
    Gradient wrt scores = κ·(1{num} − γ_den)."""
    num_pdf = torch.as_tensor(num_pdf).to(scores.device, torch.int64)
    t_idx = torch.arange(lat.T, device=scores.device)
    num = acoustic_scale * torch.sum(scores[t_idx, num_pdf])
    return num - lattice_logz(lat, scores, acoustic_scale)


# Port of kaldi_tpu/am/discriminative.py smbr_objf.
def smbr_objf(lat: DenseLattice, scores: torch.Tensor, acc,
              acoustic_scale: float = 1.0) -> torch.Tensor:
    """Expected accuracy E_den[Σ_t acc(t, arc)] via the expectation
    semiring.  `acc` is (T, A): per-arc frame accuracy (typically
    1.0 where the arc's phone matches the reference alignment's
    phone at t — `frame_accuracy` builds it).  Its autograd gradient
    wrt scores is the exact sMBR gradient."""
    lat = _on(lat, scores)
    acc = torch.as_tensor(acc).to(scores.device, scores.dtype)
    aw = _arc_scores(lat, scores, acoustic_scale)
    K = lat.K
    alpha = _alpha0(K, aw)
    ae = torch.zeros(K, dtype=aw.dtype, device=aw.device)
    for t in range(lat.T):
        src_t, dst_t = lat.src[t], lat.dst[t]
        nxt_alpha, p, tot = _forward_frame(alpha, aw[t], src_t, dst_t,
                                           lat.mask[t], K)
        # expectation carried per state: weighted mean of incoming
        # (ae[src] + acc)
        e_tot = torch.zeros_like(tot).index_add(
            0, dst_t, p * (ae[src_t] + acc[t]))
        ae = torch.where(tot > 0, e_tot / torch.clamp_min(tot, 1e-30),
                         torch.zeros_like(tot))
        alpha = nxt_alpha
    wfin = alpha + lat.final
    logz = torch.logsumexp(wfin, dim=0)
    pfin = torch.exp(wfin - logz)
    return torch.sum(pfin * ae)


# Copied from kaldi_tpu/am/discriminative.py frame_accuracy.
def frame_accuracy(lat: DenseLattice, ref_pdf: np.ndarray,
                   pdf_to_phone: Optional[np.ndarray] = None
                   ) -> np.ndarray:
    """(T, A) per-arc accuracy: 1 where the arc's phone (or pdf, when
    no mapping is given) equals the reference at frame t — the frame-
    level sMBR criterion (the reference's default in nnet1 sMBR).  The
    lattice's arrays are the host's."""
    arcs = lat.pdf
    ref = np.asarray(ref_pdf)[:, None]
    if pdf_to_phone is not None:
        arcs = pdf_to_phone[arcs]
        ref = pdf_to_phone[ref]
    return (arcs == ref).astype(np.float32) * lat.mask


# Port of kaldi_tpu/am/discriminative.py den_occupancies.
def den_occupancies(lat: DenseLattice, scores: torch.Tensor,
                    acoustic_scale: float = 1.0) -> torch.Tensor:
    """γ_den(t, pdf): derivative of log Z wrt scores, rescaled —
    sums to 1 per frame (diagnostic / EBW-style uses)."""
    s = scores.detach().requires_grad_(True)
    with torch.enable_grad():
        g, = torch.autograd.grad(lattice_logz(lat, s, acoustic_scale), s)
    return g / acoustic_scale
