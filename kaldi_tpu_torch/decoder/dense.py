"""Dense gather-based Viterbi beam decoder with lattice generation.

Port of kaldi_tpu/decoder/dense.py (``ReverseDenseGraph``,
``pack_reverse``, ``DenseDecoderConfig``, ``DenseDecoder``) plus the
numpy graph packers ``pack_dense`` and ``degrees`` of
kaldi_tpu/decoder/align.py.  Arcs are packed by destination state and
padded to the largest in-degree, so one frame is

    alpha'[s] = min over incoming arcs a of
                alpha[src(a)] + w(a) − scale·loglike[pdf(ilabel(a))]

a dense (B, S, Ain) gather and min-reduce, followed by ``eps_depth``
ε-sweeps of the same shape; beam pruning is a mask against the frame
minimum.  This is exact Viterbi over the whole state space, for graphs
small enough to keep dense (``_LatgenDecoder`` takes it up to 20,000
states).

What changed from the original: the ``vmap`` over utterances is a
leading batch axis; ``lax.scan`` is a Python loop over frames that
issues only device work (no ``.item()``, no boolean-mask indexing), so
the frame loop never waits for the device; ``jnp.argmin`` becomes
``torch.min(dim)``, which also returns the first minimum.  Utterances
are not padded to 64-frame buckets (that only served XLA's compile
cache).  The lattice's α and β run on the device; the raw lattice is
built on the host by the original's loop, copied.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch

from kaldi_tpu_torch.core.logging import KaldiError
from kaldi_tpu_torch.device import resolve_device
from kaldi_tpu_torch.fst.csr import _eps_depth
from kaldi_tpu_torch.fst.fst import EPS, VectorFst
from kaldi_tpu_torch.decoder.beam import _f32


BIG = 1e30


@dataclasses.dataclass
class ReverseDenseGraph:
    """Arcs grouped by destination, padded to max in-degree."""
    num_states: int
    start: int
    # emitting in-arcs: (S, Ae)
    e_src: np.ndarray
    e_il: np.ndarray
    e_ol: np.ndarray
    e_w: np.ndarray
    # epsilon in-arcs: (S, An)
    n_src: np.ndarray
    n_ol: np.ndarray
    n_w: np.ndarray
    final: np.ndarray          # (S,)
    eps_depth: int

    @property
    def max_in_emit(self) -> int:
        return self.e_src.shape[1]


# Copied from kaldi_tpu/decoder/dense.py pack_reverse.
def pack_reverse(fst: VectorFst) -> ReverseDenseGraph:
    S = fst.num_states
    if S == 0 or fst.start < 0:
        raise KaldiError("pack_reverse: empty FST")
    e_in: List[List[tuple]] = [[] for _ in range(S)]
    n_in: List[List[tuple]] = [[] for _ in range(S)]
    n_off = np.zeros(S + 1, np.int64)
    n_flat: List[int] = []
    for s in range(S):
        n_off[s] = len(n_flat)
        for a in fst.arcs[s]:
            if a.ilabel != EPS:
                e_in[a.nextstate].append((s, a.ilabel, a.olabel, a.weight))
            else:
                n_in[a.nextstate].append((s, a.olabel, a.weight))
                n_flat.append(a.nextstate)
    n_off[S] = len(n_flat)
    depth = _eps_depth(S, n_off, np.asarray(n_flat, np.int64))

    Ae = max(1, max(len(x) for x in e_in))
    An = max(1, max(len(x) for x in n_in))
    e_src = np.zeros((S, Ae), np.int32)
    e_il = np.zeros((S, Ae), np.int32)
    e_ol = np.zeros((S, Ae), np.int32)
    e_w = np.full((S, Ae), 1e30, np.float32)
    n_src = np.zeros((S, An), np.int32)
    n_ol = np.zeros((S, An), np.int32)
    n_w = np.full((S, An), 1e30, np.float32)
    for s in range(S):
        for i, (src, il, ol, w) in enumerate(e_in[s]):
            e_src[s, i] = src
            e_il[s, i] = il
            e_ol[s, i] = ol
            e_w[s, i] = w
        for i, (src, ol, w) in enumerate(n_in[s]):
            n_src[s, i] = src
            n_ol[s, i] = ol
            n_w[s, i] = w
    final = np.full(S, 1e30, np.float32)
    for s, w in fst.finals.items():
        final[s] = w
    return ReverseDenseGraph(S, fst.start, e_src, e_il, e_ol, e_w,
                             n_src, n_ol, n_w, final, depth)


@dataclasses.dataclass
class DenseGraph:
    """Padded dense arc arrays grouped by SOURCE state (the lattice β
    recursion and the raw-lattice build read them)."""
    num_states: int
    start: int
    e_il: np.ndarray      # (S, Ae) int32, 0-padded
    e_ol: np.ndarray      # (S, Ae) int32 output labels
    e_w: np.ndarray       # (S, Ae) f32, BIG-padded
    e_ns: np.ndarray      # (S, Ae) int32
    n_ol: np.ndarray      # (S, An) int32 output labels
    n_w: np.ndarray       # (S, An) f32, BIG-padded
    n_ns: np.ndarray      # (S, An) int32
    final: np.ndarray     # (S,) f32
    eps_depth: int


# Copied from kaldi_tpu/decoder/align.py pack_dense.
def pack_dense(fst: VectorFst, s_pad: int, ae_pad: int, an_pad: int
               ) -> DenseGraph:
    S = fst.num_states
    if S > s_pad:
        raise KaldiError(f"pack_dense: {S} states > pad {s_pad}")
    e_il = np.zeros((s_pad, ae_pad), np.int32)
    e_ol = np.zeros((s_pad, ae_pad), np.int32)
    e_w = np.full((s_pad, ae_pad), 1e30, np.float32)
    e_ns = np.zeros((s_pad, ae_pad), np.int32)
    n_ol = np.zeros((s_pad, an_pad), np.int32)
    n_w = np.full((s_pad, an_pad), 1e30, np.float32)
    n_ns = np.zeros((s_pad, an_pad), np.int32)
    final = np.full(s_pad, 1e30, np.float32)
    n_off = np.zeros(S + 1, np.int64)
    n_ns_flat = []
    for s in range(S):
        ei = ni = 0
        n_off[s] = len(n_ns_flat)
        for a in fst.arcs[s]:
            if a.ilabel != EPS:
                if ei >= ae_pad:
                    raise KaldiError("pack_dense: emit degree overflow")
                e_il[s, ei] = a.ilabel
                e_ol[s, ei] = a.olabel
                e_w[s, ei] = a.weight
                e_ns[s, ei] = a.nextstate
                ei += 1
            else:
                if ni >= an_pad:
                    raise KaldiError("pack_dense: eps degree overflow")
                n_ol[s, ni] = a.olabel
                n_w[s, ni] = a.weight
                n_ns[s, ni] = a.nextstate
                ni += 1
                n_ns_flat.append(a.nextstate)
    n_off[S] = len(n_ns_flat)
    depth = _eps_depth(S, n_off, np.asarray(n_ns_flat, np.int64))
    for s, w in fst.finals.items():
        final[s] = w
    return DenseGraph(S, fst.start, e_il, e_ol, e_w, e_ns, n_ol, n_w,
                      n_ns, final, depth)


# Copied from kaldi_tpu/decoder/align.py degrees.
def degrees(fst: VectorFst) -> Tuple[int, int]:
    """Max OUT-degrees (emitting, eps)."""
    ae = an = 0
    for arcs in fst.arcs:
        e = sum(1 for a in arcs if a.ilabel != EPS)
        n = len(arcs) - e
        ae, an = max(ae, e), max(an, n)
    return ae, an


@dataclasses.dataclass
class DenseDecoderConfig:
    beam: float = 16.0
    acoustic_scale: float = 0.1
    lattice_beam: float = 8.0       # used by decode_lattice


class DenseDecoder:
    """Exact dense Viterbi with beam masking, batched over utterances,
    with the graph's tables on ``device``.

    Accepts either a prepacked ReverseDenseGraph or a VectorFst (the
    latter additionally enables lattice generation, which needs the
    source-grouped arc pack for the backward β recursion)."""

    def __init__(self, graph, tid_to_pdf: np.ndarray,
                 config: DenseDecoderConfig = None,
                 device: torch.device | str = "cuda"):
        self.device = resolve_device(device)
        self._fst = None
        if isinstance(graph, VectorFst):
            self._fst = graph
            graph = pack_reverse(graph)
        self.graph = graph
        self.tid_to_pdf = np.asarray(tid_to_pdf)
        self.config = config or DenseDecoderConfig()
        g = graph
        self.c = {k: self._dev(v) for k, v in dict(
            e_src=g.e_src, e_il=g.e_il, e_ol=g.e_ol, e_w=g.e_w,
            n_src=g.n_src, n_ol=g.n_ol, n_w=g.n_w, final=g.final,
            e_pdf=self.tid_to_pdf.astype(np.int64)[g.e_il]).items()}
        # source-grouped tables for lattices, built on first use
        self._fwd = self.f = None

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        """Host array → device tensor (integer tables as int64 indices)."""
        a = np.ascontiguousarray(a)
        if a.dtype.kind in "iu":
            a = a.astype(np.int64)
        return torch.from_numpy(a).to(self.device)

    # -- device side --------------------------------------------------------

    def _eps_sweep(self, alpha):
        """One ε-sweep over (B, S) costs → (costs, per-state ε in-arc slot
        of the winner, −1 where the state kept its own cost)."""
        c = self.c
        cand = alpha[:, c["n_src"]] + c["n_w"]             # (B, S, An)
        best, arg = torch.min(cand, dim=2)
        keep = alpha <= best
        return torch.minimum(alpha, best), torch.where(keep, -1, arg)

    def _frame_step(self, alpha, loglike, act, bps):
        """One frame for a batch: alpha (B, S), loglike (B, P), act (B,
        1) → new alpha (the old one where ``act`` is false), with the
        frame's backpointers written into ``bps`` (E+1, B, S): the
        emitting in-arc slot, then each ε-sweep's (−1 where inactive)."""
        c = self.c
        ac = loglike[:, c["e_pdf"]] * _f32(-self.config.acoustic_scale)
        cand = alpha[:, c["e_src"]] + c["e_w"] + ac        # (B, S, Ae)
        new, bp = torch.min(cand, dim=2)
        m = new.min(dim=1, keepdim=True).values
        new = torch.where(new > m + _f32(self.config.beam), BIG, new)
        bps[0] = torch.where(act, bp, -1)
        for e in range(self.graph.eps_depth):
            new, bp = self._eps_sweep(new)
            bps[e + 1] = torch.where(act, bp, -1)
        return torch.where(act, new, alpha)

    def _decode_device(self, loglikes: torch.Tensor,
                       num_frames: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Viterbi over a batch on the device: loglikes (B, T_pad, P)
        float32, num_frames (B,) int64, both on the decoder's device →
        per-utterance tids (B, T_pad), olabels (B, T_pad, E+1) in forward
        order within each frame, initial ε-closure olabels (B, E), best
        final state and cost.  Issues no host sync."""
        c = self.c
        S = self.graph.num_states
        E = self.graph.eps_depth
        B, T_pad, _ = loglikes.shape
        dev = loglikes.device

        alpha = torch.full((1, S), BIG, dtype=torch.float32, device=dev)
        alpha[:, self.graph.start] = 0.0
        init_bps = torch.full((E, 1, S), -1, dtype=torch.int64, device=dev)
        for e in range(E):
            alpha, init_bps[e] = self._eps_sweep(alpha)
        alpha = alpha.expand(B, S)
        init_bps = init_bps.expand(E, B, S)

        active = torch.arange(T_pad, device=dev)[None, :] < num_frames[:, None]
        bps = torch.empty((T_pad, E + 1, B, S), dtype=torch.int32, device=dev)
        for t in range(T_pad):
            alpha = self._frame_step(alpha, loglikes[:, t], active[:, t, None],
                                     bps[t])
        total = alpha + c["final"]
        has_final = total.min(dim=1, keepdim=True).values < BIG
        use = torch.where(has_final, total, alpha)
        best_cost, best_state = torch.min(use, dim=1)

        # device backtrace, newest frame first: only (B, T_pad)-sized
        # label arrays leave the device
        bi = torch.arange(B, device=dev)
        s = best_state
        tids = torch.zeros((B, T_pad), dtype=torch.int64, device=dev)
        ols = torch.zeros((B, T_pad, E + 1), dtype=torch.int64, device=dev)
        for t in range(T_pad - 1, -1, -1):
            act = active[:, t]
            for e in range(E, 0, -1):
                slot = bps[t, e, bi, s].long()
                take = (slot >= 0) & act
                safe = slot.clamp_min(0)
                ols[:, t, e] = torch.where(take, c["n_ol"][s, safe], 0)
                s = torch.where(take, c["n_src"][s, safe], s)
            slot0 = bps[t, 0, bi, s].long().clamp_min(0)
            tids[:, t] = torch.where(act, c["e_il"][s, slot0], 0)
            ols[:, t, 0] = torch.where(act, c["e_ol"][s, slot0], 0)
            s = torch.where(act, c["e_src"][s, slot0], s)
        # initial ε-closure olabels (before frame 0), walked backwards
        init_ols = torch.zeros((B, E), dtype=torch.int64, device=dev)
        for e in range(E - 1, -1, -1):
            slot = init_bps[e, bi, s]
            take = slot >= 0
            safe = slot.clamp_min(0)
            init_ols[:, e] = torch.where(take, c["n_ol"][s, safe], 0)
            s = torch.where(take, c["n_src"][s, safe], s)
        return {"tids": tids, "ols": ols, "init_ols": init_ols,
                "best_state": best_state, "best_cost": best_cost}

    # -- host API ----------------------------------------------------------

    def decode(self, loglikes):
        """One utterance (T, P) → (tid alignment, olabel seq, cost)."""
        T = loglikes.shape[0]
        return self.decode_batch(torch.as_tensor(loglikes)[None], [T])[0]

    def decode_batch(self, loglikes_padded, num_frames):
        """(B, T_pad, P) (numpy or tensor) + (B,) frame counts → one
        (tids, olabels, cost) per utterance."""
        ll = torch.as_tensor(loglikes_padded,
                             dtype=torch.float32).to(self.device)
        nf = torch.as_tensor(np.asarray(num_frames, np.int64)).to(self.device)
        out = {k: v.cpu().numpy()
               for k, v in self._decode_device(ll, nf).items()}
        return [self._backtrace({k: v[b] for k, v in out.items()},
                                int(num_frames[b]))
                for b in range(ll.shape[0])]

    # Copied from kaldi_tpu/decoder/dense.py DenseDecoder._backtrace.
    def _backtrace(self, out, T: int):
        cost = float(out["best_cost"])
        if cost >= 1e29:
            raise KaldiError("DenseDecoder: no path")
        tids = [int(t) for t in out["tids"][:T]]
        if any(t == 0 for t in tids):
            raise KaldiError("DenseDecoder: broken backpointer")
        ols: List[int] = [int(o) for o in out["init_ols"] if o != 0]
        frame_ols = out["ols"][:T]               # (T, E+1), forward order
        nz = frame_ols.reshape(-1)
        ols.extend(int(o) for o in nz if o != 0)
        return tids, ols, cost

    # ------------------------------------------------------------------
    # Lattice generation (LatticeFasterDecoder::GetRawLattice equivalent)
    # ------------------------------------------------------------------

    def _ensure_lattice_tables(self):
        if self._fwd is not None:
            return
        if self._fst is None:
            raise KaldiError("lattice generation needs a VectorFst-built "
                             "DenseDecoder")
        ae, an = degrees(self._fst)
        fwd = pack_dense(self._fst, self._fst.num_states, max(ae, 1),
                         max(an, 1))
        self.f = {k: self._dev(v) for k, v in dict(
            f_w=fwd.e_w, f_ns=fwd.e_ns, fn_w=fwd.n_w, fn_ns=fwd.n_ns,
            f_pdf=self.tid_to_pdf.astype(np.int64)[fwd.e_il]).items()}
        self._fwd = fwd

    def _alpha_eps(self, alpha):
        c = self.c
        for _ in range(self.graph.eps_depth):
            cand = alpha[c["n_src"]] + c["n_w"]
            alpha = torch.minimum(alpha, cand.min(dim=1).values)
        return alpha

    def _beta_eps(self, beta):
        f = self.f
        for _ in range(self.graph.eps_depth):
            cand = f["fn_w"] + beta[f["fn_ns"]]
            beta = torch.minimum(beta, cand.min(dim=1).values)
        return beta

    def _alphas(self, ll: torch.Tensor) -> torch.Tensor:
        """Beam-pruned forward costs (T+1, S) of one utterance (T, P)."""
        c = self.c
        S = self.graph.num_states
        beam = _f32(self.config.beam)
        nscale = _f32(-self.config.acoustic_scale)
        T = ll.shape[0]
        alphas = torch.empty((T + 1, S), dtype=torch.float32,
                             device=ll.device)
        alpha = torch.full((S,), BIG, dtype=torch.float32, device=ll.device)
        alpha[self.graph.start] = 0.0
        alphas[0] = alpha = self._alpha_eps(alpha)
        for t in range(T):
            ac = ll[t][c["e_pdf"]] * nscale
            new = (alpha[c["e_src"]] + c["e_w"] + ac).min(dim=1).values
            new = torch.where(new > new.min() + beam, BIG, new)
            alphas[t + 1] = alpha = self._alpha_eps(new)
        return alphas

    def _betas(self, ll: torch.Tensor, final: torch.Tensor) -> torch.Tensor:
        """Backward costs (T+1, S) of one utterance from final costs."""
        f = self.f
        nscale = _f32(-self.config.acoustic_scale)
        T = ll.shape[0]
        betas = torch.empty((T + 1, final.shape[0]), dtype=torch.float32,
                            device=ll.device)
        betas[T] = beta = self._beta_eps(torch.clamp_max(final, BIG))
        for t in range(T - 1, -1, -1):
            ac = ll[t][f["f_pdf"]] * nscale
            bemit = (f["f_w"] + ac + beta[f["f_ns"]]).min(dim=1).values
            betas[t] = beta = self._beta_eps(bemit)
        return betas

    def decode_lattice(self, loglikes):
        """(T, P) log-likelihoods (numpy or tensor) → (Lattice raw, best
        cost).  Raw-lattice arcs are pruned by α(src) + arc + β(dst) ≤
        best + lattice_beam — exactly the extra-cost criterion of
        PruneActiveTokens."""
        from kaldi_tpu_torch.lattice.lattice import Lattice, LatticeArc
        self._ensure_lattice_tables()
        ll_dev = torch.as_tensor(loglikes, dtype=torch.float32).to(
            self.device)
        T = ll_dev.shape[0]
        alphas = self._alphas(ll_dev).cpu().numpy()
        final_np = np.asarray(self.graph.final)
        betas = self._betas(ll_dev, self.c["final"]).cpu().numpy()
        # Copied from kaldi_tpu/decoder/dense.py DenseDecoder.decode_lattice
        # from here on (the olabel helpers inlined).
        use_final_probs = bool(
            np.min(alphas[T] + betas[T]) < 1e29)
        if not use_final_probs:
            # No beam-surviving token reaches a final state: fall back to
            # treating every live last-frame token as final with zero cost
            # (LatticeFasterDecoder use_final_probs=false behavior).
            betas = self._betas(ll_dev,
                                torch.zeros_like(self.c["final"])).cpu().numpy()
            final_np = np.zeros_like(final_np)
        best = float(np.min(alphas[T] + betas[T]))
        if best >= 1e29:
            raise KaldiError("decode_lattice: no path")
        # f32 α/β accumulate rounding over T frames; widen the bound by a
        # magnitude-aware slack so the best path always survives.
        tol = 0.01 + 1e-5 * abs(best) + 1e-4 * T
        bound = best + self.config.lattice_beam + tol
        fwd = self._fwd
        S = self.graph.num_states
        keep = alphas + betas <= bound                         # (T+1, S)
        node_id = -np.ones((T + 1, S), np.int64)
        lat = Lattice()
        for t, s in zip(*np.nonzero(keep)):
            node_id[t, s] = lat.add_state()
        lat.start = int(node_id[0, self.graph.start])
        ll = ll_dev.cpu().numpy()
        pdf_of = self.tid_to_pdf
        scale = self.config.acoustic_scale
        e_valid = fwd.e_w < 1e29                               # (S, Ae)
        n_valid = fwd.n_w < 1e29
        for t in range(T + 1):
            srcs = np.nonzero(keep[t])[0]
            if len(srcs) == 0:
                continue
            # emitting arcs t → t+1
            if t < T:
                ac_row = -scale * ll[t]
                for s in srcs:
                    a_src = int(node_id[t, s])
                    for k in np.nonzero(e_valid[s])[0]:
                        ns = int(fwd.e_ns[s, k])
                        if node_id[t + 1, ns] < 0:
                            continue
                        il = int(fwd.e_il[s, k])
                        w = float(fwd.e_w[s, k])
                        ac = float(ac_row[pdf_of[il]])
                        if (alphas[t, s] + w + ac + betas[t + 1, ns]
                                <= bound):
                            lat.arcs[a_src].append(LatticeArc(
                                il, int(fwd.e_ol[s, k]), w, ac,
                                int(node_id[t + 1, ns])))
            # ε arcs within level t
            for s in srcs:
                a_src = int(node_id[t, s])
                for k in np.nonzero(n_valid[s])[0]:
                    ns = int(fwd.n_ns[s, k])
                    w = float(fwd.n_w[s, k])
                    if (alphas[t, s] + w + betas[t, ns] <= bound
                            and node_id[t, ns] >= 0):
                        lat.arcs[a_src].append(LatticeArc(
                            0, int(fwd.n_ol[s, k]), w, 0.0,
                            int(node_id[t, ns])))
        for s in np.nonzero(keep[T] & (final_np < 1e29))[0]:
            if alphas[T, s] + final_np[s] <= bound:
                lat.set_final(int(node_id[T, s]), float(final_np[s]), 0.0)
        return lat, best
