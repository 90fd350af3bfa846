"""LF-MMI ('chain') training objective.

Port of kaldi_tpu/am/chain.py.  The host part (the phone LM, the
denominator graph and their files) is the original's numpy code, copied
with its imports rewritten; a file written by either package reads back
in the other.  The device part is rewritten in PyTorch:

  * ``denominator_logprob``: log Z of the leaky denominator HMM.  On a
    CUDA tensor it launches the hand-written forward-backward kernel
    (ops/chain_den.py → csrc/chain_den.cu), whose backward is a kernel
    too; on a CPU tensor it runs ``denominator_reference``, the plain
    version, which keeps both of the original's log-space recursions (the
    dense (S,S) product up to ``dense_state_limit`` states, the per-arc
    segment logsumexp above) and takes its gradient from autograd.
  * ``numerator_logprob`` and ``numerator_flexible_logprob``: tensor ops
    with autograd (the flexible numerator is a shift + logaddexp scan).
  * ``chain_objf``: −objf + l2·mean(scores²) and its diagnostics; its
    numerator is the fixed alignment, the flexible-boundary segment
    chain (``num_graph``) or a lattice-derived / end-to-end supervision
    FSA (``num_fsa``, am/chain_supervision.py).

Parity targets of the original: src/chain/chain-training.h
(ComputeChainObjfAndDeriv), chain-den-graph.h, chain-denominator.h
(leaky_hmm_coefficient) and chainbin/chain-est-phone-lm.cc.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from kaldi_tpu_torch.core.logging import KaldiError, get_logger
from kaldi_tpu_torch.am.topology import HmmTopology
from kaldi_tpu_torch.am.tree import ContextDependency
from kaldi_tpu_torch.ops.chain_den import CudaChainDen

log = get_logger(__name__)


# ---------------------------------------------------------------------------
# Phone LM (chain-est-phone-lm role)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PhoneLm:
    """Backoff n-gram phone LM closed into dense per-history
    distributions (the den-graph states).

    States are retained histories (tuples of phone indices, length
    1..order-1, always ending in the current phone); transitions from
    history h on phone c land at the longest retained suffix of h+(c,).
    Witten–Bell interpolation down to the unigram supplies mass for
    unseen continuations, so every row is a full distribution over
    next-phone ∪ {end-of-sequence}.
    """
    order: int
    phones: List[int]                      # sorted phone symbols
    hists: List[Tuple[int, ...]]           # per-state history (phone indices)
    next_logp: np.ndarray                  # (S, P) log p(c | h)
    final_logp: np.ndarray                 # (S,) log p(</s> | h)
    next_state: np.ndarray                 # (S, P) int32 dst state ids

    @property
    def num_states(self) -> int:
        return len(self.hists)

    def state_of(self, phone_seq: Sequence[int]) -> int:
        """Longest retained suffix of the given phone sequence (must end
        in at least one phone)."""
        if not hasattr(self, "_hist_index"):
            self._hist_index = {h: i for i, h in enumerate(self.hists)}
            self._pidx = {p: i for i, p in enumerate(self.phones)}
        idx = [self._pidx[p] for p in phone_seq]
        for k in range(min(len(idx), self.order - 1), 0, -1):
            h = tuple(idx[-k:])
            if h in self._hist_index:
                return self._hist_index[h]
        raise KaldiError(f"PhoneLm.state_of: no state for {phone_seq}")


def estimate_phone_lm(phone_seqs: Sequence[Sequence[int]],
                      phones: Sequence[int],
                      order: int = 2,
                      min_hist_count: int = 1) -> PhoneLm:
    """Estimate a Witten–Bell-interpolated n-gram phone LM from training
    phone sequences (chain recipes run chain-est-phone-lm on the
    numerator alignments).  Histories with count < min_hist_count are
    pruned (their mass reaches the model through backoff)."""
    phones = sorted(phones)
    pidx = {p: i for i, p in enumerate(phones)}
    P = len(phones)
    FINAL = P                              # index of </s> in count tables

    # counts[h][c] for histories h of length 0..order-1
    counts: Dict[Tuple[int, ...], np.ndarray] = {}

    def bump(h: Tuple[int, ...], c: int) -> None:
        if h not in counts:
            counts[h] = np.zeros(P + 1)
        counts[h][c] += 1

    for seq in phone_seqs:
        idx = [pidx[p] for p in seq]
        for t, c in enumerate(idx + [FINAL]):
            for k in range(0, order):
                if k <= t:
                    bump(tuple(idx[t - k:t]), c)

    if () not in counts:
        counts[()] = np.ones(P + 1)

    # Witten–Bell closure, shortest histories first
    probs: Dict[Tuple[int, ...], np.ndarray] = {}
    uni_counts = counts[()] + 1e-3          # floor so every phone reachable
    probs[()] = uni_counts / uni_counts.sum()
    for h in sorted(counts, key=len):
        if h == ():
            continue
        c = counts[h]
        tot = c.sum()
        uniq = np.count_nonzero(c)
        lam = tot / (tot + uniq)            # weight on the ML estimate
        probs[h] = lam * (c / max(tot, 1.0)) + (1 - lam) * probs[h[1:]]

    # retained states: histories of length >= 1 whose count passes the
    # threshold; always retain every unigram history so fallback exists
    kept = [h for h in counts
            if len(h) >= 1 and (len(h) == 1
                                or counts[h].sum() >= min_hist_count)]
    for p in range(P):
        if (p,) not in counts:
            kept.append((p,))
            probs[(p,)] = probs[()]
    kept = sorted(set(kept), key=lambda h: (len(h), h))
    hist_index = {h: i for i, h in enumerate(kept)}

    S = len(kept)
    next_logp = np.zeros((S, P), np.float32)
    final_logp = np.zeros(S, np.float32)
    next_state = np.zeros((S, P), np.int32)
    for i, h in enumerate(kept):
        dist = probs[h]
        next_logp[i] = np.log(np.maximum(dist[:P], 1e-30))
        final_logp[i] = np.log(max(dist[FINAL], 1e-30))
        for c in range(P):
            ext = h + (c,)
            dst = None
            for k in range(min(len(ext), order - 1), 0, -1):
                if ext[-k:] in hist_index:
                    dst = hist_index[ext[-k:]]
                    break
            next_state[i, c] = dst
    return PhoneLm(order=order, phones=list(phones), hists=kept,
                   next_logp=next_logp, final_logp=final_logp,
                   next_state=next_state)


# ---------------------------------------------------------------------------
# Denominator graph
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class DenominatorGraph:
    """Flat arc-list HMM over pdf-ids (chain-den-graph.h equivalent).

    `initial` doubles as the leaky-HMM target distribution: it is the
    stationary distribution of the transition matrix (the reference
    computes the same thing by iterating the HMM for ~100 steps to get
    its DenominatorGraph initial probs)."""
    num_states: int
    src: np.ndarray        # (A,) int32
    dst: np.ndarray        # (A,) int32
    pdf: np.ndarray        # (A,) int32
    logw: np.ndarray       # (A,) f32
    initial: np.ndarray    # (S,) f32 log initial probs (stationary dist)
    final: np.ndarray      # (S,) f32 log final probs
    lm: Optional[PhoneLm] = None          # the phone LM behind the graph
    # per-state topology log-probs (for normalization-FST weights)
    l_self: Optional[np.ndarray] = None   # (S,) f32
    l_fwd: Optional[np.ndarray] = None    # (S,) f32
    # per-state pdfs (self-loop / phone-entry): disambiguate s==d arcs
    # that are LM RE-ENTRIES (same phone again → entry pdf) from true
    # HMM self-loops — the dense fast path needs the distinction
    state_self_pdf: Optional[np.ndarray] = None   # (S,) i32
    state_entry_pdf: Optional[np.ndarray] = None  # (S,) i32
    # context-dependent den graphs (left-biphone trees): den states are
    # (lm-state, left-phone) pairs; these per-LM-STATE views back the
    # normalization-FST weight computation, which walks LM states
    lm_initial: Optional[np.ndarray] = None   # (S_lm,) f32
    lm_l_self: Optional[np.ndarray] = None    # (S_lm,) f32
    lm_l_fwd: Optional[np.ndarray] = None     # (S_lm,) f32
    lm_final: Optional[np.ndarray] = None     # (S_lm,) f32
    exp_index: Optional[Dict] = None          # (lm-state, l-idx) → state

    def norm_view(self):
        """(initial, l_self, l_fwd, final) indexed by LM STATE — for
        normalization-FST weights along a numerator phone chain.  For
        monophone-tree graphs den states ARE LM states; CD graphs
        carry aggregated per-LM-state arrays."""
        if self.lm_initial is not None:
            return (self.lm_initial, self.lm_l_self, self.lm_l_fwd,
                    self.lm_final)
        return self.initial, self.l_self, self.l_fwd, self.final

    def initial_for(self, hist_phones) -> float:
        """log initial prob for a numerator chain whose phone history
        (ids) ends at the current phone; resolves the exact expanded
        (lm-state, left-phone) den state when it exists."""
        g = self.lm.state_of(hist_phones)
        if self.exp_index is None:
            return float(self.initial[g])
        if len(hist_phones) >= 2:
            li = self.lm._pidx.get(hist_phones[-2], -1)
            st = self.exp_index.get((g, li))
            if st is not None:
                return float(self.initial[st])
        return float(self.lm_initial[g])


def _stationary_distribution(S: int, src: np.ndarray, dst: np.ndarray,
                             w: np.ndarray, iters: int = 100) -> np.ndarray:
    """Power-iterate p ← normalize(pᵀM) over the (sub-stochastic, final
    mass leaks out) transition matrix; the reference's den-graph initial
    probs come from the same fixed-point."""
    M = np.zeros((S, S))
    np.add.at(M, (src, dst), np.exp(w))
    p = np.full(S, 1.0 / S)
    for _ in range(iters):
        p = p @ M
        p /= p.sum()
    return np.log(np.maximum(p, 1e-30)).astype(np.float32)


def make_denominator_graph(phone_seqs: Sequence[Sequence[int]],
                           tree: ContextDependency,
                           topo: HmmTopology,
                           interp: float = 1e-3,
                           order: int = 2,
                           min_hist_count: int = 1) -> DenominatorGraph:
    """Build the den graph from training phone sequences: an n-gram
    phone LM (chain-est-phone-lm role; Witten–Bell backoff closed into
    dense rows) expanded through the chain topology.

    State = LM history ending in the current phone; arcs to the next
    phone carry its *forward* pdf and weight log p_fwd + log p(c | h);
    self-loops carry the current phone's self-loop pdf and log p_self;
    finals carry log p_fwd + log p(</s> | h) so each state's total
    outgoing mass is exactly 1 (p_self + p_fwd).

    `interp` is kept for API compatibility (the WB unigram floor plays
    its smoothing role)."""
    del interp
    phones = sorted(topo.phones)
    lm = estimate_phone_lm(phone_seqs, phones, order=order,
                           min_hist_count=min_hist_count)
    if tree.context_width == 2 and tree.central_position == 1:
        return _make_den_graph_biphone(lm, tree, topo, phones, phone_seqs)
    if tree.context_width != 1:
        raise KaldiError(
            "make_denominator_graph: context-dependent den graphs "
            "support left-biphone trees (context_width 2, central "
            "position 1 — the chain build_tree.sh standard); a "
            f"({tree.context_width},{tree.central_position}) tree "
            "needs delayed-window expansion (not implemented)")
    S = lm.num_states
    P = len(phones)

    def pdfs_of(phone):
        window = [0] * tree.context_width
        window[tree.central_position] = phone
        entry = topo.topology_for_phone(phone)
        st = entry[0]
        return (tree.compute(window, st.forward_pdf_class),
                tree.compute(window, st.self_loop_pdf_class))

    # transition probs of the chain topo state (0.5 / 0.5 by default)
    def topo_probs(phone):
        entry = topo.topology_for_phone(phone)
        trans = entry[0].transitions
        p_self = sum(p for ns, p in trans if ns == 0)
        p_fwd = sum(p for ns, p in trans if ns != 0)
        return math.log(max(p_self, 1e-10)), math.log(max(p_fwd, 1e-10))

    fwd_pdf = np.zeros(P, np.int32)
    slf_pdf = np.zeros(P, np.int32)
    l_self_p = np.zeros(P, np.float32)
    l_fwd_p = np.zeros(P, np.float32)
    for i, ph in enumerate(phones):
        fwd_pdf[i], slf_pdf[i] = pdfs_of(ph)
        l_self_p[i], l_fwd_p[i] = topo_probs(ph)

    cur = np.asarray([h[-1] for h in lm.hists], np.int32)  # current phone idx
    l_self = l_self_p[cur]
    l_fwd = l_fwd_p[cur]

    # self-loops
    src = [np.arange(S, dtype=np.int32)]
    dst = [np.arange(S, dtype=np.int32)]
    pdf = [slf_pdf[cur]]
    logw = [l_self]
    # cross arcs: dense (S, P)
    ss, cc = np.meshgrid(np.arange(S, dtype=np.int32),
                         np.arange(P, dtype=np.int32), indexing="ij")
    src.append(ss.ravel())
    dst.append(lm.next_state[ss, cc].ravel().astype(np.int32))
    pdf.append(fwd_pdf[cc].ravel())
    logw.append((l_fwd[:, None] + lm.next_logp)[ss, cc].ravel())

    src = np.concatenate(src)
    dst = np.concatenate(dst)
    pdf = np.concatenate(pdf)
    logw = np.concatenate(logw).astype(np.float32)
    final = (l_fwd + lm.final_logp).astype(np.float32)
    initial = _stationary_distribution(S, src, dst, logw)
    return DenominatorGraph(
        num_states=S, src=src, dst=dst, pdf=pdf, logw=logw,
        initial=initial, final=final, lm=lm,
        l_self=l_self.astype(np.float32), l_fwd=l_fwd.astype(np.float32),
        state_self_pdf=slf_pdf[cur].astype(np.int32),
        state_entry_pdf=fwd_pdf[cur].astype(np.int32))


# the reference's initial probabilities average the graph's occupancy over
# this many frames from its start state (chain-den-graph.cc
# SetInitialProbs)
INITIAL_FRAMES = 100


def _make_den_graph_biphone(lm: PhoneLm, tree, topo, phones,
                            phone_seqs: Sequence[Sequence[int]]
                            ) -> DenominatorGraph:
    """Denominator graph for a LEFT-BIPHONE tree (context_width 2,
    central_position 1 — the reference chain/e2e build_tree.sh
    standard): a state must know its instance's (left, center) phone
    window, so den states are (lm-state, left-phone) pairs.

    LM states with history length ≥ 2 determine their left phone
    (hist[-2]) — only backoff states (history ≤ 1) split per arriving
    left context, so the expansion adds at most ~|phones|² states over
    the phone-LM state count and the dense MXU recursion path in
    denominator_logprob is unchanged.  Entry pdfs stay a function of
    the DESTINATION state (the dense path's requirement): the arc
    (g, l) --x--> (g', l'=center(g)) enters instance x with window
    (center(g), x) = (l', center(g')).  Ref: steps/nnet3/chain/
    build_tree.sh --context-width=2 --central-position=1,
    src/chain/chain-den-graph.h.

    Utterance-initial states (a repair of the original): the numerator
    gives an utterance's first phone p the window (0, p), no left context
    (pipelines/chain.py ``make_chain_egs``), and every state above has a
    real left phone.  Where the tree gives (0, p) an entry or self-loop
    pdf no state emits, LF-MMI would train that pdf on the numerator
    alone, and raising its score raises the objective without bound.  So
    each phone that starts a training sequence and has such a window gets
    a state (p's unigram LM state, left context none) that nothing enters
    and whose arcs lead into the states above.  Its initial mass is what
    the reference's initial probabilities give it: they average the
    occupancy over the first INITIAL_FRAMES frames from the start, and a
    state that nothing enters, started with probability q (the share of
    training sequences that begin with p), holds q·p_self^t at frame t,
    q·(1 − p_self^N)/(N·(1 − p_self)) on average (the reference's
    per-frame renormalisation for the final mass left out).  The rest of
    the initial mass is the stationary distribution's, scaled down."""
    P = len(phones)
    pid = list(phones)                       # index -> phone id

    def topo_probs(phone):
        entry = topo.topology_for_phone(phone)
        trans = entry[0].transitions
        p_self = sum(p for ns, p in trans if ns == 0)
        p_fwd = sum(p for ns, p in trans if ns != 0)
        return math.log(max(p_self, 1e-10)), math.log(max(p_fwd, 1e-10))

    l_self_p = np.zeros(P, np.float32)
    l_fwd_p = np.zeros(P, np.float32)
    for i in range(P):
        l_self_p[i], l_fwd_p[i] = topo_probs(pid[i])

    # pdf tables over (left idx, center idx); left -1 = no left context
    fwd_tab = np.zeros((P + 1, P), np.int32)
    slf_tab = np.zeros((P + 1, P), np.int32)
    for li in range(-1, P):
        for ci in range(P):
            st = topo.topology_for_phone(pid[ci])[0]
            w = [pid[li] if li >= 0 else 0, pid[ci]]
            fwd_tab[li + 1, ci] = tree.compute(w, st.forward_pdf_class)
            slf_tab[li + 1, ci] = tree.compute(w, st.self_loop_pdf_class)

    S_lm = lm.num_states
    last = np.asarray([h[-1] for h in lm.hists], np.int32)
    # expanded states: canonical pairs for len-2 histories, plus every
    # (dst, left) pair one LM transition generates (dedup by dict)
    exp_index: Dict[Tuple[int, int], int] = {}
    exp_states: List[Tuple[int, int]] = []

    def sid(g: int, li: int) -> int:
        k = (g, li)
        s = exp_index.get(k)
        if s is None:
            s = len(exp_states)
            exp_index[k] = s
            exp_states.append(k)
        return s

    for g, h in enumerate(lm.hists):
        if len(h) >= 2:
            sid(g, int(h[-2]))
    # closure: transitions only depend on the source's LM state, so one
    # pass over (g, x) enumerates every reachable (dst, left) pair
    for g in range(S_lm):
        for x in range(P):
            sid(int(lm.next_state[g, x]), int(last[g]))
    # utterance-initial states, for the phones that start a sequence and
    # whose window (0, p) has a pdf no state above emits
    main = np.asarray(exp_states, np.int32).reshape(-1, 2)
    read = set(slf_tab[main[:, 1] + 1, last[main[:, 0]]].tolist()) \
        | set(fwd_tab[main[:, 1] + 1, last[main[:, 0]]].tolist())
    first = np.zeros(P)
    for seq in phone_seqs:
        if len(seq):
            first[pid.index(int(seq[0]))] += 1.0
    first /= max(first.sum(), 1.0)
    start_ci = [ci for ci in range(P) if first[ci] > 0.0
                and not {int(fwd_tab[0, ci]), int(slf_tab[0, ci])} <= read]
    hist_index = {h: i for i, h in enumerate(lm.hists)}
    starts = [sid(hist_index[(ci,)], -1) for ci in start_ci]

    S = len(exp_states)
    eg = np.asarray([g for g, _ in exp_states], np.int32)
    el = np.asarray([li for _, li in exp_states], np.int32)
    ec = last[eg]                               # center phone idx
    st_self = slf_tab[el + 1, ec]
    st_entry = fwd_tab[el + 1, ec]
    l_self = l_self_p[ec]
    l_fwd = l_fwd_p[ec]

    # self-loops
    src = [np.arange(S, dtype=np.int32)]
    dst = [np.arange(S, dtype=np.int32)]
    pdf = [st_self.astype(np.int32)]
    logw = [l_self]
    # cross arcs (S, P): dst = (next_state[g, x], center(g))
    ss, xx = np.meshgrid(np.arange(S, dtype=np.int32),
                         np.arange(P, dtype=np.int32), indexing="ij")
    dst_g = lm.next_state[eg[ss.ravel()], xx.ravel()]
    dst_l = ec[ss.ravel()]
    dmap = np.asarray([exp_index[(int(g), int(l))]
                       for g, l in zip(dst_g, dst_l)], np.int32)
    src.append(ss.ravel())
    dst.append(dmap)
    pdf.append(fwd_tab[dst_l + 1, last[dst_g]])
    logw.append(l_fwd[ss.ravel()]
                + lm.next_logp[eg[ss.ravel()], xx.ravel()])

    src = np.concatenate(src)
    dst = np.concatenate(dst)
    pdf = np.concatenate(pdf).astype(np.int32)
    logw = np.concatenate(logw).astype(np.float32)
    final = (l_fwd + lm.final_logp[eg]).astype(np.float32)
    initial = _stationary_distribution(S, src, dst, logw)
    if starts:
        N = INITIAL_FRAMES
        p_self = np.exp(l_self_p[start_ci].astype(np.float64))
        mass = first[start_ci] * (1.0 - p_self ** N) / (N * (1.0 - p_self))
        p0 = (1.0 - mass.sum()) * np.exp(initial.astype(np.float64))
        p0[starts] += mass
        initial = np.log(np.maximum(p0, 1e-30)).astype(np.float32)

    # per-LM-state views for normalization weights
    lm_l_self = l_self_p[last]
    lm_l_fwd = l_fwd_p[last]
    lm_final = (lm_l_fwd + lm.final_logp).astype(np.float32)
    mass = np.full(S_lm, 0.0)
    np.add.at(mass, eg, np.exp(initial.astype(np.float64)))
    lm_initial = np.log(np.maximum(mass, 1e-30)).astype(np.float32)

    log.info("den graph (left-biphone): %d lm states → %d (lm, left) "
             "states, %d arcs", S_lm, S, len(src))
    return DenominatorGraph(
        num_states=S, src=src, dst=dst, pdf=pdf, logw=logw,
        initial=initial, final=final, lm=lm,
        l_self=l_self.astype(np.float32), l_fwd=l_fwd.astype(np.float32),
        state_self_pdf=st_self.astype(np.int32),
        state_entry_pdf=st_entry.astype(np.int32),
        lm_initial=lm_initial, lm_l_self=lm_l_self.astype(np.float32),
        lm_l_fwd=lm_l_fwd.astype(np.float32), lm_final=lm_final,
        exp_index=exp_index)


# ---------------------------------------------------------------------------
# Denominator forward (log Z)
# ---------------------------------------------------------------------------

# the original's -inf stand-in for the numerator's unreachable segments
NEG = -1e30


def state_pdfs(den: DenominatorGraph) -> Tuple[np.ndarray, np.ndarray]:
    """(self-loop pdf, entry pdf) of every den state, int32.  Frame 0 may
    start mid-phone (the state's self-loop pdf) or at a phone start (its
    entry pdf).  Graphs written without them get the original's
    heuristic."""
    if den.state_self_pdf is not None:
        return (np.asarray(den.state_self_pdf, np.int32),
                np.asarray(den.state_entry_pdf, np.int32))
    S = den.num_states
    self_pdf = np.zeros(S, np.int32)
    entry_pdf = np.zeros(S, np.int32)
    best_w = np.full(S, -np.inf)
    for a in range(len(den.src)):
        s, d = den.src[a], den.dst[a]
        if s == d and den.logw[a] > best_w[s]:
            best_w[s] = den.logw[a]
            self_pdf[s] = den.pdf[a]
        if s != d:
            entry_pdf[d] = den.pdf[a]
    return self_pdf, entry_pdf


def dense_tables(den: DenominatorGraph, self_pdf: np.ndarray):
    """The dense recursion's tables, float64: W[s, d] = Σ exp(logw) over
    the entry arcs s→d, and l_self[s] = log Σ exp(logw) over the true HMM
    self-loops (s==d arcs that emit s's self pdf; an s==d arc emitting
    the ENTRY pdf is an LM re-entry of the same phone and goes into W).
    The arcs are summed in the original's order."""
    S = den.num_states
    src = den.src.astype(np.int64)
    dst = den.dst.astype(np.int64)
    is_self = (src == dst) & (den.pdf.astype(np.int64) == self_pdf[src])
    l_self = np.full(S, -np.inf)
    np.logaddexp.at(l_self, src[is_self],
                    den.logw[is_self].astype(np.float64))
    W = np.zeros((S, S), np.float64)
    np.add.at(W, (src[~is_self], dst[~is_self]),
              np.exp(den.logw[~is_self].astype(np.float64)))
    return W, l_self


def _cached(den: DenominatorGraph, key, make):
    """Per-graph cache of derived tensors (on the graph object, which a
    training run keeps for its whole life)."""
    cache = den.__dict__.setdefault("_torch_cache", {})
    if key not in cache:
        cache[key] = make()
    return cache[key]


def _segment_logsumexp(vals: torch.Tensor, segs: torch.Tensor,
                       num_segments: int) -> torch.Tensor:
    """logsumexp of vals (B, A) grouped by segs (A,) → (B, num_segments).
    The per-segment max is a constant shift: its gradient cancels, so it
    is detached."""
    B = vals.shape[0]
    idx = segs[None, :].expand(B, -1)
    mx = torch.full((B, num_segments), NEG, dtype=vals.dtype,
                    device=vals.device).scatter_reduce(
        1, idx, vals.detach(), "amax", include_self=True)
    s = torch.zeros_like(mx).index_add(1, segs,
                                       torch.exp(vals - mx[:, segs]))
    return mx + torch.log(torch.clamp(s, min=1e-30))


def denominator_reference(den: DenominatorGraph, scores: torch.Tensor,
                          mask: Optional[torch.Tensor] = None,
                          leaky_hmm_coefficient: float = 0.0,
                          dense_state_limit: int = 4096) -> torch.Tensor:
    """The plain PyTorch version of ``denominator_logprob``: the
    original's log-space recursion, differentiable by autograd.

    Frame 0 admits every state's self-loop and entry pdf; each later
    frame t updates α by the arcs (up to ``dense_state_limit`` states as
    α[d] ← logaddexp(α[d] + l_self[d] + self_t[d], log(Σ_s e^α[s]·W[s,d])
    + entry_t[d]), above it per arc with a segment logsumexp), then the
    leak α ← logaddexp(α, log c + initial + logsumexp α), then subtracts
    the max into a running correction.  A masked frame (mask False at
    t ≥ 1) leaves α and the correction as they were.  → (B,) log Z."""
    S = den.num_states
    dev = scores.device
    B, T, _ = scores.shape
    if mask is None:
        mask = torch.ones((B, T), dtype=torch.bool, device=dev)
    mask = mask.to(device=dev, dtype=torch.bool)

    def const(name, make):
        return _cached(den, (name, dev), make)

    initial = const("initial", lambda: torch.from_numpy(
        np.asarray(den.initial, np.float32)).to(dev))
    final = const("final", lambda: torch.from_numpy(
        np.asarray(den.final, np.float32)).to(dev))
    self_np, entry_np = state_pdfs(den)
    self_pdf = const("self_pdf", lambda: torch.from_numpy(
        self_np.astype(np.int64)).to(dev))
    entry_pdf = const("entry_pdf", lambda: torch.from_numpy(
        entry_np.astype(np.int64)).to(dev))

    if leaky_hmm_coefficient > 0.0:
        log_leak = math.log(leaky_hmm_coefficient)

        def leak(alpha):
            tot = torch.logsumexp(alpha, dim=1, keepdim=True)
            return torch.logaddexp(alpha, log_leak + initial[None, :] + tot)
    else:
        def leak(alpha):
            return alpha

    def renorm(alpha, new, corr, t):
        m = new.amax(dim=1, keepdim=True)
        act = mask[:, t]
        return (torch.where(act[:, None], new - m, alpha),
                corr + torch.where(act, m[:, 0], 0.0))

    corr = torch.zeros(B, dtype=scores.dtype, device=dev)
    if S <= dense_state_limit:
        def tables():
            W, l_self = dense_tables(den, self_np)
            return (torch.from_numpy(W.astype(np.float32)).to(dev),
                    torch.from_numpy(l_self.astype(np.float32)).to(dev))

        W, l_self = const("dense", tables)
        # one (B, T, S) gather per pdf kind, outside the frame loop
        self_sc = scores[:, :, self_pdf]
        entry_sc = scores[:, :, entry_pdf]
        alpha = leak(initial[None, :]
                     + torch.logaddexp(self_sc[:, 0], entry_sc[:, 0]))
        for t in range(1, T):
            m0 = alpha.amax(dim=1, keepdim=True)
            entry = m0 + torch.log(torch.clamp(
                torch.exp(alpha - m0) @ W, min=1e-30))
            new = leak(torch.logaddexp(
                alpha + l_self[None, :] + self_sc[:, t],
                entry + entry_sc[:, t]))
            alpha, corr = renorm(alpha, new, corr, t)
    else:
        def arcs():
            return tuple(torch.from_numpy(np.asarray(a)).to(dev) for a in (
                den.src.astype(np.int64), den.dst.astype(np.int64),
                den.pdf.astype(np.int64), den.logw.astype(np.float32)))

        src, dst, pdf, logw = const("arcs", arcs)
        alpha = leak(initial[None, :] + torch.logaddexp(
            scores[:, 0][:, self_pdf], scores[:, 0][:, entry_pdf]))
        for t in range(1, T):
            contrib = alpha[:, src] + logw[None, :] + scores[:, t][:, pdf]
            new = leak(_segment_logsumexp(contrib, dst, S))
            alpha, corr = renorm(alpha, new, corr, t)
    return corr + torch.logsumexp(alpha + final[None, :], dim=1)


def den_kernel(den: DenominatorGraph, device) -> CudaChainDen:
    """The kernel wrapper holding ``den`` packed on ``device``, built
    once per graph and device."""
    def make():
        self_pdf, entry_pdf = state_pdfs(den)
        return CudaChainDen(den.num_states, den.src, den.dst, den.pdf,
                            den.logw, den.initial, den.final, self_pdf,
                            entry_pdf, device=device)
    return _cached(den, ("kernel", torch.device(device)), make)


def denominator_logprob(den: DenominatorGraph, scores: torch.Tensor,
                        mask: Optional[torch.Tensor] = None,
                        leaky_hmm_coefficient: float = 0.0,
                        dense_state_limit: int = 4096) -> torch.Tensor:
    """log Z of the denominator HMM for each sequence.

    scores: (B, T, num_pdfs) un-normalized log acoustic scores, float32.
    mask: optional (B, T) bool; a padded frame freezes α, so the
    denominator integrates exactly the frames the numerator sees (frame
    0 always counts, as in the original).  leaky_hmm_coefficient: the
    per-frame leak to the stationary distribution (chain-denominator.h).
    → (B,) log-probs, differentiable.

    A CUDA tensor launches the forward-backward kernel
    (ops/chain_den.py: ``ChainDenFn``; its backward is the second
    kernel); a CPU tensor runs ``denominator_reference``
    (``dense_state_limit`` chooses its recursion; the kernel recurses
    over the arcs at every size)."""
    if scores.device.type == "cpu":
        return denominator_reference(den, scores, mask,
                                     leaky_hmm_coefficient,
                                     dense_state_limit)
    if scores.device.type != "cuda":
        raise ValueError(f"unsupported device {scores.device}")
    return den_kernel(den, scores.device)(scores, mask,
                                          leaky_hmm_coefficient)


# ---------------------------------------------------------------------------
# Numerators
# ---------------------------------------------------------------------------

def numerator_logprob(scores: torch.Tensor, pdf_ali: torch.Tensor,
                      mask: torch.Tensor) -> torch.Tensor:
    """Fixed-path numerator: Σ_t scores[t, pdf_ali[t]] over valid frames.
    scores: (B, T, P); pdf_ali: (B, T) int; mask: (B, T)."""
    gathered = scores.gather(2, pdf_ali.long()[..., None])[..., 0]
    return torch.where(mask.to(torch.bool), gathered, 0.0).sum(dim=1)


def numerator_flexible_logprob(scores: torch.Tensor,
                               entry_pdf: torch.Tensor,
                               self_pdf: torch.Tensor,
                               num_segs: torch.Tensor,
                               mask: torch.Tensor,
                               entry_w: Optional[torch.Tensor] = None,
                               self_w: Optional[torch.Tensor] = None,
                               init_w: Optional[torch.Tensor] = None,
                               final_w: Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
    """Supervision-FST numerator with free phone-boundary placement: the
    chunk's phone-segment sequence is fixed, frames distribute over the
    segments (each ≥ 1 frame).  A linear chain, so the forward recursion
    is a shift + logaddexp:

        α'[s] = logaddexp(α[s] + score[self_pdf[s]] + self_w[s],
                          α[s−1] + score[entry_pdf[s]] + entry_w[s])

    The optional weights are the normalization-FST composition
    (phone-LM + topology log-probs per segment, den initial/final of the
    first/last segment's state).  scores (B, T, P); entry_pdf/self_pdf
    (B, S) padded; num_segs (B,); mask (B, T).  Frame 0 admits entry or
    continuation of segment 0.  → (B,) log-probs."""
    B, T, P = scores.shape
    S = entry_pdf.shape[1]
    dev, dt = scores.device, scores.dtype
    mask = mask.to(torch.bool)
    if entry_w is None:
        entry_w = torch.zeros((B, S), dtype=dt, device=dev)
    if self_w is None:
        self_w = torch.zeros((B, S), dtype=dt, device=dev)
    if init_w is None:
        init_w = torch.zeros((B,), dtype=dt, device=dev)
    if final_w is None:
        final_w = torch.zeros((B,), dtype=dt, device=dev)
    self_sc = scores.gather(2, self_pdf.long()[:, None, :].expand(B, T, S))
    entry_sc = scores.gather(2, entry_pdf.long()[:, None, :].expand(B, T, S))
    alpha0 = init_w + torch.logaddexp(entry_sc[:, 0, 0], self_sc[:, 0, 0])
    alpha = torch.cat([alpha0[:, None],
                       torch.full((B, S - 1), NEG, dtype=dt, device=dev)],
                      dim=1)
    # entering segment s from s-1 pays entry_w[s]; align it for the shift
    entry_w_shift = torch.cat(
        [entry_w[:, 1:], torch.zeros((B, 1), dtype=dt, device=dev)], dim=1)
    neg = torch.full((B, 1), NEG, dtype=dt, device=dev)
    for t in range(1, T):
        stay = alpha + self_sc[:, t] + self_w
        shifted = torch.cat([neg, (alpha + entry_w_shift)[:, :-1]], dim=1)
        new = torch.logaddexp(stay, shifted + entry_sc[:, t])
        alpha = torch.where(mask[:, t, None], new, alpha)
    # end in the LAST segment (it may continue past the chunk edge)
    last = torch.clamp(num_segs.long() - 1, 0, S - 1)
    return final_w + alpha.gather(1, last[:, None])[:, 0]


@dataclasses.dataclass
class ChainTrainingOptions:
    """Mirrors chain-training.h ChainTrainingOptions names."""
    l2_regularize: float = 5e-5
    leaky_hmm_coefficient: float = 0.1
    xent_regularize: float = 0.0


def chain_objf(den: DenominatorGraph, scores: torch.Tensor,
               pdf_ali: Optional[torch.Tensor], mask: torch.Tensor,
               opts: ChainTrainingOptions = ChainTrainingOptions(),
               num_graph: Optional[Tuple[torch.Tensor, ...]] = None,
               num_fsa: Optional[Tuple] = None,
               norm: Optional[Tuple[torch.Tensor, int]] = None
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Negative LF-MMI objective per frame (to minimize) + diagnostics.

    num_graph = (entry_pdf, self_pdf, num_segs[, entry_w, self_w,
    init_w, final_w]) switches the numerator to the flexible-boundary
    supervision FST; pdf_ali is ignored then.  num_fsa = (packed
    supervision dict, tolerance) switches to the lattice-derived or
    end-to-end supervision FSA (am/chain_supervision.py) and takes
    precedence over both.  norm = (frames, scores) of a batch spread over
    data-parallel ranks (ChainTrainer(mesh=)): the batch's unmasked
    frame count and score count, which divide this rank's sums, so the
    loss and diagnostics are this rank's shares of the batch's."""
    mask = mask.to(torch.bool)
    if num_fsa is not None:
        from kaldi_tpu_torch.am.chain_supervision import \
            numerator_fsa_logprob
        num = numerator_fsa_logprob(scores, num_fsa[0],
                                    tolerance=num_fsa[1])
    elif num_graph is not None:
        num = numerator_flexible_logprob(
            scores, num_graph[0], num_graph[1], num_graph[2], mask,
            *num_graph[3:])
    else:
        num = numerator_logprob(scores, pdf_ali, mask)
    den_lp = denominator_logprob(
        den, scores, mask=mask,
        leaky_hmm_coefficient=opts.leaky_hmm_coefficient)
    frames = mask.sum() if norm is None else norm[0]
    num_frames = torch.clamp(frames, min=1).to(scores.dtype)
    objf = (num.sum() - den_lp.sum()) / num_frames
    loss = -objf
    if opts.l2_regularize > 0:
        l2 = (torch.mean(scores ** 2) if norm is None
              else torch.sum(scores ** 2) / norm[1])
        loss = loss + opts.l2_regularize * l2
    return loss, {"objf": objf, "num": num.sum() / num_frames,
                  "den": den_lp.sum() / num_frames}


# ---------------------------------------------------------------------------
# PhoneLm serialization (chain-est-phone-lm output artifact)
# ---------------------------------------------------------------------------

def write_phone_lm(path: str, lm: PhoneLm) -> None:
    """Kaldi-style binary serialization of the denominator phone LM
    (the chain-est-phone-lm stage artifact — ref writes a phone-level
    G FST; the dense-row form here is the same model in the layout
    make_denominator_graph consumes)."""
    from kaldi_tpu_torch.core import io as kio
    with kio.open_wxfilename(path) as f:
        kio.init_kaldi_output_stream(f)
        kio.write_token(f, "<PhoneLm>")
        kio.write_basic_int32(f, lm.order)
        kio.write_int_vector(f, np.asarray(lm.phones, np.int32))
        kio.write_basic_int32(f, len(lm.hists))
        for h in lm.hists:
            kio.write_int_vector(f, np.asarray(h, np.int32))
        kio.write_matrix(f, lm.next_logp.astype(np.float32))
        kio.write_vector(f, lm.final_logp.astype(np.float32))
        kio.write_matrix(f, lm.next_state.astype(np.float32))
        kio.write_token(f, "</PhoneLm>")


def read_phone_lm(path: str) -> PhoneLm:
    from kaldi_tpu_torch.core import io as kio
    with kio.open_rxfilename(path) as f:
        kio.init_kaldi_input_stream(f)
        kio.expect_token(f, "<PhoneLm>")
        order = kio.read_basic_int32(f)
        phones = [int(x) for x in kio.read_int_vector(f)]
        nh = kio.read_basic_int32(f)
        hists = [tuple(int(x) for x in kio.read_int_vector(f))
                 for _ in range(nh)]
        next_logp = kio.read_matrix(f).astype(np.float64)
        final_logp = np.asarray(kio.read_vector(f), np.float64)
        next_state = kio.read_matrix(f).astype(np.int32)
        kio.expect_token(f, "</PhoneLm>")
        return PhoneLm(order=order, phones=phones, hists=hists,
                       next_logp=next_logp, final_logp=final_logp,
                       next_state=next_state)


def write_denominator_graph(f, den: DenominatorGraph) -> None:
    """Serialize the den graph (chainbin/nnet3-chain-make-den-fst
    writes den.fst + normalization.fst; here one file carries the flat
    arc arrays plus the stationary-distribution initial probs and the
    per-state topology log-probs the normalization weights need)."""
    from kaldi_tpu_torch.am.serialize import write_pytree
    from kaldi_tpu_torch.core import io as kio
    kio.write_token(f, "<DenGraph>")
    d = {"num_states": np.int32(den.num_states), "src": den.src,
         "dst": den.dst, "pdf": den.pdf, "logw": den.logw,
         "initial": den.initial, "final": den.final}
    if den.l_self is not None:
        d["l_self"] = den.l_self
        d["l_fwd"] = den.l_fwd
    if den.state_self_pdf is not None:
        d["state_self_pdf"] = den.state_self_pdf
        d["state_entry_pdf"] = den.state_entry_pdf
    if den.lm is not None:
        lm = den.lm
        hist_flat = np.asarray([p for h in lm.hists for p in h],
                               np.int32)
        hist_len = np.asarray([len(h) for h in lm.hists], np.int32)
        d["lm_order"] = np.int32(lm.order)
        d["lm_phones"] = np.asarray(lm.phones, np.int32)
        d["lm_hist_flat"] = hist_flat
        d["lm_hist_len"] = hist_len
        d["lm_next_logp"] = lm.next_logp
        d["lm_final_logp"] = lm.final_logp
        d["lm_next_state"] = lm.next_state
    write_pytree(f, d)
    kio.write_token(f, "</DenGraph>")


def read_denominator_graph(f) -> DenominatorGraph:
    from kaldi_tpu_torch.am.serialize import read_pytree
    from kaldi_tpu_torch.core import io as kio
    kio.expect_token(f, "<DenGraph>")
    d = read_pytree(f)
    kio.expect_token(f, "</DenGraph>")
    lm = None
    if "lm_order" in d:
        hists, pos = [], 0
        flat = d["lm_hist_flat"].astype(np.int32)
        for n in d["lm_hist_len"].astype(np.int32):
            hists.append(tuple(int(p) for p in flat[pos:pos + n]))
            pos += n
        lm = PhoneLm(order=int(d["lm_order"]),
                     phones=[int(p) for p in d["lm_phones"]],
                     hists=hists,
                     next_logp=d["lm_next_logp"].astype(np.float32),
                     final_logp=d["lm_final_logp"].astype(np.float32),
                     next_state=d["lm_next_state"].astype(np.int32))
    return DenominatorGraph(
        lm=lm,
        num_states=int(d["num_states"]),
        src=d["src"].astype(np.int32), dst=d["dst"].astype(np.int32),
        pdf=d["pdf"].astype(np.int32), logw=d["logw"].astype(np.float32),
        initial=d["initial"].astype(np.float32),
        final=d["final"].astype(np.float32),
        l_self=(d["l_self"].astype(np.float32)
                if "l_self" in d else None),
        l_fwd=(d["l_fwd"].astype(np.float32) if "l_fwd" in d else None),
        state_self_pdf=(d["state_self_pdf"].astype(np.int32)
                        if "state_self_pdf" in d else None),
        state_entry_pdf=(d["state_entry_pdf"].astype(np.int32)
                         if "state_entry_pdf" in d else None))
