# Port of kaldi_tpu/am/chain_supervision.py (host copies and ports marked).
"""Lattice-derived and end-to-end chain supervision (numerator FSAs).

Parity target: src/chain/chain-supervision.{h,cc}.  Each utterance's
numerator graph is built from a LATTICE of alternatives (or from a
transcript, for end-to-end training): every path is an allowed phone
sequence, and each phone's start/end may move within ±tolerance frames
of its lattice time.

The host part is the original's numpy code, copied with its imports
rewritten, and gives the same arrays: ``SupervisionFsa``, the builders
(``supervision_from_phone_runs``, ``supervision_from_text``,
``supervision_from_lattice``), ``chunk_supervision``,
``add_normalization_weights``, ``pack_supervisions`` and the egs makers
``make_chain_egs_from_lattices`` / ``make_chain_egs_e2e``.

The card part, ``numerator_fsa_logprob``, is the original's ``lax.scan``
rewritten as a frame loop of tensor ops on the scores' device (the arc
scores of every frame gathered once, the tolerance windows built as
masks before the loop), differentiated by autograd.  It is
arc-synchronous: trellis nodes are supervision arcs (being "inside" that
phone), and the time tolerance is a per-frame mask from each state's
boundary frame.  The linear-chain flexible numerator
(am/chain.py ``numerator_flexible_logprob``) is the special case of a
one-path lattice with unbounded tolerance.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from kaldi_tpu_torch.core.logging import KaldiError, get_logger
from kaldi_tpu_torch.lattice.functions import state_times
from kaldi_tpu_torch.lattice.lattice import CompactLattice

log = get_logger(__name__)

NEG = -1e30


# Copied from kaldi_tpu/am/chain_supervision.py SupervisionFsa.
@dataclasses.dataclass
class SupervisionFsa:
    """One utterance's numerator graph at the (subsampled) frame rate.

    Arc a models one phone occurrence: entering it at frame t emits
    entry_pdf[a], staying emits self_pdf[a].  bt[s] is state s's
    boundary frame from the lattice; entering an arc at frame t is
    allowed iff |t − bt[src]| ≤ tolerance, and a path may end in arc a
    at the sequence end iff |T − bt[dst]| ≤ tolerance."""
    src: np.ndarray          # (A,) int32
    dst: np.ndarray          # (A,) int32
    entry_pdf: np.ndarray    # (A,) int32
    self_pdf: np.ndarray     # (A,) int32
    weight: np.ndarray       # (A,) f32 log-space entry weight
    bt: np.ndarray           # (S,) int32 boundary frames
    start: int
    final: np.ndarray        # (S,) bool
    num_frames: int          # T at the subsampled rate
    phone: Optional[np.ndarray] = None     # (A,) phone of each arc
    self_w: Optional[np.ndarray] = None    # (A,) per-self-frame weight
    final_w: Optional[np.ndarray] = None   # (A,) end-of-sequence weight
    # chunk-boundary flags (chunk_supervision): start/end mid-utterance
    mid_start: bool = False
    mid_end: bool = False

    @property
    def num_states(self) -> int:
        return len(self.bt)


# Copied from kaldi_tpu/am/chain_supervision.py supervision_from_phone_runs.
def supervision_from_phone_runs(
        paths: Sequence[Sequence[Tuple[int, int]]],
        path_weights: Sequence[float],
        entry_pdf_of, self_pdf_of, num_frames: int) -> SupervisionFsa:
    """Build a supervision FSA as a union of alternative phone paths
    (each a [(phone, duration)] run list covering num_frames).  The
    general entry point: lattice paths, pronunciation alternatives, or
    a single forced alignment all reduce to this."""
    srcs: List[int] = []
    dsts: List[int] = []
    epdf: List[int] = []
    spdf: List[int] = []
    wgt: List[float] = []
    phn: List[int] = []
    bt: List[int] = [0]
    final: List[bool] = [False]
    start = 0
    # share states across paths by boundary-time prefix?  Keep it
    # simple and exact: each path is its own chain; the forward over
    # the union IS logsumexp over paths (tested against enumeration).
    for path, pw in zip(paths, path_weights):
        tot = sum(d for _, d in path)
        if tot != num_frames:
            raise KaldiError(
                f"path covers {tot} frames, utterance has {num_frames}")
        cur = start
        t = 0
        for k, (phone, dur) in enumerate(path):
            t += dur
            nxt = len(bt)
            bt.append(t)
            final.append(k == len(path) - 1)
            srcs.append(cur)
            dsts.append(nxt)
            epdf.append(entry_pdf_of(phone))
            spdf.append(self_pdf_of(phone))
            wgt.append(pw if k == 0 else 0.0)
            phn.append(phone)
            cur = nxt
    return SupervisionFsa(
        src=np.asarray(srcs, np.int32), dst=np.asarray(dsts, np.int32),
        entry_pdf=np.asarray(epdf, np.int32),
        self_pdf=np.asarray(spdf, np.int32),
        weight=np.asarray(wgt, np.float32),
        bt=np.asarray(bt, np.int32), start=start,
        final=np.asarray(final, bool), num_frames=num_frames,
        phone=np.asarray(phn, np.int32))


# Copied from kaldi_tpu/am/chain_supervision.py supervision_from_text.
def supervision_from_text(phones: Sequence[int], entry_pdf_of,
                          self_pdf_of,
                          num_frames: int) -> SupervisionFsa:
    """End-to-end (flat-start) supervision: the transcript's phone
    sequence with FREE boundary times (chain-supervision.h's
    e2e/TrainingGraphToSupervision role — egs/wsj run_e2e flat-start
    chain trains with no prior alignment).  The uniform durations
    below only seed the bt placeholders; run the numerator with
    tolerance ≥ num_frames so every boundary window is vacuous and
    ALL monotone alignments of the sequence (each phone ≥ 1 frame)
    are in the FSA."""
    n = len(phones)
    if n == 0 or n > num_frames:
        raise KaldiError(f"supervision_from_text: {n} phones cannot "
                         f"fill {num_frames} frames")
    base, rem = divmod(num_frames, n)
    runs = [(int(p), base + (1 if i < rem else 0))
            for i, p in enumerate(phones)]
    return supervision_from_phone_runs([runs], [0.0], entry_pdf_of,
                                       self_pdf_of, num_frames)


# Copied from kaldi_tpu/am/chain_supervision.py supervision_from_lattice.
def supervision_from_lattice(clat: CompactLattice, tm,
                             entry_pdf_of, self_pdf_of,
                             subsample: int = 3,
                             acoustic_scale: float = 0.0
                             ) -> SupervisionFsa:
    """Phone-aligned CompactLattice → supervision FSA: every lattice
    path is an allowed alignment; arc tid strings are split into phone
    runs (SplitToPhones semantics) and boundaries land at the
    subsampled rate.  With acoustic_scale=0 all alternatives weigh by
    graph cost only (the reference drops lattice weights entirely;
    keep 0.0 for parity, nonzero to weight alternatives)."""
    times = state_times(clat)
    srcs: List[int] = []
    dsts: List[int] = []
    epdf: List[int] = []
    spdf: List[int] = []
    wgt: List[float] = []
    phn: List[int] = []
    # supervision state per (lattice state): boundary at its time
    bt: List[int] = [t // subsample for t in times]
    final = [s in clat.finals for s in range(clat.num_states)]
    from kaldi_tpu_torch.pipelines.chain import phone_alignment_runs
    for s in range(clat.num_states):
        for a in clat.arcs[s]:
            runs = phone_alignment_runs(tm, a.tids)
            w = -(a.graph_cost + acoustic_scale * a.acoustic_cost)
            t = times[s]
            cur = s
            for k, (phone, dur) in enumerate(runs):
                t += dur
                if k == len(runs) - 1:
                    nxt = a.nextstate
                else:
                    nxt = len(bt)
                    bt.append(t // subsample)
                    final.append(False)
                srcs.append(cur)
                dsts.append(nxt)
                epdf.append(entry_pdf_of(phone))
                spdf.append(self_pdf_of(phone))
                wgt.append(w if k == 0 else 0.0)
                phn.append(phone)
                cur = nxt
    T = max(times[s] for s in clat.finals) // subsample
    return SupervisionFsa(
        src=np.asarray(srcs, np.int32), dst=np.asarray(dsts, np.int32),
        entry_pdf=np.asarray(epdf, np.int32),
        self_pdf=np.asarray(spdf, np.int32),
        weight=np.asarray(wgt, np.float32),
        bt=np.asarray(bt, np.int32), start=clat.start,
        final=np.asarray(final, bool), num_frames=T,
        phone=np.asarray(phn, np.int32))


# Copied from kaldi_tpu/am/chain_supervision.py chunk_supervision.
def chunk_supervision(fsa: SupervisionFsa, c0: int, c1: int
                      ) -> SupervisionFsa:
    """Restrict a supervision FSA to frames [c0, c1) (the fixed-chunk
    cutting of get_egs.sh).  Boundary times shift by −c0; arcs whose
    time window cannot intersect the chunk are dropped.  A chunk that
    starts (ends) mid-utterance marks mid_start (mid_end): the forward
    may then begin inside any arc alive at the boundary and finish in
    any arc alive at the end, matching the reference's chunk-boundary
    semantics (supervision need not begin at the utterance start or
    reach a final state)."""
    T = c1 - c0
    keep = []
    for a in range(len(fsa.src)):
        lo = int(fsa.bt[fsa.src[a]]) - c0
        hi = int(fsa.bt[fsa.dst[a]]) - c0
        if hi < 0 or lo > T:
            continue
        keep.append(a)
    keep = np.asarray(keep, np.int64)
    # states renumber densely over the kept arcs (+ start)
    used = sorted(set(fsa.src[keep].tolist())
                  | set(fsa.dst[keep].tolist()) | {fsa.start})
    remap = {s: i for i, s in enumerate(used)}
    return SupervisionFsa(
        src=np.asarray([remap[s] for s in fsa.src[keep]], np.int32),
        dst=np.asarray([remap[s] for s in fsa.dst[keep]], np.int32),
        entry_pdf=fsa.entry_pdf[keep], self_pdf=fsa.self_pdf[keep],
        weight=fsa.weight[keep],
        bt=np.asarray([int(fsa.bt[s]) - c0 for s in used], np.int32),
        start=remap[fsa.start],
        final=np.asarray([bool(fsa.final[s]) for s in used]),
        num_frames=T,
        phone=None if fsa.phone is None else fsa.phone[keep],
        self_w=None if fsa.self_w is None else fsa.self_w[keep],
        final_w=(np.zeros(len(keep), np.float32)
                 if fsa.final_w is not None else None),
        mid_start=c0 > 0, mid_end=c1 < fsa.num_frames)


# Copied from kaldi_tpu/am/chain_supervision.py add_normalization_weights.
def add_normalization_weights(fsa: SupervisionFsa, den
                              ) -> SupervisionFsa:
    """Compose the supervision FSA with the denominator's
    normalization weights (chain-supervision.h
    AddWeightToSupervisionFst): every arc gains the den graph's
    phone-LM + topology log-probs, making numerator − denominator a
    properly normalized (≤ 0) log-likelihood ratio.

    Weights depend on the phone HISTORY, so states are expanded to
    (supervision state, den LM state) pairs — lattice states that merge
    different histories split, exactly as the reference's FST
    composition does."""
    lm = den.lm
    if lm is None or fsa.phone is None:
        raise KaldiError("add_normalization_weights needs a den graph "
                         "with its PhoneLm and an FSA with phones")
    # per-LM-state weight views (CD den graphs expand states by left
    # phone; normalization weights walk LM states — see norm_view)
    nv_init, nv_self, nv_fwd, nv_final = den.norm_view()
    pidx = {p: i for i, p in enumerate(lm.phones)}
    out_arcs: List[Tuple[int, int, int, int, float, float, float, int]] \
        = []   # (src', dst', epdf, spdf, entry_w, self_w, final_w, phn)
    bt: List[int] = []
    final: List[bool] = []
    state_map: Dict[Tuple[int, int], int] = {}

    def new_state(s: int, lmst: int) -> int:
        key = (s, lmst)
        if key not in state_map:
            state_map[key] = len(bt)
            bt.append(int(fsa.bt[s]))
            final.append(bool(fsa.final[s]))
        return state_map[key]

    arcs_out: Dict[int, List[int]] = {}
    for a in range(len(fsa.src)):
        arcs_out.setdefault(int(fsa.src[a]), []).append(a)

    start = new_state(fsa.start, -1)     # -1 = no phone yet
    stack = [(fsa.start, -1)]
    seen = {(fsa.start, -1)}
    while stack:
        s, lmst = stack.pop()
        sid = state_map[(s, lmst)]
        for a in arcs_out.get(s, []):
            c = pidx[int(fsa.phone[a])]
            if lmst < 0:
                nl = lm.state_of((int(fsa.phone[a]),))
                ew = float(nv_init[nl])
            else:
                nl = int(lm.next_state[lmst, c])
                ew = float(nv_fwd[lmst] + lm.next_logp[lmst, c])
            d = int(fsa.dst[a])
            did = new_state(d, nl)
            out_arcs.append((
                sid, did, int(fsa.entry_pdf[a]), int(fsa.self_pdf[a]),
                float(fsa.weight[a]) + ew, float(nv_self[nl]),
                float(nv_final[nl]) if fsa.final[d] else 0.0,
                int(fsa.phone[a])))
            if (d, nl) not in seen:
                seen.add((d, nl))
                stack.append((d, nl))
    arr = list(zip(*out_arcs))
    return SupervisionFsa(
        src=np.asarray(arr[0], np.int32), dst=np.asarray(arr[1], np.int32),
        entry_pdf=np.asarray(arr[2], np.int32),
        self_pdf=np.asarray(arr[3], np.int32),
        weight=np.asarray(arr[4], np.float32),
        bt=np.asarray(bt, np.int32), start=start,
        final=np.asarray(final, bool), num_frames=fsa.num_frames,
        phone=np.asarray(arr[7], np.int32),
        self_w=np.asarray(arr[5], np.float32),
        final_w=np.asarray(arr[6], np.float32))


# Copied from kaldi_tpu/am/chain_supervision.py pack_supervisions.
def pack_supervisions(fsas: Sequence[SupervisionFsa]
                      ) -> Dict[str, np.ndarray]:
    """Pad a batch of FSAs to common (A_max, S_max) tensors for the
    batched forward."""
    B = len(fsas)
    A = max(len(f.src) for f in fsas)
    S = max(f.num_states for f in fsas)
    out = {
        "src": np.zeros((B, A), np.int32),
        "dst": np.zeros((B, A), np.int32),
        "entry_pdf": np.zeros((B, A), np.int32),
        "self_pdf": np.zeros((B, A), np.int32),
        "weight": np.full((B, A), NEG, np.float32),
        "self_w": np.zeros((B, A), np.float32),
        "final_w": np.zeros((B, A), np.float32),
        "bt": np.zeros((B, S), np.int32),
        "start": np.zeros(B, np.int32),
        "final": np.zeros((B, S), bool),
        "num_frames": np.zeros(B, np.int32),
        "num_states": np.full(B, S, np.int32),
        "n_arcs": np.zeros(B, np.int32),
        "n_states": np.zeros(B, np.int32),
        "mid_start": np.zeros(B, bool),
        "mid_end": np.zeros(B, bool),
    }
    for b, f in enumerate(fsas):
        a, s = len(f.src), f.num_states
        out["src"][b, :a] = f.src
        out["dst"][b, :a] = f.dst
        out["entry_pdf"][b, :a] = f.entry_pdf
        out["self_pdf"][b, :a] = f.self_pdf
        out["weight"][b, :a] = f.weight
        if f.self_w is not None:
            out["self_w"][b, :a] = f.self_w
        if f.final_w is not None:
            out["final_w"][b, :a] = f.final_w
        out["bt"][b, :s] = f.bt
        # padding arcs self-loop on a dead state with weight −inf
        out["src"][b, a:] = S - 1 if s < S else f.src[0]
        out["dst"][b, a:] = S - 1 if s < S else f.dst[0]
        out["start"][b] = f.start
        out["final"][b, :s] = f.final
        out["num_frames"][b] = f.num_frames
        out["n_arcs"][b] = a
        out["n_states"][b] = s
        out["mid_start"][b] = f.mid_start
        out["mid_end"][b] = f.mid_end
    return out


# Copied from kaldi_tpu/am/chain_supervision.py make_chain_egs_from_lattices.
def make_chain_egs_from_lattices(
        feats: Dict[str, np.ndarray], lattices: Dict[str, CompactLattice],
        tm, tree, topo, subsample: int = 3, den=None,
        chunk_size: Optional[int] = None):
    """Whole-utterance chain egs with lattice-derived supervision
    (the get_egs.sh path that consumes alignment LATTICES rather than
    single best alignments).  Returns a ChainEgs whose `sup` field
    carries the packed supervision FSAs; feats are padded to the batch
    max and masked.  Pass the DenominatorGraph as `den` to compose the
    normalization weights in (objf ≤ 0 contract)."""
    from kaldi_tpu_torch.pipelines.chain import ChainEgs

    def pdfs_for(phone, is_entry):
        window = [0] * tree.context_width
        window[tree.central_position] = phone
        st = topo.topology_for_phone(phone)[0]
        cls = (st.forward_pdf_class if is_entry
               else st.self_loop_pdf_class)
        return tree.compute(window, cls)

    utts = sorted(lattices)
    fsas = [supervision_from_lattice(
        lattices[u], tm, lambda p: pdfs_for(p, True),
        lambda p: pdfs_for(p, False), subsample=subsample)
        for u in utts]
    if den is not None:
        fsas = [add_normalization_weights(f, den) for f in fsas]
    # chunk_size (subsampled frames): cut each utterance into
    # fixed-size chunks like get_egs.sh (remainders < chunk_size/2 are
    # dropped, matching its min-chunk behaviour)
    pieces: List[Tuple[SupervisionFsa, np.ndarray]] = []
    for f, u in zip(fsas, utts):
        if chunk_size is None:
            pieces.append((f, feats[u]))
            continue
        c = 0
        while c < f.num_frames:
            c1 = min(c + chunk_size, f.num_frames)
            if c1 - c >= max(chunk_size // 2, 1):
                pieces.append((chunk_supervision(f, c, c1),
                               feats[u][c * subsample:c1 * subsample]))
            c = c1
    sub_fsas = [p[0] for p in pieces]
    # the model subsamples time ×subsample before scoring, so scores
    # and mask must share T_sub exactly: clamp feats to T_sub·subsample
    T_sub = max(f.num_frames for f in sub_fsas)
    T_full = T_sub * subsample
    D = next(iter(feats.values())).shape[1]
    N = len(pieces)
    fpad = np.zeros((N, T_full, D), np.float32)
    mask = np.zeros((N, T_sub), bool)
    for i, (f, x) in enumerate(pieces):
        fl = min(x.shape[0], T_full)
        fpad[i, :fl] = x[:fl]
        mask[i, :f.num_frames] = True
    return ChainEgs(feats=fpad,
                    pdf_ali=np.zeros((N, T_sub), np.int32),
                    mask=mask, sup=pack_supervisions(sub_fsas))


# Copied from kaldi_tpu/am/chain_supervision.py make_chain_egs_e2e.
def make_chain_egs_e2e(feats: Dict[str, np.ndarray],
                       phone_seqs: Dict[str, Sequence[int]],
                       tree, topo, subsample: int = 3, den=None):
    """Whole-utterance END-TO-END chain egs (flat-start: no prior
    alignment; egs/wsj run_e2e / chainbin nnet3-chain-e2e-get-egs
    role): supervision = the transcript's phone sequence with free
    boundaries.  Train with supervision_tolerance >= the longest
    utterance (ChainTrainConfig) so the boundary windows are vacuous.
    Returns a ChainEgs whose `sup` carries the packed FSAs."""
    from kaldi_tpu_torch.pipelines.chain import ChainEgs

    def pdfs_for(phone, is_entry):
        window = [0] * tree.context_width
        window[tree.central_position] = phone
        st = topo.topology_for_phone(phone)[0]
        cls = (st.forward_pdf_class if is_entry
               else st.self_loop_pdf_class)
        return tree.compute(window, cls)

    utts = sorted(phone_seqs)
    fsas = []
    for u in utts:
        T_sub = feats[u].shape[0] // subsample
        fsas.append(supervision_from_text(
            phone_seqs[u], lambda p: pdfs_for(p, True),
            lambda p: pdfs_for(p, False), T_sub))
    if den is not None:
        fsas = [add_normalization_weights(f, den) for f in fsas]
    T_sub_max = max(f.num_frames for f in fsas)
    T_full = T_sub_max * subsample
    D = next(iter(feats.values())).shape[1]
    N = len(utts)
    fpad = np.zeros((N, T_full, D), np.float32)
    mask = np.zeros((N, T_sub_max), bool)
    for i, (f, u) in enumerate(zip(fsas, utts)):
        fl = min(feats[u].shape[0], T_full)
        fpad[i, :fl] = feats[u][:fl]
        mask[i, :f.num_frames] = True
    return ChainEgs(feats=fpad,
                    pdf_ali=np.zeros((N, T_sub_max), np.int32),
                    mask=mask, sup=pack_supervisions(fsas))


# The card part.

INDEX_KEYS = ("src", "dst", "entry_pdf", "self_pdf", "bt", "start",
              "num_frames")


def sup_to_device(sup: Dict[str, np.ndarray], device
                  ) -> Dict[str, torch.Tensor]:
    """A ``pack_supervisions`` dict (numpy) → tensors on ``device``, the
    index arrays as int64 (what ``gather`` and ``index_add_`` take), cast
    once here and not once a frame."""
    out = {}
    for k, v in sup.items():
        a = np.ascontiguousarray(v)
        t = torch.from_numpy(a.astype(np.int64) if k in INDEX_KEYS else a)
        out[k] = t.to(device)
    return out


# Port of kaldi_tpu/am/chain_supervision.py _batched_segment_logsumexp.
def _batched_segment_logsumexp(vals: torch.Tensor, segs: torch.Tensor,
                               num_segments: int) -> torch.Tensor:
    """vals (B, A), segs (B, A) int64 → (B, num_segments): per-row
    segment logsumexp via flattened offset ids.  The segment max is
    detached: log-sum-exp does not depend on it, so its gradient cancels
    in exact arithmetic.  A segment no arc reaches gives NEG + log(1e-30),
    never -inf (which would make NaN gradients downstream)."""
    B, A = vals.shape
    n = B * num_segments
    flat_segs = (segs + torch.arange(B, device=segs.device)[:, None]
                 * num_segments).reshape(-1)
    flat = vals.reshape(-1)
    mx = torch.full((n,), NEG, dtype=vals.dtype, device=vals.device)
    mx = mx.scatter_reduce(0, flat_segs, flat.detach(), "amax",
                           include_self=True)
    s = torch.zeros(n, dtype=vals.dtype, device=vals.device).index_add(
        0, flat_segs, torch.exp(flat - mx[flat_segs]))
    out = mx + torch.log(torch.clamp(s, min=1e-30))
    return out.reshape(B, num_segments)


# Port of kaldi_tpu/am/chain_supervision.py numerator_fsa_logprob.
def numerator_fsa_logprob(scores: torch.Tensor,
                          sup: Dict[str, torch.Tensor],
                          tolerance: int = 0) -> torch.Tensor:
    """Forward log-prob of each sequence through its supervision FSA.

    scores (B, T, P) log acoustic scores at the subsampled rate; sup =
    ``pack_supervisions`` output on the scores' device
    (``sup_to_device``).  Time tolerance t
    lets every phone boundary move ±t frames from its lattice time
    (chain-supervision's left/right tolerance).  The loop runs over the
    padded T and holds each row past its own num_frames, as the
    original's scan does, so nothing is read back to the host.  Returns
    (B,), differentiable in ``scores``."""
    dev = scores.device
    src, dst = sup["src"].long(), sup["dst"].long()
    entry_pdf, self_pdf = sup["entry_pdf"].long(), sup["self_pdf"].long()
    weight = sup["weight"]
    self_w = sup.get("self_w")
    self_w = torch.zeros_like(weight) if self_w is None else self_w
    final_w = sup.get("final_w")
    final_w = torch.zeros_like(weight) if final_w is None else final_w
    bt = sup["bt"].long()
    start = sup["start"].long()
    final = sup["final"].bool()
    num_frames = sup["num_frames"].long()
    B, T, P = scores.shape
    S = bt.shape[1]
    A = src.shape[1]
    tol = tolerance
    mid_start = (sup["mid_start"].bool() if "mid_start" in sup
                 else torch.zeros(B, dtype=torch.bool, device=dev))
    mid_end = (sup["mid_end"].bool() if "mid_end" in sup
               else torch.zeros(B, dtype=torch.bool, device=dev))

    bt_src = bt.gather(1, src)                             # (B, A)
    bt_dst = bt.gather(1, dst)
    is_start = start[:, None] == src
    # every frame's arc scores at once: (B, T, A)
    entry_sc = scores.gather(2, entry_pdf[:, None, :].expand(B, T, A))
    self_sc = scores.gather(2, self_pdf[:, None, :].expand(B, T, A))
    # the tolerance windows of every frame, (T, B, A): exit through dst,
    # entry out of src, staying inside (both strict); act (T, B)
    t_ = torch.arange(T, device=dev)[:, None, None]
    ok_exit = (t_ - bt_dst).abs() <= tol
    ok_entry = (t_ - bt_src).abs() <= tol
    ok_stay = (t_ > bt_src - tol) & (t_ < bt_dst + tol)
    act = torch.arange(T, device=dev)[:, None] < num_frames[None, :]
    neg = scores.new_full((), NEG)

    # frame 0: enter arcs out of the start state whose entry window
    # admits frame 0; a mid-utterance chunk (chunk_supervision) may
    # instead begin by entering ANY window-admissible arc, or inside
    # one (self emission: the chunk cut the phone in half)
    ok0 = torch.where(mid_start[:, None], ok_entry[0], is_start & ok_entry[0])
    alpha = torch.where(ok0, weight + entry_sc[:, 0], neg)
    stay0 = mid_start[:, None] & ok_stay[0]
    alpha = torch.logaddexp(alpha, torch.where(stay0, self_sc[:, 0], neg))
    corr = torch.zeros(B, dtype=scores.dtype, device=dev)
    stay_w = self_sc + self_w[:, None, :]
    enter_w = entry_sc + weight[:, None, :]
    for t in range(1, T):
        # leave-arc → state mass: alpha of arcs whose dst boundary
        # window admits a transition at frame t
        state_in = _batched_segment_logsumexp(
            torch.where(ok_exit[t], alpha, neg), dst, S)
        enter = torch.where(ok_entry[t],
                            state_in.gather(1, src) + enter_w[:, t], neg)
        stay = torch.where(ok_stay[t], alpha + stay_w[:, t], neg)
        new = torch.logaddexp(stay, enter)
        # the per-frame renormalisation (any constant shift gives the
        # same log-prob, so the max is taken detached)
        m = torch.clamp(new.detach().amax(dim=1, keepdim=True), min=NEG)
        new = new - m
        alpha = torch.where(act[t][:, None], new, alpha)
        corr = corr + torch.where(act[t], m[:, 0], 0.0)
    # finish: arcs whose dst is final and whose boundary admits T; a
    # mid-utterance chunk end instead accepts any arc alive at T−1
    fin_std = (final.gather(1, dst)
               & ((num_frames[:, None] - bt_dst).abs() <= tol))
    tend = num_frames[:, None] - 1
    alive = (tend >= bt_src - tol) & (tend < bt_dst + tol)
    fin_ok = torch.where(mid_end[:, None], alive, fin_std)
    fw_eff = torch.where(mid_end[:, None], 0.0, final_w)
    return corr + torch.logsumexp(
        torch.where(fin_ok, alpha + fw_eff, neg), dim=1)
