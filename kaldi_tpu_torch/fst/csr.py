# Copied from kaldi_tpu/fst/csr.py; imports rewritten to kaldi_tpu_torch.
"""CSR packing of a compiled graph for device decoding.

Parity target: the fork's CudaFst (src/cudadecoder/cuda-fst.h in the
upstream descendant — CSR-packed HCLG resident in GPU memory, split
into emitting and ε arc sets).  Here the pack is a set of numpy/jnp
arrays resident in TPU HBM:

    emitting arcs:  e_offsets (S+1,), e_ilabel/e_nextstate (int32),
                    e_weight (f32), e_olabel (int32)
    epsilon arcs:   n_offsets (S+1,), n_nextstate, n_weight, n_olabel
    final costs:    (S,) f32 (+inf if non-final)

plus static metadata the compiled decoder needs at trace time:
max out-degrees and the ε-subgraph depth (HCLG's ε arcs are acyclic —
backoff/determinization chains — so a fixed number of masked expansion
sweeps covers the closure; the depth is measured here and baked into
the lax.scan body, replacing the reference's priority-queue
ProcessNonemitting with data-independent control flow).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from kaldi_tpu_torch.core.logging import KaldiError, get_logger
from kaldi_tpu_torch.fst.fst import EPS, INF, VectorFst

log = get_logger(__name__)

# Encoded olabel sequences: ε-elimination (biglang.eps_precompose) can
# fold several word olabels onto ONE arc (a composed emitting arc whose
# destination ε-closure crosses a word completion — e.g. 1-phone words
# in triphone graphs, or determinized CLG output with olabels on
# emitting arcs).  Labels >= OLSEQ_BASE index into CsrGraph.olabel_seqs
# (a tuple of plain word ids, emitted in order); labels below it are
# plain word ids.  The device never interprets olabels — records carry
# arc indices and olabels are recovered host-side — so the encoding
# costs nothing on the compute path.
OLSEQ_BASE = 1 << 24


def expand_olabel(ol: int, seqs) -> tuple:
    """Decode one (possibly sequence-encoded) olabel to a tuple of
    plain word ids."""
    ol = int(ol)
    if ol <= 0:
        return ()
    if ol < OLSEQ_BASE:
        return (ol,)
    return tuple(seqs[ol - OLSEQ_BASE])


@dataclasses.dataclass
class CsrGraph:
    num_states: int
    start: int
    # emitting arcs (ilabel != 0)
    e_offsets: np.ndarray
    e_ilabel: np.ndarray
    e_olabel: np.ndarray
    e_weight: np.ndarray
    e_nextstate: np.ndarray
    # epsilon (non-emitting) arcs
    n_offsets: np.ndarray
    n_olabel: np.ndarray
    n_weight: np.ndarray
    n_nextstate: np.ndarray
    final_costs: np.ndarray
    max_emit_degree: int
    max_eps_degree: int
    eps_depth: int
    # decoder ε sweeps per frame; 0 = use eps_depth.  Transitively
    # closed graphs (biglang.eps_close) need only 1 even though the
    # closed arc set's structural depth is unchanged.
    eps_sweeps: int = 0
    # initial token set (start + its ε-closure); None = just start.
    # Set by biglang.eps_precompose for ε-free graphs.
    init_states: Optional[np.ndarray] = None
    init_costs: Optional[np.ndarray] = None
    # olabel-sequence table for labels >= OLSEQ_BASE (see expand_olabel)
    olabel_seqs: Optional[list] = None
    # per-initial-token encoded olabel (word olabels on the start
    # ε-closure path — e.g. a 1-phone first word in a triphone graph);
    # aligned with init_states, 0 = none
    init_olabels: Optional[np.ndarray] = None

    def initial_tokens(self):
        """(states, costs) — host-computed ε closure of the start."""
        if self.init_states is not None:
            return self.init_states, self.init_costs
        # closure over the ε arc set (host BFS; graphs are ε-DAGs)
        best = {self.start: 0.0}
        stack = [self.start]
        while stack:
            s = stack.pop()
            for i in range(self.n_offsets[s], self.n_offsets[s + 1]):
                d = int(self.n_nextstate[i])
                c = best[s] + float(self.n_weight[i])
                if c < best.get(d, np.inf):
                    best[d] = c
                    stack.append(d)
        states = np.asarray(sorted(best), np.int32)
        return states, np.asarray([best[int(s)] for s in states],
                                  np.float32)

    @property
    def num_sweeps(self) -> int:
        return self.eps_sweeps or self.eps_depth

    @property
    def num_emitting_arcs(self) -> int:
        return len(self.e_ilabel)

    @property
    def num_eps_arcs(self) -> int:
        return len(self.n_weight)


def pack_fst(fst: VectorFst) -> CsrGraph:
    S = fst.num_states
    if S == 0 or fst.start < 0:
        raise KaldiError("pack_fst: empty FST")
    e_off = np.zeros(S + 1, dtype=np.int32)
    n_off = np.zeros(S + 1, dtype=np.int32)
    e_il, e_ol, e_w, e_ns = [], [], [], []
    n_ol, n_w, n_ns = [], [], []
    for s in range(S):
        e_off[s] = len(e_il)
        n_off[s] = len(n_w)
        for a in fst.arcs[s]:
            if a.ilabel != EPS:
                e_il.append(a.ilabel)
                e_ol.append(a.olabel)
                e_w.append(a.weight)
                e_ns.append(a.nextstate)
        for a in fst.arcs[s]:
            if a.ilabel == EPS:
                n_ol.append(a.olabel)
                n_w.append(a.weight)
                n_ns.append(a.nextstate)
    e_off[S] = len(e_il)
    n_off[S] = len(n_w)

    final = np.full(S, np.float32(np.inf), dtype=np.float32)
    for s, w in fst.finals.items():
        final[s] = w

    e_deg = np.diff(e_off)
    n_deg = np.diff(n_off)

    # ε-subgraph depth via topological longest path (must be a DAG)
    depth = _eps_depth(S, n_off, np.array(n_ns, dtype=np.int64))

    return CsrGraph(
        num_states=S,
        start=fst.start,
        e_offsets=e_off,
        e_ilabel=np.asarray(e_il, dtype=np.int32),
        e_olabel=np.asarray(e_ol, dtype=np.int32),
        e_weight=np.asarray(e_w, dtype=np.float32),
        e_nextstate=np.asarray(e_ns, dtype=np.int32),
        n_offsets=n_off,
        n_olabel=np.asarray(n_ol, dtype=np.int32),
        n_weight=np.asarray(n_w, dtype=np.float32),
        n_nextstate=np.asarray(n_ns, dtype=np.int32),
        final_costs=final,
        max_emit_degree=int(e_deg.max(initial=0)),
        max_eps_degree=int(n_deg.max(initial=0)),
        eps_depth=depth,
    )


def csr_to_vector_fst(g: CsrGraph) -> VectorFst:
    """Inverse of pack_fst (for oracle decoding / inspection of graphs
    built directly into CSR form — small graphs only)."""
    from kaldi_tpu_torch.fst.fst import Arc
    fst = VectorFst()
    for _ in range(g.num_states):
        fst.add_state()
    fst.set_start(g.start)
    for s in range(g.num_states):
        for i in range(g.e_offsets[s], g.e_offsets[s + 1]):
            fst.add_arc(s, Arc(int(g.e_ilabel[i]), int(g.e_olabel[i]),
                               float(g.e_weight[i]), int(g.e_nextstate[i])))
        for i in range(g.n_offsets[s], g.n_offsets[s + 1]):
            fst.add_arc(s, Arc(EPS, int(g.n_olabel[i]),
                               float(g.n_weight[i]), int(g.n_nextstate[i])))
        if np.isfinite(g.final_costs[s]):
            fst.set_final(s, float(g.final_costs[s]))
    return fst


def _eps_depth(S: int, n_off: np.ndarray, n_ns: np.ndarray) -> int:
    """Longest path length in the ε-subgraph (raises on ε-cycles)."""
    if len(n_ns) == 0:
        return 0
    indeg = np.zeros(S, dtype=np.int64)
    for t in n_ns:
        indeg[t] += 1
    from collections import deque
    q = deque(np.nonzero(indeg == 0)[0].tolist())
    depth = np.zeros(S, dtype=np.int64)
    seen = 0
    # only states with ε-arcs matter, but run over all for simplicity
    while q:
        s = q.popleft()
        seen += 1
        for i in range(n_off[s], n_off[s + 1]):
            t = int(n_ns[i])
            depth[t] = max(depth[t], depth[s] + 1)
            indeg[t] -= 1
            if indeg[t] == 0:
                q.append(t)
    if seen != S:
        raise KaldiError("pack_fst: ε-cycle detected in graph")
    return int(depth.max())
