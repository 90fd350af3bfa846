# Copied from kaldi_tpu/fst/grammar.py; imports rewritten to kaldi_tpu_torch.
"""Grammar FSTs: nonterminal replacement for decode graphs.

Parity target: src/decoder/grammar-fst.h GrammarFst — a top-level HCLG
whose special arcs (ilabels ≥ the nonterminal offset, e.g.
#nonterm:contact_list) stand for sub-graphs that can be swapped
without rebuilding the big graph (the use case: per-user contact
lists / dynamic phrases on a fixed LVCSR graph).

TPU-native redesign: the reference expands nonterminals LAZILY inside
its decoder (virtual states = (fst_instance, state)); lazy expansion
is data-dependent control flow that cannot live inside a compiled TPU
decode.  Instead the replacement is an EAGER ARRAY SPLICE over the
CSR graph — pure numpy concatenation + index remapping, milliseconds
even on 10⁶-state graphs — performed whenever a sub-graph changes.
The decode-time property that matters (swap a sub-grammar without
re-preparing the main graph) is preserved: the splice is cheap, and
the compiled decoder is reused as-is since it takes the graph as a
runtime argument pytree (decoder/beam.py) — same-shape swaps don't
even recompile.

Semantics per nonterminal arc (src --NT:olabel/w--> dst): one private
copy of the sub-graph (call sites need distinct return states, exactly
why the reference tracks an instance stack):
    src --ε:olabel/w--> sub.start′
    f --ε:ε/final(f)--> dst        for every sub final state f
"""

from __future__ import annotations

from typing import Dict, Iterable, Set

import numpy as np

from kaldi_tpu_torch.core.logging import KaldiError, get_logger
from kaldi_tpu_torch.fst.csr import CsrGraph
from kaldi_tpu_torch.fst.biglang import csr_from_arrays

log = get_logger(__name__)


def _arc_arrays(g: CsrGraph):
    e_src = np.repeat(np.arange(g.num_states, dtype=np.int64),
                      np.diff(g.e_offsets))
    n_src = np.repeat(np.arange(g.num_states, dtype=np.int64),
                      np.diff(g.n_offsets))
    return e_src, n_src


def replace_nonterminals(base: CsrGraph,
                         subs: Dict[int, CsrGraph]) -> CsrGraph:
    """Expand every arc of `base` whose ilabel is a key of `subs` into
    a private copy of that sub-graph.  Returns a new CsrGraph; `base`
    and the subs are unchanged."""
    nt_ids = set(subs)
    e_src, n_src = _arc_arrays(base)
    is_nt = np.isin(base.e_ilabel, list(nt_ids))
    nt_idx = np.nonzero(is_nt)[0]
    if not len(nt_idx):
        log.warning("replace_nonterminals: no nonterminal arcs found")
        return base

    # surviving base arcs
    keep = ~is_nt
    E_src = [e_src[keep]]
    E_dst = [base.e_nextstate[keep].astype(np.int64)]
    E_il = [base.e_ilabel[keep]]
    E_ol = [base.e_olabel[keep]]
    E_w = [base.e_weight[keep]]
    N_src = [n_src]
    N_dst = [base.n_nextstate.astype(np.int64)]
    N_ol = [base.n_olabel]
    N_w = [base.n_weight]
    finals = [base.final_costs]
    next_state = base.num_states

    for ai in nt_idx:
        sub = subs[int(base.e_ilabel[ai])]
        off = next_state
        next_state += sub.num_states
        se, sn = _arc_arrays(sub)
        E_src.append(se + off)
        E_dst.append(sub.e_nextstate.astype(np.int64) + off)
        E_il.append(sub.e_ilabel)
        E_ol.append(sub.e_olabel)
        E_w.append(sub.e_weight)
        N_src.append(sn + off)
        N_dst.append(sub.n_nextstate.astype(np.int64) + off)
        N_ol.append(sub.n_olabel)
        N_w.append(sub.n_weight)
        finals.append(np.full(sub.num_states, np.float32(np.inf)))
        # entry: src --ε (carries the NT arc's olabel + weight)--> start′
        N_src.append(np.asarray([e_src[ai]], np.int64))
        N_dst.append(np.asarray([off + sub.start], np.int64))
        N_ol.append(np.asarray([base.e_olabel[ai]], np.int32))
        N_w.append(np.asarray([base.e_weight[ai]], np.float32))
        # exits: every sub final --ε/final cost--> dst
        fstates = np.nonzero(np.isfinite(sub.final_costs))[0]
        if not len(fstates):
            raise KaldiError("replace_nonterminals: sub-graph has no "
                             "final state")
        N_src.append(fstates.astype(np.int64) + off)
        N_dst.append(np.full(len(fstates), base.e_nextstate[ai], np.int64))
        N_ol.append(np.zeros(len(fstates), np.int32))
        N_w.append(sub.final_costs[fstates])

    out = csr_from_arrays(
        next_state, base.start,
        np.concatenate(E_src), np.concatenate(E_dst),
        np.concatenate(E_il).astype(np.int32),
        np.concatenate(E_ol).astype(np.int32),
        np.concatenate(E_w).astype(np.float32),
        np.concatenate(N_src), np.concatenate(N_dst),
        np.concatenate(N_ol).astype(np.int32),
        np.concatenate(N_w).astype(np.float32),
        np.concatenate(finals))
    log.info("replace_nonterminals: %d call sites → %d states "
             "(%d emitting + %d ε arcs, ε-depth %d)", len(nt_idx),
             out.num_states, out.num_emitting_arcs, out.num_eps_arcs,
             out.eps_depth)
    return out


class GrammarGraph:
    """A base graph plus swappable sub-grammars (GrammarFst role).

    swap_sub() re-splices in milliseconds; the expanded CSR feeds the
    standard BeamDecoder.  Pad sub-graphs to a fixed state/arc budget
    to keep the expanded shape constant across swaps and reuse the
    compiled decoder with zero recompilation."""

    def __init__(self, base: CsrGraph, subs: Dict[int, CsrGraph]):
        self.base = base
        self.subs = dict(subs)
        self._expanded = None

    def swap_sub(self, nonterm: int, sub: CsrGraph) -> None:
        self.subs[nonterm] = sub
        self._expanded = None

    @property
    def expanded(self) -> CsrGraph:
        if self._expanded is None:
            self._expanded = replace_nonterminals(self.base, self.subs)
        return self._expanded
