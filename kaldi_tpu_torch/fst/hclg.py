# Copied from kaldi_tpu/fst/hclg.py; imports rewritten to kaldi_tpu_torch.
"""HCLG graph compilation.

Parity targets: egs/wsj/s5/utils/mkgraph.sh pipeline,
src/hmm/hmm-utils.h (GetHTransducer, AddSelfLoops),
src/bin/make-h-transducer.cc, src/bin/add-self-loops.cc.

Pipeline (mono; triphone adds the C composition from fst/context.py):

    LG    = min(det*(L_disambig ∘ G))
    CLG   = C ∘ LG        (identity for context width 1)
    HCLGa = min(rmdisambig(det*(Ha ∘ CLG)))
    HCLG  = add_self_loops(HCLGa)

Design deviation from the reference (documented, equivalent): the
self-loop-scale correction term  -self_loop_scale·log(1−p_self)  is
folded into the Ha forward-transition arc at build time instead of
being applied by AddSelfLoops — each traversal of a forward tid arc
corresponds to exactly one visit of its destination state, so the path
weights are identical; it just means Ha is built for a fixed
(transition_scale, self_loop_scale) pair, which our single-function
pipeline always knows.
"""

from __future__ import annotations

import math
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

from kaldi_tpu_torch.core.logging import KaldiError, get_logger
from kaldi_tpu_torch.fst.fst import EPS, INF, Arc, VectorFst
from kaldi_tpu_torch.fst.ops import (
    compose,
    connect,
    determinize_star,
    minimize_encoded,
)
from kaldi_tpu_torch.am.topology import NO_PDF
from kaldi_tpu_torch.am.transitions import TransitionModel

log = get_logger(__name__)


def make_h_transducer(ilabel_info: List[Tuple[int, ...]],
                      trans_model: TransitionModel,
                      disambig_start: int,
                      transition_scale: float = 1.0,
                      self_loop_scale: float = 0.1,
                      ) -> Tuple[VectorFst, List[int]]:
    """Build Ha: transition-ids (input) → CLG labels (output), no self-loops.

    ilabel_info[i] describes CLG ilabel i: a tuple of phones (the context
    window; length 1 for mono) — or, for i >= disambig_start, a
    passthrough disambiguation symbol.  Returns (Ha, disambig_tids): the
    tid-side ids used for disambig passthrough (to strip after det).
    """
    tm = trans_model
    tree = tm.tree
    fst = VectorFst()
    loop = fst.add_state()
    fst.set_start(loop)
    fst.set_final(loop, 0.0)

    # disambig passthrough ids live above the tid range
    disambig_tid_base = tm.num_transition_ids + 1
    disambig_tids: List[int] = []

    for clg_label, info in enumerate(ilabel_info):
        if clg_label == EPS:
            continue
        if clg_label >= disambig_start:
            tid = disambig_tid_base + (clg_label - disambig_start)
            disambig_tids.append(tid)
            fst.add_arc(loop, Arc(tid, clg_label, 0.0, loop))
            continue
        window = list(info)
        phone = window[tree.central_position] if len(window) > 1 else window[0]
        if len(window) == 1 and tree.context_width > 1:
            # pad mono-style window for wider trees
            full = [0] * tree.context_width
            full[tree.central_position] = phone
            window = full
        entry = tm.topo.topology_for_phone(phone)
        # state index in topo → fst state (final topo state == loop)
        topo_to_fst: Dict[int, int] = {}
        final_topo = len(entry) - 1

        def fst_state(ti: int, first_emit: bool) -> int:
            if ti == final_topo:
                return loop
            if ti not in topo_to_fst:
                topo_to_fst[ti] = fst.add_state()
            return topo_to_fst[ti]

        for hmm_state, st in enumerate(entry):
            if st.forward_pdf_class == NO_PDF:
                continue
            fwd_pdf = tree.compute(window, st.forward_pdf_class)
            slf_pdf = tree.compute(window, st.self_loop_pdf_class)
            ts = tm.tuple_to_transition_state(phone, hmm_state, fwd_pdf, slf_pdf)
            self_tid = tm.self_loop_of(ts)
            log_1mp = (tm.get_non_self_loop_log_prob(ts)
                       if self_tid else 0.0)
            src = loop if hmm_state == 0 else fst_state(hmm_state, False)
            for i, (next_state, _prob) in enumerate(st.transitions):
                if next_state == hmm_state:
                    continue  # self-loops added later
                tid = tm.pair_to_transition_id(ts, i)
                # normalized forward log-prob (ignoring self-loop mass)
                logp = tm.get_log_prob(tid) - log_1mp
                w = -transition_scale * logp - self_loop_scale * log_1mp
                olabel = clg_label if hmm_state == 0 else EPS
                dst = fst_state(next_state, hmm_state == 0)
                fst.add_arc(src, Arc(tid, olabel, w, dst))
    return fst, disambig_tids


def add_self_loops(fst: VectorFst, trans_model: TransitionModel,
                   self_loop_scale: float = 0.1) -> VectorFst:
    """Add HMM self-loop arcs after determinization/minimization
    (hmm-utils.cc AddSelfLoops, reorder=true convention: the self-loop
    of transition-state ts sits at the destination of every forward
    tid arc of ts).

    States whose incoming tid arcs disagree on the needed self-loop are
    split per self-loop tid (the reference does the same state
    duplication).
    """
    tm = trans_model
    n = fst.num_states

    def self_loop_tid_of_arc(ilabel: int) -> int:
        if ilabel == EPS or ilabel > tm.num_transition_ids:
            return 0
        ts = int(tm.id2state[ilabel])
        return tm.self_loop_of(ts)

    # Which self-loop tid does each state need, per incoming arc?
    needed: List[set] = [set() for _ in range(n)]
    for s in range(n):
        for a in fst.arcs[s]:
            needed[a.nextstate].add(self_loop_tid_of_arc(a.ilabel))
    if fst.start >= 0:
        needed[fst.start].add(0)

    out = fst.copy()
    # state → {self_loop_tid → concrete state id}; original keeps one variant
    variant: List[Dict[int, int]] = [{} for _ in range(n)]
    for s in range(n):
        tids = sorted(needed[s]) or [0]
        variant[s][tids[0]] = s
        for t in tids[1:]:
            dup = out.add_state()
            variant[s][t] = dup
            for a in fst.arcs[s]:
                out.add_arc(dup, Arc(a.ilabel, a.olabel, a.weight, a.nextstate))
            if fst.is_final(s):
                out.set_final(dup, fst.final(s))

    # Retarget every arc to the right variant of its destination.
    for s in range(out.num_states):
        for a in out.arcs[s]:
            slt = self_loop_tid_of_arc(a.ilabel)
            dest_variants = variant[a.nextstate] if a.nextstate < n else None
            if dest_variants is not None and slt in dest_variants:
                a.nextstate = dest_variants[slt]
            elif dest_variants is not None:
                a.nextstate = dest_variants[sorted(dest_variants)[0]]

    # Add the loops.
    for s in range(n):
        for slt, cs in variant[s].items():
            if slt != 0:
                w = -self_loop_scale * tm.get_log_prob(slt)
                out.add_arc(cs, Arc(slt, EPS, w, cs))
    return connect(out)


def remove_disambig_input(fst: VectorFst, disambig_tids: Sequence[int]
                          ) -> VectorFst:
    """Replace disambig input symbols with ε (fstrmsymbols)."""
    dset = set(disambig_tids)
    for arcs in fst.arcs:
        for a in arcs:
            if a.ilabel in dset:
                a.ilabel = EPS
    return fst


def mkgraph(lang, trans_model: TransitionModel, G: VectorFst,
            transition_scale: float = 1.0,
            self_loop_scale: float = 0.1) -> VectorFst:
    """Full decode-graph build (utils/mkgraph.sh).

    ``lang`` is a fst.lang.Lang.  Currently context-independent trees
    (context_width == 1); wider contexts compose C from fst/context.py.
    """
    tree = trans_model.tree
    LG = compose(lang.L_disambig, G)
    LG = determinize_star(LG)
    LG = minimize_encoded(LG)
    log.info("LG: %s", LG)

    if tree.context_width == 1:
        CLG = LG
        ilabel_info = lang.mono_ilabel_info()
        disambig_start = lang.phone_disambig_start
    else:
        from kaldi_tpu_torch.fst.context import compose_context
        CLG, ilabel_info, disambig_start = compose_context(
            LG, lang, tree.context_width, tree.central_position)
    log.info("CLG: %s", CLG)

    Ha, disambig_tids = make_h_transducer(
        ilabel_info, trans_model, disambig_start,
        transition_scale, self_loop_scale)
    HCLGa = compose(Ha, CLG)
    HCLGa = determinize_star(HCLGa)
    HCLGa = remove_disambig_input(HCLGa, disambig_tids)
    HCLGa = minimize_encoded(HCLGa)
    log.info("HCLGa: %s", HCLGa)
    HCLG = add_self_loops(HCLGa, trans_model, self_loop_scale)
    log.info("HCLG: %s", HCLG)
    return HCLG.arcsort("ilabel")
