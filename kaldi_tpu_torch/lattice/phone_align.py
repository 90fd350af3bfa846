# Copied from kaldi_tpu/lattice/phone_align.py; imports rewritten to kaldi_tpu_torch.
"""Phone alignment and alignment-boosting of compact lattices.

Parity targets: src/lat/phone-align-lattice.h (PhoneAlignLattice —
latbin/lattice-align-phones.cc) and src/lat/lattice-functions.h
LatticeBoost (latbin/lattice-boost-ali.cc, the boosted-MMI denominator
preparation of Povey et al. 2008).
"""

from __future__ import annotations

from typing import List, Sequence, Set, Tuple

from kaldi_tpu_torch.core.logging import KaldiError, get_logger
from kaldi_tpu_torch.lattice.lattice import CompactArc, CompactLattice
from kaldi_tpu_torch.lattice.word_align import _runs

log = get_logger(__name__)


def phone_align_lattice(clat: CompactLattice, tm,
                        replace_output_symbols: bool = True
                        ) -> CompactLattice:
    """Split paths at phone boundaries so each output arc carries
    exactly one phone's tids (PhoneAlignLattice).  A phone whose tids
    span several input arcs is buffered across those arcs and emitted
    as ONE arc once complete (a following phone's initial tid arrives,
    or the path ends) -- the reference's ComputationState contract
    (src/lat/phone-align-lattice.cc LatticePhoneAligner), so
    phone-level consumers never see a phone split in two.

    With ``replace_output_symbols`` the olabel becomes the phone id
    (the lattice-align-phones default used by scoring pipelines);
    otherwise buffered words ride the emitted sub-arcs in order.  Path
    tid strings and total weights are preserved exactly: pending
    weight is carried in the computation state and flushed onto the
    first arc emitted."""
    out = CompactLattice()
    # Computation state: (input state, pending tids, pending words,
    # pending graph cost, pending acoustic cost).  Distinct pending
    # contents make distinct output states (the reference's
    # LatticePhoneAligner keys its map the same way).
    start_comp = (clat.start, (), (), 0.0, 0.0)
    comp_to_out = {start_comp: out.add_state()}
    out.start = comp_to_out[start_comp]
    worklist = [start_comp]

    def emit(src_out: int, dst_out: int, runs, words, gc, ac,
             make_final: bool) -> None:
        """Emit ``runs`` as chained arcs src_out -> ... -> dst_out
        (creating intermediate states); pending weight rides the first
        arc.  With no runs, connect with a weight-only arc if needed.
        ``make_final`` marks dst_out final with zero weight (the
        pending weight already emitted on the chain)."""
        words = list(words)
        if not runs:
            if make_final:
                prev = out.finals.get(src_out)
                if prev is None or gc + ac < prev[0] + prev[1]:
                    out.finals[src_out] = (gc, ac, ())
            elif dst_out != src_out:
                out.arcs[src_out].append(
                    CompactArc(0, gc, ac, (), dst_out))
            return
        cur = src_out
        for i, (phone, run_tids) in enumerate(runs):
            if replace_output_symbols:
                olabel = phone
            else:
                olabel = words.pop(0) if words else 0
            w = (gc, ac) if i == 0 else (0.0, 0.0)
            nxt = dst_out if i == len(runs) - 1 else out.add_state()
            out.arcs[cur].append(CompactArc(
                olabel, w[0], w[1], tuple(run_tids), nxt))
            cur = nxt
        if make_final:
            prev = out.finals.get(dst_out)
            if prev is None or prev[0] + prev[1] > 0.0:
                out.finals[dst_out] = (0.0, 0.0, ())

    while worklist:
        comp = worklist.pop()
        s, buf_tids, buf_words, pend_gc, pend_ac = comp
        src_out = comp_to_out[comp]
        fin = clat.finals.get(s)
        if fin is not None:
            fgc, fac, ftids = fin
            all_runs = _runs(tm, list(buf_tids) + list(ftids))
            if all_runs:
                tail = out.add_state()
                emit(src_out, tail, all_runs, buf_words,
                     pend_gc + fgc, pend_ac + fac, make_final=True)
            else:
                emit(src_out, src_out, [], buf_words,
                     pend_gc + fgc, pend_ac + fac, make_final=True)
        for a in clat.arcs[s]:
            tids = buf_tids + tuple(a.tids)
            words = buf_words + ((a.word,) if a.word != 0 else ())
            gc = pend_gc + a.graph_cost
            ac = pend_ac + a.acoustic_cost
            runs = _runs(tm, list(tids))
            # The last run may continue across the next arc: buffer it.
            complete, leftover = (runs[:-1], tuple(runs[-1][1])) \
                if runs else ([], ())
            n_emit_words = 0 if replace_output_symbols else \
                min(len(complete), len(words))
            lo_words = words[n_emit_words:]
            if complete:
                lo_gc = lo_ac = 0.0
            else:
                lo_gc, lo_ac = gc, ac
            nxt_comp = (a.nextstate, leftover, tuple(lo_words),
                        lo_gc, lo_ac)
            if nxt_comp not in comp_to_out:
                comp_to_out[nxt_comp] = out.add_state()
                worklist.append(nxt_comp)
            dst_out = comp_to_out[nxt_comp]
            # With no complete runs, emit() adds a weight-free
            # connectivity arc; weight stays pending in nxt_comp.
            emit(src_out, dst_out, complete, words[:n_emit_words],
                 gc if complete else 0.0, ac if complete else 0.0,
                 make_final=False)
    # The reference's PhoneAlignLatticeOptions.remove_epsilon defaults
    # to true: fold the connectivity epsilons so every remaining arc
    # carries exactly one phone.
    _remove_eps_arcs(out)
    return _trim(out)


def _remove_eps_arcs(lat: CompactLattice) -> None:
    """Fold arcs with no word and no tids into their successors'
    arcs/finals (tropical RemoveEps on an acyclic lattice); processed
    in reverse topological order so successors are already eps-free."""
    order = lat.top_order()
    for s in reversed(order):
        new_arcs = []
        for a in lat.arcs[s]:
            if a.word != 0 or a.tids:
                new_arcs.append(a)
                continue
            d = a.nextstate
            for b in lat.arcs[d]:
                new_arcs.append(CompactArc(
                    b.word, a.graph_cost + b.graph_cost,
                    a.acoustic_cost + b.acoustic_cost, b.tids,
                    b.nextstate))
            fin = lat.finals.get(d)
            if fin is not None:
                fgc, fac, ftids = fin
                if ftids:
                    # final weight still carries tids: leave the eps
                    # arc so the string is not lost
                    new_arcs.append(a)
                    continue
                tg = a.graph_cost + fgc
                ta = a.acoustic_cost + fac
                prev = lat.finals.get(s)
                if prev is None or tg + ta < prev[0] + prev[1]:
                    lat.finals[s] = (tg, ta, ())
        lat.arcs[s] = new_arcs


def _trim(lat: CompactLattice) -> CompactLattice:
    """Drop states unreachable from the start (fstconnect's forward
    half; the aligner never creates non-coaccessible states)."""
    seen = {lat.start}
    stack = [lat.start]
    while stack:
        s = stack.pop()
        for a in lat.arcs[s]:
            if a.nextstate not in seen:
                seen.add(a.nextstate)
                stack.append(a.nextstate)
    if len(seen) == lat.num_states:
        return lat
    keep = sorted(seen)
    new_id = {s: i for i, s in enumerate(keep)}
    out = CompactLattice()
    for _ in keep:
        out.add_state()
    out.start = new_id[lat.start]
    for s in keep:
        for a in lat.arcs[s]:
            out.arcs[new_id[s]].append(CompactArc(
                a.word, a.graph_cost, a.acoustic_cost, a.tids,
                new_id[a.nextstate]))
        if s in lat.finals:
            out.finals[new_id[s]] = lat.finals[s]
    return out


def boost_lattice_ali(clat: CompactLattice, tm,
                      ref_tids: Sequence[int], b: float,
                      silence_phones: Set[int] = frozenset(),
                      max_silence_error: float = 0.0) -> CompactLattice:
    """Boosted MMI: decrease each arc's graph cost by
    ``b * #frame-phone-errors`` against the reference alignment
    (LatticeBoost / lattice-boost-ali).  Frames whose lattice phone is
    in ``silence_phones`` count as ``max_silence_error`` errors each
    (the reference's --max-silence default 0.0: silence is never
    penalized)."""
    from kaldi_tpu_torch.lattice.functions import state_times
    ref_phones = [tm.transition_id_to_phone(t) for t in ref_tids]
    times = state_times(clat)
    # LatticeBoost requires alignment length == lattice frame count;
    # a mismatch (e.g. truncated alignment) would silently boost the
    # tail of every path, so refuse up front like the reference binary.
    num_frames = max((times[s] + len(f[2])
                      for s, f in clat.finals.items()), default=0)
    if num_frames != len(ref_tids):
        raise KaldiError(
            f"boost_lattice_ali: lattice has {num_frames} frames but "
            f"alignment has {len(ref_tids)}")
    out = CompactLattice()
    for _ in range(clat.num_states):
        out.add_state()
    out.start = clat.start
    out.finals = dict(clat.finals)

    def arc_errors(t0: int, tids: Sequence[int]) -> float:
        err = 0.0
        for i, tid in enumerate(tids):
            phone = tm.transition_id_to_phone(tid)
            if phone in silence_phones:
                err += max_silence_error
            elif t0 + i >= len(ref_phones) or phone != ref_phones[t0 + i]:
                err += 1.0
        return err

    for s in range(clat.num_states):
        t0 = times[s]
        for a in clat.arcs[s]:
            gc = a.graph_cost - b * arc_errors(t0, a.tids)
            out.arcs[s].append(CompactArc(a.word, gc, a.acoustic_cost,
                                          a.tids, a.nextstate))
    for s, (gc, ac, ftids) in list(out.finals.items()):
        if ftids:
            out.finals[s] = (gc - b * arc_errors(times[s], ftids), ac,
                             ftids)
    return out


def minimize_lattice(clat: CompactLattice) -> CompactLattice:
    """Merge states with identical suffix languages (identical outgoing
    arc sets + final weights), bottom-up — the suffix-sharing pass of
    src/lat/minimize-lattice.h (MinimizeCompactLattice).  Path sets,
    weights and tid strings are preserved exactly."""
    order = clat.top_order()
    rep: List[int] = list(range(clat.num_states))
    sig_to_state = {}
    for s in reversed(order):
        sig = (
            tuple(sorted((a.word, round(a.graph_cost, 9),
                          round(a.acoustic_cost, 9), a.tids,
                          rep[a.nextstate]) for a in clat.arcs[s])),
            clat.finals.get(s))
        if sig in sig_to_state:
            rep[s] = sig_to_state[sig]
        else:
            sig_to_state[sig] = s
    keep = sorted({rep[s] for s in range(clat.num_states)}
                  | {rep[clat.start]})
    new_id = {s: i for i, s in enumerate(keep)}
    out = CompactLattice()
    for _ in keep:
        out.add_state()
    out.start = new_id[rep[clat.start]]
    for s in keep:
        for a in clat.arcs[s]:
            out.arcs[new_id[s]].append(CompactArc(
                a.word, a.graph_cost, a.acoustic_cost, a.tids,
                new_id[rep[a.nextstate]]))
        if s in clat.finals:
            out.finals[new_id[s]] = clat.finals[s]
    return out
