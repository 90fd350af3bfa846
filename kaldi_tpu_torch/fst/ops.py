# Copied from kaldi_tpu/fst/ops.py; imports rewritten to kaldi_tpu_torch.
"""WFST algorithms over the tropical semiring.

Parity targets:
  - composition with the epsilon-sequencing filter (OpenFst ComposeFst /
    src/fstext/table-matcher.h fsttablecompose semantics)
  - DeterminizeStar (src/fstext/determinize-star.h): subset
    determinization that also removes input-epsilons, emitting output
    *strings* (chains of intermediate states when >1 output label must
    be emitted on one input label)
  - fstminimizeencoded (src/fstbin/fstminimizeencoded.cc): weighted
    minimization by encoding (ilabel, olabel, weight) triples into
    single classes, then acceptor partition refinement
  - Connect, ShortestPath, RmEpsilon, RandEquivalent (test oracle).

These run host-side at graph-build time, exactly as the reference does
(graph compilation is a one-off CPU stage; decode-time uses the CSR
packing).
"""

from __future__ import annotations

import heapq
import random
from collections import deque
from typing import Dict, List, Optional, Tuple

from kaldi_tpu_torch.core.logging import KaldiError, get_logger
from kaldi_tpu_torch.fst.fst import EPS, INF, Arc, VectorFst

log = get_logger(__name__)


# ---------------------------------------------------------------------------
# Connect (trim): drop non-accessible / non-coaccessible states
# ---------------------------------------------------------------------------

def connect(fst: VectorFst) -> VectorFst:
    n = fst.num_states
    if fst.start < 0 or n == 0:
        return VectorFst()
    # forward reachability
    acc = [False] * n
    stack = [fst.start]
    acc[fst.start] = True
    while stack:
        s = stack.pop()
        for a in fst.arcs[s]:
            if not acc[a.nextstate]:
                acc[a.nextstate] = True
                stack.append(a.nextstate)
    # backward reachability from finals
    radj: List[List[int]] = [[] for _ in range(n)]
    for s in range(n):
        for a in fst.arcs[s]:
            radj[a.nextstate].append(s)
    coacc = [False] * n
    stack = [s for s in fst.finals if acc[s]]
    for s in stack:
        coacc[s] = True
    while stack:
        s = stack.pop()
        for p in radj[s]:
            if not coacc[p]:
                coacc[p] = True
                stack.append(p)
    keep = [s for s in range(n) if acc[s] and coacc[s]]
    remap = {s: i for i, s in enumerate(keep)}
    out = VectorFst()
    out.add_states(len(keep))
    if fst.start in remap:
        out.set_start(remap[fst.start])
    for s in keep:
        ns = remap[s]
        for a in fst.arcs[s]:
            if a.nextstate in remap:
                out.add_arc(ns, Arc(a.ilabel, a.olabel, a.weight, remap[a.nextstate]))
        if s in fst.finals:
            out.set_final(ns, fst.finals[s])
    return out


# ---------------------------------------------------------------------------
# Composition (epsilon-sequencing filter)
# ---------------------------------------------------------------------------

def compose(fst1: VectorFst, fst2: VectorFst, connect_result: bool = True
            ) -> VectorFst:
    """fst1 ∘ fst2.  fst2 should be arcsorted on ilabel (done here).

    Uses Mohri's 3-state epsilon filter so ε-output moves on fst1 and
    ε-input moves on fst2 cannot interleave and duplicate paths.
    """
    if fst1.start < 0 or fst2.start < 0:
        return VectorFst()
    fst2 = fst2  # assume caller arcsorted; we do dict-index below anyway

    # index fst2 arcs by ilabel per state
    idx2: List[Dict[int, List[Arc]]] = []
    for arcs in fst2.arcs:
        d: Dict[int, List[Arc]] = {}
        for a in arcs:
            d.setdefault(a.ilabel, []).append(a)
        idx2.append(d)

    out = VectorFst()
    state_map: Dict[Tuple[int, int, int], int] = {}

    def get_state(t: Tuple[int, int, int]) -> int:
        if t not in state_map:
            state_map[t] = out.add_state()
            s1, s2, _ = t
            w1 = fst1.final(s1)
            w2 = fst2.final(s2)
            if w1 != INF and w2 != INF:
                out.set_final(state_map[t], w1 + w2)
        return state_map[t]

    start = (fst1.start, fst2.start, 0)
    out.set_start(get_state(start))
    queue = deque([start])
    seen = {start}
    while queue:
        t = queue.popleft()
        s1, s2, f = t
        src = state_map[t]

        def emit(a1_i, a1_o, w, ns1, ns2, nf):
            nt = (ns1, ns2, nf)
            dst = get_state(nt)
            out.add_arc(src, Arc(a1_i, a1_o, w, dst))
            if nt not in seen:
                seen.add(nt)
                queue.append(nt)

        # The filter canonicalizes runs of ε-moves between real matches to
        # "all fst1-only moves, then all fst2-only moves": an fst1 ε-output
        # move is blocked once an fst2 ε-input move has happened (f == 2).
        for a1 in fst1.arcs[s1]:
            if a1.olabel == EPS:
                if f != 2:
                    emit(a1.ilabel, EPS, a1.weight, a1.nextstate, s2, 1)
            else:
                for a2 in idx2[s2].get(a1.olabel, ()):
                    emit(a1.ilabel, a2.olabel, a1.weight + a2.weight,
                         a1.nextstate, a2.nextstate, 0)
        # ε-input move on fst2: always allowed, moves filter to 2.
        for a2 in idx2[s2].get(EPS, ()):
            emit(EPS, a2.olabel, a2.weight, s1, a2.nextstate, 2)
    return connect(out) if connect_result else out


# ---------------------------------------------------------------------------
# DeterminizeStar
# ---------------------------------------------------------------------------

def determinize_star(fst: VectorFst, max_states: int = 2_000_000) -> VectorFst:
    """Subset determinization with input-ε removal and output strings.

    Result: deterministic on input labels, no input-epsilons (except on
    the inserted chain states that spill output strings longer than 1).
    Requires the input to be functional up to weights (true for L∘G with
    disambiguation symbols — the whole point of #1, #2 … symbols).
    """
    if fst.start < 0:
        return VectorFst()

    # --- ε-closure over input-epsilon arcs, tracking (weight, ostring) ----
    def eps_closure(subset: Tuple[Tuple[int, float, Tuple[int, ...]], ...]):
        """subset: tuple of (state, weight, ostring). Returns closed subset
        as dict state → (weight, ostring), taking min-weight path."""
        best: Dict[int, Tuple[float, Tuple[int, ...]]] = {}
        heap = [(w, s, o) for (s, w, o) in subset]
        heapq.heapify(heap)
        while heap:
            w, s, o = heapq.heappop(heap)
            if s in best and best[s][0] <= w:
                continue
            best[s] = (w, o)
            for a in fst.arcs[s]:
                if a.ilabel == EPS:
                    no = o + (a.olabel,) if a.olabel != EPS else o
                    nw = w + a.weight
                    if a.nextstate not in best or best[a.nextstate][0] > nw:
                        heapq.heappush(heap, (nw, a.nextstate, no))
        return best

    def normalize(closed: Dict[int, Tuple[float, Tuple[int, ...]]]):
        """Extract common weight (min) and common output prefix."""
        min_w = min(w for w, _ in closed.values())
        strings = [o for _, o in closed.values()]
        prefix = strings[0]
        for s in strings[1:]:
            i = 0
            while i < len(prefix) and i < len(s) and prefix[i] == s[i]:
                i += 1
            prefix = prefix[:i]
            if not prefix:
                break
        plen = len(prefix)
        norm = tuple(sorted((s, w - min_w, o[plen:])
                            for s, (w, o) in closed.items()))
        return min_w, prefix, norm

    out = VectorFst()
    det_states: Dict[tuple, int] = {}

    start_closed = eps_closure(((fst.start, 0.0, ()),))
    w0, prefix0, norm0 = normalize(start_closed)
    if w0 != 0.0 or prefix0:
        # Residual initial weight/output: emit via an initial ε-arc chain.
        pass  # handled uniformly below by storing them on a super-start
    det_states[norm0] = out.add_state()
    out.set_start(det_states[norm0])
    if w0 != 0.0 or prefix0:
        # Insert a fresh start with an ε chain carrying prefix0/w0.
        real_start = out.start
        chain_src = out.add_state()
        out.set_start(chain_src)
        labels = list(prefix0) if prefix0 else [EPS]
        for i, lab in enumerate(labels):
            dst = real_start if i == len(labels) - 1 else out.add_state()
            out.add_arc(chain_src, Arc(EPS, lab, w0 if i == 0 else 0.0, dst))
            chain_src = dst

    queue = deque([norm0])
    while queue:
        norm = queue.popleft()
        src = det_states[norm]
        # final weight: min over final elements of weight + final; output
        # strings of final elements must be empty (functional input) —
        # if not, we'd need final output strings which tropical acceptors
        # can't carry; DeterminizeStar errors likewise.
        fin = INF
        for s, w, o in norm:
            fw = fst.final(s)
            if fw != INF:
                if o:
                    raise KaldiError(
                        "determinize_star: leftover output string at final "
                        "state (input not functional / missing disambig syms)")
                fin = min(fin, w + fw)
        if fin != INF:
            out.set_final(src, fin)

        # group non-ε transitions by ilabel
        by_label: Dict[int, List[Tuple[int, float, Tuple[int, ...]]]] = {}
        for s, w, o in norm:
            for a in fst.arcs[s]:
                if a.ilabel != EPS:
                    no = o + (a.olabel,) if a.olabel != EPS else o
                    by_label.setdefault(a.ilabel, []).append(
                        (a.nextstate, w + a.weight, no))
        for ilabel in sorted(by_label):
            closed = eps_closure(tuple(by_label[ilabel]))
            w, prefix, nnorm = normalize(closed)
            if nnorm not in det_states:
                if len(det_states) >= max_states:
                    raise KaldiError(
                        f"determinize_star: exceeded {max_states} states")
                det_states[nnorm] = out.add_state()
                queue.append(nnorm)
            dst = det_states[nnorm]
            # Emit ilabel with first output label; spill the rest on an
            # ε-input chain (DeterminizeStar's output-string handling).
            olabels = list(prefix) if prefix else [EPS]
            cur = src
            for i, lab in enumerate(olabels):
                is_last = i == len(olabels) - 1
                nxt = dst if is_last else out.add_state()
                out.add_arc(cur, Arc(ilabel if i == 0 else EPS, lab,
                                     w if i == 0 else 0.0, nxt))
                cur = nxt
    return out


# ---------------------------------------------------------------------------
# Minimize (encoded)
# ---------------------------------------------------------------------------

def minimize_encoded(fst: VectorFst) -> VectorFst:
    """Moore partition refinement over encoded (ilabel,olabel,weight) arcs.

    Input should be deterministic (post determinize_star).  Final weights
    partition states initially, as fstminimizeencoded's encode trick does.
    """
    if fst.start < 0:
        return VectorFst()
    n = fst.num_states
    # encode arc triples
    enc: Dict[Tuple[int, int, float], int] = {}

    def code(a: Arc) -> int:
        k = (a.ilabel, a.olabel, round(a.weight, 6))
        if k not in enc:
            enc[k] = len(enc)
        return enc[k]

    coded: List[List[Tuple[int, int]]] = [
        sorted((code(a), a.nextstate) for a in arcs) for arcs in fst.arcs]

    # initial partition: by final weight
    fin_class: Dict[float, int] = {}
    cls = [0] * n
    for s in range(n):
        fw = round(fst.final(s), 6)
        if fw not in fin_class:
            fin_class[fw] = len(fin_class)
        cls[s] = fin_class[fw]

    while True:
        sig: Dict[tuple, int] = {}
        new_cls = [0] * n
        for s in range(n):
            signature = (cls[s], tuple((c, cls[ns]) for c, ns in coded[s]))
            if signature not in sig:
                sig[signature] = len(sig)
            new_cls[s] = sig[signature]
        if new_cls == cls:
            break
        cls = new_cls

    # build quotient
    out = VectorFst()
    num_classes = max(cls) + 1
    out.add_states(num_classes)
    out.set_start(cls[fst.start])
    done = [False] * num_classes
    for s in range(n):
        c = cls[s]
        if done[c]:
            continue
        done[c] = True
        for a in fst.arcs[s]:
            out.add_arc(c, Arc(a.ilabel, a.olabel, a.weight, cls[a.nextstate]))
        if fst.is_final(s):
            out.set_final(c, fst.final(s))
    return connect(out)


# ---------------------------------------------------------------------------
# Epsilon removal (small graphs; used for G etc.)
# ---------------------------------------------------------------------------

def rm_epsilon(fst: VectorFst) -> VectorFst:
    """Remove (ε,ε) arcs by ε-closure.  For acyclic-in-ε graphs."""
    if fst.start < 0:
        return VectorFst()
    n = fst.num_states
    out = VectorFst()
    out.add_states(n)
    out.set_start(fst.start)
    for s in range(n):
        # dijkstra over pure-ε arcs
        dist = {s: 0.0}
        heap = [(0.0, s)]
        while heap:
            w, u = heapq.heappop(heap)
            if w > dist.get(u, INF):
                continue
            for a in fst.arcs[u]:
                if a.ilabel == EPS and a.olabel == EPS:
                    nw = w + a.weight
                    if nw < dist.get(a.nextstate, INF):
                        dist[a.nextstate] = nw
                        heapq.heappush(heap, (nw, a.nextstate))
        fin = INF
        arc_best: Dict[Tuple[int, int, int], float] = {}
        for u, w in dist.items():
            fu = fst.final(u)
            if fu != INF:
                fin = min(fin, w + fu)
            for a in fst.arcs[u]:
                if a.ilabel == EPS and a.olabel == EPS:
                    continue
                k = (a.ilabel, a.olabel, a.nextstate)
                nw = w + a.weight
                if nw < arc_best.get(k, INF):
                    arc_best[k] = nw
        for (il, ol, ns), w in arc_best.items():
            out.add_arc(s, Arc(il, ol, w, ns))
        if fin != INF:
            out.set_final(s, fin)
    return connect(out)


# ---------------------------------------------------------------------------
# Shortest path / distance
# ---------------------------------------------------------------------------

def shortest_distance(fst: VectorFst) -> List[float]:
    """Single-source min-plus distances from start (Dijkstra; weights
    may be negative only in acyclic graphs — falls back to Bellman-Ford
    if negatives present)."""
    n = fst.num_states
    dist = [INF] * n
    if fst.start < 0:
        return dist
    has_neg = any(a.weight < 0 for arcs in fst.arcs for a in arcs)
    dist[fst.start] = 0.0
    if not has_neg:
        heap = [(0.0, fst.start)]
        while heap:
            w, s = heapq.heappop(heap)
            if w > dist[s]:
                continue
            for a in fst.arcs[s]:
                nw = w + a.weight
                if nw < dist[a.nextstate]:
                    dist[a.nextstate] = nw
                    heapq.heappush(heap, (nw, a.nextstate))
    else:
        for _ in range(n):
            changed = False
            for s in range(n):
                if dist[s] == INF:
                    continue
                for a in fst.arcs[s]:
                    nw = dist[s] + a.weight
                    if nw < dist[a.nextstate] - 1e-12:
                        dist[a.nextstate] = nw
                        changed = True
            if not changed:
                break
    return dist


def reverse(fst: VectorFst) -> VectorFst:
    """fstreverse: swap start/finals and flip every arc.  A new
    superinitial state fans out to the old finals carrying their final
    weights (OpenFst Reverse semantics, minus its state renumbering)."""
    out = VectorFst()
    n = fst.num_states
    for _ in range(n + 1):
        out.add_state()
    super_init = n
    out.set_start(super_init)
    if fst.start >= 0:
        out.set_final(fst.start, 0.0)
    for s in range(n):
        for a in fst.arcs[s]:
            out.add_arc(a.nextstate, Arc(a.ilabel, a.olabel, a.weight, s))
        fw = fst.final(s)
        if fw != INF:
            out.add_arc(super_init, Arc(EPS, EPS, fw, s))
    return out


def push_weights(fst: VectorFst) -> VectorFst:
    """fstpush --push_weights (to initial): reweight every arc by the
    min-plus potentials V(s) = distance from s to a final state:
        w'(s→d) = w + V(d) − V(s),  final'(s) = final(s) − V(s)
    with V(start) charged on the initial arcs, so every path total is
    unchanged while each state's cheapest continuation becomes 0 (the
    reweighting OpenFst Push/Kaldi pushspecial perform in tropical)."""
    n = fst.num_states
    if fst.start < 0:
        return fst
    V = shortest_distance(reverse(fst))   # distance-to-final
    # reverse() keeps original state ids 0..n-1; drop the superinitial
    V = V[:n]
    out = VectorFst()
    for _ in range(n):
        out.add_state()
    out.set_start(fst.start)
    v0 = V[fst.start] if V[fst.start] != INF else 0.0
    for s in range(n):
        vs = V[s]
        if vs == INF:
            continue                        # not coaccessible; dropped
        for a in fst.arcs[s]:
            vd = V[a.nextstate]
            if vd == INF:
                continue
            w = a.weight + vd - vs
            if s == fst.start:
                w += v0
            out.add_arc(s, Arc(a.ilabel, a.olabel, w, a.nextstate))
        fw = fst.final(s)
        if fw != INF:
            w = fw - vs + (v0 if s == fst.start else 0.0)
            out.set_final(s, w)
    return connect(out)


def shortest_path(fst: VectorFst) -> Tuple[List[Arc], float]:
    """Best path from start to a final state → (arc list, total cost)."""
    n = fst.num_states
    if fst.start < 0:
        return [], INF
    dist = [INF] * n
    back: List[Optional[Tuple[int, Arc]]] = [None] * n
    dist[fst.start] = 0.0
    heap = [(0.0, fst.start)]
    while heap:
        w, s = heapq.heappop(heap)
        if w > dist[s]:
            continue
        for a in fst.arcs[s]:
            nw = w + a.weight
            if nw < dist[a.nextstate]:
                dist[a.nextstate] = nw
                back[a.nextstate] = (s, a)
                heapq.heappush(heap, (nw, a.nextstate))
    best_s, best_cost = -1, INF
    for s, fw in fst.finals.items():
        if dist[s] + fw < best_cost:
            best_cost = dist[s] + fw
            best_s = s
    if best_s < 0:
        return [], INF
    path: List[Arc] = []
    s = best_s
    while s != fst.start:
        ps, a = back[s]  # type: ignore
        path.append(a)
        s = ps
    path.reverse()
    return path, best_cost


# ---------------------------------------------------------------------------
# Random path equivalence testing (the reference's RandEquivalent oracle)
# ---------------------------------------------------------------------------

def _accept_cost(fst: VectorFst, iseq: List[int]) -> float:
    """Min cost over paths whose *input* label sequence (ε-free) == iseq."""
    # dynamic programming over (state, position), ε-input arcs free to move
    best: Dict[Tuple[int, int], float] = {}
    heap = [(0.0, fst.start, 0)]
    ans = INF
    while heap:
        w, s, p = heapq.heappop(heap)
        if best.get((s, p), INF) < w:
            continue
        best[(s, p)] = w
        if p == len(iseq):
            fw = fst.final(s)
            if fw != INF:
                ans = min(ans, w + fw)
        for a in fst.arcs[s]:
            if a.ilabel == EPS:
                nw = w + a.weight
                if nw < best.get((a.nextstate, p), INF):
                    heapq.heappush(heap, (nw, a.nextstate, p))
            elif p < len(iseq) and a.ilabel == iseq[p]:
                nw = w + a.weight
                if nw < best.get((a.nextstate, p + 1), INF):
                    heapq.heappush(heap, (nw, a.nextstate, p + 1))
    return ans


def rand_equivalent(fst1: VectorFst, fst2: VectorFst, num_paths: int = 30,
                    seed: int = 0, tol: float = 1e-3) -> bool:
    """Sample random paths from each FST; check the other accepts the
    input sequence with the same min cost (acceptor equivalence on the
    input projection — the check used throughout reference fstext tests)."""
    rng = random.Random(seed)

    def sample_path(fst: VectorFst) -> Optional[List[int]]:
        if fst.start < 0:
            return None
        s = fst.start
        seq: List[int] = []
        for _ in range(1000):
            options = list(range(len(fst.arcs[s])))
            can_stop = fst.is_final(s)
            if not options and not can_stop:
                return None
            if can_stop and (not options or rng.random() < 0.3):
                return seq
            a = fst.arcs[s][rng.choice(options)]
            if a.ilabel != EPS:
                seq.append(a.ilabel)
            s = a.nextstate
        return None

    for fa, fb in ((fst1, fst2), (fst2, fst1)):
        for _ in range(num_paths):
            seq = sample_path(fa)
            if seq is None:
                continue
            ca = _accept_cost(fa, seq)
            cb = _accept_cost(fb, seq)
            if abs(ca - cb) > tol:
                log.warning("rand_equivalent mismatch on %s: %.4f vs %.4f",
                            seq[:10], ca, cb)
                return False
    return True
