# Copied from kaldi_tpu/kws.py; imports rewritten to kaldi_tpu_torch.
"""Keyword search over lattices.

Parity target: src/kws/ (kws-functions.h) — the reference builds factor
transducer indexes over lattice collections and searches them.  Here
the search runs directly over CompactLattices: for a keyword word
sequence, every lattice occurrence is scored with its posterior
probability (sum over paths containing the keyword at that position)
and located in time via the arcs' transition-id string lengths.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Sequence, Tuple

import numpy as np

from kaldi_tpu_torch.core.logging import get_logger
from kaldi_tpu_torch.lattice.lattice import CompactLattice, INF

log = get_logger(__name__)


@dataclasses.dataclass
class KwsHit:
    utt: str
    begin_frame: int
    end_frame: int
    posterior: float


def _log_add(a, b):
    return np.logaddexp(a, b)


def search_lattice(clat: CompactLattice, keyword: Sequence[int],
                   acoustic_scale: float = 1.0, lm_scale: float = 1.0
                   ) -> List[Tuple[int, int, float]]:
    """Occurrences of the word-id sequence in one lattice →
    [(begin_frame, end_frame, posterior)]."""
    if clat.start < 0 or not keyword:
        return []
    order = clat.top_order()
    n = clat.num_states

    def arc_ll(a):
        return -(a.graph_cost * lm_scale + a.acoustic_cost * acoustic_scale)

    # forward/backward sums + state times
    alpha = np.full(n, -np.inf)
    alpha[clat.start] = 0.0
    times = np.zeros(n, np.int64)
    for s in order:
        if alpha[s] == -np.inf:
            continue
        for a in clat.arcs[s]:
            v = alpha[s] + arc_ll(a)
            alpha[a.nextstate] = _log_add(alpha[a.nextstate], v)
            times[a.nextstate] = max(times[a.nextstate],
                                     times[s] + len(a.tids))
    beta = np.full(n, -np.inf)
    for s, (gc, ac, _) in clat.finals.items():
        beta[s] = -(gc * lm_scale + ac * acoustic_scale)
    for s in reversed(order):
        for a in clat.arcs[s]:
            beta[s] = _log_add(beta[s], arc_ll(a) + beta[a.nextstate])
    total = beta[clat.start]
    if not np.isfinite(total):
        return []

    # keyword matches: dp over (state, keyword position) carrying the
    # log-sum of path prefixes through the match start
    K = len(keyword)
    hits: Dict[Tuple[int, int], float] = {}   # (begin, end) → log post sum
    # match[s][k] = logsum of (alpha(begin) + inner path) reaching s with
    # k keyword words consumed; track begin time per entry — to keep this
    # tractable, key on (s, k, begin_time)
    cur: Dict[Tuple[int, int, int], float] = {}
    for s in order:
        if alpha[s] == -np.inf:
            continue
        for a in clat.arcs[s]:
            ll = arc_ll(a)
            if a.word == 0:
                # ε advances existing partial matches without consuming
                for (ss, k, b), v in list(cur.items()):
                    if ss == s:
                        key = (a.nextstate, k, b)
                        cur[key] = _log_add(cur.get(key, -np.inf), v + ll)
                continue
            # start a new match
            if a.word == keyword[0]:
                v = alpha[s] + ll
                if K == 1:
                    e = times[s] + len(a.tids)
                    post_log = v + beta[a.nextstate] - total
                    hk = (int(times[s]), int(e))
                    hits[hk] = _log_add(hits.get(hk, -np.inf), post_log)
                else:
                    key = (a.nextstate, 1, int(times[s]))
                    cur[key] = _log_add(cur.get(key, -np.inf), v)
            # extend existing matches
            for (ss, k, b), v in list(cur.items()):
                if ss == s and k < K and a.word == keyword[k]:
                    if k + 1 == K:
                        e = times[s] + len(a.tids)
                        post_log = v + ll + beta[a.nextstate] - total
                        hk = (b, int(e))
                        hits[hk] = _log_add(hits.get(hk, -np.inf), post_log)
                    else:
                        key = (a.nextstate, k + 1, b)
                        cur[key] = _log_add(cur.get(key, -np.inf), v + ll)
    return [(b, e, float(min(math.exp(p), 1.0)))
            for (b, e), p in sorted(hits.items())]


def keyword_search(lattices: Dict[str, CompactLattice],
                   keywords: Dict[str, Sequence[int]],
                   min_posterior: float = 0.01,
                   acoustic_scale: float = 1.0) -> Dict[str, List[KwsHit]]:
    """Search every keyword in every lattice (kws pipeline entry)."""
    results: Dict[str, List[KwsHit]] = {kw: [] for kw in keywords}
    for utt, clat in lattices.items():
        for kw_id, seq in keywords.items():
            for b, e, post in search_lattice(clat, seq, acoustic_scale):
                if post >= min_posterior:
                    results[kw_id].append(KwsHit(utt, b, e, post))
    for kw in results:
        results[kw].sort(key=lambda h: -h.posterior)
    return results


# ---------------------------------------------------------------------------
# Inverted lattice index (the factor-transducer role)
# ---------------------------------------------------------------------------

class LatticeIndex:
    """Precomputed keyword-search index over a lattice collection.

    The reference (src/kws/kws-functions.h) turns each lattice into a
    time/posterior-annotated factor transducer and unions them into one
    index FST; queries then compose against the index without touching
    the original lattices.  The equivalent here: per utterance we
    precompute the α/β sums, state times, per-arc log-likelihoods and
    the ε-closure once at build time, and store postings word → arcs.
    A query touches only the postings of its first word plus the
    adjacency joins — independent of the number or size of the original
    lattices — and returns exactly what search_lattice returns (the
    oracle used in the tests).
    """

    def __init__(self):
        self.utts: List[str] = []
        # per utt: dict of arrays/structures
        self._u: List[Dict] = []
        self.postings: Dict[int, List[Tuple[int, int]]] = {}

    @staticmethod
    def build(lattices: Dict[str, CompactLattice],
              acoustic_scale: float = 1.0, lm_scale: float = 1.0
              ) -> "LatticeIndex":
        idx = LatticeIndex()
        for utt in sorted(lattices):
            clat = lattices[utt]
            if clat.start < 0:
                continue
            order = clat.top_order()
            n = clat.num_states

            def arc_ll(a):
                return -(a.graph_cost * lm_scale
                         + a.acoustic_cost * acoustic_scale)

            alpha = np.full(n, -np.inf)
            alpha[clat.start] = 0.0
            times = np.zeros(n, np.int64)
            for s in order:
                if alpha[s] == -np.inf:
                    continue
                for a in clat.arcs[s]:
                    alpha[a.nextstate] = _log_add(alpha[a.nextstate],
                                                  alpha[s] + arc_ll(a))
                    times[a.nextstate] = max(times[a.nextstate],
                                             times[s] + len(a.tids))
            beta = np.full(n, -np.inf)
            for s, (gc, ac, _) in clat.finals.items():
                beta[s] = -(gc * lm_scale + ac * acoustic_scale)
            for s in reversed(order):
                for a in clat.arcs[s]:
                    beta[s] = _log_add(beta[s], arc_ll(a) + beta[a.nextstate])
            total = beta[clat.start]
            if not np.isfinite(total):
                continue
            # ε-closure mass: eps_reach[s] = {dst: logsum ll of ε paths}
            eps_reach: Dict[int, Dict[int, float]] = {}
            for s in reversed(order):
                reach: Dict[int, float] = {}
                for a in clat.arcs[s]:
                    if a.word != 0:
                        continue
                    ll = arc_ll(a)
                    reach[a.nextstate] = _log_add(
                        reach.get(a.nextstate, -np.inf), ll)
                    for d2, v2 in eps_reach.get(a.nextstate, {}).items():
                        reach[d2] = _log_add(reach.get(d2, -np.inf), ll + v2)
                if reach:
                    eps_reach[s] = reach
            ui = len(idx.utts)
            idx.utts.append(utt)
            arcs = []          # (src, dst, word, ll, ntids)
            out_arcs: Dict[int, List[int]] = {}
            for s in order:
                for a in clat.arcs[s]:
                    if a.word == 0:
                        continue
                    ai = len(arcs)
                    arcs.append((s, a.nextstate, a.word, arc_ll(a),
                                 len(a.tids)))
                    out_arcs.setdefault(s, []).append(ai)
                    idx.postings.setdefault(a.word, []).append((ui, ai))
            idx._u.append(dict(alpha=alpha, beta=beta, times=times,
                               total=total, eps=eps_reach, arcs=arcs,
                               out=out_arcs))
        return idx

    def _succ_arcs(self, u: Dict, state: int):
        """Word arcs reachable from `state` through ε mass: yields
        (arc_idx, extra_ll)."""
        for ai in u["out"].get(state, ()):
            yield ai, 0.0
        for d, v in u["eps"].get(state, {}).items():
            for ai in u["out"].get(d, ()):
                yield ai, v

    def search(self, keyword: Sequence[int], min_posterior: float = 0.0
               ) -> List[KwsHit]:
        """All occurrences of the word-id sequence across the indexed
        collection, sorted by descending posterior."""
        if not keyword:
            return []
        hits: List[KwsHit] = []
        K = len(keyword)
        # group first-word postings per utterance
        first: Dict[int, List[int]] = {}
        for ui, ai in self.postings.get(keyword[0], ()):
            first.setdefault(ui, []).append(ai)
        for ui, starts in first.items():
            u = self._u[ui]
            arcs = u["arcs"]
            acc: Dict[Tuple[int, int], float] = {}   # (b, e) → log post
            # partial: (dst_state, k, begin) → logsum(alpha + inner)
            cur: Dict[Tuple[int, int, int], float] = {}
            for ai in starts:
                s, d, _, ll, ntid = arcs[ai]
                v = u["alpha"][s] + ll
                b = int(u["times"][s])
                if K == 1:
                    e = b + ntid
                    p = v + u["beta"][d] - u["total"]
                    acc[(b, e)] = _log_add(acc.get((b, e), -np.inf), p)
                else:
                    key = (d, 1, b)
                    cur[key] = _log_add(cur.get(key, -np.inf), v)
            while cur:
                nxt: Dict[Tuple[int, int, int], float] = {}
                for (st, k, b), v in cur.items():
                    for ai, ev in self._succ_arcs(u, st):
                        s, d, w, ll, ntid = arcs[ai]
                        if w != keyword[k]:
                            continue
                        if k + 1 == K:
                            e = int(u["times"][s]) + ntid
                            p = v + ev + ll + u["beta"][d] - u["total"]
                            acc[(b, e)] = _log_add(acc.get((b, e), -np.inf),
                                                   p)
                        else:
                            key = (d, k + 1, b)
                            nxt[key] = _log_add(nxt.get(key, -np.inf),
                                                v + ev + ll)
                cur = nxt
            for (b, e), p in acc.items():
                post = float(min(math.exp(p), 1.0))
                if post >= min_posterior:
                    hits.append(KwsHit(self.utts[ui], b, e, post))
        hits.sort(key=lambda h: (-h.posterior, h.utt, h.begin_frame))
        return hits

    def search_all(self, keywords: Dict[str, Sequence[int]],
                   min_posterior: float = 0.01) -> Dict[str, List[KwsHit]]:
        return {kw: self.search(seq, min_posterior)
                for kw, seq in keywords.items()}


def write_lattice_index(f, idx: LatticeIndex) -> None:
    """Serialize the index (kwsbin/lattice-to-kws-index writes index
    FST shards; kws-index-union merges them — write/read + merge_index
    are that contract here).  Per-utterance payload is flat arrays;
    postings/adjacency/ε-closure are rebuilt at read time."""
    from kaldi_tpu_torch.am.serialize import write_pytree
    from kaldi_tpu_torch.core import io as kio
    kio.write_token(f, "<KwsIndex>")
    kio.write_basic_int32(f, len(idx.utts))
    for ui, utt in enumerate(idx.utts):
        u = idx._u[ui]
        eps = [(s, d, v) for s, reach in u["eps"].items()
               for d, v in reach.items()]
        kio.write_token(f, f"<{utt}>")
        write_pytree(f, {
            "alpha": np.asarray(u["alpha"], np.float64),
            "beta": np.asarray(u["beta"], np.float64),
            "times": np.asarray(u["times"], np.int64),
            "total": np.float64(u["total"]),
            "eps_src": np.asarray([e[0] for e in eps], np.int64),
            "eps_dst": np.asarray([e[1] for e in eps], np.int64),
            "eps_val": np.asarray([e[2] for e in eps], np.float64),
            "arcs": np.asarray(
                [(s, d, w, 0, n) for s, d, w, _ll, n in u["arcs"]],
                np.int64).reshape(len(u["arcs"]), 5),
            "arc_ll": np.asarray([a[3] for a in u["arcs"]],
                                 np.float64)})
    kio.write_token(f, "</KwsIndex>")


def read_lattice_index(f) -> LatticeIndex:
    from kaldi_tpu_torch.am.serialize import read_pytree
    from kaldi_tpu_torch.core import io as kio
    kio.expect_token(f, "<KwsIndex>")
    n = kio.read_basic_int32(f)
    idx = LatticeIndex()
    for _ in range(n):
        utt = kio.read_token(f)[1:-1]
        d = read_pytree(f)
        arcs = [(int(s), int(dd), int(w), float(ll), int(nt))
                for (s, dd, w, _z, nt), ll in
                zip(d["arcs"].reshape(-1, 5), d["arc_ll"])]
        eps: Dict[int, Dict[int, float]] = {}
        for s, dd, v in zip(d["eps_src"], d["eps_dst"], d["eps_val"]):
            eps.setdefault(int(s), {})[int(dd)] = float(v)
        out: Dict[int, List[int]] = {}
        ui = len(idx.utts)
        idx.utts.append(utt)
        for ai, (s, _dd, w, _ll, _nt) in enumerate(arcs):
            out.setdefault(s, []).append(ai)
            idx.postings.setdefault(w, []).append((ui, ai))
        idx._u.append(dict(alpha=d["alpha"], beta=d["beta"],
                           times=d["times"], total=float(d["total"]),
                           eps=eps, arcs=arcs, out=out))
    kio.expect_token(f, "</KwsIndex>")
    return idx


def merge_indexes(parts: List[LatticeIndex]) -> LatticeIndex:
    """Union of index shards (kwsbin/kws-index-union)."""
    out = LatticeIndex()
    for part in parts:
        base = len(out.utts)
        out.utts.extend(part.utts)
        out._u.extend(part._u)
        for w, posts in part.postings.items():
            out.postings.setdefault(w, []).extend(
                (ui + base, ai) for ui, ai in posts)
    return out
