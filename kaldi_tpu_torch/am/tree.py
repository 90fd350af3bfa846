# Copied from kaldi_tpu/am/tree.py; imports rewritten to kaldi_tpu_torch.
"""Phonetic decision trees: context-dependent state tying.

Parity targets: src/tree/context-dep.h (ContextDependency),
src/tree/event-map.h (EventMap), src/tree/build-tree.h (BuildTree).

A ContextDependency maps (phone context window, pdf-class) → pdf-id.
The event-map machinery is represented directly as a decision tree of
Python nodes (split / table / leaf); a learned tree is built greedily
by likelihood-gain splitting on phone-set questions, as the reference
does (build-tree-utils.h SplitDecisionTree), from single-Gaussian
sufficient statistics.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from kaldi_tpu_torch.core.logging import KaldiError, get_logger
from kaldi_tpu_torch.am.topology import NO_PDF, HmmTopology

log = get_logger(__name__)

# Event keys (event-map.h): -1 = pdf-class, 0..N-1 = position in window.
KEY_PDF_CLASS = -1


class ContextDependency:
    """Base interface (context-dep.h ContextDependencyInterface)."""

    context_width: int = 1
    central_position: int = 0
    num_pdfs: int = 0

    def compute(self, phone_window: Sequence[int], pdf_class: int) -> int:
        raise NotImplementedError

    def get_pdf_info(self, topo: HmmTopology) -> List[List[Tuple[int, int]]]:
        """pdf → list of (phone, pdf_class) pairs that map to it."""
        info: List[List[Tuple[int, int]]] = [[] for _ in range(self.num_pdfs)]
        for phone in topo.phones:
            for pc in range(topo.num_pdf_classes(phone)):
                window = [0] * self.context_width
                window[self.central_position] = phone
                pdf = self.compute(window, pc)
                info[pdf].append((phone, pc))
        return info


class MonophoneContextDependency(ContextDependency):
    """Monophone 'tree': each (phone, pdf-class) is its own pdf
    (context-dep.h MonophoneContextDependency)."""

    def __init__(self, phones: Sequence[int], topo: HmmTopology):
        self.context_width = 1
        self.central_position = 0
        self._map: Dict[Tuple[int, int], int] = {}
        pdf = 0
        for phone in sorted(phones):
            for pc in range(topo.num_pdf_classes(phone)):
                self._map[(phone, pc)] = pdf
                pdf += 1
        self.num_pdfs = pdf

    def compute(self, phone_window: Sequence[int], pdf_class: int) -> int:
        phone = phone_window[self.central_position]
        try:
            return self._map[(phone, pdf_class)]
        except KeyError:
            raise KaldiError(f"No pdf for phone {phone} pdf-class {pdf_class}")


# ---------------------------------------------------------------------------
# Learned trees (triphone etc.)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TreeNode:
    """Decision-tree node.

    kind 'leaf': answer = pdf-id.
    kind 'split': key (event key), yes_set (phone/class ids answering yes),
                  yes/no children.
    """
    kind: str
    answer: int = -1
    key: int = 0
    yes_set: frozenset = frozenset()
    yes: Optional["TreeNode"] = None
    no: Optional["TreeNode"] = None

    def lookup(self, event: Dict[int, int]) -> int:
        node = self
        while node.kind == "split":
            node = node.yes if event.get(node.key, 0) in node.yes_set else node.no
        return node.answer


class TreeContextDependency(ContextDependency):
    """Context tree over windows of width N (triphone: N=3, central=1)."""

    def __init__(self, context_width: int, central_position: int,
                 root: TreeNode, num_pdfs: int):
        self.context_width = context_width
        self.central_position = central_position
        self.root = root
        self.num_pdfs = num_pdfs

    def compute(self, phone_window: Sequence[int], pdf_class: int) -> int:
        event = {KEY_PDF_CLASS: pdf_class}
        for i, p in enumerate(phone_window):
            event[i] = p
        return self.root.lookup(event)

    def possible_pdfs(self, phone: int, pdf_class: int) -> List[int]:
        """All leaf pdfs reachable when the central phone and pdf-class
        are fixed but context is free (context-dep.cc GetPdfInfo's
        enumeration — needed so the TransitionModel covers every
        context's pdf, not just the zero-context window)."""
        out: List[int] = []

        def walk(node: TreeNode):
            if node.kind == "leaf":
                out.append(node.answer)
                return
            if node.key == KEY_PDF_CLASS:
                walk(node.yes if pdf_class in node.yes_set else node.no)
            elif node.key == self.central_position:
                walk(node.yes if phone in node.yes_set else node.no)
            else:
                walk(node.yes)
                walk(node.no)

        walk(self.root)
        return sorted(set(out))


class GaussStats:
    """Single-Gaussian sufficient statistics per event, for tree building
    (build-tree-questions.h GaussClusterable)."""

    def __init__(self, dim: int):
        self.count = 0.0
        self.sum = np.zeros(dim)
        self.sumsq = np.zeros(dim)

    def add(self, other: "GaussStats") -> None:
        self.count += other.count
        self.sum += other.sum
        self.sumsq += other.sumsq

    def accumulate(self, x: np.ndarray, weight: float = 1.0) -> None:
        self.count += weight
        self.sum += weight * x
        self.sumsq += weight * x * x

    def objf(self, var_floor: float = 0.01) -> float:
        """Log-likelihood of the data under the ML single Gaussian
        (GaussClusterable::Objf)."""
        if self.count <= 0:
            return 0.0
        mean = self.sum / self.count
        var = np.maximum(self.sumsq / self.count - mean ** 2, var_floor)
        dim = len(self.sum)
        return float(-0.5 * self.count *
                     (np.sum(np.log(2 * math.pi * var)) + dim))


def build_tree(stats: Dict[Tuple[Tuple[int, ...], int], GaussStats],
               questions: List[frozenset],
               context_width: int, central_position: int,
               max_leaves: int, thresh: float = 0.0,
               all_pdf_classes: Optional[Sequence[int]] = None
               ) -> TreeContextDependency:
    """Greedy likelihood-gain tree building (build-tree.h BuildTree,
    simplified: one shared root over all seen events, splitting on
    phone-set questions at any window position and on pdf-class).

    stats: (phone_window, pdf_class) → GaussStats.
    questions: list of phone sets (typically from cluster_phones +
    singleton sets).
    """
    events = []
    for (window, pc), st in stats.items():
        ev = {KEY_PDF_CLASS: pc}
        for i, p in enumerate(window):
            ev[i] = p
        events.append((ev, st))

    pdf_class_values = sorted({ev[KEY_PDF_CLASS] for ev, _ in events})
    class_questions = [frozenset([c]) for c in (
        all_pdf_classes if all_pdf_classes is not None else pdf_class_values)]

    def merged(evs) -> GaussStats:
        out = GaussStats(len(evs[0][1].sum))
        for _, st in evs:
            out.add(st)
        return out

    def best_split(evs):
        """Try every (key, question); return (gain, key, yes_set, yes, no)."""
        base = merged(evs).objf()
        best = (0.0, None, None, None, None)
        keys = list(range(context_width)) + [KEY_PDF_CLASS]
        for key in keys:
            qs = class_questions if key == KEY_PDF_CLASS else questions
            for q in qs:
                yes = [e for e in evs if e[0].get(key, 0) in q]
                no = [e for e in evs if e[0].get(key, 0) not in q]
                if not yes or not no:
                    continue
                gain = merged(yes).objf() + merged(no).objf() - base
                if gain > best[0]:
                    best = (gain, key, q, yes, no)
        return best

    # priority-driven greedy splitting
    leaves: List[Tuple[float, int, tuple]] = []  # candidate splits per leaf
    tree_leaves = [events]
    splits: Dict[int, tuple] = {}
    import heapq
    heap = []
    gain, key, q, yes, no = best_split(events)
    if key is not None:
        heapq.heappush(heap, (-gain, 0))
        splits[0] = (key, q, yes, no)
    nodes: Dict[int, TreeNode] = {0: TreeNode("leaf")}

    num_leaves = 1
    while heap and num_leaves < max_leaves:
        neg_gain, leaf_id = heapq.heappop(heap)
        if -neg_gain <= thresh:
            break
        key, q, yes, no = splits.pop(leaf_id)
        node = nodes[leaf_id]
        node.kind = "split"
        node.key = key
        node.yes_set = frozenset(q)
        yes_id = len(nodes)
        node.yes = TreeNode("leaf")
        nodes[yes_id] = node.yes
        no_id = len(nodes)
        node.no = TreeNode("leaf")
        nodes[no_id] = node.no
        num_leaves += 1
        for child_id, child_events, child_node in (
                (yes_id, yes, node.yes), (no_id, no, node.no)):
            g, k, qq, y, n = best_split(child_events)
            if k is not None:
                heapq.heappush(heap, (-g, child_id))
                splits[child_id] = (k, qq, y, n)
            child_node._events = child_events  # type: ignore

    # assign pdf ids to leaves in a stable DFS order
    root = nodes[0]
    pdf = 0

    def assign(node: TreeNode):
        nonlocal pdf
        if node.kind == "leaf":
            node.answer = pdf
            pdf += 1
        else:
            assign(node.yes)
            assign(node.no)

    assign(root)
    log.info("build_tree: %d leaves (max %d) from %d events",
             pdf, max_leaves, len(events))
    return TreeContextDependency(context_width, central_position, root, pdf)


# ---------------------------------------------------------------------------
# Tree-stats serialization (acc-tree-stats / sum-tree-stats wire format)
# ---------------------------------------------------------------------------

def write_tree_stats(path: str,
                     stats: Dict[Tuple[Tuple[int, ...], int], GaussStats]
                     ) -> None:
    """Serialize tree-building stats (the BuildTreeStatsWriter role —
    acc-tree-stats output).  Kaldi-style binary token framing; each
    event = (phone window, pdf-class) with its GaussStats."""
    from kaldi_tpu_torch.core import io as kio
    with kio.open_wxfilename(path) as f:
        kio.init_kaldi_output_stream(f)
        kio.write_token(f, "<TreeStats>")
        kio.write_basic_int32(f, len(stats))
        for (window, pc), st in sorted(stats.items()):
            kio.write_int_vector(f, np.asarray(window, np.int32))
            kio.write_basic_int32(f, pc)
            kio.write_basic_float(f, st.count)
            kio.write_vector(f, st.sum, dtype="float64")
            kio.write_vector(f, st.sumsq, dtype="float64")
        kio.write_token(f, "</TreeStats>")


def read_tree_stats(path: str
                    ) -> Dict[Tuple[Tuple[int, ...], int], GaussStats]:
    from kaldi_tpu_torch.core import io as kio
    with kio.open_rxfilename(path) as f:
        kio.init_kaldi_input_stream(f)
        kio.expect_token(f, "<TreeStats>")
        n = kio.read_basic_int32(f)
        stats: Dict[Tuple[Tuple[int, ...], int], GaussStats] = {}
        for _ in range(n):
            window = tuple(int(x) for x in kio.read_int_vector(f))
            pc = kio.read_basic_int32(f)
            count = kio.read_basic_float(f)
            s = kio.read_vector(f)
            sq = kio.read_vector(f)
            st = GaussStats(len(s))
            st.count = count
            st.sum = np.asarray(s, np.float64)
            st.sumsq = np.asarray(sq, np.float64)
            stats[(window, pc)] = st
        kio.expect_token(f, "</TreeStats>")
        return stats


def sum_tree_stats(parts) -> Dict[Tuple[Tuple[int, ...], int], GaussStats]:
    """Merge tree-stats dicts (sum-tree-stats role)."""
    total: Dict[Tuple[Tuple[int, ...], int], GaussStats] = {}
    for stats in parts:
        for key, st in stats.items():
            if key not in total:
                total[key] = GaussStats(len(st.sum))
            total[key].add(st)
    return total


def _partition_tree(items: List[Tuple[Dict[int, int], int]],
                    keys: Sequence[int]) -> TreeNode:
    """Build a TreeNode decision tree answering exactly the given
    (event → pdf) table: recursively bisect the value set of the
    first key the items still differ on.  Used for TABLE trees
    (full biphone) rather than learned ones."""
    first_pdf = items[0][1]
    if all(pdf == first_pdf for _, pdf in items):
        return TreeNode("leaf", answer=first_pdf)
    for key in keys:
        vals = sorted({ev.get(key, 0) for ev, _ in items})
        if len(vals) > 1:
            yes_set = frozenset(vals[:len(vals) // 2])
            yes = [(ev, p) for ev, p in items
                   if ev.get(key, 0) in yes_set]
            no = [(ev, p) for ev, p in items
                  if ev.get(key, 0) not in yes_set]
            return TreeNode("split", key=key, yes_set=yes_set,
                            yes=_partition_tree(yes, keys),
                            no=_partition_tree(no, keys))
    raise KaldiError("_partition_tree: identical events map to "
                     "different pdfs")


def full_biphone_tree(phones: Sequence[int], topo: "HmmTopology",
                      shared_phones: Optional[Sequence[Sequence[int]]]
                      = None) -> TreeContextDependency:
    """Flat-start FULL left-biphone tree (gmmbin/gmm-init-biphone.cc,
    the e2e 'chain' flat-start recipes): every (left-phone, phone,
    pdf-class) gets its own pdf — no stats, no questions.  Left
    context 0 (utterance start) is a distinct class.  shared_phones
    optionally merges left-context classes (the --shared-phones
    option's role)."""
    phones = sorted(phones)
    left_class: Dict[int, int] = {0: 0}
    if shared_phones:
        for ci, group in enumerate(shared_phones, start=1):
            for p in group:
                left_class[p] = ci
        n_left = 1 + len(shared_phones)
        for p in phones:
            if p not in left_class:
                raise KaldiError("full_biphone_tree: shared_phones "
                                 f"must cover phone {p}")
    else:
        for i, p in enumerate(phones, start=1):
            left_class[p] = i
        n_left = 1 + len(phones)
    items: List[Tuple[Dict[int, int], int]] = []
    pdf_of: Dict[Tuple[int, int, int], int] = {}
    for phone in phones:
        for pc in range(topo.num_pdf_classes(phone)):
            for left in [0] + phones:
                key = (left_class[left], phone, pc)
                if key not in pdf_of:
                    pdf_of[key] = len(pdf_of)
                items.append(({0: left, 1: phone, KEY_PDF_CLASS: pc},
                              pdf_of[key]))
    root = _partition_tree(items, [1, KEY_PDF_CLASS, 0])
    tree = TreeContextDependency(2, 1, root, len(pdf_of))
    log.info("full_biphone_tree: %d phones × %d left classes → %d "
             "pdfs", len(phones), n_left, len(pdf_of))
    return tree
