# Copied from kaldi_tpu/am/transitions.py; imports rewritten to kaldi_tpu_torch.
"""Transition model: transition-ids ↔ (phone, HMM-state, pdf).

Parity target: src/hmm/transition-model.h (TransitionModel).  The
decoder's HCLG input labels are transition-ids (tids); tid 0 is ε.
Numbering follows the reference scheme: tids are 1-based, grouped by
"transition state" (= tuple (phone, hmm_state, forward_pdf,
self_loop_pdf)), with one tid per outgoing topology transition.

The hot decode-path artifact is ``tid_to_pdf_array`` — an int32 vector
mapping tid → pdf-id, uploaded once to device HBM so acoustic costs are
a single gather per frame (no per-arc host calls, unlike the
reference's DecodableInterface::LogLikelihood virtual dispatch).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Sequence, Tuple

import numpy as np

from kaldi_tpu_torch.core.logging import KaldiError, get_logger
from kaldi_tpu_torch.am.topology import NO_PDF, HmmTopology
from kaldi_tpu_torch.am.tree import ContextDependency

log = get_logger(__name__)


@dataclasses.dataclass(frozen=True)
class Tuple4:
    phone: int
    hmm_state: int
    forward_pdf: int
    self_loop_pdf: int


class TransitionModel:
    def __init__(self, topo: HmmTopology, tree: ContextDependency):
        self.topo = topo
        self.tree = tree
        self.tuples: List[Tuple4] = []
        self._compute_tuples()
        self._compute_derived()
        self.init_probs()

    # -- structure ---------------------------------------------------------
    def _compute_tuples(self) -> None:
        """One transition state per (phone, hmm_state, fwd_pdf, slf_pdf)
        combination the tree can produce in ANY context (the reference
        builds these from ContextDependency::GetPdfInfo)."""
        seen = set()
        for phone in self.topo.phones:
            entry = self.topo.topology_for_phone(phone)
            for hmm_state, st in enumerate(entry):
                if st.forward_pdf_class == NO_PDF:
                    continue
                if hasattr(self.tree, "possible_pdfs"):
                    fwds = self.tree.possible_pdfs(phone, st.forward_pdf_class)
                    slfs = self.tree.possible_pdfs(phone,
                                                   st.self_loop_pdf_class)
                else:
                    window = [0] * self.tree.context_width
                    window[self.tree.central_position] = phone
                    fwds = [self.tree.compute(window, st.forward_pdf_class)]
                    slfs = [self.tree.compute(window, st.self_loop_pdf_class)]
                if st.forward_pdf_class == st.self_loop_pdf_class:
                    combos = [(f, f) for f in fwds]
                else:
                    combos = [(f, s) for f in fwds for s in slfs]
                for fwd, slf in combos:
                    t = Tuple4(phone, hmm_state, fwd, slf)
                    if t not in seen:
                        seen.add(t)
                        self.tuples.append(t)
        self.tuples.sort(key=lambda t: (t.phone, t.hmm_state,
                                        t.forward_pdf, t.self_loop_pdf))
        self._tuple_index = {t: i for i, t in enumerate(self.tuples)}

    def _compute_derived(self) -> None:
        # trans-state s (1-based) covers tids state2id[s] .. state2id[s+1]-1
        self.state2id = [0, 1]  # index 0 unused; trans-state 1 starts at tid 1
        for t in self.tuples:
            entry = self.topo.topology_for_phone(t.phone)
            n = len(entry[t.hmm_state].transitions)
            self.state2id.append(self.state2id[-1] + n)
        self.num_transition_ids = self.state2id[-1] - 1

        self.id2state = np.zeros(self.num_transition_ids + 1, dtype=np.int32)
        self.id2index = np.zeros(self.num_transition_ids + 1, dtype=np.int32)
        for ts in range(1, len(self.tuples) + 1):
            for i, tid in enumerate(range(self.state2id[ts],
                                          self.state2id[ts + 1])):
                self.id2state[tid] = ts
                self.id2index[tid] = i

        # tid → pdf (self-loop tids use self_loop_pdf)
        self.tid_to_pdf_array = np.zeros(self.num_transition_ids + 1,
                                         dtype=np.int32)
        self._tid_is_self_loop = np.zeros(self.num_transition_ids + 1,
                                          dtype=bool)
        for tid in range(1, self.num_transition_ids + 1):
            t = self.tuples[self.id2state[tid] - 1]
            entry = self.topo.topology_for_phone(t.phone)
            next_state = entry[t.hmm_state].transitions[self.id2index[tid]][0]
            is_self = next_state == t.hmm_state
            self._tid_is_self_loop[tid] = is_self
            self.tid_to_pdf_array[tid] = (t.self_loop_pdf if is_self
                                          else t.forward_pdf)

    def init_probs(self) -> None:
        """Initialize transition log-probs from the topology priors."""
        self.log_probs = np.zeros(self.num_transition_ids + 1,
                                  dtype=np.float32)
        for tid in range(1, self.num_transition_ids + 1):
            t = self.tuples[self.id2state[tid] - 1]
            entry = self.topo.topology_for_phone(t.phone)
            prob = entry[t.hmm_state].transitions[self.id2index[tid]][1]
            self.log_probs[tid] = math.log(max(prob, 1e-10))

    # -- queries (transition-model.h API) ----------------------------------
    @property
    def num_pdfs(self) -> int:
        return self.tree.num_pdfs

    def transition_id_to_pdf(self, tid: int) -> int:
        return int(self.tid_to_pdf_array[tid])

    def transition_id_to_phone(self, tid: int) -> int:
        return self.tuples[self.id2state[tid] - 1].phone

    def transition_id_to_hmm_state(self, tid: int) -> int:
        return self.tuples[self.id2state[tid] - 1].hmm_state

    def is_self_loop(self, tid: int) -> bool:
        return bool(self._tid_is_self_loop[tid])

    def tuple_to_transition_state(self, phone: int, hmm_state: int,
                                  fwd_pdf: int, slf_pdf: int) -> int:
        t = Tuple4(phone, hmm_state, fwd_pdf, slf_pdf)
        try:
            return self._tuple_index[t] + 1
        except KeyError:
            raise KaldiError(f"No transition state for {t}")

    def pair_to_transition_id(self, trans_state: int, trans_index: int) -> int:
        return self.state2id[trans_state] + trans_index

    def self_loop_of(self, trans_state: int) -> int:
        """tid of the self-loop of this transition state, or 0."""
        t = self.tuples[trans_state - 1]
        entry = self.topo.topology_for_phone(t.phone)
        for i, (ns, _) in enumerate(entry[t.hmm_state].transitions):
            if ns == t.hmm_state:
                return self.state2id[trans_state] + i
        return 0

    def get_log_prob(self, tid: int) -> float:
        return float(self.log_probs[tid])

    def get_non_self_loop_log_prob(self, trans_state: int) -> float:
        """log(1 - P(self-loop)) for the state (used with reorder=true)."""
        total = 0.0
        for tid in range(self.state2id[trans_state],
                         self.state2id[trans_state + 1]):
            if not self._tid_is_self_loop[tid]:
                total += math.exp(self.log_probs[tid])
        return math.log(max(total, 1e-10))

    # -- training ----------------------------------------------------------
    def accumulate(self, tid_counts: np.ndarray) -> np.ndarray:
        return tid_counts  # stats are just counts; kept for API symmetry

    def mle_update(self, tid_counts: np.ndarray, floor: float = 0.01) -> float:
        """Re-estimate transition probs from tid occupation counts
        (transition-model.cc MleUpdate).  Returns objf improvement proxy."""
        change = 0.0
        for ts in range(1, len(self.tuples) + 1):
            lo, hi = self.state2id[ts], self.state2id[ts + 1]
            counts = tid_counts[lo:hi].astype(np.float64)
            total = counts.sum()
            if total == 0:
                continue
            probs = np.maximum(counts / total, floor)
            probs /= probs.sum()
            new = np.log(probs).astype(np.float32)
            change += float(np.sum(counts * (new - self.log_probs[lo:hi])))
            self.log_probs[lo:hi] = new
        return change

    # -- alignment utilities (hmm-utils.h) ---------------------------------
    def alignment_to_phones(self, alignment: Sequence[int]) -> List[int]:
        """Phone sequence from a tid alignment (SplitToPhones + mapping).

        A new phone starts at any tid whose hmm_state is the phone's
        initial state and which is not a self-loop (reorder=true
        convention: the forward transition comes first)."""
        phones: List[int] = []
        prev_phone = -1
        for tid in alignment:
            phone = self.transition_id_to_phone(tid)
            is_initial = (self.transition_id_to_hmm_state(tid) == 0
                          and not self.is_self_loop(tid))
            if is_initial or phone != prev_phone:
                phones.append(phone)
            prev_phone = phone
        return phones
