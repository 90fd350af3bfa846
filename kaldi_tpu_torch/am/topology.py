# Copied from kaldi_tpu/am/topology.py; imports rewritten to kaldi_tpu_torch.
"""HMM topology.

Parity target: src/hmm/hmm-topology.h (HmmTopology) — per-phone HMM
state graphs with pdf-classes and transition probabilities.  The
conventional 3-state left-to-right ("Bakis") topology is the default;
the chain 2-state topology (gen_topo.py in the chain recipes) is also
provided.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

from kaldi_tpu_torch.core.logging import KaldiError

NO_PDF = -1


@dataclasses.dataclass
class HmmState:
    """One emitting (or final non-emitting) HMM state.

    transitions: list of (next_state_index, probability).  pdf_class is
    NO_PDF for the final non-emitting state.  forward_pdf_class /
    self_loop_pdf_class may differ (chain topologies).
    """
    forward_pdf_class: int
    self_loop_pdf_class: int
    transitions: List[Tuple[int, float]]

    @property
    def pdf_class(self) -> int:
        return self.forward_pdf_class


class HmmTopology:
    """Maps phone id → list of HmmState (last state is final/nonemitting)."""

    def __init__(self, phones: Sequence[int],
                 entries: Dict[int, List[HmmState]]):
        self.phones = sorted(phones)
        self.entries = entries
        for p in self.phones:
            if p not in entries:
                raise KaldiError(f"No topology entry for phone {p}")

    def topology_for_phone(self, phone: int) -> List[HmmState]:
        return self.entries[phone]

    def num_pdf_classes(self, phone: int) -> int:
        classes = set()
        for st in self.entries[phone]:
            if st.forward_pdf_class != NO_PDF:
                classes.add(st.forward_pdf_class)
                classes.add(st.self_loop_pdf_class)
        return len(classes)

    @staticmethod
    def three_state(phones: Sequence[int],
                    self_loop_prob: float = 0.5) -> "HmmTopology":
        """The standard 3-emitting-state left-to-right topology
        (egs/wsj/s5/conf default topo)."""
        fwd = 1.0 - self_loop_prob

        def entry() -> List[HmmState]:
            return [
                HmmState(0, 0, [(0, self_loop_prob), (1, fwd)]),
                HmmState(1, 1, [(1, self_loop_prob), (2, fwd)]),
                HmmState(2, 2, [(2, self_loop_prob), (3, fwd)]),
                HmmState(NO_PDF, NO_PDF, []),
            ]

        return HmmTopology(phones, {p: entry() for p in phones})

    @staticmethod
    def chain(phones: Sequence[int]) -> "HmmTopology":
        """Chain/LF-MMI topology (steps/nnet3/chain/gen_topo.py): state 0
        emits pdf-class 0 once then either exits or self-loops through
        pdf-class 1."""
        def entry() -> List[HmmState]:
            return [
                HmmState(0, 1, [(0, 0.5), (1, 0.5)]),
                HmmState(NO_PDF, NO_PDF, []),
            ]

        return HmmTopology(phones, {p: entry() for p in phones})
