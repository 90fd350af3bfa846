# Copied from kaldi_tpu/fst/fst.py; imports rewritten to kaldi_tpu_torch.
"""WFST core types: arcs, vector FSTs, symbol tables, semirings.

Parity targets: OpenFst's StdVectorFst as used by the reference
(tools/openfst/), src/fstext/lattice-weight.h (LatticeWeight — a pair
(graph_cost, acoustic_cost) compared by total), and fstext-utils.

Host-side representation is a plain adjacency list (graph *construction*
is control-flow heavy and stays on CPU, like the reference); the device
decoder consumes the CSR packing in fst/csr.py instead.

Weights are tropical costs (floats, min-plus): smaller is better,
``inf`` is Zero (no path), ``0.0`` is One.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from kaldi_tpu_torch.core.logging import KaldiError

EPS = 0                 # epsilon label id, by convention
INF = float("inf")      # tropical Zero


@dataclasses.dataclass
class Arc:
    ilabel: int
    olabel: int
    weight: float
    nextstate: int

    def copy(self) -> "Arc":
        return Arc(self.ilabel, self.olabel, self.weight, self.nextstate)


class VectorFst:
    """Mutable WFST over the tropical semiring.

    states are 0..num_states-1; ``finals[s]`` is the final cost
    (absent = not final).  ``start`` is -1 for an empty FST.
    """

    def __init__(self):
        self.start: int = -1
        self.arcs: List[List[Arc]] = []
        self.finals: Dict[int, float] = {}

    # -- construction ------------------------------------------------------
    def add_state(self) -> int:
        self.arcs.append([])
        return len(self.arcs) - 1

    def add_states(self, n: int) -> int:
        first = len(self.arcs)
        for _ in range(n):
            self.arcs.append([])
        return first

    def add_arc(self, state: int, arc: Arc) -> None:
        self.arcs[state].append(arc)

    def set_start(self, s: int) -> None:
        self.start = s

    def set_final(self, s: int, weight: float = 0.0) -> None:
        if weight == INF:
            self.finals.pop(s, None)
        else:
            self.finals[s] = weight

    # -- accessors ---------------------------------------------------------
    @property
    def num_states(self) -> int:
        return len(self.arcs)

    @property
    def num_arcs(self) -> int:
        return sum(len(a) for a in self.arcs)

    def is_final(self, s: int) -> bool:
        return s in self.finals

    def final(self, s: int) -> float:
        return self.finals.get(s, INF)

    # -- utilities ---------------------------------------------------------
    def copy(self) -> "VectorFst":
        out = VectorFst()
        out.start = self.start
        out.arcs = [[a.copy() for a in arcs] for arcs in self.arcs]
        out.finals = dict(self.finals)
        return out

    def arcsort(self, by: str = "ilabel") -> "VectorFst":
        key = ((lambda a: (a.ilabel, a.olabel)) if by == "ilabel"
               else (lambda a: (a.olabel, a.ilabel)))
        for arcs in self.arcs:
            arcs.sort(key=key)
        return self

    def relabel(self, imap: Optional[Dict[int, int]] = None,
                omap: Optional[Dict[int, int]] = None) -> "VectorFst":
        for arcs in self.arcs:
            for a in arcs:
                if imap is not None:
                    a.ilabel = imap.get(a.ilabel, a.ilabel)
                if omap is not None:
                    a.olabel = omap.get(a.olabel, a.olabel)
        return self

    def invert(self) -> "VectorFst":
        for arcs in self.arcs:
            for a in arcs:
                a.ilabel, a.olabel = a.olabel, a.ilabel
        return self

    def project(self, output: bool = False) -> "VectorFst":
        for arcs in self.arcs:
            for a in arcs:
                if output:
                    a.ilabel = a.olabel
                else:
                    a.olabel = a.ilabel
        return self

    def input_symbols_used(self) -> set:
        return {a.ilabel for arcs in self.arcs for a in arcs}

    # -- text I/O (AT&T format, interoperable with fstcompile/fstprint) ----
    def write_text(self, path_or_file, ilabels=None, olabels=None) -> None:
        close = False
        if isinstance(path_or_file, str):
            f = open(path_or_file, "w")
            close = True
        else:
            f = path_or_file

        def isym(i):
            return ilabels.find(i) if ilabels is not None else str(i)

        def osym(o):
            return olabels.find(o) if olabels is not None else str(o)

        order = [self.start] + [s for s in range(self.num_states)
                                if s != self.start] if self.start >= 0 else []
        for s in order:
            for a in self.arcs[s]:
                w = "" if a.weight == 0.0 else f"\t{a.weight:.6g}"
                f.write(f"{s}\t{a.nextstate}\t{isym(a.ilabel)}\t{osym(a.olabel)}{w}\n")
            if s in self.finals:
                w = "" if self.finals[s] == 0.0 else f"\t{self.finals[s]:.6g}"
                f.write(f"{s}{w}\n")
        if close:
            f.close()

    @staticmethod
    def read_text(path_or_file, isymbols=None, osymbols=None) -> "VectorFst":
        close = False
        if isinstance(path_or_file, str):
            f = open(path_or_file)
            close = True
        else:
            f = path_or_file
        fst = VectorFst()
        state_map: Dict[int, int] = {}

        def get(s: int) -> int:
            if s not in state_map:
                state_map[s] = fst.add_state()
            return state_map[s]

        def ilab(x: str) -> int:
            return isymbols[x] if isymbols is not None else int(x)

        def olab(x: str) -> int:
            return osymbols[x] if osymbols is not None else int(x)

        first = True
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if len(parts) >= 4:
                s = get(int(parts[0]))
                ns = get(int(parts[1]))
                w = float(parts[4]) if len(parts) > 4 else 0.0
                fst.add_arc(s, Arc(ilab(parts[2]), olab(parts[3]), w, ns))
            elif len(parts) <= 2:
                s = get(int(parts[0]))
                fst.set_final(s, float(parts[1]) if len(parts) == 2 else 0.0)
            if first:
                fst.set_start(get(int(parts[0])))
                first = False
        if close:
            f.close()
        return fst

    def __repr__(self) -> str:
        return (f"VectorFst(states={self.num_states}, arcs={self.num_arcs}, "
                f"start={self.start}, finals={len(self.finals)})")


class SymbolTable:
    """Label ↔ string mapping (OpenFst SymbolTable / words.txt format)."""

    def __init__(self):
        self._sym2id: Dict[str, int] = {}
        self._id2sym: Dict[int, str] = {}

    @staticmethod
    def from_list(symbols: Iterable[str], start: int = 0) -> "SymbolTable":
        t = SymbolTable()
        for i, s in enumerate(symbols):
            t.add(s, start + i)
        return t

    def add(self, sym: str, idx: Optional[int] = None) -> int:
        if sym in self._sym2id:
            return self._sym2id[sym]
        if idx is None:
            idx = max(self._id2sym, default=-1) + 1
        if idx in self._id2sym:
            raise KaldiError(f"Symbol id {idx} already used")
        self._sym2id[sym] = idx
        self._id2sym[idx] = sym
        return idx

    def __getitem__(self, sym: str) -> int:
        return self._sym2id[sym]

    def __contains__(self, sym: str) -> bool:
        return sym in self._sym2id

    def find(self, idx: int) -> str:
        return self._id2sym.get(idx, str(idx))

    def get(self, sym: str, default=None):
        return self._sym2id.get(sym, default)

    def __len__(self) -> int:
        return len(self._sym2id)

    def ids(self) -> List[int]:
        return sorted(self._id2sym)

    def symbols(self) -> List[str]:
        return [self._id2sym[i] for i in sorted(self._id2sym)]

    def write(self, path: str) -> None:
        with open(path, "w") as f:
            for i in sorted(self._id2sym):
                f.write(f"{self._id2sym[i]} {i}\n")

    @staticmethod
    def read(path: str) -> "SymbolTable":
        t = SymbolTable()
        with open(path) as f:
            for line in f:
                parts = line.split()
                if len(parts) == 2:
                    t.add(parts[0], int(parts[1]))
        return t
