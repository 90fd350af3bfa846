# Copied from kaldi_tpu/fst/__init__.py; imports rewritten to kaldi_tpu_torch.
"""WFST layer (reference L6: src/fstext/ + OpenFst usage + graph build)."""

from kaldi_tpu_torch.fst.fst import EPS, INF, Arc, SymbolTable, VectorFst
from kaldi_tpu_torch.fst.ops import (
    compose,
    connect,
    determinize_star,
    minimize_encoded,
    rand_equivalent,
    rm_epsilon,
    shortest_distance,
    shortest_path,
)
from kaldi_tpu_torch.fst.lang import Lang, Lexicon
from kaldi_tpu_torch.fst.arpa import ArpaModel, arpa_to_fst, make_unigram_arpa
from kaldi_tpu_torch.fst.hclg import add_self_loops, make_h_transducer, mkgraph

__all__ = [
    "EPS", "INF", "Arc", "SymbolTable", "VectorFst",
    "compose", "connect", "determinize_star", "minimize_encoded",
    "rand_equivalent", "rm_epsilon", "shortest_distance", "shortest_path",
    "Lang", "Lexicon", "ArpaModel", "arpa_to_fst", "make_unigram_arpa",
    "add_self_loops", "make_h_transducer", "mkgraph",
]
