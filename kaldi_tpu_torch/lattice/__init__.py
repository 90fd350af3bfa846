# From kaldi_tpu/lattice/__init__.py, down to the copied modules.
"""Lattices: raw and compact lattices, determinization and pruning,
lattice functions and LM rescoring, structural operations, word and
phone alignment and CTM output (copied from kaldi_tpu/lattice/:
lattice.py, determinize.py, io.py, functions.py, rescore.py, ops.py,
word_align.py, phone_align.py, ctm.py).  The package exports what the
original's does; the last four are imported as modules, as there."""

from kaldi_tpu_torch.lattice.lattice import (
    CompactArc,
    CompactLattice,
    Lattice,
    LatticeArc,
)
from kaldi_tpu_torch.lattice.determinize import (determinize_lattice,
                                                 prune_lattice)
from kaldi_tpu_torch.lattice.functions import (
    MbrResult,
    forward_backward_post,
    mbr_decode,
    nbest,
    scale_lattice,
    state_times,
)
from kaldi_tpu_torch.lattice.rescore import (compose_lm, compose_lm_pruned,
                                             lmrescore, lmrescore_pruned)

__all__ = ["CompactArc", "CompactLattice", "Lattice", "LatticeArc",
           "determinize_lattice", "prune_lattice", "MbrResult",
           "forward_backward_post", "mbr_decode", "nbest", "scale_lattice",
           "state_times", "compose_lm", "lmrescore",
           "compose_lm_pruned", "lmrescore_pruned"]
