# From kaldi_tpu/lattice/__init__.py, down to the copied modules.
"""Lattices: raw and compact lattices, determinization and pruning
and lattice functions (copied from kaldi_tpu/lattice/: lattice.py,
determinize.py, io.py, functions.py)."""

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

__all__ = ["CompactArc", "CompactLattice", "Lattice", "LatticeArc",
           "determinize_lattice", "prune_lattice", "MbrResult",
           "forward_backward_post", "mbr_decode", "nbest", "scale_lattice",
           "state_times"]
