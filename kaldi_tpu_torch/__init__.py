"""kaldi_tpu_torch — the PyTorch/CUDA port of kaldi_tpu for NVIDIA Hopper.

The layout mirrors ``kaldi_tpu``: ``features/`` (framing, mel banks,
fbank, MFCC, CMVN, deltas, splicing), ``ops/`` (kernel wrappers and
their plain PyTorch versions), ``csrc/`` (CUDA C++ kernel sources,
built with nvcc on first use), ``am/`` (TDNN-F and diagonal-GMM
acoustic models, .mdl I/O, feature transforms), ``decoder/`` (the
batched lattice beam decoder and the dense Viterbi decoder),
``pipelines/`` (task builders, scoring, wav → lattice, GMM decodes) and
``cli/`` (``gmm-latgen-faster``).

The host modules the paths share with the JAX package (``core/``,
``fst/``, ``lattice/``, ``native/``, ``am/topology.py``,
``am/transitions.py``, ``am/tree.py``) are this package's own copies of
kaldi_tpu's, each naming its original on its first line.  Nothing in
this package imports JAX or ``kaldi_tpu``.

Entry points run on the CUDA card unless the caller passes
``device="cpu"``; without a card they raise.

Every wrapper of a CUDA kernel runs its plain PyTorch version for a
tensor on the CPU and launches the kernel (or raises) for a CUDA
tensor; there is no silent fallback between the two.
"""

__version__ = "0.1.0"
