"""kaldi_tpu_torch — the PyTorch/CUDA port of kaldi_tpu for NVIDIA Hopper.

The layout mirrors ``kaldi_tpu``: ``features/`` (framing, mel banks,
fbank, MFCC, CMVN, deltas, splicing), ``ops/`` (kernel wrappers and
their plain PyTorch versions), ``csrc/`` (CUDA C++ kernel sources,
built with nvcc on first use), ``am/`` (TDNN-F and diagonal-GMM
acoustic models, .mdl I/O, feature transforms), ``decoder/`` (the
batched lattice beam decoder and the dense Viterbi decoder),
``pipelines/`` (task builders, scoring, wav → lattice, GMM decodes) and
``cli/`` (``gmm-latgen-faster``).

Host-only modules with no JAX dependency (``kaldi_tpu.fst``,
``kaldi_tpu.lattice``, ``kaldi_tpu.native``, ``kaldi_tpu.am.topology``,
``am.tree``, ``am.transitions``, ``core.io``, ``core.table``,
``core.options``, ``core.logging``) are imported from ``kaldi_tpu``
rather than copied.  Nothing in this package imports JAX.

Every wrapper of a CUDA kernel runs its plain PyTorch version for a
tensor on the CPU and launches the kernel (or raises) for a CUDA
tensor; there is no silent fallback between the two.
"""

__version__ = "0.1.0"
