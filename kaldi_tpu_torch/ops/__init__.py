"""Kernel wrappers (CUDA sources in ``kaldi_tpu_torch/csrc/``) and
their plain PyTorch versions."""
