# Port of kaldi_tpu/lm/__init__.py.
"""Language models (reference src/lm/ + src/rnnlm/).

ARPA n-gram parsing/compilation lives in fst/arpa.py (G build is a
graph concern); this package adds the neural LM."""

from kaldi_tpu_torch.fst.arpa import ArpaModel, arpa_to_fst, make_unigram_arpa
from kaldi_tpu_torch.lm.rnnlm import (RnnLm, RnnLmConfig, RnnLmScorer,
                                      perplexity, train_rnnlm,
                                      unigram_proposal)

__all__ = ["ArpaModel", "arpa_to_fst", "make_unigram_arpa",
           "RnnLm", "RnnLmConfig", "RnnLmScorer", "train_rnnlm",
           "perplexity", "unigram_proposal"]
