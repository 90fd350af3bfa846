"""Task builders, recipes, scoring and end-to-end decode pipelines
(the exports of kaldi_tpu/pipelines/__init__.py)."""

from kaldi_tpu_torch.pipelines.data import (
    DataSet,
    SyntheticSpeech,
    make_synthetic_dataset,
    yesno_lexicon,
)
from kaldi_tpu_torch.pipelines.score import WerStats, compute_wer, edit_distance
from kaldi_tpu_torch.pipelines.mono import MonoModel, MonoTrainConfig, train_mono
from kaldi_tpu_torch.pipelines.decode import DecodeResult, decode_gmm

__all__ = [
    "DataSet", "SyntheticSpeech", "make_synthetic_dataset", "yesno_lexicon",
    "WerStats", "compute_wer", "edit_distance",
    "MonoModel", "MonoTrainConfig", "train_mono",
    "DecodeResult", "decode_gmm",
]
