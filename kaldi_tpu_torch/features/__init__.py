"""Feature extraction: framing, mel banks, the fbank, MFCC, spectrogram
and PLP computers, the batched frontend, CMVN, deltas, splicing,
sliding-window CMN, pitch and resampling."""

from kaldi_tpu_torch.features.cmvn import (apply_cmvn, compute_cmvn_stats,
                                           sum_cmvn_stats)
from kaldi_tpu_torch.features.compute import (Fbank, FbankOptions, Mfcc,
                                              MfccOptions, Plp, PlpOptions,
                                              Spectrogram,
                                              SpectrogramOptions,
                                              compute_dct_matrix)
from kaldi_tpu_torch.features.functions import (DeltaFeaturesOptions,
                                                SlidingWindowCmnOptions,
                                                add_deltas,
                                                sliding_window_cmn,
                                                splice_frames)
from kaldi_tpu_torch.features.mel import MelBanks, MelBanksOptions
from kaldi_tpu_torch.features.window import (FrameExtractionOptions,
                                             extract_frames,
                                             feature_window_function,
                                             num_frames)
from kaldi_tpu_torch.features.batch import (BatchedFrontend,
                                            GmmDecodableProvider)

__all__ = ["Fbank", "FbankOptions", "Mfcc", "MfccOptions", "Plp",
           "PlpOptions", "Spectrogram", "SpectrogramOptions",
           "compute_dct_matrix", "MelBanks", "MelBanksOptions",
           "FrameExtractionOptions", "extract_frames",
           "feature_window_function", "num_frames", "compute_cmvn_stats",
           "sum_cmvn_stats", "apply_cmvn", "DeltaFeaturesOptions",
           "add_deltas", "splice_frames", "SlidingWindowCmnOptions",
           "sliding_window_cmn", "BatchedFrontend", "GmmDecodableProvider"]
