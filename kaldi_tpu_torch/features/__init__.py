"""Feature extraction: framing, mel banks, the fbank and MFCC computers,
CMVN, deltas and splicing."""

from kaldi_tpu_torch.features.cmvn import (apply_cmvn, compute_cmvn_stats,
                                           sum_cmvn_stats)
from kaldi_tpu_torch.features.compute import (Fbank, FbankOptions, Mfcc,
                                              MfccOptions)
from kaldi_tpu_torch.features.functions import (DeltaFeaturesOptions,
                                                add_deltas, splice_frames)
from kaldi_tpu_torch.features.mel import MelBanks, MelBanksOptions
from kaldi_tpu_torch.features.window import (FrameExtractionOptions,
                                             extract_frames,
                                             feature_window_function,
                                             num_frames)

__all__ = ["Fbank", "FbankOptions", "Mfcc", "MfccOptions", "MelBanks",
           "MelBanksOptions", "FrameExtractionOptions", "extract_frames",
           "feature_window_function", "num_frames", "compute_cmvn_stats",
           "sum_cmvn_stats", "apply_cmvn", "DeltaFeaturesOptions",
           "add_deltas", "splice_frames"]
