"""Feature extraction: framing, mel banks and the fbank computer."""

from kaldi_tpu_torch.features.compute import Fbank, FbankOptions
from kaldi_tpu_torch.features.mel import MelBanks, MelBanksOptions
from kaldi_tpu_torch.features.window import (FrameExtractionOptions,
                                             extract_frames,
                                             feature_window_function,
                                             num_frames)

__all__ = ["Fbank", "FbankOptions", "MelBanks", "MelBanksOptions",
           "FrameExtractionOptions", "extract_frames",
           "feature_window_function", "num_frames"]
