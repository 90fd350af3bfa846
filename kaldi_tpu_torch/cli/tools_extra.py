"""compute-spectrogram-feats and apply-cmvn-sliding.

Port of the two featbin tools of kaldi_tpu/cli/tools_extra.py (parity
targets featbin/compute-spectrogram-feats.cc, apply-cmvn-sliding.cc),
registered in cli/tools.py's ``TOOLS``.  The spectrogram runs the fbank
kernel with one filter per DFT bin on ``--device`` (default cuda);
sliding-window CMN is host numpy, as in the original.
"""

from __future__ import annotations

import numpy as np

from kaldi_tpu_torch.cli.tools import _feature_tool, _make_frame_opts, tool
from kaldi_tpu_torch.core.options import ParseOptions
from kaldi_tpu_torch.core.table import SequentialTableReader, TableWriter


@tool("compute-spectrogram-feats")
def compute_spectrogram_feats(argv):
    from kaldi_tpu_torch.features.compute import (Spectrogram,
                                                  SpectrogramOptions)

    def factory(po, device):
        return Spectrogram(SpectrogramOptions(
            frame_opts=_make_frame_opts(po)), device=device)

    return _feature_tool(
        argv, factory,
        "compute-spectrogram-feats [opts] <wav-rspec> <feats-wspec>")


@tool("apply-cmvn-sliding")
def apply_cmvn_sliding(argv):
    from kaldi_tpu_torch.features.functions import (SlidingWindowCmnOptions,
                                                    sliding_window_cmn)
    po = ParseOptions("apply-cmvn-sliding [opts] <rspec> <wspec>")
    po.register("cmn-window", int, 600, "window size in frames")
    po.register("min-cmn-window", int, 100, "minimum window")
    po.register("norm-vars", bool, False, "normalize variance")
    po.register("center", bool, True, "center the window")
    args = po.read(argv)
    opts = SlidingWindowCmnOptions(
        cmn_window=po["cmn-window"], min_window=po["min-cmn-window"],
        normalize_variance=po["norm-vars"], center=po["center"])
    with TableWriter(args[1], holder="mat") as w:
        for key, m in SequentialTableReader(args[0], holder="mat"):
            w[key] = sliding_window_cmn(np.asarray(m), opts)
    return 0
