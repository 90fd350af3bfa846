"""compute-and-process-kaldi-pitch-feats.

Port of the tool of kaldi_tpu/cli/tools_bank10.py (parity target
featbin/compute-and-process-kaldi-pitch-feats.cc), registered in
cli/tools.py's ``TOOLS``: host numpy, on the wave at its int16 scale,
as in the original (see cli/tools_bank3.py).
"""

from __future__ import annotations

import numpy as np

from kaldi_tpu_torch.cli.tools import tool
from kaldi_tpu_torch.core.logging import KaldiError, get_logger
from kaldi_tpu_torch.core.options import ParseOptions
from kaldi_tpu_torch.core.table import SequentialTableReader, TableWriter

log = get_logger(__name__)


@tool("compute-and-process-kaldi-pitch-feats")
def compute_and_process_kaldi_pitch_feats(argv):
    """compute-kaldi-pitch-feats | process-kaldi-pitch-feats in one
    pass (featbin/compute-and-process-kaldi-pitch-feats.cc)."""
    from kaldi_tpu_torch.features.pitch import (PitchExtractionOptions,
                                                compute_kaldi_pitch,
                                                process_pitch)
    po = ParseOptions("compute-and-process-kaldi-pitch-feats [opts] "
                      "<wav-rspec> <feats-wspec>")
    po.register("sample-frequency", float, 16000.0, "sample rate")
    args = po.read(argv)
    opts = PitchExtractionOptions(samp_freq=po["sample-frequency"])
    n = 0
    with TableWriter(args[1], holder="mat") as w:
        for key, (wave, rate) in SequentialTableReader(args[0],
                                                       holder="wav"):
            if rate != opts.samp_freq:
                raise KaldiError(f"{key}: rate {rate} != "
                                 f"{opts.samp_freq}")
            w[key] = np.asarray(process_pitch(
                compute_kaldi_pitch(np.asarray(wave), opts)))
            n += 1
    log.info("compute-and-process-kaldi-pitch-feats: %d utterances", n)
    return 0
