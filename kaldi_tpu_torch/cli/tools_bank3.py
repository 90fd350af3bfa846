"""compute-kaldi-pitch-feats and process-kaldi-pitch-feats.

Port of the two featbin tools of kaldi_tpu/cli/tools_bank3.py (parity
targets featbin/compute-kaldi-pitch-feats.cc,
process-kaldi-pitch-feats.cc), registered in cli/tools.py's ``TOOLS``.
Pitch is host numpy (features/pitch.py), as in the original.  As there,
compute-kaldi-pitch-feats divides the int16-scale wave by 32768 and
compute-and-process-kaldi-pitch-feats (cli/tools_bank10.py) does not.
The NCCF's ballast is scaled by the signal's own mean square, and 32768
is a power of two, so the two give the same pitch all the same.
"""

from __future__ import annotations

import numpy as np

from kaldi_tpu_torch.cli.tools import tool
from kaldi_tpu_torch.core.options import ParseOptions
from kaldi_tpu_torch.core.table import SequentialTableReader, TableWriter


@tool("compute-kaldi-pitch-feats")
def compute_kaldi_pitch_feats(argv):
    from kaldi_tpu_torch.features.pitch import (PitchExtractionOptions,
                                                compute_kaldi_pitch)
    po = ParseOptions("compute-kaldi-pitch-feats [opts] <wav-rspec> "
                      "<feats-wspec>")
    po.register("sample-frequency", float, 16000.0, "expected sample rate")
    po.register("min-f0", float, 50.0, "min F0")
    po.register("max-f0", float, 400.0, "max F0")
    args = po.read(argv)
    with TableWriter(args[1], holder="mat") as w:
        for key, (wave, rate) in SequentialTableReader(args[0],
                                                       holder="wav"):
            opts = PitchExtractionOptions(samp_freq=float(rate),
                                          min_f0=po["min-f0"],
                                          max_f0=po["max-f0"])
            w[key] = compute_kaldi_pitch(np.asarray(wave, np.float32)
                                         / 32768.0, opts)
    return 0


@tool("process-kaldi-pitch-feats")
def process_kaldi_pitch_feats(argv):
    """(pov, pitch) → 3-dim (pov, normalized-log-pitch, delta-pitch)
    features (featbin/process-kaldi-pitch-feats.cc role)."""
    from kaldi_tpu_torch.features.pitch import process_pitch
    po = ParseOptions("process-kaldi-pitch-feats [opts] <pitch-rspec> "
                      "<feats-wspec>")
    po.register("pov-scale", float, 2.0, "scale on the POV feature")
    po.register("pitch-scale", float, 2.0, "scale on normalized log pitch")
    po.register("delta-pitch-scale", float, 10.0, "scale on delta pitch")
    args = po.read(argv)
    with TableWriter(args[1], holder="mat") as w:
        for key, mat in SequentialTableReader(args[0], holder="mat"):
            w[key] = process_pitch(np.asarray(mat),
                                   pov_scale=po["pov-scale"],
                                   pitch_scale=po["pitch-scale"],
                                   delta_scale=po["delta-pitch-scale"])
    return 0
