"""compute-and-process-kaldi-pitch-feats, nnet3-am-copy and
nnet3-am-info.

Port of those tools of kaldi_tpu/cli/tools_bank10.py (parity targets
featbin/compute-and-process-kaldi-pitch-feats.cc,
nnet3bin/nnet3-am-copy.cc, nnet3-am-info.cc), registered in
cli/tools.py's ``TOOLS``: host numpy, copied; the pitch on the wave at
its int16 scale, as in the original (see cli/tools_bank3.py).
gmm-est-regtree-mllr (gmmbin/gmm-est-regtree-mllr.cc) computes its
statistics' mixture posteriors on ``--device`` (default cuda) and
estimates on the host (am/regtree.py).
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


# Copied from kaldi_tpu/cli/tools_bank10.py nnet3_am_copy.
@tool("nnet3-am-copy")
def nnet3_am_copy(argv):
    """Copy an nnet3 .mdl; --raw extracts the bare nnet
    (nnet3bin/nnet3-am-copy.cc)."""
    from kaldi_tpu_torch.am import nnet3_io as n3
    po = ParseOptions("nnet3-am-copy [--raw=false] <mdl-in> <out>")
    po.register("raw", bool, False, "write bare nnet (final.raw)")
    args = po.read(argv)
    with open(args[0], "rb") as f:
        if f.read(2) != b"\0B":
            raise KaldiError(f"{args[0]}: not binary kaldi")
        head = f.read()
    # the .mdl holds <TransitionModel>…</TransitionModel> then the nnet
    tag = b"</TransitionModel>"
    pos = head.find(tag)
    tm_blob = head[:pos + len(tag)] if pos >= 0 else b""
    nnet_blob = head[pos + len(tag):] if pos >= 0 else head
    import io as pio
    model = n3.read_nnet3(pio.BytesIO(nnet_blob))
    with open(args[1], "wb") as f:
        f.write(b"\0B")
        if not po["raw"] and tm_blob:
            f.write(tm_blob)
        n3.write_nnet3(f, model)
    log.info("nnet3-am-copy: %d components%s", len(model.components),
             " (raw)" if po["raw"] else "")
    return 0


# Copied from kaldi_tpu/cli/tools_bank10.py nnet3_am_info.
@tool("nnet3-am-info")
def nnet3_am_info(argv):
    import io as pio
    from kaldi_tpu_torch.am import nnet3_io as n3
    po = ParseOptions("nnet3-am-info <mdl>")
    args = po.read(argv)
    with open(args[0], "rb") as f:
        if f.read(2) != b"\0B":
            raise KaldiError(f"{args[0]}: not binary kaldi")
        head = f.read()
    tag = b"</TransitionModel>"
    pos = head.find(tag)
    model = n3.read_nnet3(
        pio.BytesIO(head[pos + len(tag):] if pos >= 0 else head))
    print(f"num-components {len(model.components)}")
    for c in model.components:
        print(f"component name={c.name} type={c.ctype} "
              f"fields={','.join(sorted(c.fields))}")
    return 0


# Port of kaldi_tpu/cli/tools_bank10.py gmm_est_regtree_mllr.
@tool("gmm-est-regtree-mllr")
def gmm_est_regtree_mllr(argv):
    """Estimate per-base-class MLLR mean transforms from alignments and
    write the adapted model (gmmbin/gmm-est-regtree-mllr.cc folded with
    the transform application — the decode-ready artifact).  The mixture
    posteriors run on ``--device``."""
    from kaldi_tpu_torch.am.regtree import RegressionTree, RegtreeMllrAccs
    from kaldi_tpu_torch.am.serialize import read_mdl, write_mdl
    from kaldi_tpu_torch.cli.tools import _device_po
    from kaldi_tpu_torch.core.table import RandomAccessTableReader
    from kaldi_tpu_torch.device import resolve_device
    po = ParseOptions("gmm-est-regtree-mllr [opts] <model-in> "
                      "<feats-rspec> <ali-rspec> <model-out>")
    po.register("num-base-classes", int, 4, "regression-tree leaves")
    po.register("min-count", float, 100.0, "occupancy to estimate a node")
    _device_po(po)
    args = po.read(argv)
    tm, am = read_mdl(args[0], device=resolve_device(po["device"]))
    tree = RegressionTree.build(am, po["num-base-classes"])
    accs = RegtreeMllrAccs(tree, am.dim)
    alis = RandomAccessTableReader(args[2], holder="ivec")
    n = 0
    for key, feats in SequentialTableReader(args[1], holder="mat"):
        if key not in alis:
            continue
        pdfs = np.array([tm.transition_id_to_pdf(int(t))
                         for t in alis[key]], np.int32)
        accs.accumulate(am, np.asarray(feats), pdfs)
        n += 1
    if not n:
        raise KaldiError("gmm-est-regtree-mllr: no utterances")
    mllr = accs.estimate(min_count=po["min-count"])
    write_mdl(args[3], tm, mllr.transform_model(am))
    log.info("gmm-est-regtree-mllr: adapted on %d utterances", n)
    return 0
