"""compute-spectrogram-feats, apply-cmvn-sliding, the GMM estimation
tools gmm-mixup, gmm-acc-stats-ali, gmm-sum-accs and gmm-est, the
lattice tools lattice-depth and lattice-lmrescore, and the host tools
feat-to-dim, feat-to-len, nnet3-info and nnet3-copy.

Port of those tools of kaldi_tpu/cli/tools_extra.py (parity targets
featbin/compute-spectrogram-feats.cc, apply-cmvn-sliding.cc,
gmmbin/gmm-mixup.cc, gmm-acc-stats-ali.cc, gmm-sum-accs.cc,
gmm-est.cc, latbin/lattice-depth.cc, lattice-lmrescore.cc,
featbin/feat-to-dim.cc, feat-to-len.cc, nnet3bin/nnet3-info.cc,
nnet3-copy.cc),
registered in cli/tools.py's ``TOOLS``, with the
accumulator files' reader and writer.  The spectrogram runs the fbank
kernel with one filter per DFT bin on ``--device`` (default cuda), and
gmm-acc-stats-ali accumulates on it; sliding-window CMN and the
updates are host numpy, as in the original.  The original's gmm-mixup
and ``gmm-est --mix-up`` drop ``mixup``'s result and write the model
unchanged; these write the mixed-up model.  The lattice tools are the
original's host code, copied.  online2-wav-gmm-latgen-faster
(online2bin/online2-wav-gmm-latgen-faster.cc) streams on ``--device``:
online MFCC + Δ+ΔΔ (the fbank kernel), the GMM kernel and a
``SingleUtteranceDecoder``.
"""

from __future__ import annotations

import numpy as np

from kaldi_tpu_torch.cli.tools import (_device_po, _feature_tool,
                                       _make_frame_opts, tool)
from kaldi_tpu_torch.core.io import (read_matrix, read_token, read_vector,
                                     write_matrix, write_token, write_vector)
from kaldi_tpu_torch.core.logging import KaldiError, get_logger
from kaldi_tpu_torch.core.options import ParseOptions
from kaldi_tpu_torch.core.table import SequentialTableReader, TableWriter
from kaldi_tpu_torch.device import resolve_device

log = get_logger(__name__)


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


# ---------------------------------------------------------------------------
# gmmbin
# ---------------------------------------------------------------------------

_ACC_TOKEN = "<GmmAccs>"


# Copied from kaldi_tpu/cli/tools_extra.py write_gmm_accs.
def write_gmm_accs(path: str, accs) -> None:
    P, M, D = accs.mean_acc.shape
    with open(path, "wb") as f:
        f.write(b"\0B")
        write_token(f, _ACC_TOKEN)
        write_matrix(f, accs.occ.astype(np.float64), dtype="float64")
        write_matrix(f, accs.mean_acc.reshape(P, M * D).astype(np.float64),
                     dtype="float64")
        write_matrix(f, accs.var_acc.reshape(P, M * D).astype(np.float64),
                     dtype="float64")
        write_vector(f, np.array([accs.tot_like, accs.tot_frames, D],
                                 np.float64), dtype="float64")


# Copied from kaldi_tpu/cli/tools_extra.py read_gmm_accs.
def read_gmm_accs(path: str):
    from kaldi_tpu_torch.am.gmm import GmmAccs
    with open(path, "rb") as f:
        if f.read(2) != b"\0B":
            raise KaldiError(f"{path}: not a binary kaldi file")
        tok = read_token(f)
        if tok != _ACC_TOKEN:
            raise KaldiError(f"{path}: expected {_ACC_TOKEN}, got {tok}")
        occ = read_matrix(f)
        mean = read_matrix(f)
        var = read_matrix(f)
        meta = read_vector(f)
    P, M = occ.shape
    D = int(meta[2])
    return GmmAccs(occ, mean.reshape(P, M, D), var.reshape(P, M, D),
                   float(meta[0]), float(meta[1]))


@tool("gmm-mixup")
def gmm_mixup(argv):
    from kaldi_tpu_torch.am.gmm import mixup
    from kaldi_tpu_torch.am.serialize import read_mdl, write_mdl
    po = ParseOptions("gmm-mixup --mix-up=N <model-in> <model-out>")
    po.register("mix-up", int, 0, "target total #gauss")
    po.register("perturb-factor", float, 0.01, "mean perturbation")
    args = po.read(argv)
    tm, am = read_mdl(args[0], device="cpu")
    if po["mix-up"]:
        am = mixup(am, po["mix-up"], perturb=po["perturb-factor"])
    write_mdl(args[1], tm, am)
    return 0


@tool("gmm-acc-stats-ali")
def gmm_acc_stats_ali(argv):
    from kaldi_tpu_torch.am.gmm import GmmAccs, accumulate_stats
    from kaldi_tpu_torch.am.serialize import read_mdl
    po = ParseOptions("gmm-acc-stats-ali <model> <feats-rspec> "
                      "<ali-rspec> <accs-out>")
    _device_po(po)
    args = po.read(argv)
    tm, am = read_mdl(args[0], device=resolve_device(po["device"]))
    accs = GmmAccs.zeros(am.num_pdfs, am.max_mix, am.dim)
    alis = dict(SequentialTableReader(args[2], holder="ivec"))
    n = 0
    for key, feats in SequentialTableReader(args[1], holder="mat"):
        if key not in alis:
            log.warning("no alignment for %s", key)
            continue
        pdf_ali = tm.tid_to_pdf_array[np.asarray(alis[key])]
        accumulate_stats(am, np.asarray(feats), pdf_ali, accs)
        n += 1
    write_gmm_accs(args[3], accs)
    log.info("accumulated stats from %d utterances; avg like/frame %.4f",
             n, accs.tot_like / max(accs.tot_frames, 1.0))
    return 0


@tool("gmm-sum-accs")
def gmm_sum_accs(argv):
    po = ParseOptions("gmm-sum-accs <accs-out> <accs-in1> [<accs-in2> ...]")
    args = po.read(argv)
    total = read_gmm_accs(args[1])
    for p in args[2:]:
        total = total + read_gmm_accs(p)
    write_gmm_accs(args[0], total)
    return 0


@tool("gmm-est")
def gmm_est(argv):
    from kaldi_tpu_torch.am.gmm import mixup, mle_update
    from kaldi_tpu_torch.am.serialize import read_mdl, write_mdl
    po = ParseOptions("gmm-est [opts] <model-in> <accs-in> <model-out>")
    po.register("min-gaussian-occupancy", float, 3.0, "")
    po.register("mix-up", int, 0, "target #gauss after update")
    args = po.read(argv)
    tm, am = read_mdl(args[0], device="cpu")
    accs = read_gmm_accs(args[1])
    mle_update(am, accs, min_occ=po["min-gaussian-occupancy"])
    if po["mix-up"]:
        am = mixup(am, po["mix-up"])
    write_mdl(args[2], tm, am)
    log.info("estimated model; tot like/frame %.4f over %.0f frames",
             accs.tot_like / max(accs.tot_frames, 1.0), accs.tot_frames)
    return 0


# ---------------------------------------------------------------------------
# latbin (host code, copied from kaldi_tpu/cli/tools_extra.py)
# ---------------------------------------------------------------------------

@tool("lattice-depth")
def lattice_depth(argv):
    from kaldi_tpu_torch.lattice.functions import state_times
    po = ParseOptions("lattice-depth <rspec> [<depth-wspec>]")
    args = po.read(argv)
    w = TableWriter(args[1], holder="text") if len(args) > 1 else None
    tot_arc_frames = tot_frames = 0
    for key, clat in SequentialTableReader(args[0], holder="clat"):
        times = state_times(clat)
        T = max(times) if times else 0
        arc_frames = sum(len(a.tids) for s in range(clat.num_states)
                         for a in clat.arcs[s])
        depth = arc_frames / max(T, 1)
        tot_arc_frames += arc_frames
        tot_frames += T
        if w:
            w[key] = [f"{depth:.2f}"]
        else:
            print(key, f"{depth:.2f}")
    log.info("overall lattice depth %.2f over %d frames",
             tot_arc_frames / max(tot_frames, 1), tot_frames)
    if w:
        w.close()
    return 0


@tool("lattice-lmrescore")
def lattice_lmrescore(argv):
    from kaldi_tpu_torch.fst.arpa import ArpaModel
    from kaldi_tpu_torch.fst.fst import SymbolTable
    from kaldi_tpu_torch.lattice.rescore import lmrescore
    po = ParseOptions("lattice-lmrescore [--lm-scale=1.0] <old-arpa> "
                      "<new-arpa> <words.txt> <lat-rspec> <lat-wspec>")
    po.register("lm-scale", float, 1.0, "LM scale")
    args = po.read(argv)
    old_lm = ArpaModel.parse(args[0])
    new_lm = ArpaModel.parse(args[1])
    words = SymbolTable.read(args[2])
    with TableWriter(args[4], holder="clat") as w:
        for key, clat in SequentialTableReader(args[3], holder="clat"):
            w[key] = lmrescore(clat, old_lm, new_lm, words,
                               lm_scale=po["lm-scale"])
    return 0


# Port of kaldi_tpu/cli/tools_extra.py online2_wav_gmm_latgen_faster.
@tool("online2-wav-gmm-latgen-faster")
def online2_wav_gmm_latgen_faster(argv):
    """Streaming decode driver (online2bin/online2-wav-gmm-latgen-faster
    role): waveform chunks → online MFCC(+deltas) → GMM loglikes →
    SingleUtteranceDecoder, partials available throughout
    (cli/tools_bank30.py ``_gmm_stream``).  MFCC (the fbank kernel), the
    GMM (the GMM kernel) and the decoder run on ``--device``."""
    from kaldi_tpu_torch.cli.online2 import online_mfcc
    from kaldi_tpu_torch.cli.tools_bank30 import (_gmm_online_setup,
                                                  _gmm_stream)
    po = ParseOptions("online2-wav-gmm-latgen-faster [opts] <model> "
                      "<fst> <wav-rspec> <words-wspec>")
    po.register("chunk-length", float, 0.18, "seconds per audio chunk")
    po.register("beam", float, 16.0, "decoding beam")
    po.register("acoustic-scale", float, 0.1, "acoustic scale")
    po.register("sample-frequency", float, 16000.0, "expected rate")
    po.register("do-endpointing", bool, False, "stop at an endpoint")
    po.register("word-symbol-table", str, "", "words.txt")
    _device_po(po)
    args = po.read(argv)
    device = resolve_device(po["device"])
    _tm, am, dec = _gmm_online_setup(args[0], args[1], po["beam"],
                                     po["acoustic-scale"], device)
    words_tab = None
    if po["word-symbol-table"]:
        from kaldi_tpu_torch.fst.fst import SymbolTable
        words_tab = SymbolTable.read(po["word-symbol-table"])
    chunk = int(po["chunk-length"] * po["sample-frequency"])
    mfcc = online_mfcc(po["sample-frequency"], device)
    with TableWriter(args[3], holder="text") as w:
        for key, (wave, rate) in SequentialTableReader(args[2],
                                                       holder="wav"):
            if rate != po["sample-frequency"]:
                raise KaldiError(f"{key}: rate {rate} != "
                                 f"{po['sample-frequency']}")
            ols, tids = _gmm_stream(am, dec, mfcc, wave, chunk,
                                    endpointing=po["do-endpointing"])
            text = [words_tab.find(o) if words_tab else str(o)
                    for o in ols]
            w[key] = text
            log.info("%s: %s (%d frames)", key, " ".join(text), len(tids))
    log.info("online2-wav-gmm-latgen-faster: fbank kernel launches %d, "
             "GMM kernel launches %d", mfcc.kernel.launches,
             am.device_params().launches)
    return 0


# Copied from kaldi_tpu/cli/tools_extra.py feat_to_dim.
@tool("feat-to-dim")
def feat_to_dim(argv):
    po = ParseOptions("feat-to-dim <feats-rspec>")
    args = po.read(argv)
    for _, m in SequentialTableReader(args[0], holder="mat"):
        print(np.asarray(m).shape[1])
        return 0
    raise KaldiError("feat-to-dim: empty table")


# Copied from kaldi_tpu/cli/tools_extra.py feat_to_len.
@tool("feat-to-len")
def feat_to_len(argv):
    po = ParseOptions("feat-to-len <feats-rspec> [<len-wspec>]")
    args = po.read(argv)
    w = TableWriter(args[1], holder="text") if len(args) > 1 else None
    for key, m in SequentialTableReader(args[0], holder="mat"):
        n = np.asarray(m).shape[0]
        if w:
            w[key] = [str(n)]
        else:
            print(key, n)
    if w:
        w.close()
    return 0


# Copied from kaldi_tpu/cli/tools_extra.py _open_nnet3.
def _open_nnet3(path: str):
    from kaldi_tpu_torch.am.nnet3_io import read_nnet3
    with open(path, "rb") as f:
        if f.read(2) != b"\0B":
            raise KaldiError(f"{path}: expected binary header \\0B")
        return read_nnet3(f)


# Port of kaldi_tpu/cli/tools_extra.py nnet3_info.
@tool("nnet3-info")
def nnet3_info(argv):
    po = ParseOptions("nnet3-info <nnet3-file>")
    args = po.read(argv)
    model = _open_nnet3(args[0])
    print(f"num-components {len(model.components)}")
    for c in model.components:
        dims = []
        for k in ("InputDim", "OutputDim", "Dim"):
            if k in c.fields:
                dims.append(f"{k.lower()}={c.fields[k].as_int}")
        print(f"component name={c.name} type={c.ctype} "
              + " ".join(dims))
    return 0


# Copied from kaldi_tpu/cli/tools_extra.py nnet3_copy.
@tool("nnet3-copy")
def nnet3_copy(argv):
    from kaldi_tpu_torch.am.nnet3_io import write_nnet3
    po = ParseOptions("nnet3-copy <nnet3-in> <nnet3-out>")
    args = po.read(argv)
    model = _open_nnet3(args[0])
    with open(args[1], "wb") as f:
        f.write(b"\0B")
        write_nnet3(f, model)
    return 0
