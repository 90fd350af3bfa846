"""The port's tool registry and its feature tools.

Port of ``TOOLS``, ``tool``, ``_frame_opts_po``, ``_make_frame_opts``,
``_feature_tool``, ``main`` and the feature tools of
kaldi_tpu/cli/tools.py (``compute-mfcc-feats``, ``compute-fbank-feats``,
``compute-plp-feats``, ``copy-feats``, ``compute-cmvn-stats``,
``apply-cmvn``, ``add-deltas``, ``splice-feats``, ``transform-feats``
and ``resample-wav``; parity targets src/featbin/) and its lattice tools
(``lattice-best-path``, ``lattice-mbr-decode``, ``lattice-scale``,
``lattice-prune``; host code, as there).  Each tool keeps the
original's options and arguments; those that compute with tensors add
``--device`` (default cuda): the computers launch the fbank kernel
there, and CMVN, deltas, splicing and transforms run on it.  The
registry also holds the port's other tools: ``gmm-latgen-faster``
(cli/latgen.py), ``online2-wav-nnet3-latgen-faster`` (cli/online2.py),
``nnet3-chain-train`` and ``nnet3-chain-compute-prob`` (cli/chain.py),
and those of cli/tools_extra.py, tools_bank3.py, tools_bank5.py,
tools_bank10.py, tools_ivector.py, tools_rnnlm.py, tools_const_arpa.py,
tools_lattice.py and tools_chain.py.

    python -m kaldi_tpu_torch.cli <tool-name> [options] args...
"""

from __future__ import annotations

import sys
from typing import Callable, Dict, List

import numpy as np
import torch

from kaldi_tpu_torch.core.logging import KaldiError, get_logger
from kaldi_tpu_torch.core.options import ParseOptions
from kaldi_tpu_torch.core.table import (RandomAccessTableReader,
                                        SequentialTableReader, TableWriter)
from kaldi_tpu_torch.device import resolve_device

log = get_logger(__name__)

TOOLS: Dict[str, Callable[[List[str]], int]] = {}


def tool(name: str):
    def deco(fn):
        TOOLS[name] = fn
        return fn
    return deco


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def _device_po(po: ParseOptions) -> None:
    po.register("device", str, "cuda", "torch device to compute on")


def _frame_opts_po(po: ParseOptions) -> None:
    po.register("sample-frequency", float, 16000.0, "sample rate")
    po.register("frame-length", float, 25.0, "frame length ms")
    po.register("frame-shift", float, 10.0, "frame shift ms")
    po.register("dither", float, 1.0, "dither")
    po.register("window-type", str, "povey", "window type")
    po.register("num-mel-bins", int, 23, "mel bins")


def _make_frame_opts(po):
    from kaldi_tpu_torch.features import FrameExtractionOptions
    return FrameExtractionOptions(
        samp_freq=po["sample-frequency"], frame_length_ms=po["frame-length"],
        frame_shift_ms=po["frame-shift"], dither=po["dither"],
        window_type=po["window-type"])


def _feature_tool(argv, computer_factory, usage, extra=None):
    """wav table → feature table through ``computer_factory(po,
    device)``'s ``compute``; logs the fbank kernel's launches."""
    po = ParseOptions(usage)
    _frame_opts_po(po)
    _device_po(po)
    if extra is not None:
        extra(po)
    args = po.read(argv)
    if len(args) != 2:
        po.print_usage()
        return 1
    computer = computer_factory(po, resolve_device(po["device"]))
    n = 0
    with TableWriter(args[1], holder="mat") as w:
        for key, (wave, rate) in SequentialTableReader(args[0], holder="wav"):
            if rate != po["sample-frequency"]:
                raise KaldiError(f"{key}: sample rate {rate} != "
                                 f"{po['sample-frequency']}")
            w[key] = _host(computer.compute(wave))
            n += 1
    log.info("processed %d utterances; fbank kernel launches %d", n,
             computer.kernel.launches)
    return 0


@tool("compute-mfcc-feats")
def compute_mfcc_feats(argv):
    from kaldi_tpu_torch.features import MelBanksOptions, Mfcc, MfccOptions

    def factory(po, device):
        return Mfcc(MfccOptions(
            frame_opts=_make_frame_opts(po),
            mel_opts=MelBanksOptions(num_bins=po["num-mel-bins"]),
            num_ceps=po["num-ceps"]), device=device)

    return _feature_tool(
        argv, factory,
        "compute-mfcc-feats [opts] <wav-rspecifier> <feats-wspecifier>",
        extra=lambda po: po.register("num-ceps", int, 13,
                                     "number of cepstra"))


@tool("compute-fbank-feats")
def compute_fbank_feats(argv):
    from kaldi_tpu_torch.features import Fbank, FbankOptions, MelBanksOptions

    def factory(po, device):
        return Fbank(FbankOptions(
            frame_opts=_make_frame_opts(po),
            mel_opts=MelBanksOptions(num_bins=po["num-mel-bins"])),
            device=device)

    return _feature_tool(
        argv, factory,
        "compute-fbank-feats [opts] <wav-rspecifier> <feats-wspecifier>")


@tool("compute-plp-feats")
def compute_plp_feats(argv):
    from kaldi_tpu_torch.features import MelBanksOptions, Plp, PlpOptions

    def factory(po, device):
        return Plp(PlpOptions(
            frame_opts=_make_frame_opts(po),
            mel_opts=MelBanksOptions(num_bins=po["num-mel-bins"])),
            device=device)

    return _feature_tool(
        argv, factory,
        "compute-plp-feats [opts] <wav-rspecifier> <feats-wspecifier>")


@tool("copy-feats")
def copy_feats(argv):
    po = ParseOptions("copy-feats <rspecifier> <wspecifier>")
    po.register("compress", bool, False,
                "write compressed (\"CM\") matrices")
    args = po.read(argv)
    holder = "cmat" if po["compress"] else "mat"
    with TableWriter(args[1], holder=holder) as w:
        for key, mat in SequentialTableReader(args[0], holder="mat"):
            w[key] = mat
    return 0


def _feats_on(mat, device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(mat, np.float32)).to(device)


@tool("compute-cmvn-stats")
def compute_cmvn_stats_tool(argv):
    from kaldi_tpu_torch.features import compute_cmvn_stats, sum_cmvn_stats
    po = ParseOptions(
        "compute-cmvn-stats [--spk2utt=...] <feats-rspec> <stats-wspec>")
    po.register("spk2utt", str, "", "spk2utt file for per-speaker stats")
    _device_po(po)
    args = po.read(argv)
    device = resolve_device(po["device"])
    feats = RandomAccessTableReader(args[0], holder="mat")

    def stats(key):
        return compute_cmvn_stats(_feats_on(feats[key], device))

    with TableWriter(args[1], holder="mat") as w:
        if po["spk2utt"]:
            with open(po["spk2utt"]) as f:
                for line in f:
                    parts = line.split()
                    spk, utts = parts[0], parts[1:]
                    w[spk] = _host(sum_cmvn_stats(
                        [stats(u) for u in utts if u in feats]))
        else:
            for key in feats.keys():
                w[key] = _host(stats(key))
    return 0


@tool("apply-cmvn")
def apply_cmvn_tool(argv):
    from kaldi_tpu_torch.features import apply_cmvn
    po = ParseOptions(
        "apply-cmvn [--utt2spk=...] <stats-rspec> <feats-rspec> <out-wspec>")
    po.register("norm-vars", bool, False, "normalize variance")
    po.register("utt2spk", str, "", "utt2spk map file")
    _device_po(po)
    args = po.read(argv)
    device = resolve_device(po["device"])
    stats = RandomAccessTableReader(args[0], holder="mat")
    u2s = {}
    if po["utt2spk"]:
        with open(po["utt2spk"]) as f:
            u2s = dict(line.split()[:2] for line in f if line.strip())
    with TableWriter(args[2], holder="mat") as w:
        for key, mat in SequentialTableReader(args[1], holder="mat"):
            skey = u2s.get(key, key)
            w[key] = _host(apply_cmvn(_feats_on(mat, device), stats[skey],
                                      norm_vars=po["norm-vars"]))
    return 0


@tool("add-deltas")
def add_deltas_tool(argv):
    from kaldi_tpu_torch.features import DeltaFeaturesOptions, add_deltas
    po = ParseOptions("add-deltas <rspecifier> <wspecifier>")
    po.register("delta-order", int, 2, "delta order")
    po.register("delta-window", int, 2, "delta window")
    _device_po(po)
    args = po.read(argv)
    device = resolve_device(po["device"])
    opts = DeltaFeaturesOptions(order=po["delta-order"],
                                window=po["delta-window"])
    with TableWriter(args[1], holder="mat") as w:
        for key, mat in SequentialTableReader(args[0], holder="mat"):
            w[key] = _host(add_deltas(_feats_on(mat, device), opts))
    return 0


@tool("splice-feats")
def splice_feats_tool(argv):
    from kaldi_tpu_torch.features import splice_frames
    po = ParseOptions("splice-feats <rspecifier> <wspecifier>")
    po.register("left-context", int, 4, "left context")
    po.register("right-context", int, 4, "right context")
    _device_po(po)
    args = po.read(argv)
    device = resolve_device(po["device"])
    with TableWriter(args[1], holder="mat") as w:
        for key, mat in SequentialTableReader(args[0], holder="mat"):
            w[key] = _host(splice_frames(_feats_on(mat, device),
                                         po["left-context"],
                                         po["right-context"]))
    return 0


@tool("transform-feats")
def transform_feats_tool(argv):
    from kaldi_tpu_torch.am.transforms import apply_transform
    from kaldi_tpu_torch.core import io as kio
    po = ParseOptions("transform-feats <matrix-file> <rspec> <wspec>")
    _device_po(po)
    args = po.read(argv)
    device = resolve_device(po["device"])
    with kio.open_rxfilename(args[0]) as f:
        kio.init_kaldi_input_stream(f)
        mat = kio.read_matrix(f)
    with TableWriter(args[2], holder="mat") as w:
        for key, feats in SequentialTableReader(args[1], holder="mat"):
            w[key] = _host(apply_transform(_feats_on(feats, device), mat))
    return 0


@tool("resample-wav")
def resample_wav(argv):
    from kaldi_tpu_torch.features.resample import linear_resample
    po = ParseOptions("resample-wav --target-rate=8000 <wav-rspec> <wspec>")
    po.register("target-rate", float, 16000.0, "output sample rate")
    args = po.read(argv)
    with TableWriter(args[1], holder="wav") as w:
        for key, (wave, rate) in SequentialTableReader(args[0], holder="wav"):
            out = linear_resample(wave / 32768.0, rate, po["target-rate"])
            w[key] = (out, int(po["target-rate"]))
    return 0


# ---------------------------------------------------------------------------
# latbin (host code, copied from kaldi_tpu/cli/tools.py)
# ---------------------------------------------------------------------------

@tool("lattice-best-path")
def lattice_best_path(argv):
    po = ParseOptions(
        "lattice-best-path [opts] <lattice-rspec> <words-wspec>")
    po.register("lm-scale", float, 1.0, "LM scale")
    po.register("acoustic-scale", float, 1.0, "acoustic scale")
    po.register("word-symbol-table", str, "", "words.txt")
    args = po.read(argv)
    from kaldi_tpu_torch.lattice import scale_lattice
    words_tab = None
    if po["word-symbol-table"]:
        from kaldi_tpu_torch.fst.fst import SymbolTable
        words_tab = SymbolTable.read(po["word-symbol-table"])
    with TableWriter(args[1], holder="text") as w:
        for key, clat in SequentialTableReader(args[0], holder="clat"):
            scale_lattice(clat, po["lm-scale"], po["acoustic-scale"])
            wseq, _, cost = clat.best_path()
            w[key] = [words_tab.find(x) if words_tab else str(x)
                      for x in wseq]
    return 0


@tool("lattice-mbr-decode")
def lattice_mbr_decode(argv):
    from kaldi_tpu_torch.lattice import mbr_decode
    po = ParseOptions("lattice-mbr-decode <lattice-rspec> <words-wspec>")
    po.register("word-symbol-table", str, "", "words.txt")
    args = po.read(argv)
    words_tab = None
    if po["word-symbol-table"]:
        from kaldi_tpu_torch.fst.fst import SymbolTable
        words_tab = SymbolTable.read(po["word-symbol-table"])
    with TableWriter(args[1], holder="text") as w:
        for key, clat in SequentialTableReader(args[0], holder="clat"):
            r = mbr_decode(clat)
            w[key] = [words_tab.find(x) if words_tab else str(x)
                      for x in r.words]
    return 0


@tool("lattice-scale")
def lattice_scale_tool(argv):
    from kaldi_tpu_torch.lattice import scale_lattice
    po = ParseOptions("lattice-scale <rspec> <wspec>")
    po.register("lm-scale", float, 1.0, "")
    po.register("acoustic-scale", float, 1.0, "")
    args = po.read(argv)
    with TableWriter(args[1], holder="clat") as w:
        for key, clat in SequentialTableReader(args[0], holder="clat"):
            w[key] = scale_lattice(clat, po["lm-scale"], po["acoustic-scale"])
    return 0


@tool("lattice-prune")
def lattice_prune_tool(argv):
    from kaldi_tpu_torch.lattice import prune_lattice
    po = ParseOptions("lattice-prune --beam=4.0 <rspec> <wspec>")
    po.register("beam", float, 4.0, "pruning beam")
    args = po.read(argv)
    with TableWriter(args[1], holder="clat") as w:
        for key, clat in SequentialTableReader(args[0], holder="clat"):
            w[key] = prune_lattice(clat, po["beam"])
    return 0


# The port's tools that live in modules of their own, imported when
# called, so that ``python -m kaldi_tpu_torch.cli.<module>`` still runs
# each module as the main one.

@tool("gmm-latgen-faster")
def gmm_latgen_faster(argv):
    from kaldi_tpu_torch.cli import latgen
    return latgen.gmm_latgen_faster(argv)


@tool("online2-wav-nnet3-latgen-faster")
def online2_wav_nnet3_latgen_faster(argv):
    from kaldi_tpu_torch.cli import online2
    return online2.online2_wav_nnet3_latgen_faster(argv)


@tool("nnet3-chain-train")
def nnet3_chain_train(argv):
    from kaldi_tpu_torch.cli import chain
    return chain.nnet3_chain_train(argv)


@tool("nnet3-chain-compute-prob")
def nnet3_chain_compute_prob(argv):
    from kaldi_tpu_torch.cli import chain
    return chain.nnet3_chain_compute_prob(argv)


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if not argv or argv[0] in ("-h", "--help"):
        print("Available tools:", file=sys.stderr)
        for name in sorted(TOOLS):
            print(f"  {name}", file=sys.stderr)
        return 1
    name, rest = argv[0], argv[1:]
    if name not in TOOLS:
        print(f"Unknown tool '{name}'. Run with --help for the list.",
              file=sys.stderr)
        return 1
    try:
        return TOOLS[name](rest) or 0
    except KaldiError as e:
        print(f"ERROR ({name}): {e}", file=sys.stderr)
        return 1
