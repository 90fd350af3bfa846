"""compute-kaldi-pitch-feats, process-kaldi-pitch-feats,
compile-train-graphs, align-equal-compiled and gmm-align-compiled.

Port of those tools of kaldi_tpu/cli/tools_bank3.py (parity targets
featbin/compute-kaldi-pitch-feats.cc, process-kaldi-pitch-feats.cc,
bin/compile-train-graphs.cc, align-equal-compiled.cc,
gmmbin/gmm-align-compiled.cc), registered in cli/tools.py's ``TOOLS``.
Training graphs and the equal alignment are host code, as in the
original; gmm-align-compiled runs the GMM kernel and the aligner on
``--device`` (default cuda), ``ALIGN_BATCH`` utterances at a time (the
original aligns one at a time; the alignments are the same).
Pitch is host numpy (features/pitch.py), as in the original.  As there,
compute-kaldi-pitch-feats divides the int16-scale wave by 32768 and
compute-and-process-kaldi-pitch-feats (cli/tools_bank10.py) does not.
The NCCF's ballast is scaled by the signal's own mean square, and 32768
is a power of two, so the two give the same pitch all the same.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from kaldi_tpu_torch.cli.tools import _device_po, tool
from kaldi_tpu_torch.core.logging import get_logger
from kaldi_tpu_torch.core.options import ParseOptions
from kaldi_tpu_torch.core.table import (RandomAccessTableReader,
                                        SequentialTableReader, TableWriter)
from kaldi_tpu_torch.device import resolve_device

log = get_logger(__name__)

# utterances gmm-align-compiled aligns in one batch
ALIGN_BATCH = 64


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


# ---------------------------------------------------------------------------
# bin/gmmbin: training graphs + alignment
# ---------------------------------------------------------------------------

# Copied from kaldi_tpu/cli/tools_bank3.py _lang_from_lexicon.
def _lang_from_lexicon(path: str, sil_phone: str):
    from kaldi_tpu_torch.fst.lang import Lang, Lexicon
    entries: List[Tuple[str, List[str]]] = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 2:
                entries.append((parts[0], parts[1:]))
    return Lang(Lexicon(entries), sil_phone=sil_phone)


@tool("compile-train-graphs")
def compile_train_graphs(argv):
    from kaldi_tpu_torch.am.serialize import read_mdl
    from kaldi_tpu_torch.decoder.training_graph import TrainingGraphCompiler
    po = ParseOptions("compile-train-graphs [opts] <lexicon.txt> <model> "
                      "<text-rspec> <graphs-wspec>")
    po.register("transition-scale", float, 1.0, "transition scale")
    po.register("self-loop-scale", float, 0.1, "self-loop scale")
    po.register("sil-phone", str, "SIL", "optional-silence phone")
    args = po.read(argv)
    lang = _lang_from_lexicon(args[0], po["sil-phone"])
    tm, _ = read_mdl(args[1], device="cpu")
    compiler = TrainingGraphCompiler(lang, tm, po["transition-scale"],
                                     po["self-loop-scale"])
    n = 0
    with TableWriter(args[3], holder="fst") as w:
        for key, words in SequentialTableReader(args[2], holder="text"):
            w[key] = compiler.compile_text(list(words))
            n += 1
    log.info("compile-train-graphs: %d graphs", n)
    return 0


@tool("align-equal-compiled")
def align_equal_compiled(argv):
    from kaldi_tpu_torch.decoder.training_graph import equal_align
    po = ParseOptions("align-equal-compiled <graphs-rspec> <feats-rspec> "
                      "<ali-wspec>")
    args = po.read(argv)
    graphs = RandomAccessTableReader(args[0], holder="fst")
    with TableWriter(args[2], holder="ivec") as w:
        for key, m in SequentialTableReader(args[1], holder="mat"):
            if key not in graphs:
                log.warning("align-equal-compiled: no graph for %s", key)
                continue
            w[key] = np.asarray(
                equal_align(graphs[key], np.asarray(m).shape[0]), np.int32)
    return 0


@tool("gmm-align-compiled")
def gmm_align_compiled(argv):
    from kaldi_tpu_torch.am.serialize import read_mdl
    from kaldi_tpu_torch.decoder.align import (DenseAligner, in_degrees,
                                               pack_dense_reverse)
    from kaldi_tpu_torch.pipelines.mono import realign
    po = ParseOptions("gmm-align-compiled [opts] <model> <graphs-rspec> "
                      "<feats-rspec> <ali-wspec>")
    po.register("acoustic-scale", float, 1.0, "acoustic scale")
    _device_po(po)
    args = po.read(argv)
    device = resolve_device(po["device"])
    tm, am = read_mdl(args[0], device=device)
    graphs = dict(SequentialTableReader(args[1], holder="fst"))
    aligner = DenseAligner(tm.tid_to_pdf_array,
                           acoustic_scale=po["acoustic-scale"], device=device)
    ae = an = smax = 1
    for g in graphs.values():
        e, n = in_degrees(g)
        ae, an = max(ae, e), max(an, n)
        smax = max(smax, g.num_states)
    n_done = 0
    with TableWriter(args[3], holder="ivec") as w:
        def flush(batch):
            feats = dict(batch)
            dense = {k: pack_dense_reverse(graphs[k], smax, ae, an)
                     for k in feats}
            ali = realign(am, aligner, dense, list(feats), feats)
            for key in feats:
                w[key] = np.asarray(ali[key], np.int32)

        batch = []
        for key, m in SequentialTableReader(args[2], holder="mat"):
            if key not in graphs:
                log.warning("gmm-align-compiled: no graph for %s", key)
                continue
            batch.append((key, np.asarray(m, np.float32)))
            n_done += 1
            if len(batch) == ALIGN_BATCH:
                flush(batch)
                batch = []
        if batch:
            flush(batch)
    log.info("gmm-align-compiled: aligned %d utterances; GMM kernel "
             "launches %d", n_done, am.device_params().launches)
    return 0
