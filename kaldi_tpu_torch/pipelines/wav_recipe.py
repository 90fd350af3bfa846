"""File-based recipe: the real-audio data path, runnable as a module:

    python -m kaldi_tpu_torch.pipelines.wav_recipe [--work-dir=...]
        [--device=cuda]

Port of kaldi_tpu/pipelines/wav_recipe.py (parity target: the
egs/*/s5 stage contract driven from audio FILES, egs/yesno/s5/run.sh
shape).  Data prep writes RIFF .wav files plus a Kaldi data directory
(wav.scp / text / utt2spk / spk2utt); every later stage reads only disk
artifacts through the port's tools: compute-mfcc-feats (the fbank
kernel on ``device``) → ark,scp archives, compute-cmvn-stats /
apply-cmvn / add-deltas, mono training writing exp/mono/final.mdl,
mkgraph writing a binary OpenFst HCLG.fst, and gmm-latgen-faster reading
.mdl + HCLG.fst + feats.scp to lattice archives.  The corpus audio is
synthesized (pipelines/data.py), but from stage 1 on the recipe sees
only files.  ``prepare_corpus``, ``make_mfcc`` and ``final_feats`` are
the stages the chain CLI recipe (pipelines/chain_cli_recipe.py) reuses.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from kaldi_tpu_torch.core.logging import KaldiError, Timer, get_logger
from kaldi_tpu_torch.core.options import ParseOptions
from kaldi_tpu_torch.core.table import SequentialTableReader, _wav_write
from kaldi_tpu_torch.pipelines.data import (make_synthetic_dataset,
                                            yesno_lexicon)
from kaldi_tpu_torch.pipelines.datadir import (DataDir, read_data_dir,
                                               validate_data_dir,
                                               write_data_dir)
from kaldi_tpu_torch.pipelines.score import compute_wer

log = get_logger(__name__)


def _tool(name: str, argv) -> None:
    from kaldi_tpu_torch.cli import TOOLS
    rc = TOOLS[name](argv)
    if rc:
        raise KaldiError(f"{name} failed (rc={rc})")


def prepare_corpus(work: str, name: str, lex, num_utts: int,
                   seed: int) -> str:
    """Stage 0 (local/ data prep): synthesize the corpus as .wav FILES
    and a data dir referencing them by path."""
    ds = make_synthetic_dataset(lex, num_utts=num_utts, max_words=4,
                                seed=seed)
    wav_dir = os.path.join(work, "corpus", name)
    os.makedirs(wav_dir, exist_ok=True)
    wav_scp = {}
    for u in ds.utts:
        p = os.path.join(wav_dir, f"{u}.wav")
        with open(p, "wb") as f:
            _wav_write(f, ds.wavs[u])
        wav_scp[u] = p
    dpath = os.path.join(work, "data", name)
    write_data_dir(dpath, DataDir(wav_scp=wav_scp, text=ds.text,
                                  utt2spk=ds.utt2spk))
    problems = validate_data_dir(read_data_dir(dpath))
    if problems:
        raise KaldiError(f"{dpath}: {problems}")
    return dpath


def _attach(dpath: str, key: str, scp_path: str) -> None:
    """Register an scp (feats.scp / cmvn.scp) into the data dir."""
    d = read_data_dir(dpath)
    with open(scp_path) as f:
        table = dict(ln.split(None, 1) for ln in f if ln.strip())
    setattr(d, key, {k: v.strip() for k, v in table.items()})
    write_data_dir(dpath, d)


def make_mfcc(dpath: str, mfcc_dir: str, samp_freq: float = 8000.0,
              num_mel: int = 15, num_ceps: int = 10,
              device: torch.device | str = "cuda") -> None:
    """steps/make_mfcc.sh + compute_cmvn_stats.sh: wav.scp → MFCC ark,scp
    (the fbank kernel on ``device``) + per-speaker CMVN stats, through
    the tools."""
    os.makedirs(mfcc_dir, exist_ok=True)
    name = os.path.basename(dpath.rstrip("/"))
    ark = os.path.join(mfcc_dir, f"raw_mfcc_{name}.ark")
    scp = ark[:-4] + ".scp"
    dev = f"--device={torch.device(device).type}"
    _tool("compute-mfcc-feats", [
        "--dither=0.0", f"--sample-frequency={samp_freq}",
        f"--num-mel-bins={num_mel}", f"--num-ceps={num_ceps}", dev,
        f"scp:{dpath}/wav.scp", f"ark,scp:{ark},{scp}"])
    _attach(dpath, "feats_scp", scp)
    cark = os.path.join(mfcc_dir, f"cmvn_{name}.ark")
    cscp = cark[:-4] + ".scp"
    _tool("compute-cmvn-stats", [
        f"--spk2utt={dpath}/spk2utt", dev, f"scp:{dpath}/feats.scp",
        f"ark,scp:{cark},{cscp}"])
    _attach(dpath, "cmvn_scp", cscp)


def final_feats(dpath: str, out_dir: str,
                device: torch.device | str = "cuda") -> str:
    """The GMM feature pipe (apply-cmvn | add-deltas) materialized to an
    ark,scp (Kaldi keeps it as a pipe inside the decode rspecifier; both
    forms go through the same table layer).  → the scp's path."""
    os.makedirs(out_dir, exist_ok=True)
    name = os.path.basename(dpath.rstrip("/"))
    dev = f"--device={torch.device(device).type}"
    norm = os.path.join(out_dir, f"norm_{name}.ark")
    _tool("apply-cmvn", [f"--utt2spk={dpath}/utt2spk", dev,
                         f"scp:{dpath}/cmvn.scp", f"scp:{dpath}/feats.scp",
                         f"ark:{norm}"])
    fin = os.path.join(out_dir, f"final_{name}.ark")
    fscp = fin[:-4] + ".scp"
    _tool("add-deltas", [dev, f"ark:{norm}", f"ark,scp:{fin},{fscp}"])
    return fscp


def run(work_dir: str, num_utts: int = 30, num_test: int = 10,
        num_iters: int = 12, totgauss: int = 120,
        acoustic_scale: float = 0.1, device: torch.device | str = "cuda"):
    from kaldi_tpu_torch.am.serialize import write_mdl
    from kaldi_tpu_torch.device import resolve_device
    from kaldi_tpu_torch.fst import (ArpaModel, Lang, arpa_to_fst,
                                     make_unigram_arpa, mkgraph)
    from kaldi_tpu_torch.fst.openfst_io import write_fst_path
    from kaldi_tpu_torch.pipelines.mono import MonoTrainConfig, train_mono

    device = resolve_device(device)
    timer = Timer()
    lex = yesno_lexicon()
    lang = Lang(lex)
    train_d = prepare_corpus(work_dir, "train", lex, num_utts, seed=1)
    test_d = prepare_corpus(work_dir, "test", lex, num_test, seed=2)
    log.info("stage 0: corpora on disk under %s (%.1fs)", work_dir,
             timer.elapsed())

    mfcc_dir = os.path.join(work_dir, "mfcc")
    make_mfcc(train_d, mfcc_dir, device=device)
    make_mfcc(test_d, mfcc_dir, device=device)
    tr_scp = final_feats(train_d, mfcc_dir, device=device)
    te_scp = final_feats(test_d, mfcc_dir, device=device)
    log.info("stage 1: features via the tools (%.1fs)", timer.elapsed())

    feats = {u: np.asarray(m) for u, m in
             SequentialTableReader(f"scp:{tr_scp}", holder="mat")}
    text = read_data_dir(train_d).text
    model = train_mono(feats, text, lang, MonoTrainConfig(
        num_iters=num_iters, totgauss=totgauss,
        realign_iters=tuple(range(1, num_iters, 2))), device=device)
    exp = os.path.join(work_dir, "exp", "mono")
    os.makedirs(exp, exist_ok=True)
    mdl = os.path.join(exp, "final.mdl")
    write_mdl(mdl, model.tm, model.am)
    log.info("stage 2: mono trained → %s (%.1fs)", mdl, timer.elapsed())

    arpa = ArpaModel.parse(make_unigram_arpa(
        {w: 1.0 for w, _ in lex.entries}))
    HCLG = mkgraph(lang, model.tm, arpa_to_fst(arpa, lang.words))
    graph_dir = os.path.join(exp, "graph")
    os.makedirs(graph_dir, exist_ok=True)
    fst_path = os.path.join(graph_dir, "HCLG.fst")
    write_fst_path(fst_path, HCLG)            # BINARY OpenFst format
    words_txt = os.path.join(graph_dir, "words.txt")
    lang.words.write(words_txt)
    log.info("stage 3: %s on disk (%.1fs)", fst_path, timer.elapsed())

    dec_dir = os.path.join(exp, "decode_test")
    os.makedirs(dec_dir, exist_ok=True)
    lat_ark = os.path.join(dec_dir, "lat.1.ark")
    tra = os.path.join(dec_dir, "tra.1.txt")
    _tool("gmm-latgen-faster", [
        "--beam=16.0", f"--acoustic-scale={acoustic_scale}",
        f"--word-symbol-table={words_txt}", f"--device={device.type}",
        mdl, fst_path, f"scp:{te_scp}", f"ark:{lat_ark}", f"ark,t:{tra}"])
    log.info("stage 4: decoded from disk artifacts (%.1fs)",
             timer.elapsed())

    hyps = {u: words for u, words in
            SequentialTableReader(f"ark,t:{tra}", holder="text")}
    refs = read_data_dir(test_d).text
    wer = compute_wer(refs, hyps)
    log.info("stage 5: %s (%.1fs total)", wer, timer.elapsed())
    print(wer)
    return wer


def main(argv=None):
    po = ParseOptions(
        "Usage: python -m kaldi_tpu_torch.pipelines.wav_recipe [options]")
    po.register("work-dir", str, "build/wav_recipe",
                "working directory for all artifacts")
    po.register("num-utts", int, 30, "training utterances")
    po.register("num-iters", int, 12, "training iterations")
    po.register("device", str, "cuda", "torch device to run on")
    po.read(argv)
    wer = run(po["work-dir"], num_utts=po["num-utts"],
              num_iters=po["num-iters"], device=po["device"])
    return 0 if wer.wer == 0.0 else 1


if __name__ == "__main__":
    sys.exit(main())
