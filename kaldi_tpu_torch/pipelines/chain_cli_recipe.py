"""Chain (LF-MMI) recipe driven only through the tools, with ark/scp
artifacts between every stage.

Port of kaldi_tpu/pipelines/chain_cli_recipe.py (parity target: the
egs/wsj/s5/steps/nnet3/chain/train.py stage contract): every processing
step below is a call of the port's ``TOOLS`` reading and writing disk
artifacts, the boundary a user scripting Kaldi sees.  Python code only
synthesizes the corpus (local/ data prep, pipelines/wav_recipe.py) and
sequences the tool calls (the run.sh role).  The tools that compute with
tensors run on ``device``: MFCC through the fbank kernel, the GMM
kernel in the mono loop's accumulation and alignment, the chain
training's den kernels, the TDNN-F and the decoder.

Stages (tool per arrow):
  0 local/:        wavs + data dir + lexicon.txt + lm.arpa on disk
  1 features:      compute-mfcc-feats → compute-cmvn-stats →
                   apply-cmvn → add-deltas          (ark,scp)
  2 mono GMM:      gmm-init-mono → compile-train-graphs →
                   align-equal-compiled → {gmm-acc-stats-ali →
                   gmm-est → gmm-align-compiled}* → gmm-copy (exp/mono)
  3 chain prep:    gmm-init-mono(chain topo) → ali-to-phones (exp/chain)
  4 egs:           nnet3-chain-get-egs → nnet3-chain-shuffle-egs
  5 train:         nnet3-init → nnet3-chain-train   (final.raw)
  6 graph:         arpa2fst → compile-graph         (HCLG.fst)
  7 decode:        nnet3-latgen-faster              (lat.ark)
  8 score:         lattice-best-path → compute-wer

Runnable:  python -m kaldi_tpu_torch.pipelines.chain_cli_recipe
           [--work-dir=...] [--device=cuda]
It prints the WER, then each stage's wall time, and exits 0 when the
WER is below 20.  ``run`` returns the WER and logs each stage's wall
time (``stage_s``, when given a dict, collects them).
"""

from __future__ import annotations

import os
import sys
from typing import Dict, Optional

import torch

from kaldi_tpu_torch.core.logging import KaldiError, Timer, get_logger
from kaldi_tpu_torch.core.options import ParseOptions
from kaldi_tpu_torch.core.table import SequentialTableReader
from kaldi_tpu_torch.pipelines.wav_recipe import (final_feats, make_mfcc,
                                                  prepare_corpus)

log = get_logger(__name__)


def _run(name, argv):
    from kaldi_tpu_torch.cli import TOOLS
    rc = TOOLS[name](argv)
    if rc:
        raise KaldiError(f"{name} failed (rc={rc})")


def _write_topo(path: str, topo) -> None:
    from kaldi_tpu_torch.am.serialize import write_topology
    with open(path, "wb") as f:
        f.write(b"\0B")
        write_topology(f, topo)


def run(work: str, num_utts: int = 40, num_test: int = 12,
        mono_iters: int = 8, chain_epochs: int = 8,
        hidden: int = 48, seed: int = 1,
        device: torch.device | str = "cuda",
        stage_s: Optional[Dict[str, float]] = None):
    from kaldi_tpu_torch.am.serialize import read_mdl
    from kaldi_tpu_torch.am.topology import HmmTopology
    from kaldi_tpu_torch.device import resolve_device
    from kaldi_tpu_torch.fst import Lang, make_unigram_arpa
    from kaldi_tpu_torch.pipelines.data import yesno_lexicon
    from kaldi_tpu_torch.pipelines.datadir import read_data_dir
    from kaldi_tpu_torch.pipelines.score import compute_wer

    device = resolve_device(device)
    dev = f"--device={device.type}"
    timer = Timer()
    stage_s = {} if stage_s is None else stage_s
    last = [0.0]

    def done(stage: str, msg: str, *a) -> None:
        now = timer.elapsed()
        stage_s[stage] = now - last[0]
        last[0] = now
        log.info(f"{stage}: {msg} (%.1fs)", *a, now)

    lex = yesno_lexicon()
    lang = Lang(lex)

    # ---- stage 0: local/ data prep (files on disk) -----------------
    train_d = prepare_corpus(work, "train", lex, num_utts, seed=seed)
    test_d = prepare_corpus(work, "test", lex, num_test, seed=seed + 1)
    lang_dir = os.path.join(work, "lang")
    os.makedirs(lang_dir, exist_ok=True)
    lex_txt = os.path.join(lang_dir, "lexicon.txt")
    with open(lex_txt, "w") as f:
        for word, pron in lex.entries:
            f.write(word + " " + " ".join(pron) + "\n")
    arpa_path = os.path.join(lang_dir, "lm.arpa")
    with open(arpa_path, "w") as f:
        f.write(make_unigram_arpa({w: 1.0 for w, _ in lex.entries}))
    words_txt = os.path.join(lang_dir, "words.txt")
    lang.words.write(words_txt)
    phones = lang.phone_list()
    topo3 = os.path.join(lang_dir, "topo")
    _write_topo(topo3, HmmTopology.three_state(phones))
    topo_chain = os.path.join(lang_dir, "topo_chain")
    _write_topo(topo_chain, HmmTopology.chain(phones))
    done("stage 0", "corpus + lang on disk")

    # ---- stage 1: features through the tools -----------------------
    mfcc_dir = os.path.join(work, "mfcc")
    make_mfcc(train_d, mfcc_dir, device=device)
    make_mfcc(test_d, mfcc_dir, device=device)
    tr_scp = final_feats(train_d, mfcc_dir, device=device)
    te_scp = final_feats(test_d, mfcc_dir, device=device)
    dim = next(iter(SequentialTableReader(f"scp:{tr_scp}",
                                          holder="mat")))[1].shape[1]
    done("stage 1", "features dim %d", dim)

    # ---- stage 2: mono GMM training loop, all tools ----------------
    exp = os.path.join(work, "exp", "mono")
    os.makedirs(exp, exist_ok=True)
    mdl0 = os.path.join(exp, "0.mdl")
    tree0 = os.path.join(exp, "tree")
    _run("gmm-init-mono", [f"--train-feats=scp:{tr_scp}", topo3,
                           str(dim), mdl0, tree0])
    graphs = os.path.join(exp, "graphs.ark")
    text_ark = f"ark,t:{train_d}/text"
    _run("compile-train-graphs", [lex_txt, mdl0, text_ark,
                                  f"ark:{graphs}"])
    ali = os.path.join(exp, "ali.0.ark")
    _run("align-equal-compiled", [f"ark:{graphs}", f"scp:{tr_scp}",
                                  f"ark:{ali}"])
    cur = mdl0
    for it in range(mono_iters):
        accs = os.path.join(exp, f"{it}.acc")
        _run("gmm-acc-stats-ali", [dev, cur, f"scp:{tr_scp}", f"ark:{ali}",
                                   accs])
        nxt = os.path.join(exp, f"{it + 1}.mdl")
        _run("gmm-est", ["--mix-up=0", cur, accs, nxt])
        cur = nxt
        if it % 2 == 1:
            ali = os.path.join(exp, f"ali.{it + 1}.ark")
            _run("gmm-align-compiled",
                 [dev, cur, f"ark:{graphs}", f"scp:{tr_scp}",
                  f"ark:{ali}"])
    mono_mdl = os.path.join(exp, "final.mdl")
    _run("gmm-copy", [cur, mono_mdl])
    done("stage 2", "mono GMM trained")

    # ---- stage 3: chain transition model + phone supervision -------
    chain_dir = os.path.join(work, "exp", "chain")
    os.makedirs(chain_dir, exist_ok=True)
    chain_mdl = os.path.join(chain_dir, "0.mdl")
    chain_tree = os.path.join(chain_dir, "tree")
    _run("gmm-init-mono", [f"--train-feats=scp:{tr_scp}", topo_chain,
                           str(dim), chain_mdl, chain_tree])
    # chain supervision is phone-level: the GMM's alignment feeds
    # get-egs directly (the get_egs.sh contract); no cross-topology
    # tid conversion
    phone_seqs = os.path.join(chain_dir, "phones.ark")
    _run("ali-to-phones", [mono_mdl, f"ark:{ali}", f"ark:{phone_seqs}"])
    done("stage 3", "chain model + phone supervision")

    # ---- stage 4: egs ---------------------------------------------
    egs0 = os.path.join(chain_dir, "egs.raw.ark")
    _run("nnet3-chain-get-egs",
         ["--chunk-size=30", "--frame-subsampling-factor=3",
          f"--ali-model={mono_mdl}", chain_mdl, f"scp:{tr_scp}",
          f"ark:{ali}", f"ark:{egs0}"])
    egs = os.path.join(chain_dir, "egs.ark")
    _run("nnet3-chain-shuffle-egs", ["--srand=7", f"ark:{egs0}",
                                     f"ark:{egs}"])
    done("stage 4", "egs extracted")

    # ---- stage 5: nnet3-chain-train -------------------------------
    raw0 = os.path.join(chain_dir, "0.raw")
    num_pdfs = read_mdl(chain_mdl, device="cpu")[0].num_pdfs
    _run("nnet3-init", [f"--feat-dim={dim}", f"--num-pdfs={num_pdfs}",
                        f"--hidden-dim={hidden}",
                        f"--bottleneck-dim={hidden // 4}",
                        "--num-layers=3", raw0])
    final_raw = os.path.join(chain_dir, "final.raw")
    _run("nnet3-chain-train",
         [f"--num-epochs={chain_epochs}", "--learning-rate=2e-3",
          "--lm-order=2", dev, chain_mdl, raw0, f"ark:{phone_seqs}",
          f"ark:{egs}", final_raw])
    done("stage 5", "chain model trained")

    # ---- stage 6: decode graph ------------------------------------
    graph_dir = os.path.join(chain_dir, "graph")
    os.makedirs(graph_dir, exist_ok=True)
    g_fst = os.path.join(graph_dir, "G.fst")
    _run("arpa2fst", [f"--read-symbol-table={words_txt}", arpa_path,
                      g_fst])
    hclg = os.path.join(graph_dir, "HCLG.fst")
    _run("compile-graph", ["--self-loop-scale=1.0", lex_txt, chain_mdl,
                           g_fst, hclg])
    done("stage 6", "HCLG.fst on disk")

    # ---- stage 7: decode ------------------------------------------
    dec_dir = os.path.join(chain_dir, "decode_test")
    os.makedirs(dec_dir, exist_ok=True)
    lat_ark = os.path.join(dec_dir, "lat.1.ark")
    _run("nnet3-latgen-faster",
         ["--beam=16.0", "--acoustic-scale=1.0",
          "--frame-subsampling-factor=3", dev,
          f"--word-symbol-table={words_txt}", chain_mdl, final_raw,
          hclg, f"scp:{te_scp}", f"ark:{lat_ark}"])
    done("stage 7", "decoded")

    # ---- stage 8: score -------------------------------------------
    tra = os.path.join(dec_dir, "tra.txt")
    _run("lattice-best-path",
         [f"--word-symbol-table={words_txt}", f"ark:{lat_ark}",
          f"ark,t:{tra}"])
    hyps = dict(SequentialTableReader(f"ark,t:{tra}", holder="text"))
    refs = read_data_dir(test_d).text
    wer = compute_wer(refs, hyps)
    done("stage 8", "%s", wer)
    print(wer)
    return wer


def main(argv=None):
    po = ParseOptions(
        "Usage: python -m kaldi_tpu_torch.pipelines.chain_cli_recipe")
    po.register("work-dir", str, "build/chain_cli_recipe",
                "working directory")
    po.register("num-utts", int, 40, "training utterances")
    po.register("chain-epochs", int, 8, "chain training epochs")
    po.register("device", str, "cuda", "torch device to run on")
    po.read(argv)
    stage_s: Dict[str, float] = {}
    wer = run(po["work-dir"], num_utts=po["num-utts"],
              chain_epochs=po["chain-epochs"], device=po["device"],
              stage_s=stage_s)
    print("stage walls (s): " + ", ".join(f"{k} {v:.3f}"
                                          for k, v in stage_s.items()))
    return 0 if wer.wer < 20.0 else 1


if __name__ == "__main__":
    sys.exit(main())
