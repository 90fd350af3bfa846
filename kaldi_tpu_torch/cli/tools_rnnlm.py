"""The RNNLM tools (rnnlmbin/, and latbin/lattice-lmrescore-rnnlm).

Port of ``rnnlm-train``, ``rnnlm-compute-prob`` and
``lattice-lmrescore-kaldi-rnnlm`` (kaldi_tpu/cli/tools_bank9.py),
``rnnlm-get-egs`` and ``rnnlm-sentence-probs`` (tools_bank17.py),
``rnnlm-get-word-embedding`` (tools_bank18.py),
``lattice-lmrescore-kaldi-rnnlm-pruned`` (tools_bank21.py),
``lattice-lmrescore-rnnlm`` and ``rnnlm-get-sampling-lm`` with
``read_sampling_lm`` (tools_bank28.py), registered in cli/tools.py's
``TOOLS``.  Each keeps the original's options and arguments; those that
hold the model add ``--device`` (default cuda), where lm/rnnlm.py trains
it, computes its probabilities and runs the lattice scorer's GRU steps.
The model file is the original's (``<RnnLm>`` around a flax msgpack
payload), so each side reads the other's.

``rnnlm-sentence-probs`` is ported to intent: the original hands the
bare parameter tree to flax's ``apply`` and raises on every sentence
(ROADMAP Queue 3); the port writes each sentence's total natural-log
probability, <s> to </s>, as the original's code means to.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from kaldi_tpu_torch.cli.tools import _device_po, tool
from kaldi_tpu_torch.core.logging import KaldiError, get_logger
from kaldi_tpu_torch.core.options import ParseOptions
from kaldi_tpu_torch.core.table import SequentialTableReader, TableWriter
from kaldi_tpu_torch.device import resolve_device

log = get_logger(__name__)


# Port of kaldi_tpu/cli/tools_bank9.py rnnlm_train.
@tool("rnnlm-train")
def rnnlm_train(argv):
    """Train the GRU RNNLM on integerized text (rnnlm-train role;
    --sample-k enables importance-sampled softmax)."""
    from kaldi_tpu_torch.lm.rnnlm import RnnLmConfig, save_rnnlm, \
        train_rnnlm
    po = ParseOptions("rnnlm-train [opts] <text-rspec> <rnnlm-out>")
    po.register("vocab-size", int, 0, "vocab size (required)")
    po.register("embed-dim", int, 64, "embedding dim")
    po.register("hidden-dim", int, 128, "GRU dim")
    po.register("num-epochs", int, 20, "epochs")
    po.register("learning-rate", float, 5e-3, "adam lr")
    po.register("sample-k", int, 0, "sampled-softmax candidates (0=full)")
    _device_po(po)
    args = po.read(argv)
    if po["vocab-size"] <= 0:
        raise KaldiError("rnnlm-train: --vocab-size is required")
    sents = [[int(x) for x in v]
             for _, v in SequentialTableReader(args[0], holder="text")]
    cfg = RnnLmConfig(vocab_size=po["vocab-size"],
                      embed_dim=po["embed-dim"],
                      hidden_dim=po["hidden-dim"])
    stats: Dict[str, float] = {}
    model = train_rnnlm(
        sents, cfg, num_epochs=po["num-epochs"],
        learning_rate=po["learning-rate"],
        sample_k=po["sample-k"] or None,
        device=resolve_device(po["device"]), stats=stats)
    save_rnnlm(args[1], model)
    log.info("rnnlm-train: trained on %d sentences (%d steps, final nll "
             "per word %.4f, %.1f s)", len(sents), stats["steps"],
             stats["nll"], stats["train_s"])
    return 0


# Port of kaldi_tpu/cli/tools_bank9.py rnnlm_compute_prob.
@tool("rnnlm-compute-prob")
def rnnlm_compute_prob(argv):
    """Perplexity of integerized text under a trained RNNLM
    (rnnlm-compute-prob / rnnlm-sentence-probs role)."""
    from kaldi_tpu_torch.lm.rnnlm import load_rnnlm, perplexity
    po = ParseOptions("rnnlm-compute-prob <rnnlm> <text-rspec>")
    _device_po(po)
    args = po.read(argv)
    model = load_rnnlm(args[0], device=resolve_device(po["device"]))
    sents = [[int(x) for x in v]
             for _, v in SequentialTableReader(args[1], holder="text")]
    ppl = perplexity(model, sents)
    log.info("rnnlm-compute-prob: ppl %.3f over %d sentences",
             ppl, len(sents))
    print(f"{ppl:.6f}")
    return 0


# Port of kaldi_tpu/cli/tools_bank9.py lattice_lmrescore_kaldi_rnnlm.
@tool("lattice-lmrescore-kaldi-rnnlm")
def lattice_lmrescore_kaldi_rnnlm(argv):
    """Rescore lattices with the RNNLM as a deterministic on-demand LM
    (rnnlmbin/lattice-lmrescore-kaldi-rnnlm.cc)."""
    from kaldi_tpu_torch.fst.fst import SymbolTable
    from kaldi_tpu_torch.lattice.rescore import compose_lm
    from kaldi_tpu_torch.lm.rnnlm import RnnLmScorer, load_rnnlm
    po = ParseOptions("lattice-lmrescore-kaldi-rnnlm [opts] <rnnlm> "
                      "<words.txt> <lattice-rspec> <lattice-wspec>")
    po.register("lm-scale", float, 1.0, "RNNLM weight (negative removes)")
    _device_po(po)
    args = po.read(argv)
    dev = resolve_device(po["device"])
    words = SymbolTable.read(args[1])
    scorer = RnnLmScorer(load_rnnlm(args[0], device=dev), words,
                         device=dev)
    n = 0
    with TableWriter(args[3], holder="clat") as w:
        for key, clat in SequentialTableReader(args[2], holder="clat"):
            w[key] = compose_lm(clat, scorer.score, words,
                                scale=po["lm-scale"])
            n += 1
    log.info("lattice-lmrescore-kaldi-rnnlm: rescored %d lattices, %d "
             "histories scored on %s", n, scorer.steps, scorer.device.type)
    return 0


# Port of kaldi_tpu/cli/tools_bank17.py rnnlm_get_egs_tool (copied).
@tool("rnnlm-get-egs")
def rnnlm_get_egs_tool(argv):
    """Integerized sentences → (input, target) training pairs with
    BOS/EOS framing (rnnlmbin/rnnlm-get-egs.cc role); each entry is a
    2×(L+1) int matrix [input; target]."""
    po = ParseOptions("rnnlm-get-egs [--bos=1] [--eos=2] <text-rspec> "
                      "<egs-wspec>")
    po.register("bos", int, 1, "BOS id")
    po.register("eos", int, 2, "EOS id")
    args = po.read(argv)
    n = 0
    with TableWriter(args[1], holder="mat") as w:
        for key, words in SequentialTableReader(args[0], holder="text"):
            ids = [int(x) for x in words]
            inp = [po["bos"]] + ids
            tgt = ids + [po["eos"]]
            w[key] = np.asarray([inp, tgt], np.float32)
            n += 1
    log.info("rnnlm-get-egs: %d sentences", n)
    return 0


# Port of kaldi_tpu/cli/tools_bank17.py rnnlm_sentence_probs_tool, to
# intent (the original raises on every sentence).
@tool("rnnlm-sentence-probs")
def rnnlm_sentence_probs_tool(argv):
    """Per-sentence total log-probability under a trained RNNLM
    (rnnlmbin/rnnlm-sentence-probs.cc)."""
    from kaldi_tpu_torch.lm.rnnlm import load_rnnlm
    po = ParseOptions("rnnlm-sentence-probs [--bos=1] [--eos=2] "
                      "<rnnlm-in> <text-rspec> <probs-wspec>")
    po.register("bos", int, 1, "BOS id")
    po.register("eos", int, 2, "EOS id")
    _device_po(po)
    args = po.read(argv)
    dev = resolve_device(po["device"])
    model = load_rnnlm(args[0], device=dev)
    n = 0
    with TableWriter(args[2], holder="text") as w, torch.no_grad():
        for key, words in SequentialTableReader(args[1], holder="text"):
            ids = [int(x) for x in words]
            toks = torch.tensor([[po["bos"]] + ids], device=dev)
            lp = torch.log_softmax(model(toks)[0], dim=-1)[0]
            tgt = torch.tensor(ids + [po["eos"]], device=dev)
            total = float(lp[torch.arange(len(tgt), device=dev), tgt]
                          .double().sum())
            w[key] = [f"{total:.4f}"]
            n += 1
    log.info("rnnlm-sentence-probs: %d sentences", n)
    return 0


# Port of kaldi_tpu/cli/tools_bank18.py rnnlm_get_word_embedding_tool.
@tool("rnnlm-get-word-embedding")
def rnnlm_get_word_embedding_tool(argv):
    """Dump the trained RNNLM's word-embedding matrix
    (rnnlmbin/rnnlm-get-word-embedding.cc)."""
    from kaldi_tpu_torch.core import io as kio
    from kaldi_tpu_torch.lm.rnnlm import load_rnnlm
    po = ParseOptions("rnnlm-get-word-embedding <rnnlm-in> "
                      "<matrix-out>")
    args = po.read(argv)
    emb = load_rnnlm(args[0], device="cpu").embed.embedding.detach() \
        .numpy()
    with kio.open_wxfilename(args[1]) as f:
        kio.init_kaldi_output_stream(f)
        kio.write_matrix(f, emb.astype(np.float32))
    log.info("rnnlm-get-word-embedding: %s", emb.shape)
    return 0


# Port of kaldi_tpu/cli/tools_bank21.py
# lattice_lmrescore_kaldi_rnnlm_pruned_tool.
@tool("lattice-lmrescore-kaldi-rnnlm-pruned")
def lattice_lmrescore_kaldi_rnnlm_pruned_tool(argv):
    """RNNLM rescoring through the PRUNED composition (the
    rnnlmbin/lattice-lmrescore-kaldi-rnnlm-pruned.cc flow: subtract
    the old ARPA G exactly, add the RNNLM via beam-pruned on-demand
    composition — tractable on dense lattices where the exact
    composition blows up)."""
    from kaldi_tpu_torch.fst.arpa import ArpaModel
    from kaldi_tpu_torch.fst.fst import SymbolTable
    from kaldi_tpu_torch.lattice.rescore import lmrescore_pruned
    from kaldi_tpu_torch.lm.rnnlm import RnnLmScorer, load_rnnlm
    po = ParseOptions("lattice-lmrescore-kaldi-rnnlm-pruned [opts] "
                      "<old-arpa> <rnnlm> <words.txt> <lat-rspec> "
                      "<lat-wspec>")
    po.register("lm-scale", float, 1.0, "RNNLM weight")
    po.register("lattice-compose-beam", float, 6.0, "composition beam")
    po.register("max-arcs", int, 100_000, "output arc cap")
    _device_po(po)
    args = po.read(argv)
    dev = resolve_device(po["device"])
    old_lm = ArpaModel.parse(args[0])
    words = SymbolTable.read(args[2])
    scorer = RnnLmScorer(load_rnnlm(args[1], device=dev), words,
                         device=dev)
    n = 0
    with TableWriter(args[4], holder="clat") as w:
        for key, clat in SequentialTableReader(args[3], holder="clat"):
            w[key] = lmrescore_pruned(
                clat, old_lm, scorer, words, lm_scale=po["lm-scale"],
                beam=po["lattice-compose-beam"],
                max_arcs=po["max-arcs"])
            n += 1
    log.info("lattice-lmrescore-kaldi-rnnlm-pruned: %d lattices, %d "
             "histories scored on %s", n, scorer.steps, scorer.device.type)
    return 0


# Port of kaldi_tpu/cli/tools_bank28.py lattice_lmrescore_rnnlm_tool.
@tool("lattice-lmrescore-rnnlm")
def lattice_lmrescore_rnnlm_tool(argv):
    """RNNLM lattice rescoring — the legacy latbin spelling
    (latbin/lattice-lmrescore-rnnlm.cc); same deterministic on-demand
    composition as lattice-lmrescore-kaldi-rnnlm."""
    return lattice_lmrescore_kaldi_rnnlm(argv)


# Port of kaldi_tpu/cli/tools_bank28.py rnnlm_get_sampling_lm_tool
# (copied).
@tool("rnnlm-get-sampling-lm")
def rnnlm_get_sampling_lm_tool(argv):
    """Estimate the importance-sampling proposal distribution
    (unigram^power, the rnnlmbin/rnnlm-get-sampling-lm.cc role) from
    training text; rnnlm-train's sampled softmax draws negatives
    from it."""
    from kaldi_tpu_torch.core import io as kio
    po = ParseOptions("rnnlm-get-sampling-lm [opts] <text-rspec> "
                      "<sampling-lm-out>\ntext: int-transcript table")
    po.register("vocab-size", int, 0, "vocabulary size (0 = infer "
                "from the data: max id + 1)")
    po.register("unigram-power", float, 0.75,
                "flattening exponent on the unigram counts")
    args = po.read(argv)
    counts: Dict[int, float] = {}
    n_sent = 0
    for _key, words in SequentialTableReader(args[0], holder="ivec"):
        for wd in np.asarray(words):
            counts[int(wd)] = counts.get(int(wd), 0.0) + 1.0
        n_sent += 1
    if not counts:
        raise KaldiError("rnnlm-get-sampling-lm: no text")
    V = po["vocab-size"] or (max(counts) + 1)
    vec = np.ones(V)                           # add-one smoothing
    for wd, c in counts.items():
        if wd >= V:
            raise KaldiError(f"rnnlm-get-sampling-lm: word id {wd} "
                             f">= vocab size {V}")
        vec[wd] += c
    probs = vec ** po["unigram-power"]
    probs /= probs.sum()
    with kio.open_wxfilename(args[1]) as f:
        kio.init_kaldi_output_stream(f)
        kio.write_token(f, "<SamplingLm>")
        kio.write_basic_float(f, po["unigram-power"])
        kio.write_vector(f, probs.astype(np.float32))
        kio.write_token(f, "</SamplingLm>")
    log.info("rnnlm-get-sampling-lm: %d sentences, vocab %d, "
             "entropy %.3f", n_sent, V,
             -float((probs * np.log(probs)).sum()))
    return 0


# Copied from kaldi_tpu/cli/tools_bank28.py read_sampling_lm.
def read_sampling_lm(path: str) -> np.ndarray:
    """→ proposal probability vector (rnnlm-train consumes this)."""
    from kaldi_tpu_torch.core import io as kio
    with kio.open_rxfilename(path) as f:
        kio.init_kaldi_input_stream(f)
        kio.expect_token(f, "<SamplingLm>")
        kio.read_basic_float(f)
        probs = np.asarray(kio.read_vector(f), np.float64)
        kio.expect_token(f, "</SamplingLm>")
    return probs
