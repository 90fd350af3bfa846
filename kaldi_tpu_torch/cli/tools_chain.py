"""The chain recipe's tools: supervision, egs, model init, graph and decode.

Ports of the tools of the original's cli/ that Kaldi's chain recipes run
(kaldi_tpu/pipelines/chain_cli_recipe.py drives them), registered in
cli/tools.py's ``TOOLS``, each with the original's options and
positional arguments:

  * supervision FSAs (tools_bank28.py, chainbin/chain-get-supervision.cc
    and chain-make-num-fst-e2e.cc): ``chain-get-supervision``,
    ``chain-make-num-fst-e2e``;
  * egs (tools_bank6.py, tools_bank23.py; chainbin/nnet3-chain-get-egs.cc,
    nnet3-chain-e2e-get-egs.cc, nnet3bin/nnet3-chain-copy-egs.cc,
    nnet3-chain-shuffle-egs.cc): ``nnet3-chain-get-egs``,
    ``nnet3-chain-e2e-get-egs`` (which also writes the den graph),
    ``nnet3-chain-copy-egs``, ``nnet3-chain-shuffle-egs``;
  * the rest of the recipe: ``gmm-copy`` and ``arpa2fst``
    (tools_extra.py), ``ali-to-phones`` and ``compute-wer`` (tools.py),
    ``compile-graph`` (tools_bank18.py), ``nnet3-init``
    (tools_bank14.py) and ``nnet3-latgen-faster`` (tools_bank3.py).

All but nnet3-latgen-faster are host code, as in the original, and read
their models on the CPU.  nnet3-latgen-faster runs the raw TDNN-F and the
decoder on ``--device`` (default cuda).  nnet3-init draws its weights
with the port's ``init_tdnn`` from a generator seeded by ``--srand``
(the original's come from jax.random, which the port cannot
reproduce): the same layout and distributions, other values.

    python -m kaldi_tpu_torch.cli <tool> [opts] args...
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from kaldi_tpu_torch.cli.tools import _device_po, tool
from kaldi_tpu_torch.core.logging import KaldiError, get_logger
from kaldi_tpu_torch.core.options import ParseOptions
from kaldi_tpu_torch.core.table import (RandomAccessTableReader,
                                        SequentialTableReader, TableWriter)

log = get_logger(__name__)


def _host_mdl(path: str):
    """A .mdl's transition model and GMM, read on the CPU."""
    from kaldi_tpu_torch.am.serialize import read_mdl
    return read_mdl(path, device="cpu")


# ---------------------------------------------------------------------------
# supervision FSAs
# ---------------------------------------------------------------------------

# Copied from kaldi_tpu/cli/tools_bank28.py _pdfs_for_factory.
def _pdfs_for_factory(tree, topo):
    def pdfs_for(phone: int, is_entry: bool) -> int:
        window = [0] * tree.context_width
        window[tree.central_position] = phone
        st = topo.topology_for_phone(phone)[0]
        cls = (st.forward_pdf_class if is_entry
               else st.self_loop_pdf_class)
        return tree.compute(window, cls)
    return pdfs_for


# Copied from kaldi_tpu/cli/tools_bank28.py _subsample_runs.
def _subsample_runs(runs: List[Tuple[int, int]], sub: int
                    ) -> List[Tuple[int, int]]:
    """Phone-at-frame t·sub for each subsampled frame, re-run-length
    encoded (the get_egs.sh frame-subsampling rule)."""
    T = sum(d for _, d in runs)
    phones = np.repeat([p for p, _ in runs], [d for _, d in runs])
    sub_phones = phones[::sub][:T // sub]
    out: List[Tuple[int, int]] = []
    for p in sub_phones:
        p = int(p)
        if out and out[-1][0] == p:
            out[-1] = (p, out[-1][1] + 1)
        else:
            out.append((p, 1))
    return out


def _fsa_eg(fsa):
    """An fsa-only chain eg (no feats), as the supervision tools write."""
    from kaldi_tpu_torch.pipelines.egs_io import ChainEg
    T_sub = fsa.num_frames
    return ChainEg(feats=np.zeros((0, 0), np.float32),
                   pdf_ali=np.zeros(T_sub, np.int32),
                   mask=np.ones(T_sub, bool), fsa=fsa)


@tool("chain-get-supervision")
def chain_get_supervision_tool(argv):
    """Per-utterance numerator supervision FSAs from forced alignments:
    phone runs at the subsampled rate become one arc per phone with
    boundary times from the alignment; written as fsa-only chain egs."""
    from kaldi_tpu_torch.am.chain_supervision import \
        supervision_from_phone_runs
    from kaldi_tpu_torch.pipelines.chain import phone_alignment_runs
    po = ParseOptions("chain-get-supervision [opts] <chain-mdl> "
                      "<ali-rspec> <supervision-wspec>")
    po.register("frame-subsampling-factor", int, 3, "subsampling")
    args = po.read(argv)
    if len(args) != 3:
        po.print_usage()
        return 1
    tm, _ = _host_mdl(args[0])
    pdfs_for = _pdfs_for_factory(tm.tree, tm.topo)
    sub = po["frame-subsampling-factor"]
    n = 0
    with TableWriter(args[2], holder="ceg") as w:
        for key, tids in SequentialTableReader(args[1], holder="ivec"):
            runs = _subsample_runs(
                phone_alignment_runs(tm, np.asarray(tids).tolist()), sub)
            if not runs:
                log.warning("chain-get-supervision: %s too short", key)
                continue
            T_sub = sum(d for _, d in runs)
            w[key] = _fsa_eg(supervision_from_phone_runs(
                [runs], [0.0], lambda p: pdfs_for(p, True),
                lambda p: pdfs_for(p, False), T_sub))
            n += 1
    log.info("chain-get-supervision: %d utterances (sub ×%d)", n, sub)
    return 0


@tool("chain-make-num-fst-e2e")
def chain_make_num_fst_e2e_tool(argv):
    """End-to-end numerator FSAs straight from phone transcripts, no
    alignment: free boundary times; train with supervision tolerance >=
    the utterance length."""
    from kaldi_tpu_torch.am.chain_supervision import supervision_from_text
    po = ParseOptions("chain-make-num-fst-e2e [opts] <chain-mdl> "
                      "<phone-transcript-rspec> <num-frames-rspec> "
                      "<supervision-wspec>\n"
                      "num-frames: int-vector table with one entry "
                      "[T] per utterance (full frame rate)")
    po.register("frame-subsampling-factor", int, 3, "subsampling")
    args = po.read(argv)
    if len(args) != 4:
        po.print_usage()
        return 1
    tm, _ = _host_mdl(args[0])
    pdfs_for = _pdfs_for_factory(tm.tree, tm.topo)
    sub = po["frame-subsampling-factor"]
    nf_r = RandomAccessTableReader(args[2], holder="ivec")
    n = 0
    with TableWriter(args[3], holder="ceg") as w:
        for key, phones in SequentialTableReader(args[1], holder="ivec"):
            if key not in nf_r:
                continue
            T_sub = int(np.asarray(nf_r[key])[0]) // sub
            phones = [int(p) for p in phones]
            if not phones or len(phones) > T_sub:
                log.warning("chain-make-num-fst-e2e: %s: %d phones vs %d "
                            "frames", key, len(phones), T_sub)
                continue
            w[key] = _fsa_eg(supervision_from_text(
                phones, lambda p: pdfs_for(p, True),
                lambda p: pdfs_for(p, False), T_sub))
            n += 1
    log.info("chain-make-num-fst-e2e: %d utterances", n)
    return 0


# ---------------------------------------------------------------------------
# egs
# ---------------------------------------------------------------------------

@tool("nnet3-chain-get-egs")
def nnet3_chain_get_egs_tool(argv):
    """Cut aligned utterances into fixed-size chain training chunks.  The
    model supplies the chain topology and tree; the den phone LM (for
    the normalization weights) is estimated from the alignments
    themselves (chain-est-phone-lm + get_egs.sh in one stage)."""
    from kaldi_tpu_torch.am.chain import make_denominator_graph
    from kaldi_tpu_torch.pipelines.chain import (make_chain_egs,
                                                 phone_alignment_runs)
    from kaldi_tpu_torch.pipelines.egs_io import write_egs_ark
    po = ParseOptions(
        "nnet3-chain-get-egs [opts] <chain-mdl> <feats-rspec> "
        "<ali-rspec> <egs-wspec>")
    po.register("chunk-size", int, 96, "frames per chunk")
    po.register("frame-subsampling-factor", int, 3, "chain ×3")
    po.register("lm-order", int, 3, "denominator phone-LM order")
    po.register("ali-model", str, "",
                "model whose topology produced <ali-rspec> (the GMM that "
                "aligned the data: chain supervision is phone-level, so "
                "the alignment may come from another topology than the "
                "chain model's; default: the chain model itself)")
    args = po.read(argv)
    if len(args) != 4:
        po.print_usage()
        return 1
    tm, _ = _host_mdl(args[0])
    ali_tm = _host_mdl(po["ali-model"])[0] if po["ali-model"] else tm
    ali = {k: np.asarray(v) for k, v in
           SequentialTableReader(args[2], holder="ivec")}
    feats_r = RandomAccessTableReader(args[1], holder="mat")
    feats = {k: np.asarray(feats_r[k]) for k in sorted(ali)
             if k in feats_r}
    runs = {k: phone_alignment_runs(ali_tm, ali[k]) for k in feats}
    phone_seqs = [[p for p, _ in runs[k]] for k in sorted(runs)]
    den = make_denominator_graph(phone_seqs, tm.tree, tm.topo,
                                 order=po["lm-order"])
    egs = make_chain_egs(feats, runs, tm.tree, tm.topo,
                         chunk_size=po["chunk-size"],
                         subsample=po["frame-subsampling-factor"], den=den)
    write_egs_ark(args[3], egs)
    return 0


@tool("nnet3-chain-e2e-get-egs")
def nnet3_chain_e2e_get_egs_tool(argv):
    """End-to-end (flat-start) chain egs from transcripts, no prior
    alignment: each utterance's supervision is its phone sequence with
    free boundary times, stored as a full FSA in the eg.  Train with
    nnet3-chain-train --supervision-tolerance >= the longest utterance's
    subsampled frame count."""
    from kaldi_tpu_torch.am.chain import (make_denominator_graph,
                                          write_denominator_graph)
    from kaldi_tpu_torch.am.chain_supervision import make_chain_egs_e2e
    from kaldi_tpu_torch.core import io as kio
    from kaldi_tpu_torch.pipelines.egs_io import write_egs_ark
    po = ParseOptions("nnet3-chain-e2e-get-egs [opts] <chain-mdl> "
                      "<feats-rspec> <phone-transcript-rspec> "
                      "<egs-wspec> [<den-out>]\n"
                      "phone transcripts: int-vector tables "
                      "(sym2int'd pronunciations)")
    po.register("frame-subsampling-factor", int, 3, "subsampling")
    po.register("lm-order", int, 2, "den phone-LM order (den graph "
                "estimated from the transcripts themselves)")
    args = po.read(argv)
    if len(args) not in (4, 5):
        po.print_usage()
        return 1
    tm, _ = _host_mdl(args[0])
    seqs = {k: [int(p) for p in v] for k, v in
            SequentialTableReader(args[2], holder="ivec")}
    feats = {k: np.asarray(v, np.float32) for k, v in
             SequentialTableReader(args[1], holder="mat") if k in seqs}
    if not feats:
        raise KaldiError("nnet3-chain-e2e-get-egs: no utterances with both "
                         "feats and transcripts")
    den = make_denominator_graph(list(seqs.values()), tm.tree, tm.topo,
                                 order=po["lm-order"])
    egs = make_chain_egs_e2e(feats, seqs, tm.tree, tm.topo,
                             subsample=po["frame-subsampling-factor"],
                             den=den)
    n = write_egs_ark(args[3], egs)
    if len(args) > 4:
        with kio.open_wxfilename(args[4]) as f:
            kio.init_kaldi_output_stream(f)
            write_denominator_graph(f, den)
    log.info("nnet3-chain-e2e-get-egs: %d egs (max %d subsampled frames: "
             "pass --supervision-tolerance >= that to nnet3-chain-train)",
             n, int(egs.mask.shape[1]))
    return 0


@tool("nnet3-chain-copy-egs")
def nnet3_chain_copy_egs_tool(argv):
    po = ParseOptions(
        "nnet3-chain-copy-egs [--n=-1] <egs-rspec> <egs-wspec>")
    po.register("n", int, -1, "copy only the first n (-1 = all)")
    args = po.read(argv)
    if len(args) != 2:
        po.print_usage()
        return 1
    n = 0
    with TableWriter(args[1], holder="ceg") as w:
        for key, eg in SequentialTableReader(args[0], holder="ceg"):
            if po["n"] >= 0 and n >= po["n"]:
                break
            w[key] = eg
            n += 1
    log.info("copied %d chain egs", n)
    return 0


@tool("nnet3-chain-shuffle-egs")
def nnet3_chain_shuffle_egs_tool(argv):
    po = ParseOptions(
        "nnet3-chain-shuffle-egs [--srand=0] <egs-rspec> <egs-wspec>")
    po.register("srand", int, 0, "shuffle seed")
    args = po.read(argv)
    if len(args) != 2:
        po.print_usage()
        return 1
    entries = list(SequentialTableReader(args[0], holder="ceg"))
    order = np.random.default_rng(po["srand"]).permutation(len(entries))
    with TableWriter(args[1], holder="ceg") as w:
        for i in order:
            key, eg = entries[i]
            w[key] = eg
    log.info("shuffled %d chain egs (srand %d)", len(entries), po["srand"])
    return 0


# ---------------------------------------------------------------------------
# the rest of the recipe
# ---------------------------------------------------------------------------

@tool("gmm-copy")
def gmm_copy(argv):
    from kaldi_tpu_torch.am.serialize import write_mdl
    po = ParseOptions("gmm-copy <model-in> <model-out>")
    args = po.read(argv)
    if len(args) != 2:
        po.print_usage()
        return 1
    tm, am = _host_mdl(args[0])
    write_mdl(args[1], tm, am)
    return 0


@tool("ali-to-phones")
def ali_to_phones(argv):
    po = ParseOptions("ali-to-phones <model> <ali-rspec> <phones-wspec>")
    args = po.read(argv)
    if len(args) != 3:
        po.print_usage()
        return 1
    tm, _ = _host_mdl(args[0])
    with TableWriter(args[2], holder="ivec") as w:
        for key, ali in SequentialTableReader(args[1], holder="ivec"):
            w[key] = np.asarray(tm.alignment_to_phones(ali.tolist()),
                                dtype=np.int32)
    return 0


@tool("compute-wer")
def compute_wer_tool(argv):
    from kaldi_tpu_torch.pipelines.score import compute_wer
    po = ParseOptions("compute-wer <ref-rspecifier> <hyp-rspecifier>")
    args = po.read(argv)
    if len(args) != 2:
        po.print_usage()
        return 1
    refs = dict(SequentialTableReader(args[0], holder="text"))
    hyps = dict(SequentialTableReader(args[1], holder="text"))
    print(compute_wer(refs, hyps))
    return 0


@tool("arpa2fst")
def arpa2fst(argv):
    from kaldi_tpu_torch.fst.arpa import ArpaModel, arpa_to_fst
    from kaldi_tpu_torch.fst.fst import SymbolTable
    from kaldi_tpu_torch.fst.openfst_io import write_fst_path
    po = ParseOptions("arpa2fst --read-symbol-table=words.txt "
                      "<arpa-in> <fst-out>")
    po.register("read-symbol-table", str, "", "words.txt")
    po.register("disambig-symbol", str, "#0", "backoff ilabel name")
    args = po.read(argv)
    if len(args) != 2:
        po.print_usage()
        return 1
    if not po["read-symbol-table"]:
        raise KaldiError("arpa2fst: --read-symbol-table is required")
    words = SymbolTable.read(po["read-symbol-table"])
    backoff = (words[po["disambig-symbol"]]
               if po["disambig-symbol"] in words else None)
    model = ArpaModel.parse(args[0])
    write_fst_path(args[1], arpa_to_fst(model, words,
                                        backoff_symbol=backoff))
    return 0


@tool("compile-graph")
def compile_graph_tool(argv):
    """One-shot HCLG compilation from lang pieces and a model
    (bin/compile-graph.cc / utils/mkgraph.sh): lexicon + G fst → binary
    HCLG."""
    from kaldi_tpu_torch.cli.latgen import _load_hclg
    from kaldi_tpu_torch.fst import Lang, Lexicon, mkgraph
    from kaldi_tpu_torch.fst.openfst_io import write_vector_fst
    po = ParseOptions("compile-graph [opts] <lexicon-file> <model-in> "
                      "<G-fst> <HCLG-out>")
    po.register("self-loop-scale", float, 0.1, "self-loop scale")
    args = po.read(argv)
    if len(args) != 4:
        po.print_usage()
        return 1
    entries = []
    with open(args[0]) as f:
        for line in f:
            parts = line.split()
            if parts:
                entries.append((parts[0], parts[1:]))
    lang = Lang(Lexicon(entries=entries))
    tm, _ = _host_mdl(args[1])
    HCLG = mkgraph(lang, tm, _load_hclg(args[2]),
                   self_loop_scale=po["self-loop-scale"])
    with open(args[3], "wb") as f:
        write_vector_fst(f, HCLG)
    log.info("compile-graph: HCLG %d states, %d arcs", HCLG.num_states,
             HCLG.num_arcs)
    return 0


@tool("nnet3-init")
def nnet3_init_tool(argv):
    """A raw TDNN-F acoustic model with fresh weights (nnet3bin/nnet3-init
    role; the topology from flags, as nnet3-train takes it): the port's
    ``init_tdnn`` draws them from a generator seeded by ``--srand``."""
    from kaldi_tpu_torch.am.nnet3_io import write_raw_model
    from kaldi_tpu_torch.am.tdnn import TdnnChain, TdnnConfig, init_tdnn
    po = ParseOptions("nnet3-init [opts] <raw-out>")
    po.register("feat-dim", int, 0, "input dim (required)")
    po.register("num-pdfs", int, 0, "output dim (required)")
    po.register("hidden-dim", int, 256, "hidden layer dim")
    po.register("bottleneck-dim", int, 64, "TDNN-F bottleneck dim")
    po.register("num-layers", int, 5, "TDNN-F layers")
    po.register("srand", int, 0, "init seed")
    args = po.read(argv)
    if len(args) != 1:
        po.print_usage()
        return 1
    if po["feat-dim"] <= 0 or po["num-pdfs"] <= 0:
        raise KaldiError("nnet3-init: --feat-dim and --num-pdfs required")
    cfg = TdnnConfig(feat_dim=po["feat-dim"], num_pdfs=po["num-pdfs"],
                     hidden_dim=po["hidden-dim"],
                     bottleneck_dim=po["bottleneck-dim"],
                     num_layers=po["num-layers"], frame_subsampling_factor=1)
    net = init_tdnn(TdnnChain(cfg), po["srand"])
    write_raw_model(args[0], net.state_dict(), cfg)
    return 0


@tool("nnet3-latgen-faster")
def nnet3_latgen_faster(argv):
    """Chain-model lattice decoding: the raw TDNN-F's outputs at the
    subsampled rate, decoded by the latgen tools' decoder (dense up to
    20,000 graph states, beam above) on ``--device``."""
    import torch
    from kaldi_tpu_torch.cli.latgen import (_LatgenDecoder, _load_hclg,
                                            latgen_kwargs,
                                            register_latgen_opts)
    from kaldi_tpu_torch.cli.online2 import _load_tdnn
    from kaldi_tpu_torch.device import resolve_device
    from kaldi_tpu_torch.fst.fst import SymbolTable
    po = ParseOptions("nnet3-latgen-faster [opts] <trans-model> "
                      "<raw-nnet3> <fst> <feats-rspec> <lat-wspec> "
                      "[<words-wspec>]")
    po.register("beam", float, 15.0, "decoding beam")
    po.register("lattice-beam", float, 8.0, "lattice beam")
    po.register("max-active", int, 7000, "max active states")
    po.register("acoustic-scale", float, 1.0, "acoustic scale")
    po.register("frame-subsampling-factor", int, 3, "subsampling")
    po.register("word-symbol-table", str, "", "words.txt")
    register_latgen_opts(po)
    _device_po(po)
    args = po.read(argv)
    if len(args) not in (5, 6):
        po.print_usage()
        return 1
    device = resolve_device(po["device"])
    tm, _ = _host_mdl(args[0])
    _, net = _load_tdnn(args[1], po["frame-subsampling-factor"], device)
    dec = _LatgenDecoder(_load_hclg(args[2]), tm.tid_to_pdf_array,
                         po["beam"], po["lattice-beam"],
                         po["acoustic-scale"], max_active=po["max-active"],
                         device=device, **latgen_kwargs(po))
    words_tab = (SymbolTable.read(po["word-symbol-table"])
                 if po["word-symbol-table"] else None)
    wwriter = (TableWriter(args[5], holder="text")
               if len(args) > 5 else None)
    n = 0
    with TableWriter(args[4], holder="clat") as lw:
        for key, feats in SequentialTableReader(args[3], holder="mat"):
            x = torch.from_numpy(np.asarray(feats, np.float32)).to(device)
            with torch.no_grad():
                scores = net(x[None])[0]
            clat = dec.decode_to_clat(scores)
            lw[key] = clat
            wseq, _, cost = clat.best_path()
            text = [words_tab.find(w) if words_tab else str(w)
                    for w in wseq]
            if wwriter:
                wwriter[key] = text
            log.info("%s: %s (cost %.2f)", key, " ".join(text), cost)
            n += 1
    if wwriter:
        wwriter.close()
    log.info("nnet3-latgen-faster: decoded %d utterances", n)
    return 0
