"""Port of kaldi_tpu/cli/tools_bank29.py nnet3-latgen-grammar (parity
target nnet3bin/nnet3-latgen-grammar.cc), registered in cli/tools.py's
``TOOLS``.  It takes ``--device`` (default cuda): the raw TDNN-F's
forward and the latgen decoder (cli/latgen.py ``_LatgenDecoder``) run
there; the grammar's splice is host code (fst/grammar.py).
nnet3-get-egs-dense-targets (nnet3bin/nnet3-get-egs-dense-targets.cc)
is the original's host code, copied: it writes ``dteg`` archives
(pipelines/egs_io.py ``DenseEg``).
nnet3-latgen-faster-looped (nnet3bin/nnet3-latgen-faster-looped.cc)
takes ``--device``: the TDNN-F scores overlapping windows there and the
latgen decoder decodes their rows.
nnet3-get-egs-simple (nnet3bin/nnet3-get-egs-simple.cc) is host code,
copied.  The nnetbin tail (nnetbin/{nnet-train-multistream,
nnet-train-multistream-perutt, train-transitions,
nnet-set-learnrate}.cc): the two multistream trainers run the nnet1
sigmoid DNN's SGD on ``--device``; train-transitions and
nnet-set-learnrate are host code, copied.
"""

from __future__ import annotations

import numpy as np
import torch

from kaldi_tpu_torch.cli.tools import _device_po, tool
from kaldi_tpu_torch.core.logging import KaldiError, get_logger
from kaldi_tpu_torch.core.options import ParseOptions
from kaldi_tpu_torch.core.table import (RandomAccessTableReader,
                                        SequentialTableReader, TableWriter)
from kaldi_tpu_torch.device import resolve_device

log = get_logger(__name__)


# Port of kaldi_tpu/cli/tools_bank29.py nnet3_latgen_grammar_tool.
@tool("nnet3-latgen-grammar")
def nnet3_latgen_grammar_tool(argv):
    """Lattice decoding over a grammar FST: nonterminal sub-HCLGs are
    spliced into the top-level graph, then the standard latgen runs
    (nnet3bin/nnet3-latgen-grammar.cc; expansion via
    fst/grammar.py replace_nonterminals — the offline reading of the
    reference's lazily-expanded GrammarFst)."""
    from kaldi_tpu_torch.am.serialize import read_mdl
    from kaldi_tpu_torch.cli.latgen import _LatgenDecoder
    from kaldi_tpu_torch.cli.online2 import _load_tdnn
    from kaldi_tpu_torch.cli.tools_bank24 import read_grammar
    from kaldi_tpu_torch.fst.csr import csr_to_vector_fst
    from kaldi_tpu_torch.fst.grammar import replace_nonterminals
    po = ParseOptions("nnet3-latgen-grammar [opts] <trans-model> "
                      "<raw-nnet3> <top-hclg> <nonterm-int1> "
                      "<sub-hclg1> [...] <feats-rspec> <lat-wspec>")
    po.register("beam", float, 15.0, "decoding beam")
    po.register("lattice-beam", float, 8.0, "lattice beam")
    po.register("max-active", int, 7000, "max active states")
    po.register("acoustic-scale", float, 1.0, "acoustic scale")
    po.register("frame-subsampling-factor", int, 3, "subsampling")
    _device_po(po)
    args = po.read(argv)
    if len(args) < 7 or (len(args) - 5) % 2:
        raise KaldiError("nnet3-latgen-grammar: need trans-model, "
                         "nnet, top, (nonterm, sub)+, feats, lats")
    device = resolve_device(po["device"])
    tm, _am = read_mdl(args[0], device="cpu")
    _cfg, net = _load_tdnn(args[1], po["frame-subsampling-factor"], device)
    top, subs = read_grammar(args[2], args[3:-2])
    HCLG = csr_to_vector_fst(replace_nonterminals(top, subs))
    dec = _LatgenDecoder(HCLG, tm.tid_to_pdf_array, po["beam"],
                         po["lattice-beam"], po["acoustic-scale"],
                         max_active=po["max-active"], device=device)
    n = 0
    with TableWriter(args[-1], holder="clat") as lw, torch.no_grad():
        for key, feats in SequentialTableReader(args[-2], holder="mat"):
            x = torch.as_tensor(np.asarray(feats, np.float32)).to(device)
            lw[key] = dec.decode_to_clat(net(x[None])[0])
            n += 1
    log.info("nnet3-latgen-grammar: %d utterances (%d nonterminals)",
             n, len(subs))
    return 0


# Copied from kaldi_tpu/cli/tools_bank29.py nnet3_get_egs_dense_targets_tool.
@tool("nnet3-get-egs-dense-targets")
def nnet3_get_egs_dense_targets_tool(argv):
    """Chunked egs with DENSE float targets
    (nnet3bin/nnet3-get-egs-dense-targets.cc): regression/soft-label
    training examples."""
    from kaldi_tpu_torch.pipelines.egs_io import DenseEg
    po = ParseOptions("nnet3-get-egs-dense-targets [--chunk-size=64] "
                      "<feats-rspec> <targets-rspec> <egs-wspec>")
    po.register("chunk-size", int, 64, "frames per chunk")
    args = po.read(argv)
    T = po["chunk-size"]
    tgt_r = RandomAccessTableReader(args[1], holder="mat")
    n = 0
    with TableWriter(args[2], holder="dteg") as w:
        for key, feats in SequentialTableReader(args[0], holder="mat"):
            if key not in tgt_r:
                log.warning("nnet3-get-egs-dense-targets: no targets "
                            "for %s", key)
                continue
            feats = np.asarray(feats, np.float32)
            tgts = np.asarray(tgt_r[key], np.float32)
            if len(tgts) != len(feats):
                raise KaldiError(f"{key}: targets/feats length "
                                 "mismatch")
            for i, lo in enumerate(range(0, len(feats) - T + 1, T)):
                w[f"{key}-{i}"] = DenseEg(feats[lo:lo + T],
                                          tgts[lo:lo + T])
                n += 1
    log.info("nnet3-get-egs-dense-targets: %d egs", n)
    return 0


# Port of kaldi_tpu/cli/tools_bank29.py nnet3_latgen_faster_looped_tool.
@tool("nnet3-latgen-faster-looped")
def nnet3_latgen_faster_looped_tool(argv):
    """Lattice decoding with LOOPED (chunked, state-carrying) acoustic
    scoring (nnet3bin/nnet3-latgen-faster-looped.cc): the TDNN scores
    --chunk-frames at a time with --extra-context frames of overlap —
    bounded activation memory for arbitrarily long utterances; with
    overlap ≥ the receptive field the scores equal the whole-utterance
    forward.  The windows' forwards and the decode run on
    ``--device``."""
    from kaldi_tpu_torch.am.serialize import read_mdl
    from kaldi_tpu_torch.cli.latgen import _LatgenDecoder, _load_hclg
    from kaldi_tpu_torch.cli.online2 import _load_tdnn
    po = ParseOptions("nnet3-latgen-faster-looped [opts] <trans-model> "
                      "<raw-nnet3> <fst> <feats-rspec> <lat-wspec>")
    po.register("beam", float, 15.0, "decoding beam")
    po.register("lattice-beam", float, 8.0, "lattice beam")
    po.register("max-active", int, 7000, "max active states")
    po.register("acoustic-scale", float, 1.0, "acoustic scale")
    po.register("frame-subsampling-factor", int, 3, "subsampling")
    po.register("chunk-frames", int, 51,
                "frames scored per step (multiple of subsampling)")
    po.register("extra-context", int, 30,
                "overlap frames each side (≥ receptive field)")
    _device_po(po)
    args = po.read(argv)
    device = resolve_device(po["device"])
    tm, _am = read_mdl(args[0], device="cpu")
    sub = po["frame-subsampling-factor"]
    _cfg, net = _load_tdnn(args[1], sub, device)
    dec = _LatgenDecoder(_load_hclg(args[2]), tm.tid_to_pdf_array,
                         po["beam"], po["lattice-beam"],
                         po["acoustic-scale"],
                         max_active=po["max-active"], device=device)
    C = po["chunk-frames"] - po["chunk-frames"] % sub or sub
    ctx = po["extra-context"] - po["extra-context"] % sub
    n = 0
    with TableWriter(args[4], holder="clat") as lw, torch.no_grad():
        for key, feats in SequentialTableReader(args[3], holder="mat"):
            x = torch.as_tensor(np.asarray(feats, np.float32)).to(device)
            lw[key] = dec.decode_to_clat(looped_scores(net, x, C, ctx, sub))
            n += 1
    log.info("nnet3-latgen-faster-looped: %d utterances (chunk %d, "
             "context %d)", n, C, ctx)
    return 0


def looped_scores(net, feats: torch.Tensor, C: int, ctx: int,
                  sub: int) -> torch.Tensor:
    """The original's ``looped_scores``: the forward of each window of
    ``C`` frames with ``ctx`` frames of context either side (cut at the
    utterance's ends), each window's own rows kept."""
    T = feats.shape[0]
    outs = []
    for lo in range(0, T, C):
        hi = min(lo + C, T)
        a = max(lo - ctx, 0)
        b = min(hi + ctx, T)
        win = net(feats[a:b][None])[0]
        s0 = (lo - a) // sub
        outs.append(win[s0:s0 + (hi - lo) // sub])
    return torch.cat(outs)


# Copied from kaldi_tpu/cli/tools_bank29.py nnet3_get_egs_simple_tool.
@tool("nnet3-get-egs-simple")
def nnet3_get_egs_simple_tool(argv):
    """Whole-utterance egs, no chunking
    (nnet3bin/nnet3-get-egs-simple.cc)."""
    from kaldi_tpu_torch.pipelines.egs_io import XentEg
    po = ParseOptions("nnet3-get-egs-simple <feats-rspec> "
                      "<pdf-ali-rspec> <egs-wspec>")
    args = po.read(argv)
    ali_r = RandomAccessTableReader(args[1], holder="ivec")
    n = 0
    with TableWriter(args[2], holder="xeg") as w:
        for key, feats in SequentialTableReader(args[0], holder="mat"):
            if key not in ali_r:
                continue
            feats = np.asarray(feats, np.float32)
            pdfs = np.asarray(ali_r[key], np.int32)
            T = min(len(feats), len(pdfs))
            w[key] = XentEg(feats[:T][None], pdfs[:T][None])
            n += 1
    log.info("nnet3-get-egs-simple: %d egs", n)
    return 0


# ---------------------------------------------------------------------------
# nnetbin tail
# ---------------------------------------------------------------------------

# Port of kaldi_tpu/cli/tools_bank29.py _nnet1_multistream.
def _nnet1_multistream(argv, name: str, perutt: bool):
    """Shared body of nnet-train-multistream{,-perutt}: N parallel
    utterance streams; each step consumes one chunk (or whole
    utterance) per stream, so consecutive minibatches mix speakers —
    the BPTT data-scheduling pattern of nnetbin, applied to the
    sigmoid DNN (sequential within a stream, shuffled across).  The
    SGD steps run on ``--device``."""
    from kaldi_tpu_torch.am.nnet1 import (load_nnet1, nnet1_model,
                                          save_nnet1, sgd_step)
    po = ParseOptions(f"{name} [opts] <nnet1-in> <feats-rspec> "
                      "<pdf-ali-rspec> <nnet1-out>")
    po.register("num-streams", int, 4, "parallel utterance streams")
    po.register("batch-frames", int, 32,
                "frames pulled per stream per step")
    po.register("learning-rate", float, 0.5, "SGD lr")
    _device_po(po)
    args = po.read(argv)
    device = resolve_device(po["device"])
    params, hid_dims, num_pdfs, priors = load_nnet1(args[0])
    model = nnet1_model(params, hid_dims, num_pdfs, device).train()
    ali_r = RandomAccessTableReader(args[2], holder="ivec")
    utts = []
    for key, m in SequentialTableReader(args[1], holder="mat"):
        if key not in ali_r:
            continue
        m = np.asarray(m, np.float32)
        a = np.asarray(ali_r[key], np.int64)
        T = min(len(m), len(a))
        utts.append((torch.tensor(m[:T], device=device),
                     torch.tensor(a[:T], device=device)))
    if not utts:
        raise KaldiError(f"{name}: no matched utterances")
    S = min(po["num-streams"], len(utts))
    C = po["batch-frames"]
    # stream scheduler: stream s holds utterance queue s::S
    queues = [[utts[i] for i in range(s, len(utts), S)]
              for s in range(S)]
    cursors = [[0, 0] for _ in range(S)]        # (utt idx, frame pos)
    loss, n_steps = None, 0
    while True:
        fs, ts = [], []
        for s in range(S):
            ui, pos = cursors[s]
            if ui >= len(queues[s]):
                continue
            m, a = queues[s][ui]
            if perutt:
                fs.append(m)
                ts.append(a)
                cursors[s] = [ui + 1, 0]
            else:
                fs.append(m[pos:pos + C])
                ts.append(a[pos:pos + C])
                pos += C
                cursors[s] = ([ui + 1, 0] if pos >= len(m)
                              else [ui, pos])
        if not fs:
            break
        f, t = torch.cat(fs), torch.cat(ts)
        loss = -torch.gather(model(f), 1, t[:, None]).mean()
        sgd_step(model, loss, po["learning-rate"])
        loss = loss.detach()
        n_steps += 1
    save_nnet1(args[3], model, hid_dims, num_pdfs, priors)
    log.info("%s: %d streams, %d steps, final xent %.4f", name, S,
             n_steps, float(loss))
    return 0


# Port of kaldi_tpu/cli/tools_bank29.py nnet_train_multistream_tool.
@tool("nnet-train-multistream")
def nnet_train_multistream_tool(argv):
    """Multistream nnet1 training
    (nnetbin/nnet-train-multistream.cc)."""
    return _nnet1_multistream(argv, "nnet-train-multistream", False)


# Port of kaldi_tpu/cli/tools_bank29.py nnet_train_multistream_perutt_tool.
@tool("nnet-train-multistream-perutt")
def nnet_train_multistream_perutt_tool(argv):
    """Per-utterance multistream nnet1 training
    (nnetbin/nnet-train-multistream-perutt.cc)."""
    return _nnet1_multistream(argv, "nnet-train-multistream-perutt",
                              True)


# Copied from kaldi_tpu/cli/tools_bank29.py train_transitions_tool.
@tool("train-transitions")
def train_transitions_tool(argv):
    """Re-estimate transition probabilities from alignments — the
    nnetbin spelling (nnetbin/train-transitions.cc)."""
    from kaldi_tpu_torch.am.serialize import (read_transition_model,
                                              write_transition_model)
    from kaldi_tpu_torch.core import io as kio
    po = ParseOptions("train-transitions <trans-model-in> <ali-rspec> "
                      "<trans-model-out>")
    args = po.read(argv)
    with kio.open_rxfilename(args[0]) as f:
        kio.init_kaldi_input_stream(f)
        tm = read_transition_model(f)
    counts = np.zeros(tm.num_transition_ids + 1)
    n = 0
    for _key, ali in SequentialTableReader(args[1], holder="ivec"):
        np.add.at(counts, np.asarray(ali, np.int64), 1.0)
        n += 1
    if n == 0:
        raise KaldiError("train-transitions: no alignments")
    tm.mle_update(counts)
    with kio.open_wxfilename(args[2]) as f:
        kio.init_kaldi_output_stream(f)
        write_transition_model(f, tm)
    log.info("train-transitions: %d alignments", n)
    return 0


# Copied from kaldi_tpu/cli/tools_bank29.py nnet_set_learnrate_tool.
@tool("nnet-set-learnrate")
def nnet_set_learnrate_tool(argv):
    """Set per-layer learning-rate factors on an nnet1
    (nnetbin/nnet-set-learnrate.cc): ':'-separated factors for
    [hidden1..hiddenN, output_affine]; 0 freezes a layer.
    nnet-train-frmshuff scales its gradients by them."""
    from kaldi_tpu_torch.am.nnet1 import load_nnet1_full, save_nnet1
    po = ParseOptions("nnet-set-learnrate --coefs=1:1:0.1 <nnet1-in> "
                      "<nnet1-out>")
    po.register("coefs", str, "",
                "per-layer factors, ':'-separated (REQUIRED)")
    args = po.read(argv)
    if not po["coefs"]:
        raise KaldiError("nnet-set-learnrate: --coefs required")
    params, hid_dims, num_pdfs, priors, _old = load_nnet1_full(args[0])
    coefs = [float(x) for x in po["coefs"].split(":")]
    want = len(hid_dims) + 1
    if len(coefs) != want:
        raise KaldiError(f"nnet-set-learnrate: {len(coefs)} coefs for "
                         f"{want} layers")
    save_nnet1(args[1], params, hid_dims, num_pdfs, priors=priors,
               lr_factors=np.asarray(coefs, np.float32))
    log.info("nnet-set-learnrate: %s", coefs)
    return 0
