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
