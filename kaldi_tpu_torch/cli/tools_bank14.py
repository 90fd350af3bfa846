"""Port of kaldi_tpu/cli/tools_bank14.py's nnet3 cross-entropy egs tools
(parity targets nnet3bin/{nnet3-get-egs, nnet3-copy-egs,
nnet3-shuffle-egs, nnet3-merge-egs, nnet3-compute-prob,
nnet3-align-compiled}.cc), registered in cli/tools.py's ``TOOLS``.  The
egs tools are the original's host code, copied (``xeg`` archives,
pipelines/egs_io.py ``XentEg``).  nnet3-compute-prob and
nnet3-align-compiled take ``--device`` (default cuda): the raw TDNN-F's
forward runs there, and the aligner (``DenseAligner``, one utterance a
call, as in the original) with it.  The rest of the original's bank
(nnet3-init, the lattice tools) is registered by cli/tools_chain.py and
cli/tools_lattice.py.
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


# Copied from kaldi_tpu/cli/tools_bank14.py nnet3_get_egs_tool.
@tool("nnet3-get-egs")
def nnet3_get_egs_tool(argv):
    """Cut feats + pdf alignments into fixed-size xent chunks
    (nnet3bin/nnet3-get-egs.cc)."""
    from kaldi_tpu_torch.pipelines.egs_io import XentEg
    po = ParseOptions("nnet3-get-egs [--chunk-size=64] <feats-rspec> "
                      "<pdf-ali-rspec> <egs-wspec>")
    po.register("chunk-size", int, 64, "frames per chunk")
    args = po.read(argv)
    T = po["chunk-size"]
    ali_r = RandomAccessTableReader(args[1], holder="ivec")
    n = 0
    with TableWriter(args[2], holder="xeg") as w:
        for key, feats in SequentialTableReader(args[0], holder="mat"):
            if key not in ali_r:
                log.warning("nnet3-get-egs: no alignment for %s", key)
                continue
            feats = np.asarray(feats, np.float32)
            pdfs = np.asarray(ali_r[key], np.int32)
            if len(pdfs) != len(feats):
                raise KaldiError(f"{key}: ali/feats length mismatch")
            for i, lo in enumerate(range(0, len(feats) - T + 1, T)):
                w[f"{key}-{i}"] = XentEg(feats[lo:lo + T][None],
                                         pdfs[lo:lo + T][None])
                n += 1
            rem = len(feats) % T
            if rem >= T // 2:    # keep the tail chunk, left-extended
                w[f"{key}-tail"] = XentEg(feats[-T:][None],
                                          pdfs[-T:][None])
                n += 1
    log.info("nnet3-get-egs: wrote %d egs of %d frames", n, T)
    return 0


# Copied from kaldi_tpu/cli/tools_bank14.py nnet3_copy_egs_tool.
@tool("nnet3-copy-egs")
def nnet3_copy_egs_tool(argv):
    po = ParseOptions("nnet3-copy-egs [--n=-1] <egs-rspec> <egs-wspec>")
    po.register("n", int, -1, "copy only the first n (-1 = all)")
    args = po.read(argv)
    n = 0
    with TableWriter(args[1], holder="xeg") as w:
        for key, eg in SequentialTableReader(args[0], holder="xeg"):
            if po["n"] >= 0 and n >= po["n"]:
                break
            w[key] = eg
            n += 1
    log.info("copied %d egs", n)
    return 0


# Copied from kaldi_tpu/cli/tools_bank14.py nnet3_shuffle_egs_tool.
@tool("nnet3-shuffle-egs")
def nnet3_shuffle_egs_tool(argv):
    po = ParseOptions("nnet3-shuffle-egs [--srand=0] <egs-rspec> "
                      "<egs-wspec>")
    po.register("srand", int, 0, "shuffle seed")
    args = po.read(argv)
    entries = list(SequentialTableReader(args[0], holder="xeg"))
    order = np.random.default_rng(po["srand"]).permutation(len(entries))
    with TableWriter(args[1], holder="xeg") as w:
        for i in order:
            key, eg = entries[i]
            w[key] = eg
    return 0


# Copied from kaldi_tpu/cli/tools_bank14.py nnet3_merge_egs_tool.
@tool("nnet3-merge-egs")
def nnet3_merge_egs_tool(argv):
    """Batch consecutive same-length egs into minibatch egs
    (nnet3bin/nnet3-merge-egs.cc)."""
    from kaldi_tpu_torch.pipelines.egs_io import XentEg
    po = ParseOptions("nnet3-merge-egs [--minibatch-size=32] "
                      "<egs-rspec> <egs-wspec>")
    po.register("minibatch-size", int, 32, "chunks per merged eg")
    args = po.read(argv)
    B = po["minibatch-size"]
    buf, n_out = [], 0

    def flush(w):
        nonlocal n_out
        if not buf:
            return
        feats = np.concatenate([e.feats for e in buf])
        pdfs = np.concatenate([e.pdfs for e in buf])
        w[f"mb-{n_out}"] = XentEg(feats, pdfs)
        n_out += 1
        buf.clear()

    with TableWriter(args[1], holder="xeg") as w:
        for _key, eg in SequentialTableReader(args[0], holder="xeg"):
            if buf and buf[0].feats.shape[1] != eg.feats.shape[1]:
                flush(w)
            buf.append(eg)
            if sum(e.feats.shape[0] for e in buf) >= B:
                flush(w)
        flush(w)
    log.info("nnet3-merge-egs: wrote %d minibatch egs", n_out)
    return 0


def compute_prob(net, egs_rspec: str, device):
    """nnet3-compute-prob's sums over the xent egs of ``egs_rspec``:
    the TDNN-F ``net``'s log-softmax at each eg's pdf targets, its
    frames whose argmax is the target, and the frames.  → (total
    log-probability, correct frames, frames)."""
    tot_lp = torch.zeros((), dtype=torch.float64, device=device)
    tot_correct = torch.zeros((), dtype=torch.int64, device=device)
    tot_frames = 0
    with torch.no_grad():
        for _key, eg in SequentialTableReader(egs_rspec, holder="xeg"):
            lp = torch.log_softmax(net(torch.tensor(
                np.asarray(eg.feats, np.float32), device=device)), dim=-1)
            pdfs = torch.tensor(np.asarray(eg.pdfs, np.int64),
                                device=device)
            picked = torch.gather(lp, 2, pdfs[..., None])[..., 0]
            tot_lp += picked.sum()
            tot_correct += (lp.argmax(-1) == pdfs).sum()
            tot_frames += pdfs.numel()
    return float(tot_lp), int(tot_correct), tot_frames


# Port of kaldi_tpu/cli/tools_bank14.py nnet3_compute_prob_tool.
@tool("nnet3-compute-prob")
def nnet3_compute_prob_tool(argv):
    """Average per-frame log-probability + accuracy of a raw model on
    egs on ``--device`` (nnet3bin/nnet3-compute-prob.cc; the
    train/valid diagnostic)."""
    from kaldi_tpu_torch.cli.online2 import _load_tdnn
    po = ParseOptions("nnet3-compute-prob <raw-model> <egs-rspec>")
    _device_po(po)
    args = po.read(argv)
    device = resolve_device(po["device"])
    _, net = _load_tdnn(args[0], 1, device)
    tot_lp, tot_correct, tot_frames = compute_prob(net, args[1], device)
    if tot_frames == 0:
        raise KaldiError("nnet3-compute-prob: no egs")
    print(f"log-probability per frame {tot_lp / tot_frames:.4f} "
          f"accuracy {tot_correct / tot_frames:.4f} "
          f"over {tot_frames} frames")
    return 0


# Port of kaldi_tpu/cli/tools_bank14.py nnet3_align_compiled_tool.
@tool("nnet3-align-compiled")
def nnet3_align_compiled_tool(argv):
    """Align utterances against per-utterance graphs with nnet3
    pseudo-loglikes on ``--device`` (nnet3bin/nnet3-align-compiled.cc).
    The transition model (tid→pdf map) comes from <model>; acoustic
    scores (the raw nnet's outputs, as the original uses them) from the
    raw nnet."""
    from kaldi_tpu_torch.am.serialize import read_mdl
    from kaldi_tpu_torch.cli.online2 import _load_tdnn
    from kaldi_tpu_torch.cli.tools_bank28 import align_compiled
    po = ParseOptions("nnet3-align-compiled [opts] <model> <raw-nnet> "
                      "<graphs-rspec> <feats-rspec> <ali-wspec>")
    po.register("acoustic-scale", float, 1.0, "acoustic scale")
    _device_po(po)
    args = po.read(argv)
    device = resolve_device(po["device"])
    tm, _am = read_mdl(args[0], device="cpu")
    _, net = _load_tdnn(args[1], 1, device)

    def scored():
        for key, m in SequentialTableReader(args[3], holder="mat"):
            x = torch.tensor(np.asarray(m, np.float32), device=device)
            with torch.no_grad():
                yield key, net(x[None])[0]

    align_compiled("nnet3-align-compiled", tm.tid_to_pdf_array, args[2],
                   scored(), args[4], po["acoustic-scale"], device)
    return 0
