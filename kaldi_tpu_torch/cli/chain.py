"""nnet3-chain-train and nnet3-chain-compute-prob.

Port of the two tools of kaldi_tpu/cli/tools_bank9.py (parity targets
chainbin/nnet3-chain-train.cc and nnet3-chain-compute-prob.cc), with the
original's options and positional arguments plus ``--device`` (default
cuda).  The den graph is built from the model's tree and topology and
the phone sequences (ali-to-phones output, the chain-est-phone-lm
input); the model is a binary nnet3 TDNN-F ``.raw``.

    python -m kaldi_tpu_torch.cli.chain nnet3-chain-train [opts] \\
        <trans-model> <raw-in> <phone-seqs-rspec> <egs-rspec> <raw-out>
    python -m kaldi_tpu_torch.cli.chain nnet3-chain-compute-prob [opts] \\
        <trans-model> <raw-model> <phone-seqs-rspec> <egs-rspec>

compute-prob prints the objective per frame on its last line.  On egs
that carry supervision FSAs (nnet3-chain-e2e-get-egs, lattice egs) it
scores the FSA numerator at ``--supervision-tolerance``, as training
does; the original scores those egs' all-zero pdf alignment instead.
"""

from __future__ import annotations

import sys
from typing import List

import numpy as np
import torch

from kaldi_tpu_torch.core.logging import KaldiError, get_logger
from kaldi_tpu_torch.core.options import ParseOptions
from kaldi_tpu_torch.core.table import SequentialTableReader
from kaldi_tpu_torch.device import resolve_device

log = get_logger(__name__)


def _read_phone_seqs(rspec: str) -> List[List[int]]:
    return [[int(x) for x in v]
            for _, v in SequentialTableReader(rspec, holder="ivec")]


def _load(po, args, device):
    """(den graph, TdnnConfig, state dict) from the tools' first three
    arguments."""
    from kaldi_tpu_torch.am.chain import make_denominator_graph
    from kaldi_tpu_torch.am.nnet3_io import (infer_tdnn_config,
                                             nnet3_to_state_dict,
                                             read_nnet3_path)
    from kaldi_tpu_torch.am.serialize import read_mdl
    tm, _ = read_mdl(args[0], device=device)
    den = make_denominator_graph(_read_phone_seqs(args[2]), tm.tree,
                                 tm.topo, order=po["lm-order"])
    model = read_nnet3_path(args[1])
    cfg = infer_tdnn_config(
        model, frame_subsampling_factor=po["frame-subsampling-factor"])
    return den, cfg, nnet3_to_state_dict(model, cfg)


def _common_opts(po) -> None:
    po.register("lm-order", int, 3, "den phone-LM order")
    po.register("frame-subsampling-factor", int, 3, "subsampling")
    po.register("device", str, "cuda", "torch device to run on")


def nnet3_chain_train(argv=None) -> int:
    """LF-MMI training from egs archives."""
    from kaldi_tpu_torch.am.nnet3_io import write_raw_model
    from kaldi_tpu_torch.ops.chain_den import CudaChainDen
    from kaldi_tpu_torch.pipelines.chain import ChainTrainConfig, ChainTrainer
    from kaldi_tpu_torch.pipelines.egs_io import read_egs_ark
    po = ParseOptions("nnet3-chain-train [opts] <trans-model> <raw-in> "
                      "<phone-seqs-rspec> <egs-rspec> <raw-out>")
    po.register("num-epochs", int, 2, "training epochs")
    po.register("learning-rate", float, 1e-3, "initial lr")
    po.register("supervision-tolerance", int, 1, "numerator boundary "
                "tolerance (FSA egs); >= chunk frames = e2e free "
                "boundaries")
    _common_opts(po)
    args = po.read(argv)
    if len(args) != 5:
        po.print_usage()
        return 1
    device = resolve_device(po["device"])
    den, cfg, sd = _load(po, args, device)
    tr = ChainTrainer(cfg, den, ChainTrainConfig(
        num_epochs=po["num-epochs"], learning_rate=po["learning-rate"],
        supervision_tolerance=po["supervision-tolerance"]), device=device)
    tr.model.load_state_dict(sd)
    egs = read_egs_ark(args[3])
    before = CudaChainDen.total_launches
    stats = tr.train(egs)
    write_raw_model(args[4], tr.model.state_dict(), cfg)
    log.info("nnet3-chain-train: %s", stats)
    log.info("nnet3-chain-train: den kernel launches %d",
             CudaChainDen.total_launches - before)
    return 0


def nnet3_chain_compute_prob(argv=None) -> int:
    """Chain objective diagnostics on held-out egs."""
    from kaldi_tpu_torch.am.chain import ChainTrainingOptions, chain_objf
    from kaldi_tpu_torch.am.tdnn import TdnnChain
    from kaldi_tpu_torch.pipelines.egs_io import read_egs_ark
    po = ParseOptions("nnet3-chain-compute-prob [opts] <trans-model> "
                      "<raw-model> <phone-seqs-rspec> <egs-rspec>")
    po.register("supervision-tolerance", int, 1, "numerator boundary "
                "tolerance (FSA egs), as nnet3-chain-train's")
    _common_opts(po)
    args = po.read(argv)
    if len(args) != 4:
        po.print_usage()
        return 1
    device = resolve_device(po["device"])
    den, cfg, sd = _load(po, args, device)
    net = TdnnChain(cfg)
    net.load_state_dict(sd)
    net.eval().to(device)
    egs = read_egs_ark(args[3])

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    num_fsa = None
    if egs.sup is not None:
        from kaldi_tpu_torch.am.chain_supervision import sup_to_device
        num_fsa = (sup_to_device(egs.sup, device),
                   po["supervision-tolerance"])
    with torch.no_grad():
        scores = net(dev(egs.feats.astype(np.float32)))
        loss, diag = chain_objf(den, scores, dev(egs.pdf_ali.astype(np.int64)),
                                dev(egs.mask), ChainTrainingOptions(),
                                num_fsa=num_fsa)
    log.info("nnet3-chain-compute-prob: objf %.4f (num %.4f den %.4f)",
             -float(loss), float(diag["num"]), float(diag["den"]))
    print(f"{-float(loss):.6f}")
    return 0


TOOLS = {"nnet3-chain-train": nnet3_chain_train,
         "nnet3-chain-compute-prob": nnet3_chain_compute_prob}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] not in TOOLS:
        print(f"usage: python -m kaldi_tpu_torch.cli.chain "
              f"{{{','.join(TOOLS)}}} [opts] args...", file=sys.stderr)
        return 1
    try:
        return TOOLS[argv[0]](argv[1:])
    except KaldiError as e:
        print(f"ERROR ({argv[0]}): {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
