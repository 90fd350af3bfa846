"""Port of kaldi_tpu/cli/tools_bank23.py's discriminative egs tail
(nnet3-discriminative-merge-egs, -subset-egs, -compute-from-egs; parity
targets nnet3bin/nnet3-discriminative-*.cc), registered in cli/tools.py's
``TOOLS``.  The merge and subset tools are the original's host code,
copied; -compute-from-egs takes ``--device`` (default cuda) and runs the
raw TDNN-F's forward there.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from kaldi_tpu_torch.cli.tools import _device_po, tool
from kaldi_tpu_torch.core.logging import get_logger
from kaldi_tpu_torch.core.options import ParseOptions
from kaldi_tpu_torch.core.table import SequentialTableReader, TableWriter
from kaldi_tpu_torch.device import resolve_device

log = get_logger(__name__)


# Copied from kaldi_tpu/cli/tools_bank23.py nnet3_discriminative_merge_egs_tool.
@tool("nnet3-discriminative-merge-egs")
def nnet3_discriminative_merge_egs_tool(argv):
    """Group discriminative egs into same-shape minibatches
    (nnet3bin/nnet3-discriminative-merge-egs.cc; key-renaming
    convention as nnet3-chain-merge-egs)."""
    po = ParseOptions("nnet3-discriminative-merge-egs [opts] "
                      "<egs-rspec> <egs-wspec>")
    po.register("minibatch-size", int, 8, "egs per minibatch")
    args = po.read(argv)
    B = max(1, po["minibatch-size"])
    groups: Dict[tuple, List] = {}
    for key, eg in SequentialTableReader(args[0], holder="deg"):
        groups.setdefault(eg.feats.shape, []).append(eg)
    n = mb = 0
    with TableWriter(args[1], holder="deg") as w:
        for shape in sorted(groups):
            for i in range(0, len(groups[shape]), B):
                for j, eg in enumerate(groups[shape][i:i + B]):
                    w[f"mb{mb}-{j}"] = eg
                    n += 1
                mb += 1
    log.info("nnet3-discriminative-merge-egs: %d egs → %d "
             "minibatches", n, mb)
    return 0


# Copied from kaldi_tpu/cli/tools_bank23.py nnet3_discriminative_subset_egs_tool.
@tool("nnet3-discriminative-subset-egs")
def nnet3_discriminative_subset_egs_tool(argv):
    po = ParseOptions("nnet3-discriminative-subset-egs [--n=10] "
                      "<egs-rspec> <egs-wspec>")
    po.register("n", int, 10, "keep first n")
    args = po.read(argv)
    n = 0
    with TableWriter(args[1], holder="deg") as w:
        for key, eg in SequentialTableReader(args[0], holder="deg"):
            if n >= po["n"]:
                break
            w[key] = eg
            n += 1
    log.info("nnet3-discriminative-subset-egs: kept %d", n)
    return 0


# Port of kaldi_tpu/cli/tools_bank23.py nnet3_discriminative_compute_from_egs_tool.
@tool("nnet3-discriminative-compute-from-egs")
def nnet3_discriminative_compute_from_egs_tool(argv):
    """Forward discriminative egs through a raw model and write the
    per-frame output (nnet3bin/nnet3-discriminative-compute-from-
    egs.cc)."""
    from kaldi_tpu_torch.cli.tools_bank16 import _read_raw_auto
    po = ParseOptions("nnet3-discriminative-compute-from-egs "
                      "<raw-model> <egs-rspec> <mat-wspec>")
    _device_po(po)
    args = po.read(argv)
    device = resolve_device(po["device"])
    net, _cfg = _read_raw_auto(args[0], device)
    n = 0
    with TableWriter(args[2], holder="mat") as w, torch.no_grad():
        for key, eg in SequentialTableReader(args[1], holder="deg"):
            x = torch.as_tensor(np.asarray(eg.feats, np.float32)).to(device)
            w[key] = net(x[None])[0].cpu().numpy().astype(np.float32)
            n += 1
    log.info("nnet3-discriminative-compute-from-egs: %d egs", n)
    return 0
