"""Port of kaldi_tpu/cli/tools_bank18.py nnet3-compute-from-egs (parity
target nnet3bin/nnet3-compute-from-egs.cc), registered in
cli/tools.py's ``TOOLS``.  It takes ``--device`` (default cuda): the raw
TDNN-F's forward runs there.

Ported to intent, not as it is: the original writes ``out[0]``, the
first sequence of each eg, so a merged eg of B > 1 sequences loses all
but its first; Kaldi writes the whole output.  This tool writes an eg's
B sequences' T frames as one (B·T, P) matrix, sequence after sequence
(for B = 1, the original's matrix).
"""

from __future__ import annotations

import numpy as np
import torch

from kaldi_tpu_torch.cli.tools import _device_po, tool
from kaldi_tpu_torch.cli.tools_bank16 import _read_raw_auto
from kaldi_tpu_torch.core.logging import get_logger
from kaldi_tpu_torch.core.options import ParseOptions
from kaldi_tpu_torch.core.table import SequentialTableReader, TableWriter
from kaldi_tpu_torch.device import resolve_device

log = get_logger(__name__)


# Port of kaldi_tpu/cli/tools_bank18.py nnet3_compute_from_egs_tool.
@tool("nnet3-compute-from-egs")
def nnet3_compute_from_egs_tool(argv):
    """Forward xent egs through a raw model on ``--device``, writing
    each eg's (B·T, P) log-softmax (or softmax) outputs
    (nnet3bin/nnet3-compute-from-egs.cc)."""
    po = ParseOptions("nnet3-compute-from-egs [--apply-exp=false] "
                      "<raw-in> <egs-rspec> <mat-wspec>")
    po.register("apply-exp", bool, False, "write softmax probs")
    _device_po(po)
    args = po.read(argv)
    device = resolve_device(po["device"])
    net, _cfg = _read_raw_auto(args[0], device)
    n = 0
    with TableWriter(args[2], holder="mat") as w, torch.no_grad():
        for key, eg in SequentialTableReader(args[1], holder="xeg"):
            x = torch.tensor(np.asarray(eg.feats, np.float32), device=device)
            out = torch.log_softmax(net(x), dim=-1)
            if po["apply-exp"]:
                out = torch.exp(out)
            w[key] = out.reshape(-1, out.shape[-1]).cpu().numpy()
            n += 1
    log.info("nnet3-compute-from-egs: %d egs", n)
    return 0
