"""Port of kaldi_tpu/cli/tools_bank6.py gmm-adapt-map (parity target
gmmbin/gmm-adapt-map.cc), registered in cli/tools.py's ``TOOLS``.  It
takes ``--device`` (default cuda): the aligned frames' statistics are
accumulated there (am/gmm.py ``accumulate_stats``), and the MAP update
is the original's host numpy (``map_update``).
"""

from __future__ import annotations

import numpy as np

from kaldi_tpu_torch.cli.tools import _device_po, tool
from kaldi_tpu_torch.core.logging import get_logger
from kaldi_tpu_torch.core.options import ParseOptions
from kaldi_tpu_torch.core.table import (RandomAccessTableReader,
                                        SequentialTableReader)
from kaldi_tpu_torch.device import resolve_device

log = get_logger(__name__)


# Port of kaldi_tpu/cli/tools_bank6.py gmm_adapt_map_tool.
@tool("gmm-adapt-map")
def gmm_adapt_map_tool(argv):
    """MAP mean adaptation of a GMM model to new data.

    Usage: gmm-adapt-map [opts] <model-in> <feats-rspec> <ali-rspec>
           <model-out>"""
    from kaldi_tpu_torch.am.gmm import GmmAccs, accumulate_stats, map_update
    from kaldi_tpu_torch.am.serialize import read_mdl, write_mdl
    po = ParseOptions(
        "gmm-adapt-map [opts] <model-in> <feats-rspec> <ali-rspec> "
        "<model-out>")
    po.register("mean-tau", float, 10.0, "prior count for means")
    po.register("weight-tau", float, 0.0, "prior count for weights "
                "(0 = no weight update)")
    po.register("var-tau", float, 0.0, "prior count for variances "
                "(0 = no variance update)")
    _device_po(po)
    args = po.read(argv)
    if len(args) != 4:
        po.print_usage()
        return 1
    tm, am = read_mdl(args[0], device=resolve_device(po["device"]))
    feats = RandomAccessTableReader(args[1], holder="mat")
    accs = GmmAccs.zeros(am.num_pdfs, am.means.shape[1],
                         am.means.shape[2])
    n = 0
    for key, tids in SequentialTableReader(args[2], holder="ivec"):
        if key not in feats:
            continue
        pdfs = tm.tid_to_pdf_array[np.asarray(tids, np.int64)]
        accumulate_stats(am, np.asarray(feats[key]), pdfs, accs)
        n += 1
    map_update(am, accs, mean_tau=po["mean-tau"],
               weight_tau=po["weight-tau"], var_tau=po["var-tau"])
    write_mdl(args[3], tm, am)
    log.info("MAP-adapted on %d utterances", n)
    return 0
