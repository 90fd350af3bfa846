"""Port of kaldi_tpu/cli/tools_bank22.py gmm-acc-stats-twofeats (parity
target gmmbin/gmm-acc-stats-twofeats.cc, the SAT alignment-model stage of
steps/train_sat.sh), registered in cli/tools.py's ``TOOLS``.  It takes
``--device`` (default cuda): the mixture posteriors on the first feature
stream run there (am/gmm.py ``accumulate_stats_twofeats``), the
statistics on the second are summed on the host, as in the original.
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


# Port of kaldi_tpu/cli/tools_bank22.py gmm_acc_stats_twofeats_tool.
@tool("gmm-acc-stats-twofeats")
def gmm_acc_stats_twofeats_tool(argv):
    """Posteriors on one feature stream, stats on another
    (gmmbin/gmm-acc-stats-twofeats.cc — the SAT alimdl stage of
    steps/train_sat.sh)."""
    from kaldi_tpu_torch.am.gmm import GmmAccs, accumulate_stats_twofeats
    from kaldi_tpu_torch.am.serialize import read_mdl
    from kaldi_tpu_torch.cli.tools_extra import write_gmm_accs
    po = ParseOptions("gmm-acc-stats-twofeats <model> <feats1-rspec> "
                      "<feats2-rspec> <ali-rspec> <accs-out>")
    _device_po(po)
    args = po.read(argv)
    if len(args) != 5:
        po.print_usage()
        return 1
    tm, am = read_mdl(args[0], device=resolve_device(po["device"]))
    f2 = RandomAccessTableReader(args[2], holder="mat")
    ali_r = RandomAccessTableReader(args[3], holder="ivec")
    accs = GmmAccs.zeros(am.num_pdfs, am.max_mix, am.dim)
    n = 0
    for key, feats in SequentialTableReader(args[1], holder="mat"):
        if key not in f2 or key not in ali_r:
            continue
        tids = np.asarray(ali_r[key], np.int64)
        pdf_ali = tm.tid_to_pdf_array[tids]
        accumulate_stats_twofeats(am, np.asarray(feats, np.float32),
                                  np.asarray(f2[key], np.float32),
                                  pdf_ali, accs)
        n += 1
    write_gmm_accs(args[4], accs)
    log.info("gmm-acc-stats-twofeats: %d utterances", n)
    return 0
