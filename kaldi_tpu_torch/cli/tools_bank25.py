"""Port of the nnet2 tools of kaldi_tpu/cli/tools_bank25.py (parity
targets nnet2bin/{nnet-am-copy, nnet-compute, nnet-am-fix}.cc),
registered in cli/tools.py's ``TOOLS``: the upstream spellings
nnet-am-copy and nnet-compute (the flows of bank 19's nnet2-am-copy and
nnet2-compute; nnet-compute takes ``--device``, default cuda) and
nnet-am-fix (host numpy).  nnet-am-copy and nnet-am-fix carry the
model's ``<Priors>``, which the originals drop (ported to intent).
"""

from __future__ import annotations

import numpy as np

from kaldi_tpu_torch.cli.tools import tool
from kaldi_tpu_torch.core.logging import get_logger
from kaldi_tpu_torch.core.options import ParseOptions

log = get_logger(__name__)


# Port of kaldi_tpu/cli/tools_bank25.py nnet_am_copy_tool.
@tool("nnet-am-copy")
def nnet_am_copy_tool(argv):
    """Copy/convert an nnet2 model — the upstream nnet2bin spelling
    (nnet2bin/nnet-am-copy.cc); same flow as nnet2-am-copy."""
    from kaldi_tpu_torch.cli.tools_bank19 import nnet2_am_copy_tool
    return nnet2_am_copy_tool(argv)


# Port of kaldi_tpu/cli/tools_bank25.py nnet_compute_tool.
@tool("nnet-compute")
def nnet_compute_tool(argv):
    """Forward features through an nnet2 model — upstream spelling
    (nnet2bin/nnet-compute.cc); same flow as nnet2-compute."""
    from kaldi_tpu_torch.cli.tools_bank19 import nnet2_compute_tool
    return nnet2_compute_tool(argv)


# Port of kaldi_tpu/cli/tools_bank25.py nnet_am_fix_tool.
@tool("nnet-am-fix")
def nnet_am_fix_tool(argv):
    """Repair an nnet2 model's parameters
    (nnet2bin/nnet-am-fix.cc): replace non-finite values and clip
    magnitudes to --max-param-value; the priors are kept."""
    from kaldi_tpu_torch.am.nnet2 import load_nnet2_full, save_nnet2, \
        tree_map
    po = ParseOptions("nnet-am-fix [opts] <nnet2-in> <nnet2-out>")
    po.register("max-param-value", float, 20.0, "magnitude clip")
    args = po.read(argv)
    params, cfg, priors = load_nnet2_full(args[0])
    cap = po["max-param-value"]
    n_fixed = [0]

    def fix(a):
        a = np.asarray(a)
        bad = ~np.isfinite(a)
        n_fixed[0] += int(bad.sum())
        a = np.where(bad, 0.0, a)
        over = np.abs(a) > cap
        n_fixed[0] += int(over.sum())
        return np.clip(a, -cap, cap)

    params = tree_map(fix, params)
    save_nnet2(args[1], params, cfg, priors=priors)
    log.info("nnet-am-fix: %d values repaired/clipped", n_fixed[0])
    return 0
