"""gmm-init-mono.

Port of the tool of kaldi_tpu/cli/tools_bank5.py (parity target
gmmbin/gmm-init-mono.cc), registered in cli/tools.py's ``TOOLS``.  The
flat start is host numpy (``AmDiagGmm.flat_start``, ``global_stats``),
as in the original.
"""

from __future__ import annotations

import numpy as np

from kaldi_tpu_torch.cli.tools import tool
from kaldi_tpu_torch.core.logging import get_logger
from kaldi_tpu_torch.core.options import ParseOptions
from kaldi_tpu_torch.core.table import SequentialTableReader

log = get_logger(__name__)


@tool("gmm-init-mono")
def gmm_init_mono_tool(argv):
    from kaldi_tpu_torch.am.gmm import AmDiagGmm, global_stats
    from kaldi_tpu_torch.am.serialize import (read_topology, write_mdl,
                                              write_tree)
    from kaldi_tpu_torch.am.transitions import TransitionModel
    from kaldi_tpu_torch.am.tree import MonophoneContextDependency
    from kaldi_tpu_torch.core import io as kio
    po = ParseOptions("gmm-init-mono [--train-feats=rspec] "
                      "[--perturb-factor=0] <topo-in> <dim> <model-out> "
                      "<tree-out>")
    po.register("train-feats", str, "",
                "features for the global mean/var flat start")
    po.register("perturb-factor", float, 0.0, "mean perturbation")
    args = po.read(argv)
    with kio.open_rxfilename(args[0]) as f:
        kio.init_kaldi_input_stream(f)
        topo = read_topology(f)
    dim = int(args[1])
    if po["train-feats"]:
        feats = [np.asarray(m) for _, m in
                 SequentialTableReader(po["train-feats"], holder="mat")]
        gmean, gvar = global_stats(feats)
    else:
        gmean, gvar = np.zeros(dim), np.ones(dim)
    tree = MonophoneContextDependency(topo.phones, topo)
    tm = TransitionModel(topo, tree)
    am = AmDiagGmm.flat_start(tree.num_pdfs, gmean, gvar,
                              perturb=po["perturb-factor"], device="cpu")
    write_mdl(args[2], tm, am)
    with kio.open_wxfilename(args[3]) as f:
        write_tree(f, tree)
    log.info("gmm-init-mono: %d pdfs dim %d", tree.num_pdfs, dim)
    return 0
