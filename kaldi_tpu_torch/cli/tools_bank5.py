"""gmm-init-mono and the global (one-pdf) GMM tools.

Port of the tools of kaldi_tpu/cli/tools_bank5.py (parity targets
gmmbin/gmm-init-mono.cc, gmm-global-init-from-feats.cc,
gmm-global-acc-stats.cc, gmm-global-est.cc, gmm-global-get-post.cc),
registered in cli/tools.py's ``TOOLS``.  The flat start is host numpy
(``AmDiagGmm.flat_start``, ``global_stats``), as in the original.  A
global GMM is the port's ``AmDiagGmm`` with one pdf: the tools that
compute with it take ``--device`` (default cuda), where its EM
accumulation and posteriors run as tensor ops (am/gmm.py
``accumulate_stats_device``, ``component_posteriors``).  The GMM kernel
runs once, for gmm-global-init-from-feats's closing like/frame log
line, which also logs the kernel's launches.
"""

from __future__ import annotations

import numpy as np

from kaldi_tpu_torch.cli.tools import _device_po, tool
from kaldi_tpu_torch.core.logging import get_logger
from kaldi_tpu_torch.core.options import ParseOptions
from kaldi_tpu_torch.core.table import SequentialTableReader, TableWriter
from kaldi_tpu_torch.device import resolve_device

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


# Port of kaldi_tpu/cli/tools_bank5.py _write_global_gmm.
def _write_global_gmm(path: str, am) -> None:
    from kaldi_tpu_torch.am.serialize import write_am_diag_gmm
    from kaldi_tpu_torch.core import io as kio
    with kio.open_wxfilename(path) as f:
        kio.init_kaldi_output_stream(f)
        write_am_diag_gmm(f, am)


# Port of kaldi_tpu/cli/tools_bank5.py _read_global_gmm (+ device).
def _read_global_gmm(path: str, device="cuda"):
    from kaldi_tpu_torch.am.serialize import read_am_diag_gmm
    from kaldi_tpu_torch.core import io as kio
    with kio.open_rxfilename(path) as f:
        kio.init_kaldi_input_stream(f)
        return read_am_diag_gmm(f, device)


# Port of kaldi_tpu/cli/tools_bank5.py gmm_global_init_from_feats_tool.
@tool("gmm-global-init-from-feats")
def gmm_global_init_from_feats_tool(argv):
    from kaldi_tpu_torch.am.gmm import (AmDiagGmm, GmmAccs, accumulate_stats,
                                        global_stats, mixup, mle_update)
    from kaldi_tpu_torch.ops.gmm import CudaGmm
    po = ParseOptions("gmm-global-init-from-feats [--num-gauss=100] "
                      "[--num-iters=20] <feats-rspec> <gmm-out>")
    po.register("num-gauss", int, 100, "target mixture size")
    po.register("num-iters", int, 20, "EM iterations")
    _device_po(po)
    args = po.read(argv)
    if len(args) != 2:
        po.print_usage()
        return 1
    device = resolve_device(po["device"])
    feats = np.concatenate([np.asarray(m) for _, m in
                            SequentialTableReader(args[0], holder="mat")])
    gmean, gvar = global_stats([feats])
    am = AmDiagGmm.flat_start(1, gmean, gvar, device=device)
    pdf_ali = np.zeros(len(feats), np.int32)
    target = po["num-gauss"]
    for it in range(po["num-iters"]):
        # grow the mixture over the first half of the iterations
        want = min(target, 1 + (target * (it + 1) * 2)
                   // max(po["num-iters"], 1))
        if am.num_gauss() < want:
            am = mixup(am, want)
        accs = GmmAccs.zeros(am.num_pdfs, am.max_mix, am.dim)
        accumulate_stats(am, feats, pdf_ali, accs)
        mle_update(am, accs)
    _write_global_gmm(args[1], am)
    log.info("gmm-global-init-from-feats: %d gaussians on %d frames, "
             "like/frame %.4f; GMM kernel launches %d", am.num_gauss(),
             len(feats), float(am.loglikes(feats)[:, 0].mean()),
             CudaGmm.total_launches)
    return 0


# Port of kaldi_tpu/cli/tools_bank5.py gmm_global_acc_stats_tool.
@tool("gmm-global-acc-stats")
def gmm_global_acc_stats_tool(argv):
    from kaldi_tpu_torch.am.gmm import GmmAccs, accumulate_stats
    from kaldi_tpu_torch.cli.tools_extra import write_gmm_accs
    po = ParseOptions("gmm-global-acc-stats <gmm-in> <feats-rspec> "
                      "<accs-out>")
    _device_po(po)
    args = po.read(argv)
    if len(args) != 3:
        po.print_usage()
        return 1
    am = _read_global_gmm(args[0], resolve_device(po["device"]))
    accs = GmmAccs.zeros(am.num_pdfs, am.max_mix, am.dim)
    n = 0
    for key, feats in SequentialTableReader(args[1], holder="mat"):
        feats = np.asarray(feats)
        accumulate_stats(am, feats, np.zeros(len(feats), np.int32), accs)
        n += 1
    write_gmm_accs(args[2], accs)
    log.info("gmm-global-acc-stats: %d utterances", n)
    return 0


# Port of kaldi_tpu/cli/tools_bank5.py gmm_global_est_tool.
@tool("gmm-global-est")
def gmm_global_est_tool(argv):
    from kaldi_tpu_torch.am.gmm import mixup, mle_update
    from kaldi_tpu_torch.cli.tools_extra import read_gmm_accs
    po = ParseOptions("gmm-global-est [--mix-up=0] <gmm-in> <accs-in> "
                      "<gmm-out>")
    po.register("mix-up", int, 0, "grow mixture to this size after update")
    args = po.read(argv)
    if len(args) != 3:
        po.print_usage()
        return 1
    # host numpy updates, as the original: the model is read on the CPU
    am = _read_global_gmm(args[0], "cpu")
    accs = read_gmm_accs(args[1])
    mle_update(am, accs)
    if po["mix-up"] > am.num_gauss():
        am = mixup(am, po["mix-up"])
    _write_global_gmm(args[2], am)
    return 0


# Port of kaldi_tpu/cli/tools_bank5.py gmm_global_get_post_tool.
@tool("gmm-global-get-post")
def gmm_global_get_post_tool(argv):
    po = ParseOptions("gmm-global-get-post [--n=10] <gmm-in> <feats-rspec> "
                      "<post-wspec>")
    po.register("n", int, 10, "top-n gaussians per frame")
    _device_po(po)
    args = po.read(argv)
    if len(args) != 3:
        po.print_usage()
        return 1
    am = _read_global_gmm(args[0], resolve_device(po["device"]))
    topn = po["n"]
    with TableWriter(args[2], holder="post") as w:
        for key, feats in SequentialTableReader(args[1], holder="mat"):
            feats = np.asarray(feats)
            comp = am.component_posteriors(
                feats, np.zeros(len(feats), np.int32)).cpu().numpy()
            out = []
            for row in comp:
                idx = np.argsort(-row)[:topn]
                tot = float(row[idx].sum())
                out.append([(int(i), float(row[i]) / max(tot, 1e-20))
                            for i in idx])
            w[key] = out
    return 0
