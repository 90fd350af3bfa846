"""Port of kaldi_tpu/cli/tools_bank7.py gmm-rescore-lattice (parity target
latbin/gmm-rescore-lattice.cc), registered in cli/tools.py's ``TOOLS``.
It takes ``--device`` (default cuda): each utterance's GMM
log-likelihoods (the GMM kernel on a card) are computed there and come
to the host once; the walk over the lattice's arcs is the original's
host code, copied.
"""

from __future__ import annotations

import numpy as np

from kaldi_tpu_torch.cli.tools import _device_po, tool
from kaldi_tpu_torch.core.logging import get_logger
from kaldi_tpu_torch.core.options import ParseOptions
from kaldi_tpu_torch.core.table import (RandomAccessTableReader,
                                        SequentialTableReader, TableWriter)
from kaldi_tpu_torch.device import resolve_device

log = get_logger(__name__)


# Port of kaldi_tpu/cli/tools_bank7.py gmm_rescore_lattice.
@tool("gmm-rescore-lattice")
def gmm_rescore_lattice(argv):
    """Replace lattice acoustic scores with a (new) GMM model's
    (latbin/gmm-rescore-lattice.cc): each arc's acoustic cost becomes
    −Σ_t log p(x_t | pdf(tid_t)) over the frames its tid string spans."""
    from kaldi_tpu_torch.am.serialize import read_mdl
    from kaldi_tpu_torch.lattice.functions import state_times
    po = ParseOptions(
        "gmm-rescore-lattice <model> <lat-rspec> <feats-rspec> "
        "<lat-wspec>")
    _device_po(po)
    args = po.read(argv)
    if len(args) != 4:
        po.print_usage()
        return 1
    tm, am = read_mdl(args[0], device=resolve_device(po["device"]))
    feats = RandomAccessTableReader(args[2], holder="mat")
    n = 0
    with TableWriter(args[3], holder="clat") as w:
        for key, clat in SequentialTableReader(args[1], holder="clat"):
            if key not in feats:
                log.warning("%s: no feats; copying unrescored", key)
                w[key] = clat
                continue
            ll = am.loglikes(np.asarray(feats[key])).cpu().numpy()
            times = state_times(clat)
            for s in range(clat.num_states):
                for a in clat.arcs[s]:
                    t0 = times[s]
                    ac = 0.0
                    for k, tid in enumerate(a.tids):
                        t = t0 + k
                        if t < ll.shape[0]:
                            pdf = tm.tid_to_pdf_array[tid]
                            ac -= float(ll[t, pdf])
                    a.acoustic_cost = ac
            for s, (g, _ac, tids) in list(clat.finals.items()):
                t0 = times[s]
                ac = 0.0
                for k, tid in enumerate(tids):
                    t = t0 + k
                    if t < ll.shape[0]:
                        ac -= float(ll[t, tm.tid_to_pdf_array[tid]])
                clat.finals[s] = (g, ac, tids)
            w[key] = clat
            n += 1
    log.info("rescored %d lattices; GMM kernel launches %d", n,
             am.device_params().launches)
    return 0
