"""The decode tools that fan out: mapped log-likelihoods, GMM and nnet3.

Ports of four tools of the original's cli/, registered in cli/tools.py's
``TOOLS``, each with the original's options and positional arguments
plus ``--device`` (default cuda):

  * ``latgen-faster-mapped`` (tools_bank16.py; bin/latgen-faster-mapped.cc):
    lattices from log-likelihood matrices, the transition model mapping
    tids to pdfs;
  * ``latgen-faster-mapped-parallel`` (tools_bank21.py;
    bin/latgen-faster-mapped-parallel.cc);
  * ``gmm-latgen-faster-parallel`` (tools_bank17.py;
    gmmbin/gmm-latgen-faster-parallel.cc): GMM scoring (the GMM kernel on
    a card) and the decode of each utterance;
  * ``nnet3-latgen-faster-parallel`` (tools_bank23.py;
    nnet3bin/nnet3-latgen-faster-parallel.cc): the raw TDNN-F's scores,
    then the decode.

The ``-parallel`` tools are host thread pools, as in the original (the
TaskSequencer role): ``--num-threads`` threads each decode an utterance
(the device work queues on the rank's card, the host lattice build and
determinization overlap), and the lattices are written in input order.
They fan out over threads of one process; the rank-sharded decode over
processes and cards is kaldi_tpu_torch/parallel/decode.py.  Graphs up to
20,000 states decode with the dense decoder, larger ones with the beam
decoder, as every latgen tool (cli/latgen.py ``_LatgenDecoder``).  The
transition model is read from the head of any ``.mdl`` (GMM or nnet3).

    python -m kaldi_tpu_torch.cli <tool> [opts] args...
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from kaldi_tpu_torch.cli.tools import _device_po, tool
from kaldi_tpu_torch.core.logging import get_logger
from kaldi_tpu_torch.core.options import ParseOptions
from kaldi_tpu_torch.core.table import SequentialTableReader, TableWriter

log = get_logger(__name__)


def _read_trans_model(path: str):
    """The transition model at the head of a binary ``.mdl``."""
    from kaldi_tpu_torch.am.serialize import read_transition_model
    from kaldi_tpu_torch.core import io as kio
    from kaldi_tpu_torch.core.logging import KaldiError
    with kio.open_rxfilename(path) as f:
        if not kio.init_kaldi_input_stream(f):
            raise KaldiError(f"{path}: expected a binary .mdl")
        return read_transition_model(f)


def _latgen_po(usage: str, acoustic_scale: float) -> ParseOptions:
    po = ParseOptions(usage)
    po.register("beam", float, 13.0, "decoding beam")
    po.register("lattice-beam", float, 6.0, "lattice beam")
    po.register("max-active", int, 7000, "max active states")
    po.register("acoustic-scale", float, acoustic_scale, "acoustic scale")
    _device_po(po)
    return po


def _decoder(po, tm, fst_path: str):
    from kaldi_tpu_torch.cli.latgen import _LatgenDecoder, _load_hclg
    return _LatgenDecoder(_load_hclg(fst_path), tm.tid_to_pdf_array,
                          po["beam"], po["lattice-beam"],
                          po["acoustic-scale"], max_active=po["max-active"],
                          device=po["device"])


def _words_writer(po, args, n: int):
    """(words table or None, text writer or None) of the optional
    ``<words-wspec>`` at ``args[n]``."""
    from kaldi_tpu_torch.fst.fst import SymbolTable
    tab = (SymbolTable.read(po["word-symbol-table"])
           if po["word-symbol-table"] else None)
    return tab, (TableWriter(args[n], holder="text") if len(args) > n
                 else None)


@tool("latgen-faster-mapped")
def latgen_faster_mapped_tool(argv):
    """Lattice decoding from precomputed log-likelihood matrices
    (bin/latgen-faster-mapped.cc): rows are pdf log-likelihoods; the
    transition model supplies tid→pdf."""
    po = _latgen_po("latgen-faster-mapped [opts] <trans-model> <fst> "
                    "<loglikes-rspec> <lattice-wspec> [<words-wspec>]", 0.1)
    po.register("word-symbol-table", str, "", "words.txt")
    args = po.read(argv)
    if len(args) not in (4, 5):
        po.print_usage()
        return 1
    dec = _decoder(po, _read_trans_model(args[0]), args[1])
    words_tab, wwriter = _words_writer(po, args, 4)
    n = 0
    with TableWriter(args[3], holder="clat") as lw:
        for key, ll in SequentialTableReader(args[2], holder="mat"):
            clat = dec.decode_to_clat(np.asarray(ll, np.float32))
            lw[key] = clat
            if wwriter:
                wseq = clat.best_path()[0]
                wwriter[key] = [words_tab.find(w) if words_tab else str(w)
                                for w in wseq]
            n += 1
    if wwriter:
        wwriter.close()
    log.info("latgen-faster-mapped: decoded %d utterances", n)
    return 0


@tool("latgen-faster-mapped-parallel")
def latgen_faster_mapped_parallel_tool(argv):
    """latgen-faster-mapped over a host thread pool
    (bin/latgen-faster-mapped-parallel.cc, the TaskSequencer role):
    ``--num-threads`` utterances decode at once, lattices written in
    input order.  The sharded decode over processes is
    parallel/decode.py."""
    po = _latgen_po("latgen-faster-mapped-parallel [opts] <trans-model> "
                    "<fst> <loglikes-rspec> <lattice-wspec>", 0.1)
    po.register("num-threads", int, 4, "worker threads")
    args = po.read(argv)
    if len(args) != 4:
        po.print_usage()
        return 1
    dec = _decoder(po, _read_trans_model(args[0]), args[1])
    n = 0
    with TableWriter(args[3], holder="clat") as lw, \
            ThreadPoolExecutor(max_workers=max(1, po["num-threads"])) \
            as pool:
        pend = [(key, pool.submit(dec.decode_to_clat,
                                  np.asarray(ll, np.float32)))
                for key, ll in SequentialTableReader(args[2], holder="mat")]
        for key, fut in pend:
            lw[key] = fut.result()
            n += 1
    log.info("latgen-faster-mapped-parallel: %d utterances (%d threads)",
             n, po["num-threads"])
    return 0


@tool("gmm-latgen-faster-parallel")
def gmm_latgen_faster_parallel_tool(argv):
    """gmm-latgen-faster over a host thread pool
    (gmmbin/gmm-latgen-faster-parallel.cc, the TaskSequencer role): each
    thread scores an utterance with the GMM (the GMM kernel on a card)
    and decodes it; lattices written in input order.  The sharded decode
    over processes is parallel/decode.py."""
    from kaldi_tpu_torch.am.serialize import read_mdl
    po = _latgen_po("gmm-latgen-faster-parallel [opts] <model> <fst> "
                    "<feats-rspec> <lattice-wspec>", 0.1)
    po.register("num-threads", int, 4, "host worker threads")
    args = po.read(argv)
    if len(args) != 4:
        po.print_usage()
        return 1
    tm, am = read_mdl(args[0], device=po["device"])
    dec = _decoder(po, tm, args[1])

    def one(item):
        key, feats = item
        return key, dec.decode_to_clat(am.loglikes(feats))

    entries = list(SequentialTableReader(args[2], holder="mat"))
    with ThreadPoolExecutor(max_workers=max(1, po["num-threads"])) as pool:
        results = list(pool.map(one, entries))
    with TableWriter(args[3], holder="clat") as w:
        for key, clat in results:
            w[key] = clat
    log.info("gmm-latgen-faster-parallel: %d utterances on %d threads",
             len(results), po["num-threads"])
    return 0


@tool("nnet3-latgen-faster-parallel")
def nnet3_latgen_faster_parallel_tool(argv):
    """nnet3 lattice decoding over a host thread pool
    (nnet3bin/nnet3-latgen-faster-parallel.cc): the raw TDNN-F scores each
    utterance on ``--device`` in turn, and a pool of ``--num-threads``
    threads decodes the scores; lattices written in input order.  The
    sharded decode over processes is parallel/decode.py."""
    from kaldi_tpu_torch.cli.online2 import _load_tdnn
    from kaldi_tpu_torch.device import resolve_device
    po = _latgen_po("nnet3-latgen-faster-parallel [opts] <trans-model-mdl> "
                    "<raw-model> <fst> <feats-rspec> <lattice-wspec>", 1.0)
    po.register("frame-subsampling-factor", int, 3, "subsampling")
    po.register("num-threads", int, 4, "worker threads")
    args = po.read(argv)
    if len(args) != 5:
        po.print_usage()
        return 1
    tm = _read_trans_model(args[0])
    device = resolve_device(po["device"])
    _, net = _load_tdnn(args[1], po["frame-subsampling-factor"], device)
    dec = _decoder(po, tm, args[2])
    n = 0
    with TableWriter(args[4], holder="clat") as w, \
            ThreadPoolExecutor(max_workers=max(1, po["num-threads"])) \
            as pool:
        pend = []
        for key, feats in SequentialTableReader(args[3], holder="mat"):
            x = torch.from_numpy(np.asarray(feats, np.float32)).to(device)
            with torch.no_grad():
                scores = net(x[None])[0]
            pend.append((key, pool.submit(dec.decode_to_clat, scores)))
        for key, fut in pend:
            w[key] = fut.result()
            n += 1
    log.info("nnet3-latgen-faster-parallel: %d utterances (%d threads)",
             n, po["num-threads"])
    return 0
