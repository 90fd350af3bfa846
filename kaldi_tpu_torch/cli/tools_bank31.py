"""Port of kaldi_tpu/cli/tools_bank31.py nnet3-latgen-incremental (parity
target nnet3bin/nnet3-latgen-incremental.cc), registered in cli/tools.py's
``TOOLS``.  It takes ``--device`` (default cuda): the raw TDNN-F scores
each utterance there, and ``OnlineBeamDecoder`` (decoder/online_beam.py)
advances over the scores there ``--chunk-frames`` at a time, its lattice
finalized at the utterance's end.
"""

from __future__ import annotations

import numpy as np
import torch

from kaldi_tpu_torch.cli.tools import _device_po, tool
from kaldi_tpu_torch.core.logging import get_logger
from kaldi_tpu_torch.core.options import ParseOptions
from kaldi_tpu_torch.core.table import SequentialTableReader, TableWriter
from kaldi_tpu_torch.device import resolve_device

log = get_logger(__name__)


def incremental_decoder(mdl: str, fst: str, po, device,
                        chunk_frames: int = 32,
                        record_capacity: int = 16384):
    """(transition model, ``OnlineBeamDecoder`` over the graph ``fst`` on
    ``device``, advancing ``chunk_frames`` at a time) from the latgen
    options in ``po`` (beam, lattice-beam, max-active, acoustic-scale):
    the set-up the original's incremental tools share."""
    from kaldi_tpu_torch.am.serialize import read_mdl
    from kaldi_tpu_torch.cli.latgen import _load_hclg
    from kaldi_tpu_torch.decoder.beam import BeamDecoder, BeamDecoderConfig
    from kaldi_tpu_torch.decoder.online_beam import OnlineBeamDecoder
    from kaldi_tpu_torch.fst.csr import pack_fst
    tm, _ = read_mdl(mdl, device="cpu")
    cap = max(po["max-active"], 512)
    dec = BeamDecoder(pack_fst(_load_hclg(fst)), tm.tid_to_pdf_array,
                      BeamDecoderConfig(
                          beam=po["beam"],
                          lattice_beam=po["lattice-beam"],
                          acoustic_scale=po["acoustic-scale"],
                          max_active=po["max-active"],
                          lattice_arcs_per_frame=max(2 * cap, 4096),
                          record_capacity=record_capacity), device=device)
    return tm, OnlineBeamDecoder(dec, chunk_frames=chunk_frames)


# Port of kaldi_tpu/cli/tools_bank31.py nnet3_latgen_incremental_tool.
@tool("nnet3-latgen-incremental")
def nnet3_latgen_incremental_tool(argv):
    """nnet3 lattice decoding with chunked advance and incrementally
    finalized lattices (nnet3bin/nnet3-latgen-incremental.cc): the
    TDNN scores the whole utterance in one forward, then the online
    beam decoder consumes --chunk-frames at a time so decoder state
    stays bounded."""
    from kaldi_tpu_torch.cli.online2 import _load_tdnn
    from kaldi_tpu_torch.fst.fst import SymbolTable
    po = ParseOptions("nnet3-latgen-incremental [opts] <trans-model> "
                      "<raw-nnet3> <fst> <feats-rspec> <lat-wspec> "
                      "[<words-wspec>]")
    po.register("beam", float, 15.0, "decoding beam")
    po.register("lattice-beam", float, 8.0, "lattice beam")
    po.register("max-active", int, 7000, "max active states")
    po.register("acoustic-scale", float, 1.0, "acoustic scale")
    po.register("frame-subsampling-factor", int, 3, "subsampling")
    po.register("chunk-frames", int, 32, "decoder frames per advance")
    po.register("word-symbol-table", str, "", "words.txt")
    _device_po(po)
    args = po.read(argv)
    device = resolve_device(po["device"])
    _tm, ob = incremental_decoder(args[0], args[2], po, device,
                                  chunk_frames=po["chunk-frames"])
    _, net = _load_tdnn(args[1], po["frame-subsampling-factor"], device)
    words_tab = (SymbolTable.read(po["word-symbol-table"])
                 if po["word-symbol-table"] else None)
    ww = TableWriter(args[5], holder="text") if len(args) > 5 else None
    C = po["chunk-frames"]
    n = 0
    with TableWriter(args[4], holder="clat") as lw, torch.no_grad():
        for key, feats in SequentialTableReader(args[3], holder="mat"):
            x = torch.as_tensor(np.asarray(feats, np.float32)).to(device)
            scores = net(x[None])[0]
            ob.reset()
            for c in range(0, len(scores), C):
                ob.advance(scores[c:c + C])
            clat = ob.finalize()
            lw[key] = clat
            wseq, _, cost = clat.best_path()
            text = [words_tab.find(w) if words_tab else str(w)
                    for w in wseq]
            if ww:
                ww[key] = text
            log.info("%s: %s (cost %.2f)", key, " ".join(text), cost)
            n += 1
    if ww:
        ww.close()
    log.info("nnet3-latgen-incremental: %d utterances", n)
    return 0
