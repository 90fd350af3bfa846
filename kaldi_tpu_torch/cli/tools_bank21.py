"""Port of kaldi_tpu/cli/tools_bank21.py decode-faster (parity target
bin/decode-faster.cc), registered in cli/tools.py's ``TOOLS``.  It takes
``--device`` (default cuda): the dense decoder's Viterbi runs there.
"""

from __future__ import annotations

import numpy as np

from kaldi_tpu_torch.cli.latgen import _load_hclg
from kaldi_tpu_torch.cli.tools import _device_po, tool
from kaldi_tpu_torch.core.logging import get_logger
from kaldi_tpu_torch.core.options import ParseOptions
from kaldi_tpu_torch.core.table import SequentialTableReader, TableWriter
from kaldi_tpu_torch.device import resolve_device

log = get_logger(__name__)


# Port of kaldi_tpu/cli/tools_bank21.py decode_faster_tool.
@tool("decode-faster")
def decode_faster_tool(argv):
    """Viterbi decoding of loglike matrices whose COLUMNS are already
    the FST's ilabels−1 (bin/decode-faster.cc — no transition model;
    contrast decode-faster-mapped which maps tid→pdf)."""
    from kaldi_tpu_torch.decoder.dense import (DenseDecoder,
                                               DenseDecoderConfig)
    from kaldi_tpu_torch.fst.fst import SymbolTable
    po = ParseOptions("decode-faster [opts] <fst> <loglikes-rspec> "
                      "<words-wspec> [<ali-wspec>]")
    po.register("beam", float, 16.0, "decoding beam")
    po.register("acoustic-scale", float, 0.1, "acoustic scale")
    po.register("word-symbol-table", str, "", "words.txt for logging")
    _device_po(po)
    args = po.read(argv)
    device = resolve_device(po["device"])
    HCLG = _load_hclg(args[0])
    # identity tid→pdf: ilabel i scores loglikes column i-1
    max_il = max((a.ilabel for arcs in HCLG.arcs for a in arcs),
                 default=1)
    ident = np.concatenate([np.zeros(1, np.int32),
                            np.arange(max_il, dtype=np.int32)])
    dec = DenseDecoder(HCLG, ident, DenseDecoderConfig(
        beam=po["beam"], acoustic_scale=po["acoustic-scale"]),
        device=device)
    words_tab = (SymbolTable.read(po["word-symbol-table"])
                 if po["word-symbol-table"] else None)
    awriter = (TableWriter(args[3], holder="ivec")
               if len(args) > 3 else None)
    n = 0
    with TableWriter(args[2], holder="text") as w:
        for key, ll in SequentialTableReader(args[1], holder="mat"):
            tids, ols, _cost = dec.decode(np.asarray(ll, np.float32))
            w[key] = [words_tab.find(o) if words_tab else str(o)
                      for o in ols]
            if awriter:
                awriter[key] = np.asarray(tids, np.int32)
            n += 1
    if awriter:
        awriter.close()
    log.info("decode-faster: decoded %d utterances", n)
    return 0
