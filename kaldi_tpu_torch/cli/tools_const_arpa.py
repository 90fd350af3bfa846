"""The const-ARPA tools (lmbin/arpa-to-const-arpa, const-arpa-to-arpa).

Port of ``arpa-to-const-arpa`` and ``read_const_arpa``
(kaldi_tpu/cli/tools_bank18.py) and ``const-arpa-to-arpa``
(tools_bank21.py), host code copied, registered in cli/tools.py's
``TOOLS``.  The file is the original's: ``<ConstArpaLm>``, the word
count and the words as tokens, then each order's word ids, log-probs and
back-offs as an am/serialize.py ``write_pytree`` (float32), then
``</ConstArpaLm>``.  ``lattice-lmrescore-const-arpa`` (tools_bank3.py)
reads such a file through ``read_const_arpa``.
"""

from __future__ import annotations

import math

import numpy as np

from kaldi_tpu_torch.cli.tools import tool
from kaldi_tpu_torch.core.logging import get_logger
from kaldi_tpu_torch.core.options import ParseOptions

log = get_logger(__name__)

CONST_ARPA_HEAD = b"\0B<ConstArpaLm> "


# Port of kaldi_tpu/cli/tools_bank18.py arpa_to_const_arpa_tool (copied).
@tool("arpa-to-const-arpa")
def arpa_to_const_arpa_tool(argv):
    """Compile an ARPA file into the binary const-LM trie used for
    fast lattice rescoring (lmbin/arpa-to-const-arpa.cc)."""
    from kaldi_tpu_torch.am.serialize import write_pytree
    from kaldi_tpu_torch.core import io as kio
    from kaldi_tpu_torch.fst.arpa import ArpaModel
    po = ParseOptions("arpa-to-const-arpa <arpa-in> <const-arpa-out>")
    args = po.read(argv)
    with kio.open_rxfilename(args[0]) as f:
        text = f.read().decode("utf-8", errors="replace")
    arpa = ArpaModel.parse(text)
    # vocabulary: every word string, id = position (strings ride as a
    # separate token list; pytree carries only arrays)
    vocab = sorted({w for table in arpa.ngrams for ctx in table
                    for w in ctx})
    wid = {w: i for i, w in enumerate(vocab)}
    ngrams = {}
    for order, table in enumerate(arpa.ngrams, start=1):
        ws, lps, bows = [], [], []
        for ctx, (lp, bow) in sorted(table.items()):
            ws.append([wid[w] for w in ctx])
            lps.append(lp)
            bows.append(bow)
        ngrams[f"order{order}"] = {
            "words": (np.asarray(ws, np.int64).reshape(len(ws), order)
                      if ws else np.zeros((0, order), np.int64)),
            "logprob": np.asarray(lps, np.float64),
            "backoff": np.asarray(bows, np.float64)}
    with kio.open_wxfilename(args[1]) as f:
        kio.init_kaldi_output_stream(f)
        kio.write_token(f, "<ConstArpaLm>")
        kio.write_basic_int32(f, len(vocab))
        for w in vocab:
            kio.write_token(f, f"<{w}>")
        write_pytree(f, ngrams)
        kio.write_token(f, "</ConstArpaLm>")
    log.info("arpa-to-const-arpa: %d orders, %d 1-grams, %d words",
             len(arpa.ngrams), len(arpa.ngrams[0]), len(vocab))
    return 0


# Copied from kaldi_tpu/cli/tools_bank18.py read_const_arpa.
def read_const_arpa(path: str):
    """→ ArpaModel (the trie scorer used by
    lattice-lmrescore-const-arpa)."""
    from kaldi_tpu_torch.am.serialize import read_pytree
    from kaldi_tpu_torch.core import io as kio
    from kaldi_tpu_torch.fst.arpa import ArpaModel
    with kio.open_rxfilename(path) as f:
        kio.init_kaldi_input_stream(f)
        kio.expect_token(f, "<ConstArpaLm>")
        nv = kio.read_basic_int32(f)
        vocab = [kio.read_token(f)[1:-1] for _ in range(nv)]
        d = read_pytree(f)
        kio.expect_token(f, "</ConstArpaLm>")
    arpa = ArpaModel()
    for order in range(1, len(d) + 1):
        t = d[f"order{order}"]
        table = {}
        for row, lp, bow in zip(t["words"], t["logprob"],
                                t["backoff"]):
            table[tuple(vocab[int(x)] for x in row)] = (float(lp),
                                                        float(bow))
        arpa.ngrams.append(table)
    return arpa


def is_const_arpa(path: str) -> bool:
    """Whether the file at ``path`` is an arpa-to-const-arpa file (its
    binary header and first token), not ARPA text."""
    with open(path, "rb") as f:
        return f.read(len(CONST_ARPA_HEAD)) == CONST_ARPA_HEAD


# Port of kaldi_tpu/cli/tools_bank21.py const_arpa_to_arpa_tool (copied).
@tool("const-arpa-to-arpa")
def const_arpa_to_arpa_tool(argv):
    """Write a const-LM back out as ARPA text — the inverse of
    arpa-to-const-arpa (round-trip check for the binary trie; the
    reference pairs const-arpa-lm.h with ArpaFileParser the same
    way)."""
    from kaldi_tpu_torch.core import io as kio
    po = ParseOptions("const-arpa-to-arpa <const-arpa-in> "
                      "<arpa-out>")
    args = po.read(argv)
    arpa = read_const_arpa(args[0])
    ln10 = math.log(10.0)
    lines = ["\\data\\"]
    for order, table in enumerate(arpa.ngrams, start=1):
        lines.append(f"ngram {order}={len(table)}")
    for order, table in enumerate(arpa.ngrams, start=1):
        lines.append("")
        lines.append(f"\\{order}-grams:")
        for ctx in sorted(table):
            lp, bow = table[ctx]
            row = f"{lp / ln10:.6f}\t{' '.join(ctx)}"
            if bow != 0.0:
                row += f"\t{bow / ln10:.6f}"
            lines.append(row)
    lines += ["", "\\end\\", ""]
    with kio.open_wxfilename(args[1]) as f:
        f.write("\n".join(lines).encode())
    log.info("const-arpa-to-arpa: %d orders", arpa.order)
    return 0
