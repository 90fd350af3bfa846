"""Port of kaldi_tpu/cli/tools_bank4.py kws-search (parity target
kwsbin/kws-search.cc), registered in cli/tools.py's ``TOOLS``: host code,
copied (kws.py's ``LatticeIndex`` or the direct per-lattice search).
"""

from __future__ import annotations

from kaldi_tpu_torch.cli.tools import tool
from kaldi_tpu_torch.core.options import ParseOptions
from kaldi_tpu_torch.core.table import SequentialTableReader, TableWriter


# Copied from kaldi_tpu/cli/tools_bank4.py kws_search_tool.
@tool("kws-search")
def kws_search_tool(argv):
    from kaldi_tpu_torch.kws import LatticeIndex, keyword_search
    po = ParseOptions(
        "kws-search [opts] <lattice-rspec> <keywords-file> <hits-wspec>\n"
        "keywords-file lines: <kw-id> <word-int> [<word-int> ...];\n"
        "hit lines: <utt> <t-begin> <t-end> <posterior>.")
    po.register("min-posterior", float, 0.01, "drop weaker hits")
    po.register("acoustic-scale", float, 1.0, "acoustic scale")
    po.register("use-index", bool, True,
                "build the inverted index (factor-transducer role) "
                "instead of per-lattice search")
    args = po.read(argv)
    keywords = {}
    with open(args[1]) as f:
        for line in f:
            parts = line.split()
            if parts:
                keywords[parts[0]] = [int(x) for x in parts[1:]]
    lattices = {k: v for k, v in
                SequentialTableReader(args[0], holder="clat")}
    if po["use-index"]:
        index = LatticeIndex.build(lattices,
                                   acoustic_scale=po["acoustic-scale"])
        results = {kw: index.search(seq, po["min-posterior"])
                   for kw, seq in keywords.items()}
    else:
        results = keyword_search(lattices, keywords, po["min-posterior"],
                                 po["acoustic-scale"])
    with TableWriter(args[2], holder="text") as w:
        for kw in sorted(results):
            for i, h in enumerate(results[kw]):
                w[f"{kw}-{i + 1}"] = [h.utt, str(h.begin_frame),
                                      str(h.end_frame),
                                      f"{h.posterior:.4f}"]
    return 0
