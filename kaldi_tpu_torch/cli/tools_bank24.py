"""Port of kaldi_tpu/cli/tools_bank24.py make-grammar-fst (parity target
fstbin/make-grammar-fst.cc), registered in cli/tools.py's ``TOOLS``: host
code, copied (fst/grammar.py ``replace_nonterminals``).
"""

from __future__ import annotations

from kaldi_tpu_torch.cli.tools import tool
from kaldi_tpu_torch.core.logging import KaldiError, get_logger
from kaldi_tpu_torch.core.options import ParseOptions

log = get_logger(__name__)


def read_grammar(top_path: str, pairs):
    """The top graph and ``<nonterm-int> <sub>`` argument pairs (each FST
    a text or binary OpenFst file) → (top, {nonterm: sub}) as CSR graphs
    (the argument handling the original's grammar tools share)."""
    from kaldi_tpu_torch.cli.latgen import _load_hclg
    from kaldi_tpu_torch.fst.csr import pack_fst
    subs = {int(pairs[i]): pack_fst(_load_hclg(pairs[i + 1]))
            for i in range(0, len(pairs), 2)}
    return pack_fst(_load_hclg(top_path)), subs


# Port of kaldi_tpu/cli/tools_bank24.py make_grammar_fst_tool.
@tool("make-grammar-fst")
def make_grammar_fst_tool(argv):
    """Splice nonterminal sub-HCLGs into a top-level HCLG
    (fstbin/make-grammar-fst.cc).  The reference builds a GrammarFst
    expanded lazily at decode time; this implementation expands
    offline via fst/grammar.py replace_nonterminals — the decoder
    consumes the result like any HCLG (swap_sub supports runtime
    replacement through the library API)."""
    from kaldi_tpu_torch.fst.csr import csr_to_vector_fst
    from kaldi_tpu_torch.fst.grammar import replace_nonterminals
    from kaldi_tpu_torch.fst.openfst_io import write_fst_path
    po = ParseOptions("make-grammar-fst <top-hclg> <nonterm-int1> "
                      "<sub-hclg1> [<nonterm-int2> <sub-hclg2> ...] "
                      "<fst-out>")
    args = po.read(argv)
    if len(args) < 4 or len(args) % 2 != 0:
        raise KaldiError("make-grammar-fst: need top, (nonterm, sub) "
                         "pairs, out")
    top, subs = read_grammar(args[0], args[1:-1])
    expanded = replace_nonterminals(top, subs)
    write_fst_path(args[-1], csr_to_vector_fst(expanded))
    log.info("make-grammar-fst: %d nonterminals → %d states",
             len(subs), expanded.num_states)
    return 0
