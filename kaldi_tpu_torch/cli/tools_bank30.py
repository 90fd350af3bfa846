"""Port of kaldi_tpu/cli/tools_bank30.py online2-wav-nnet3-latgen-grammar
(parity target online2bin/online2-wav-nnet3-latgen-grammar.cc),
registered in cli/tools.py's ``TOOLS``: the grammar is spliced on the
host (fst/grammar.py), then the port's online2-wav-nnet3-latgen-faster
(cli/online2.py) streams on the expanded graph on ``--device`` (default
cuda: the fbank kernel, the TDNN-F and the decoder there).
"""

from __future__ import annotations

from kaldi_tpu_torch.cli.tools import _device_po, tool
from kaldi_tpu_torch.core.logging import KaldiError, get_logger
from kaldi_tpu_torch.core.options import ParseOptions
from kaldi_tpu_torch.device import resolve_device

log = get_logger(__name__)


# Port of kaldi_tpu/cli/tools_bank30.py online2_wav_nnet3_latgen_grammar_tool.
@tool("online2-wav-nnet3-latgen-grammar")
def online2_wav_nnet3_latgen_grammar_tool(argv):
    """Streaming nnet3 decode over a grammar FST
    (online2bin/online2-wav-nnet3-latgen-grammar.cc): nonterminal
    sub-HCLGs are spliced in offline, then the standard streaming
    flow runs on the expanded graph."""
    import tempfile
    from kaldi_tpu_torch.cli.online2 import online2_wav_nnet3_latgen_faster
    from kaldi_tpu_torch.cli.tools_bank24 import read_grammar
    from kaldi_tpu_torch.fst.csr import csr_to_vector_fst
    from kaldi_tpu_torch.fst.grammar import replace_nonterminals
    from kaldi_tpu_torch.fst.openfst_io import write_fst_path
    po = ParseOptions("online2-wav-nnet3-latgen-grammar [opts] "
                      "<trans-model> <raw-nnet3> <top-hclg> "
                      "<nonterm-int1> <sub-hclg1> [...] <wav-rspec> "
                      "<words-wspec>\n(passes residual options to "
                      "online2-wav-nnet3-latgen-faster)")
    po.register("beam", float, 15.0, "decoding beam")
    po.register("acoustic-scale", float, 1.0, "acoustic scale")
    po.register("frame-subsampling-factor", int, 3, "subsampling")
    po.register("num-ceps", int, 13, "MFCC cepstra")
    po.register("word-symbol-table", str, "", "words.txt")
    _device_po(po)
    args = po.read(argv)
    if len(args) < 7 or (len(args) - 5) % 2:
        raise KaldiError("online2-wav-nnet3-latgen-grammar: need "
                         "trans-model, nnet, top, (nonterm, sub)+, "
                         "wav, words")
    resolve_device(po["device"])
    top, subs = read_grammar(args[2], args[3:-2])
    expanded = csr_to_vector_fst(replace_nonterminals(top, subs))
    with tempfile.TemporaryDirectory() as td:
        fst_path = f"{td}/expanded.fst"
        write_fst_path(fst_path, expanded)
        fwd_args = [f"--beam={po['beam']}",
                    f"--acoustic-scale={po['acoustic-scale']}",
                    "--frame-subsampling-factor="
                    f"{po['frame-subsampling-factor']}",
                    f"--num-ceps={po['num-ceps']}",
                    f"--device={po['device']}"]
        if po["word-symbol-table"]:
            fwd_args.append(
                f"--word-symbol-table={po['word-symbol-table']}")
        return online2_wav_nnet3_latgen_faster(
            fwd_args + [args[0], args[1], fst_path, args[-2],
                        args[-1]])
