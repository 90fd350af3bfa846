"""Command-line tools of the port (Kaldi tool names, ParseOptions), all
registered in one dispatcher: ``python -m kaldi_tpu_torch.cli <tool>``."""

from kaldi_tpu_torch.cli.tools import TOOLS, main
import kaldi_tpu_torch.cli.tools_extra  # noqa: F401  (registers into TOOLS)
import kaldi_tpu_torch.cli.tools_bank3  # noqa: F401  (registers into TOOLS)
import kaldi_tpu_torch.cli.tools_bank10  # noqa: F401  (registers into TOOLS)
import kaldi_tpu_torch.cli.tools_bank5  # noqa: F401  (registers into TOOLS)
import kaldi_tpu_torch.cli.tools_ivector  # noqa: F401  (registers into TOOLS)
import kaldi_tpu_torch.cli.tools_rnnlm  # noqa: F401  (registers into TOOLS)
import kaldi_tpu_torch.cli.tools_const_arpa  # noqa: F401  (registers into TOOLS)
import kaldi_tpu_torch.cli.tools_lattice  # noqa: F401  (registers into TOOLS)
import kaldi_tpu_torch.cli.tools_chain  # noqa: F401  (registers into TOOLS)

__all__ = ["TOOLS", "main"]
