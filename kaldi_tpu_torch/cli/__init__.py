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
import kaldi_tpu_torch.cli.tools_nnet  # noqa: F401  (registers into TOOLS)
import kaldi_tpu_torch.cli.tools_parallel  # noqa: F401  (registers into TOOLS)
import kaldi_tpu_torch.cli.tools_bank6  # noqa: F401  (registers into TOOLS)
import kaldi_tpu_torch.cli.tools_bank9  # noqa: F401  (registers into TOOLS)
import kaldi_tpu_torch.cli.tools_bank12  # noqa: F401  (registers into TOOLS)
import kaldi_tpu_torch.cli.tools_bank13  # noqa: F401  (registers into TOOLS)
import kaldi_tpu_torch.cli.tools_bank22  # noqa: F401  (registers into TOOLS)
import kaldi_tpu_torch.cli.tools_bank4  # noqa: F401  (registers into TOOLS)
import kaldi_tpu_torch.cli.tools_bank16  # noqa: F401  (registers into TOOLS)
import kaldi_tpu_torch.cli.tools_bank17  # noqa: F401  (registers into TOOLS)
import kaldi_tpu_torch.cli.tools_bank21  # noqa: F401  (registers into TOOLS)
import kaldi_tpu_torch.cli.tools_bank23  # noqa: F401  (registers into TOOLS)
import kaldi_tpu_torch.cli.tools_bank24  # noqa: F401  (registers into TOOLS)
import kaldi_tpu_torch.cli.tools_bank27  # noqa: F401  (registers into TOOLS)
import kaldi_tpu_torch.cli.tools_bank28  # noqa: F401  (registers into TOOLS)
import kaldi_tpu_torch.cli.tools_bank29  # noqa: F401  (registers into TOOLS)
import kaldi_tpu_torch.cli.tools_bank30  # noqa: F401  (registers into TOOLS)

__all__ = ["TOOLS", "main"]
