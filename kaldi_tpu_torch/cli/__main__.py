"""``python -m kaldi_tpu_torch.cli <tool-name> [options] args...``; with
no tool or ``--help`` it lists the tools."""

import signal
import sys

# behave like a unix tool under `| head`
try:
    signal.signal(signal.SIGPIPE, signal.SIG_DFL)
except (AttributeError, ValueError):
    pass

from kaldi_tpu_torch.cli import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
