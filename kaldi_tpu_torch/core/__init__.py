# Copied from kaldi_tpu/core/__init__.py; imports rewritten to kaldi_tpu_torch.
"""Core runtime: logging, option parsing, extended-filename I/O, tables.

Replaces reference layers L0 (src/base/) and L2 (src/util/):
KALDI_LOG/WARN/ERR macros, ParseOptions, kaldi-io extended filenames,
and the ark/scp SequentialTableReader / RandomAccessTableReader /
TableWriter machinery.
"""

from kaldi_tpu_torch.core.logging import get_logger, KaldiError
from kaldi_tpu_torch.core.options import ParseOptions
from kaldi_tpu_torch.core.io import open_rxfilename, open_wxfilename
from kaldi_tpu_torch.core.table import (
    SequentialTableReader,
    RandomAccessTableReader,
    TableWriter,
    read_scp,
)

__all__ = [
    "get_logger",
    "KaldiError",
    "ParseOptions",
    "open_rxfilename",
    "open_wxfilename",
    "SequentialTableReader",
    "RandomAccessTableReader",
    "TableWriter",
    "read_scp",
]
