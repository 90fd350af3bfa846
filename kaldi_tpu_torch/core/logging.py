# Copied from kaldi_tpu/core/logging.py; the loggers live under
# "kaldi_tpu_torch".
"""Logging and error handling.

Parity target: reference src/base/kaldi-error.h (KALDI_LOG / KALDI_WARN /
KALDI_ERR / KALDI_ASSERT macros, stderr logging with file:line).  We use
stdlib logging with a Kaldi-style formatter so recipe logs remain
grep-able (the reference treats text logs as *the* observability layer —
SURVEY.md §5).
"""

from __future__ import annotations

import logging
import sys
import time


class KaldiError(RuntimeError):
    """Raised where the reference would KALDI_ERR (throws std::runtime_error)."""


_FORMAT = "%(levelname)s (%(name)s:%(lineno)d) %(message)s"
_configured = False


def _configure() -> None:
    global _configured
    if _configured:
        return
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(logging.Formatter(_FORMAT))
    root = logging.getLogger("kaldi_tpu_torch")
    root.addHandler(handler)
    root.setLevel(logging.INFO)
    root.propagate = False
    _configured = True


def get_logger(name: str) -> logging.Logger:
    _configure()
    if not name.startswith("kaldi_tpu_torch"):
        name = f"kaldi_tpu_torch.{name}"
    return logging.getLogger(name)


class Timer:
    """Wall-clock timer; parity with src/base/timer.h Timer::Elapsed()."""

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self._t0 = time.perf_counter()

    def elapsed(self) -> float:
        return time.perf_counter() - self._t0
