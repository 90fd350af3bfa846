# Copied from kaldi_tpu/core/options.py; imports rewritten to kaldi_tpu_torch.
"""Command-line option parsing.

Parity target: reference src/util/parse-options.h ParseOptions — every
binary registers typed options (bool/int/float/str), supports
``--config=file`` (reads more ``--name=value`` lines), ``--print-args``,
and positional arguments.  Option names keep Kaldi spelling (dashes),
e.g. ``--beam``, ``--max-active``, ``--acoustic-scale``, so recipes
translate one-to-one.

Options structs register themselves via a ``register(po, prefix="")``
method, mirroring e.g. ``MfccOptions::Register`` /
``LatticeFasterDecoderConfig::Register``.
"""

from __future__ import annotations

import shlex
import sys
from typing import Any, Dict, List, Optional, Tuple

from kaldi_tpu_torch.core.logging import KaldiError, get_logger

log = get_logger(__name__)

_TRUE = {"true", "t", "1", "yes"}
_FALSE = {"false", "f", "0", "no"}


def _parse_bool(s: str) -> bool:
    ls = s.lower()
    if ls in _TRUE:
        return True
    if ls in _FALSE:
        return False
    raise KaldiError(f"Invalid boolean option value '{s}'")


class ParseOptions:
    def __init__(self, usage: str = ""):
        self.usage = usage
        self._opts: Dict[str, Tuple[type, Any, str]] = {}
        self._values: Dict[str, Any] = {}
        self._positional: List[str] = []
        # Standard options present on every reference binary.
        self.register("config", str, "", "Configuration file with more options")
        self.register("print-args", bool, False, "Print command line arguments")
        self.register("verbose", int, 0, "Verbose level")

    def register(self, name: str, typ: type, default: Any, doc: str = "") -> None:
        name = name.replace("_", "-")
        self._opts[name] = (typ, default, doc)
        self._values[name] = default

    def register_struct(self, struct: Any, prefix: str = "") -> None:
        """Register all fields of a dataclass-like options struct.

        Field ``some_opt`` becomes ``--[prefix.]some-opt``; read() writes
        parsed values back onto the struct.
        """
        struct.__po_prefix__ = prefix
        for fname, fval in vars(struct).items():
            if fname.startswith("_") or fname.startswith("__po"):
                continue
            opt = fname.replace("_", "-")
            if prefix:
                opt = f"{prefix}.{opt}"
            self.register(opt, type(fval), fval, "")
        if not hasattr(self, "_structs"):
            self._structs: List[Any] = []
        self._structs.append(struct)

    def _set(self, name: str, raw: str) -> None:
        name = name.replace("_", "-")
        if name not in self._opts:
            raise KaldiError(f"Unknown option --{name}\n{self.usage}")
        typ = self._opts[name][0]
        if typ is bool:
            self._values[name] = _parse_bool(raw)
        else:
            try:
                self._values[name] = typ(raw)
            except ValueError as e:
                raise KaldiError(f"Bad value for --{name}: '{raw}'") from e

    def read(self, argv: Optional[List[str]] = None) -> List[str]:
        """Parse argv (excluding program name); returns positional args."""
        if argv is None:
            argv = sys.argv[1:]
        positional: List[str] = []
        seen_ddash = False
        for arg in argv:
            if seen_ddash or not arg.startswith("--"):
                positional.append(arg)
                continue
            if arg == "--":
                seen_ddash = True
                continue
            body = arg[2:]
            if "=" in body:
                name, raw = body.split("=", 1)
            else:
                name, raw = body, "true"  # bare --flag means boolean true
            self._set(name, raw)
        if self._values["config"]:
            self._read_config(self._values["config"])
        if self._values["print-args"]:
            print(" ".join(map(shlex.quote, argv)), file=sys.stderr)
        self._positional = positional
        self._writeback()
        return positional

    def _read_config(self, path: str) -> None:
        with open(path) as f:
            for line in f:
                line = line.split("#", 1)[0].strip()
                if not line:
                    continue
                if not line.startswith("--"):
                    raise KaldiError(f"Bad config line in {path}: {line}")
                body = line[2:]
                name, _, raw = body.partition("=")
                self._set(name, raw if raw else "true")

    def _writeback(self) -> None:
        for struct in getattr(self, "_structs", []):
            prefix = getattr(struct, "__po_prefix__", "")
            for fname in list(vars(struct)):
                if fname.startswith("_") or fname.startswith("__po"):
                    continue
                opt = fname.replace("_", "-")
                if prefix:
                    opt = f"{prefix}.{opt}"
                if opt in self._values:
                    setattr(struct, fname, self._values[opt])

    def __getitem__(self, name: str) -> Any:
        return self._values[name.replace("_", "-")]

    def num_args(self) -> int:
        return len(self._positional)

    def get_arg(self, i: int) -> str:
        """1-based positional access, mirroring ParseOptions::GetArg."""
        return self._positional[i - 1]

    def print_usage(self) -> None:
        print(self.usage, file=sys.stderr)
        for name, (typ, default, doc) in sorted(self._opts.items()):
            print(f"  --{name:<24} : {doc} ({typ.__name__}, default = {default})",
                  file=sys.stderr)
