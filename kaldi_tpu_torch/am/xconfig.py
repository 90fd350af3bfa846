# Port of kaldi_tpu/am/xconfig.py (the parser copied, the model in torch.nn).
"""xconfig: the nnet3 network-configuration language.

Port of kaldi_tpu/am/xconfig.py (parity target:
egs/wsj/s5/steps/nnet3/xconfig_to_configs.py and
steps/libs/nnet3/xconfig/): the parser (``XLine``,
``_parse_descriptor``, ``parse_xconfig``, ``_parse_stats_config``) is
the original's host code, and ``XconfigModel`` interprets the parsed
lines as a ``torch.nn`` network, reusing the port's layers
(``TdnnFLayer``, ``RestrictedAttentionLayer``, ``LstmpLayer``,
``ConvReluBatchnormLayer``).  flax infers each layer's input width at
``init``; here every width is resolved from the lines and their
descriptors when the model is built.  Each layer is a child module named
as the line, with flax's submodule names under it (``tdnn1.affine``,
``tdnnf2.linear``, ``lstm1.cell.ii``, ``cnn1.conv``), so
``am/tdnn.py``'s ``state_dict_from_flax`` carries the original's
variables across; a layer name that holds a dot or that torch's
``nn.Module`` uses for itself is refused.

The conventions are the original's: each ``output-layer`` takes
``h[:, ::k]`` of its input (k the frame-subsampling factor) and starts
from a zero kernel; the ``stats-layer`` is a moving window of mean (and
stddev) over [t + left, t + right] clamped to the utterance, by cumulative
sums; descriptors splice with edge clamping; the parser ignores options
it does not know, as the original does.  There is no dtype: xconfig
models compute in float32.

Supported grammar (one layer per line, ``#`` comments):
    input name=<n> dim=<d>
    relu-batchnorm-layer name=<n> [input=<desc>] dim=<d>
    relu-renorm-layer        (renorm ≈ batchnorm here, noted)
    tdnnf-layer name=<n> dim=<d> bottleneck-dim=<b> time-stride=<s>
                [dropout-proportion=<p>] [bypass-scale=<f>]
    fast-lstmp-layer name=<n> cell-dim=<c> recurrent-projection-dim=<p>
    attention-relu-batchnorm-layer name=<n> dim=<d> num-heads=<h>
                num-left-inputs=<l> num-right-inputs=<r>
    stats-layer name=<n> config=mean+stddev(<l>:<.>:<.>:<r>)
    conv-relu-batchnorm-layer name=<n> height-in=<h> num-filters-out=<f>
                [time-offsets=-1,0,1] [height-offsets=-1,0,1]
                [height-subsample-out=<s>]
    output-layer name=<n> [input=<desc>] dim=<d>
                [include-log-softmax=true|false]
Descriptors: layer name | integer offset of the default input |
    Offset(<name>, <k>) | Append(<item>, ...) of the above.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from kaldi_tpu_torch.am.cnn import ConvReluBatchnormLayer
from kaldi_tpu_torch.am.lstm import LstmpLayer
from kaldi_tpu_torch.am.tdnn import (BatchNorm, RestrictedAttentionLayer,
                                     TdnnFLayer, splice)
from kaldi_tpu_torch.core.logging import KaldiError, get_logger

log = get_logger(__name__)

LAYER_TYPES = (
    "input", "relu-batchnorm-layer", "relu-renorm-layer", "tdnnf-layer",
    "fast-lstmp-layer", "attention-relu-batchnorm-layer", "stats-layer",
    "conv-relu-batchnorm-layer", "output-layer", "no-op-component",
)


def _parse_offsets(s: str) -> Tuple[int, ...]:
    return tuple(int(t) for t in s.split(","))


# Copied from kaldi_tpu/am/xconfig.py XLine.
@dataclasses.dataclass(frozen=True)
class XLine:
    """One parsed xconfig line."""
    layer_type: str
    name: str
    # descriptor: tuple of (referenced layer name | "" = default, offset)
    inputs: Tuple[Tuple[str, int], ...]
    opts: Tuple[Tuple[str, str], ...]

    def opt(self, key: str, default=None) -> Optional[str]:
        for k, v in self.opts:
            if k == key:
                return v
        return default

    def opt_int(self, key: str, default: int = 0) -> int:
        v = self.opt(key)
        return int(v) if v is not None else default

    def opt_float(self, key: str, default: float = 0.0) -> float:
        v = self.opt(key)
        return float(v) if v is not None else default


# Copied from kaldi_tpu/am/xconfig.py _parse_descriptor.
def _parse_descriptor(desc: str) -> Tuple[Tuple[str, int], ...]:
    """'Append(-1,0,1)' / 'Offset(tdnn1,-3)' / 'tdnn1' / '-1' →
    ((ref, offset), ...); ref '' means the previous layer."""
    desc = desc.strip()
    m = re.fullmatch(r"Append\((.*)\)", desc)
    if m:
        # split top-level commas (Offset(x,-1) has its own comma)
        parts, depth, cur = [], 0, ""
        for ch in m.group(1):
            if ch == "(":
                depth += 1
            elif ch == ")":
                depth -= 1
            if ch == "," and depth == 0:
                parts.append(cur)
                cur = ""
            else:
                cur += ch
        if cur.strip():
            parts.append(cur)
        out: List[Tuple[str, int]] = []
        for p in parts:
            out.extend(_parse_descriptor(p))
        return tuple(out)
    m = re.fullmatch(r"Offset\(([^,]+),\s*(-?\d+)\)", desc)
    if m:
        return ((m.group(1).strip(), int(m.group(2))),)
    if re.fullmatch(r"-?\d+", desc):
        return (("", int(desc)),)
    if not re.fullmatch(r"[A-Za-z_][\w.\-]*", desc):
        raise KaldiError(f"xconfig: cannot parse descriptor '{desc}'")
    return ((desc, 0),)


# Copied from kaldi_tpu/am/xconfig.py parse_xconfig.
def parse_xconfig(text: str) -> Tuple[XLine, ...]:
    """Parse xconfig text into a validated line tuple."""
    lines: List[XLine] = []
    names = set()
    for raw in text.splitlines():
        raw = raw.split("#", 1)[0].strip()
        if not raw:
            continue
        toks = raw.split()
        ltype = toks[0]
        if ltype not in LAYER_TYPES:
            raise KaldiError(f"xconfig: unknown layer type '{ltype}'")
        opts: List[Tuple[str, str]] = []
        name = None
        inputs: Tuple[Tuple[str, int], ...] = (("", 0),)
        for tok in toks[1:]:
            if "=" not in tok:
                raise KaldiError(f"xconfig: bad token '{tok}' in: {raw}")
            k, v = tok.split("=", 1)
            if k == "name":
                name = v
            elif k == "input":
                inputs = _parse_descriptor(v)
            else:
                opts.append((k, v))
        if name is None:
            raise KaldiError(f"xconfig: line missing name=: {raw}")
        if name in names:
            raise KaldiError(f"xconfig: duplicate layer name '{name}'")
        for ref, _ in inputs:
            if ref and ref not in names:
                raise KaldiError(
                    f"xconfig: '{name}' references undefined '{ref}'")
        names.add(name)
        lines.append(XLine(ltype, name, inputs, tuple(opts)))
    if not lines or lines[0].layer_type != "input":
        raise KaldiError("xconfig: first line must be `input name=.. "
                         "dim=..`")
    if not any(l.layer_type == "output-layer" for l in lines):
        raise KaldiError("xconfig: no output-layer")
    return tuple(lines)


# Copied from kaldi_tpu/am/xconfig.py _parse_stats_config.
def _parse_stats_config(cfg: str) -> Tuple[int, int, bool]:
    """'mean+stddev(-99:3:9:99)' → (left, right, include_stddev)."""
    m = re.fullmatch(r"(mean|mean\+stddev)\((-?\d+):\d+:\d+:(-?\d+)\)",
                     cfg)
    if not m:
        raise KaldiError(f"xconfig: bad stats-layer config '{cfg}'")
    return int(m.group(2)), int(m.group(3)), m.group(1) == "mean+stddev"


class _ReluBatchnorm(nn.Module):
    """relu-batchnorm-layer: affine → ReLU → batch norm."""

    def __init__(self, in_dim: int, dim: int):
        super().__init__()
        self.affine = nn.Linear(in_dim, dim)
        self.batchnorm = BatchNorm(dim)

    def forward(self, x):
        return self.batchnorm(torch.relu(self.affine(x)))


class _Output(nn.Module):
    """output-layer: a zero-initialised affine (the reference's
    param-stddev=0), then log-softmax unless include-log-softmax=false."""

    def __init__(self, in_dim: int, dim: int, log_softmax: bool):
        super().__init__()
        self.affine = nn.Linear(in_dim, dim)
        self.affine.zero_init = True
        self.log_softmax = log_softmax

    def forward(self, x):
        h = self.affine(x)
        return torch.log_softmax(h, dim=-1) if self.log_softmax else h


def stats_window(h: torch.Tensor, left: int, right: int,
                 stddev: bool) -> torch.Tensor:
    """Mean (and stddev, variance floored at 1e-6) of h over [t + left,
    t + right] clamped to [0, T − 1], by cumulative sums."""
    T = h.shape[1]
    csum = torch.cumsum(h, dim=1)
    idx = torch.arange(T, device=h.device)
    lo = torch.clamp(idx + left, 0, T - 1)
    hi = torch.clamp(idx + right, 0, T - 1)
    n = (hi - lo + 1).to(h.dtype)[None, :, None]
    before = (lo > 0)[None, :, None]
    below = torch.clamp(lo - 1, min=0)

    def take(c):
        return c[:, hi] - torch.where(before, c[:, below],
                                      torch.zeros_like(c[:, below]))

    mean = take(csum) / n
    if not stddev:
        return mean
    var = torch.clamp(take(torch.cumsum(h * h, dim=1)) / n - mean ** 2,
                      min=1e-6)
    return torch.cat([mean, torch.sqrt(var)], dim=-1)


def layer_widths(lines: Tuple[XLine, ...]) -> Dict[str, int]:
    """Each line's output width, its input width resolved from its
    descriptor (the sum of the widths it appends)."""
    return {line.name: out for line, _, out, _ in _resolved(lines)}


def _resolved(lines):
    """(line, input width, output width, default input's name) of each
    line; the default input is the last line before it that is not an
    output layer."""
    dims: Dict[str, int] = {}
    prev = None
    for line in lines:
        if line.layer_type == "input":
            in_dim = line.opt_int("dim")
        else:
            in_dim = sum(dims[ref or prev] for ref, _ in line.inputs)
        dims[line.name] = _out_width(line, in_dim)
        yield line, in_dim, dims[line.name], prev
        if line.layer_type != "output-layer":
            prev = line.name


def _out_width(line: XLine, in_dim: int) -> int:
    lt = line.layer_type
    if lt == "input":
        return in_dim
    if lt in ("relu-batchnorm-layer", "relu-renorm-layer", "tdnnf-layer",
              "attention-relu-batchnorm-layer", "output-layer"):
        return line.opt_int("dim")
    if lt == "fast-lstmp-layer":
        return line.opt_int("recurrent-projection-dim",
                            max(line.opt_int("cell-dim") // 2, 1))
    if lt == "stats-layer":
        stddev = _parse_stats_config(
            line.opt("config", "mean+stddev(-99:3:9:99)"))[2]
        return in_dim * (2 if stddev else 1)
    if lt == "conv-relu-batchnorm-layer":
        sub = line.opt_int("height-subsample-out", 1)
        return ((line.opt_int("height-in") - 1) // sub + 1) * \
            line.opt_int("num-filters-out")
    return in_dim                               # no-op-component


def _layer(line: XLine, in_dim: int) -> Optional[nn.Module]:
    """The module of one line (None: a line without parameters)."""
    lt = line.layer_type
    if lt in ("relu-batchnorm-layer", "relu-renorm-layer"):
        return _ReluBatchnorm(in_dim, line.opt_int("dim"))
    if lt == "tdnnf-layer":
        dim = line.opt_int("dim")
        return TdnnFLayer(in_dim, dim,
                          line.opt_int("bottleneck-dim", max(dim // 4, 1)),
                          time_stride=line.opt_int("time-stride", 1),
                          bypass_scale=line.opt_float("bypass-scale", 0.66),
                          dropout=line.opt_float("dropout-proportion", 0.0))
    if lt == "fast-lstmp-layer":
        cell = line.opt_int("cell-dim")
        return LstmpLayer(in_dim, cell, _out_width(line, in_dim))
    if lt == "attention-relu-batchnorm-layer":
        return RestrictedAttentionLayer(
            in_dim, line.opt_int("dim"),
            num_heads=line.opt_int("num-heads", 4),
            left_ctx=line.opt_int("num-left-inputs", 9),
            right_ctx=line.opt_int("num-right-inputs", 9))
    if lt == "conv-relu-batchnorm-layer":
        return ConvReluBatchnormLayer(
            line.opt_int("height-in"), in_dim,
            line.opt_int("num-filters-out"),
            _parse_offsets(line.opt("time-offsets", "-1,0,1")),
            _parse_offsets(line.opt("height-offsets", "-1,0,1")),
            line.opt_int("height-subsample-out", 1))
    if lt == "output-layer":
        return _Output(in_dim, line.opt_int("dim"),
                       line.opt("include-log-softmax", "true") == "true")
    return None


# Port of kaldi_tpu/am/xconfig.py XconfigModel.
class XconfigModel(nn.Module):
    """A parsed xconfig line tuple as a network: forward (B, T,
    feat_dim) → dict of output-layer name → tensor.
    ``frame_subsampling_factor`` subsamples time before the output
    layers (the chain ×3 convention)."""

    def __init__(self, lines: Tuple[XLine, ...],
                 frame_subsampling_factor: int = 1):
        super().__init__()
        self.xlines = lines
        self.frame_subsampling_factor = frame_subsampling_factor
        self._plan = []
        for line, in_dim, _, prev in _resolved(lines):
            mod = _layer(line, in_dim)
            if mod is not None:
                if "." in line.name or hasattr(self, line.name):
                    raise KaldiError(f"xconfig: layer name '{line.name}' "
                                     "cannot name a torch module")
                self.add_module(line.name, mod)
            if line.layer_type == "stats-layer":
                cfg = line.opt("config", "mean+stddev(-99:3:9:99)")
                mod = _parse_stats_config(cfg)
            self._plan.append((line, prev, mod))

    def forward(self, x):
        tensors: Dict[str, torch.Tensor] = {}
        outputs: Dict[str, torch.Tensor] = {}
        for line, prev, mod in self._plan:
            lt = line.layer_type
            if lt == "input":
                dim = line.opt_int("dim")
                if x.shape[-1] != dim:
                    raise KaldiError(
                        f"xconfig input dim={dim} but features have "
                        f"dim {x.shape[-1]}")
                tensors[line.name] = x
                continue
            cols = [splice(tensors[ref or prev], (off,)) if off
                    else tensors[ref or prev] for ref, off in line.inputs]
            h = cols[0] if len(cols) == 1 else torch.cat(cols, dim=-1)
            if lt == "stats-layer":
                h = stats_window(h, *mod)
            elif lt == "output-layer":
                k = self.frame_subsampling_factor
                if k > 1:
                    h = h[:, ::k]
                h = mod(h)
                outputs[line.name] = h
            elif lt == "fast-lstmp-layer":
                h = mod(h)[0]
            elif mod is not None:
                h = mod(h)
            tensors[line.name] = h
        return outputs


# Port of kaldi_tpu/am/xconfig.py XconfigChainModel.
class XconfigChainModel(nn.Module):
    """XconfigModel with the ChainTrainer model contract: forward →
    the one (B, T', num_pdfs) score tensor of the named output head;
    ``feat_dim`` as TdnnConfig has it."""

    def __init__(self, lines: Tuple[XLine, ...],
                 frame_subsampling_factor: int = 1,
                 output_name: str = "output"):
        super().__init__()
        self.net = XconfigModel(lines, frame_subsampling_factor)
        self.output_name = output_name

    @property
    def feat_dim(self) -> int:
        return self.net.xlines[0].opt_int("dim")

    def forward(self, x):
        return self.net(x)[self.output_name]


# Port of kaldi_tpu/am/xconfig.py chain_model_from_xconfig.
def chain_model_from_xconfig(text: str,
                             frame_subsampling_factor: int = 3,
                             output_name: str = "output"
                             ) -> XconfigChainModel:
    """Parse xconfig text into a chain-trainable model (the
    steps/nnet3/chain recipes' xconfig → training-graph step)."""
    lines = parse_xconfig(text)
    out = [l for l in lines if l.name == output_name
           and l.layer_type == "output-layer"]
    if not out:
        raise KaldiError(f"xconfig: no output-layer named "
                         f"'{output_name}'")
    if out[0].opt("include-log-softmax", "true") == "true":
        raise KaldiError(
            "xconfig chain output must set include-log-softmax=false "
            "(chain scores are unnormalized; the denominator "
            "normalizes)")
    return XconfigChainModel(lines, frame_subsampling_factor, output_name)


# Port of kaldi_tpu/am/xconfig.py model_from_xconfig.
def model_from_xconfig(text: str, frame_subsampling_factor: int = 1
                       ) -> Tuple[XconfigModel, int, Dict[str, int]]:
    """Parse + build.  Returns (model, input_dim, {output: dim})."""
    lines = parse_xconfig(text)
    in_dim = lines[0].opt_int("dim")
    out_dims = {l.name: l.opt_int("dim") for l in lines
                if l.layer_type == "output-layer"}
    model = XconfigModel(lines, frame_subsampling_factor)
    log.info("xconfig: %d layers, input dim %d, outputs %s",
             len(lines), in_dim, out_dims)
    return model, in_dim, out_dims
