# Copied from kaldi_tpu/am/nnet3_io.py; imports rewritten to kaldi_tpu_torch,
# and the flax converters replaced by TdnnChain state-dict ones.
"""nnet3 model-file (.mdl / .raw) reader, writer, and TdnnChain converter.

Parity target: src/nnet3/nnet-nnet.cc Nnet::{Read,Write} and the
component Read/Write methods in nnet-simple-component.cc — the format
of the reference's `final.mdl` (TransitionModel + AmNnetSimple) and
`final.raw` (bare Nnet), so upstream-trained TDNN-F weights can be
loaded into the port's ``TdnnChain`` (am/tdnn.py) and written back.
The converters map components to the module's state dict directly:
nnet3 keeps a linear map as (out, in), as ``nn.Linear`` does.

Format (public nnet3 sources; round-trip-tested here, byte
verification pending a populated reference mount — SURVEY.md §0):

  <Nnet3> \n
  one text config line per node ("component-node name=... input=...")
  blank line
  <NumComponents> int32
  per component: <ComponentName> <name> then the component's own
    <TypeComponent> ... </TypeComponent> section
  </Nnet3>

The READER is generic: inside a component section it sniffs each
field's value type from the stream (4/8-byte scalars by their Kaldi
size prefix, 'T'/'F' bools, FM/FV/DM/DV/CM matrices and vectors) and
stores unknown fields raw — so files from slightly different nnet3
versions still parse, and the converter only interprets the fields it
needs (LinearParams/BiasParams/Params/StatsMean/StatsVar/Dim).
"""

from __future__ import annotations

import dataclasses
import struct
from typing import BinaryIO, Dict, List, Optional, Tuple

import numpy as np
import torch

from kaldi_tpu_torch.core.logging import KaldiError, get_logger
from kaldi_tpu_torch.core import io as kio

log = get_logger(__name__)


# ---------------------------------------------------------------------------
# generic component field parsing
# ---------------------------------------------------------------------------

class _Peek:
    """Minimal pushback wrapper over a binary stream."""

    def __init__(self, f: BinaryIO):
        self.f = f
        self.buf = b""

    def read(self, n: int) -> bytes:
        out = b""
        if self.buf:
            out, self.buf = self.buf[:n], self.buf[n:]
        if len(out) < n:
            out += self.f.read(n - len(out))
        return out

    def peek(self, n: int) -> bytes:
        while len(self.buf) < n:
            b = self.f.read(n - len(self.buf))
            if not b:
                break
            self.buf += b
        return self.buf[:n]

    def readline(self) -> bytes:
        out = b""
        while True:
            c = self.read(1)
            if not c or c == b"\n":
                return out
            out += c


@dataclasses.dataclass
class FieldValue:
    kind: str                      # scalar4 | scalar8 | bool | mat | vec
    raw: bytes = b""
    array: Optional[np.ndarray] = None

    @property
    def as_int(self) -> int:
        return struct.unpack("<i", self.raw)[0]

    @property
    def as_float(self) -> float:
        if self.kind == "scalar8":
            return struct.unpack("<d", self.raw)[0]
        return struct.unpack("<f", self.raw)[0]

    @property
    def as_bool(self) -> bool:
        return self.raw == b"T"


def _f32(v: float) -> FieldValue:
    return FieldValue("scalar4", struct.pack("<f", v))


def _i32(v: int) -> FieldValue:
    return FieldValue("scalar4", struct.pack("<i", v))


def _f64(v: float) -> FieldValue:
    return FieldValue("scalar8", struct.pack("<d", v))


def _b(v: bool) -> FieldValue:
    return FieldValue("bool", b"T" if v else b"F")


def _mat(m: np.ndarray) -> FieldValue:
    return FieldValue("mat", array=np.asarray(m, np.float32))


def _vec(v: np.ndarray) -> FieldValue:
    return FieldValue("vec", array=np.asarray(v, np.float32))


@dataclasses.dataclass
class Nnet3Component:
    name: str
    ctype: str                    # e.g. "NaturalGradientAffineComponent"
    fields: Dict[str, FieldValue] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Nnet3Model:
    config_lines: List[str]
    components: List[Nnet3Component]

    def component(self, name: str) -> Nnet3Component:
        for c in self.components:
            if c.name == name:
                return c
        raise KaldiError(f"nnet3: no component {name!r}")


def _read_value(p: _Peek) -> FieldValue:
    head = p.peek(3)
    if not head:
        raise KaldiError("nnet3: truncated stream")
    if head[:1] == b"\x04":
        p.read(1)
        return FieldValue("scalar4", p.read(4))
    if head[:1] == b"\x08":
        p.read(1)
        return FieldValue("scalar8", p.read(8))
    if len(head) >= 3 and head[1:2] in (b"M", b"V") \
            and head[:1] in (b"F", b"D", b"C") and head[2:3] == b" ":
        tok = p.read(3)[:2].decode()
        if tok in ("FM", "DM"):
            rows = kio.read_basic_int32(p)
            cols = kio.read_basic_int32(p)
            n = 4 if tok == "FM" else 8
            dt = "<f4" if tok == "FM" else "<f8"
            arr = np.frombuffer(p.read(n * rows * cols), dt)
            return _mat(arr.reshape(rows, cols))
        rows = kio.read_basic_int32(p)
        n = 4 if tok == "FV" else 8
        dt = "<f4" if tok == "FV" else "<f8"
        return _vec(np.frombuffer(p.read(n * rows), dt))
    if head[:1] in (b"T", b"F"):
        c = p.read(1)
        if p.peek(1) == b" ":
            p.read(1)
        return FieldValue("bool", c)
    raise KaldiError(f"nnet3: cannot sniff value starting {head!r}")


def _read_token(p: _Peek) -> str:
    out = b""
    while True:
        c = p.read(1)
        if not c:
            raise KaldiError("nnet3: EOF reading token")
        if c in b" \n":
            if out:
                return out.decode()
            continue
        out += c


def _write_token(f: BinaryIO, tok: str) -> None:
    f.write(tok.encode() + b" ")


def _write_value(f: BinaryIO, v: FieldValue) -> None:
    if v.kind == "scalar4":
        f.write(b"\x04" + v.raw)
    elif v.kind == "scalar8":
        f.write(b"\x08" + v.raw)
    elif v.kind == "bool":
        f.write(v.raw + b" ")
    elif v.kind == "mat":
        kio.write_matrix(f, v.array)
    elif v.kind == "vec":
        kio.write_vector(f, v.array)
    else:
        raise KaldiError(f"bad field kind {v.kind}")


def read_component(p: _Peek) -> Tuple[str, Dict[str, FieldValue]]:
    ctype_tok = _read_token(p)
    if not (ctype_tok.startswith("<") and ctype_tok.endswith(">")):
        raise KaldiError(f"nnet3: bad component type token {ctype_tok!r}")
    ctype = ctype_tok[1:-1]
    end = f"</{ctype}>"
    fields: Dict[str, FieldValue] = {}
    while True:
        tok = _read_token(p)
        if tok == end:
            return ctype, fields
        if not (tok.startswith("<") and tok.endswith(">")):
            raise KaldiError(f"nnet3: bad field token {tok!r} in {ctype}")
        nxt = p.peek(1)
        if nxt == b"<":
            # marker with no value (e.g. <ValueSum> absent)
            fields[tok[1:-1]] = FieldValue("bool", b"")
            continue
        fields[tok[1:-1]] = _read_value(p)


def read_nnet3(f: BinaryIO) -> Nnet3Model:
    """Read a bare <Nnet3> section (a .raw file, or the nnet part of a
    .mdl after its TransitionModel)."""
    p = f if isinstance(f, _Peek) else _Peek(f)
    tok = _read_token(p)
    if tok != "<Nnet3>":
        raise KaldiError(f"nnet3: expected <Nnet3>, got {tok!r}")
    # skip to end of line, then text config lines until a blank one
    p.readline()
    config = []
    while True:
        line = p.readline().decode().strip()
        if not line:
            break
        config.append(line)
    tok = _read_token(p)
    if tok != "<NumComponents>":
        raise KaldiError(f"nnet3: expected <NumComponents>, got {tok!r}")
    n = kio.read_basic_int32(p)
    comps = []
    for _ in range(n):
        tok = _read_token(p)
        if tok != "<ComponentName>":
            raise KaldiError(f"nnet3: expected <ComponentName>, got {tok!r}")
        name = _read_token(p)
        ctype, fields = read_component(p)
        comps.append(Nnet3Component(name, ctype, fields))
    tok = _read_token(p)
    if tok != "</Nnet3>":
        raise KaldiError(f"nnet3: expected </Nnet3>, got {tok!r}")
    return Nnet3Model(config, comps)


def write_nnet3(f: BinaryIO, model: Nnet3Model) -> None:
    f.write(b"<Nnet3> \n")
    for line in model.config_lines:
        f.write(line.encode() + b"\n")
    f.write(b"\n")
    _write_token(f, "<NumComponents>")
    kio.write_basic_int32(f, len(model.components))
    for c in model.components:
        _write_token(f, "<ComponentName>")
        _write_token(f, c.name)
        _write_token(f, f"<{c.ctype}>")
        for k, v in c.fields.items():
            _write_token(f, f"<{k}>")
            _write_value(f, v)
        _write_token(f, f"</{c.ctype}>")
    f.write(b"</Nnet3> ")


# ---------------------------------------------------------------------------
# TdnnChain state dict ↔ nnet3 component conversion
# ---------------------------------------------------------------------------

def _affine(name: str, weight: np.ndarray, bias: np.ndarray
            ) -> Nnet3Component:
    """nnet3 LinearParams is (out, in), the layout of an nn.Linear."""
    return Nnet3Component(name, "NaturalGradientAffineComponent", {
        "LearningRateFactor": _f32(1.0),
        "LearningRate": _f32(0.001),
        "LinearParams": _mat(weight),
        "BiasParams": _vec(bias),
        "RankIn": _i32(20), "RankOut": _i32(80),
        "UpdatePeriod": _i32(4),
        "NumSamplesHistory": _f32(2000.0), "Alpha": _f32(4.0),
    })


def _linear(name: str, weight: np.ndarray) -> Nnet3Component:
    return Nnet3Component(name, "LinearComponent", {
        "LearningRateFactor": _f32(1.0),
        "LearningRate": _f32(0.001),
        "Params": _mat(weight),
        "OrthonormalConstraint": _f32(-1.0),
        "UseNaturalGradient": _b(True),
    })


# Copied from kaldi_tpu/am/nnet3_io.py _batchnorm.
def _batchnorm(name: str, mean: np.ndarray, var: np.ndarray,
               eps: float = 1e-3) -> Nnet3Component:
    return Nnet3Component(name, "BatchNormComponent", {
        "Dim": _i32(len(mean)), "BlockDim": _i32(len(mean)),
        "Epsilon": _f32(eps), "TargetRms": _f32(1.0),
        "TestMode": _b(True), "Count": _f64(1.0),
        "StatsMean": _vec(mean), "StatsVar": _vec(var),
    })


# Copied from kaldi_tpu/am/nnet3_io.py _relu.
def _relu(name: str, dim: int) -> Nnet3Component:
    return Nnet3Component(name, "RectifiedLinearComponent", {
        "Dim": _i32(dim),
        "ValueAvg": _vec(np.zeros(0)), "DerivAvg": _vec(np.zeros(0)),
        "Count": _f64(0.0),
        "NumDimsSelfRepaired": _f64(0.0), "NumDimsProcessed": _f64(0.0),
    })


def _blocks(cfg):
    """(nnet3 name prefix, state-dict prefix) of each affine + ReLU +
    batch-norm block, with its TDNN-F linear, in network order."""
    out = [("input", "input_affine", "input_bn", None)]
    for i, _s in enumerate(cfg.layer_strides()):
        out.append((f"tdnnf{i + 1}", f"tdnnf.{i}.affine",
                    f"tdnnf.{i}.batchnorm", f"tdnnf.{i}.linear"))
    out.append(("prefinal", "prefinal", "prefinal_bn", None))
    return out


def state_dict_to_nnet3(state_dict, cfg) -> Nnet3Model:
    """A ``TdnnChain`` state dict (the port of ``tdnn_to_nnet3``) → an
    nnet3 component list, nnet3-copy-compatible for the matching
    xconfig."""
    sd = {k: v.detach().cpu().numpy() for k, v in state_dict.items()}
    comps = []
    for n, aff, bn, lin in _blocks(cfg):
        if lin is not None:
            comps.append(_linear(f"{n}.linear", sd[f"{lin}.weight"]))
        comps.append(_affine(f"{n}.affine", sd[f"{aff}.weight"],
                             sd[f"{aff}.bias"]))
        comps.append(_relu(f"{n}.relu", cfg.hidden_dim))
        comps.append(_batchnorm(f"{n}.batchnorm", sd[f"{bn}.mean"],
                                sd[f"{bn}.var"]))
    comps.append(_affine("output.affine", sd["output_affine.weight"],
                         sd["output_affine.bias"]))
    config = [f"input-node name=input dim={cfg.feat_dim}"]
    for c in comps:
        config.append(f"component-node name={c.name} component={c.name} "
                      f"input=[...]")
    config.append("output-node name=output input=output.affine "
                  "objective=linear")
    return Nnet3Model(config, comps)


def nnet3_to_state_dict(model: Nnet3Model, cfg) -> Dict[str, torch.Tensor]:
    """An nnet3 TDNN-F component list → a ``TdnnChain`` state dict (the
    work of the original's ``nnet3_to_tdnn`` and the port's
    ``params_from_flax`` together)."""
    def t(a):
        return torch.from_numpy(np.array(a, np.float32))

    def field(name, key):
        return model.component(name).fields[key].array

    sd: Dict[str, torch.Tensor] = {}
    for n, aff, bn, lin in _blocks(cfg):
        if lin is not None:
            sd[f"{lin}.weight"] = t(field(f"{n}.linear", "Params"))
        sd[f"{aff}.weight"] = t(field(f"{n}.affine", "LinearParams"))
        sd[f"{aff}.bias"] = t(field(f"{n}.affine", "BiasParams"))
        sd[f"{bn}.mean"] = t(field(f"{n}.batchnorm", "StatsMean"))
        sd[f"{bn}.var"] = t(field(f"{n}.batchnorm", "StatsVar"))
    sd["output_affine.weight"] = t(field("output.affine", "LinearParams"))
    sd["output_affine.bias"] = t(field("output.affine", "BiasParams"))
    return sd


def write_raw_model(path: str, state_dict, cfg) -> None:
    """A ``TdnnChain`` state dict → a binary nnet3 ``.raw`` file."""
    with open(path, "wb") as f:
        f.write(b"\0B")
        write_nnet3(f, state_dict_to_nnet3(state_dict, cfg))


def read_nnet3_path(path: str) -> Nnet3Model:
    """A binary nnet3 ``.raw`` file → its component list."""
    with open(path, "rb") as f:
        if f.read(2) != b"\0B":
            raise KaldiError(f"{path}: expected binary header \\0B")
        return read_nnet3(f)


def read_raw_model(path: str, cfg) -> Dict[str, torch.Tensor]:
    """A binary nnet3 ``.raw`` file → a ``TdnnChain`` state dict."""
    return nnet3_to_state_dict(read_nnet3_path(path), cfg)


# Port of kaldi_tpu/am/nnet3_io.py infer_tdnn_config (returns the port's
# TdnnConfig).
def infer_tdnn_config(model: Nnet3Model, frame_subsampling_factor: int = 3):
    """Recover a TdnnConfig from a serialized component list (the nnet3
    file itself is the config, as in the reference).  The input affine
    reads the ±1 splice, so feat_dim is a third of its input width (the
    original returns the whole width, which flax never reads)."""
    from kaldi_tpu_torch.am.tdnn import TdnnConfig
    inp = model.component("input.affine")
    out = model.component("output.affine")
    feat_dim = inp.fields["LinearParams"].array.shape[1] // 3
    hidden = inp.fields["LinearParams"].array.shape[0]
    num_pdfs = out.fields["LinearParams"].array.shape[0]
    n_layers = sum(1 for c in model.components
                   if c.name.startswith("tdnnf") and
                   c.name.endswith(".linear"))
    bottleneck = model.component("tdnnf1.linear") \
        .fields["Params"].array.shape[0] if n_layers else hidden // 4
    return TdnnConfig(feat_dim=feat_dim, num_pdfs=num_pdfs,
                      hidden_dim=hidden, bottleneck_dim=bottleneck,
                      num_layers=n_layers,
                      frame_subsampling_factor=frame_subsampling_factor)
