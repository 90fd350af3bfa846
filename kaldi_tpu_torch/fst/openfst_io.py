# Copied from kaldi_tpu/fst/openfst_io.py; imports rewritten to kaldi_tpu_torch.
"""OpenFst binary FST format: read/write VectorFst, read ConstFst.

Parity target: OpenFst's fst/fst.h FstHeader::{Read,Write},
fst/vector-fst.h VectorFstBaseImpl::{Read,Write}, fst/const-fst.h
ConstFstImpl::Read — the on-disk format of every HCLG.fst / L.fst /
G.fst the reference toolchain produces (utils/mkgraph.sh output is a
ConstFst or VectorFst over the tropical StdArc).

Byte layout implemented from the OpenFst-1.6.x format (the version the
reference vendors in tools/openfst):

  FstHeader:
    int32   magic = 2125659606
    string  fsttype   ("vector" | "const")     [int32 len + bytes]
    string  arctype   ("standard")
    int32   version   (vector: 2, const: 2)
    int32   flags     (bit0 HAS_ISYMBOLS, bit1 HAS_OSYMBOLS — we
                       reject symbol-table-carrying files for now)
    uint64  properties
    int64   start
    int64   numstates
    int64   numarcs
  VectorFst body, per state:
    float32 final-weight (+inf = non-final)
    int64   numarcs
    arcs: int32 ilabel, int32 olabel, float32 weight, int32 nextstate
  ConstFst body (v2, written by a MappedFile: each array preceded by
  padding to a 16-byte boundary):
    states: {float32 final, uint32 pos, uint32 narcs,
             uint32 niepsilons, uint32 noepsilons} × numstates
    arcs:   {int32, int32, float32, int32} × numarcs

VERIFICATION STATUS: the reference mount is empty (SURVEY.md §0), so
this cannot be byte-checked against real upstream artifacts yet; the
layout follows the public OpenFst sources and is exercised by
write→read round-trips.  Re-verify against a real HCLG.fst the moment
one is available.
"""

from __future__ import annotations

import struct
from typing import BinaryIO, Tuple

import numpy as np

from kaldi_tpu_torch.core.logging import KaldiError, get_logger
from kaldi_tpu_torch.fst.fst import Arc, VectorFst

log = get_logger(__name__)

FST_MAGIC = 2125659606
INF = float("inf")
_ALIGN = 16


def _write_string(f: BinaryIO, s: str) -> None:
    b = s.encode()
    f.write(struct.pack("<i", len(b)))
    f.write(b)


def _read_string(f: BinaryIO) -> str:
    (n,) = struct.unpack("<i", f.read(4))
    if n < 0 or n > 1 << 20:
        raise KaldiError(f"openfst_io: bad string length {n}")
    return f.read(n).decode()


def write_fst_header(f: BinaryIO, fsttype: str, version: int,
                     start: int, numstates: int, numarcs: int,
                     properties: int = 0) -> None:
    f.write(struct.pack("<i", FST_MAGIC))
    _write_string(f, fsttype)
    _write_string(f, "standard")
    f.write(struct.pack("<iiQqqq", version, 0, properties, start,
                        numstates, numarcs))


def read_fst_header(f: BinaryIO):
    (magic,) = struct.unpack("<i", f.read(4))
    if magic != FST_MAGIC:
        raise KaldiError(f"openfst_io: bad magic {magic} "
                         f"(expected {FST_MAGIC})")
    fsttype = _read_string(f)
    arctype = _read_string(f)
    if arctype != "standard":
        raise KaldiError(f"openfst_io: unsupported arc type {arctype!r}")
    version, flags, properties, start, numstates, numarcs = struct.unpack(
        "<iiQqqq", f.read(4 + 4 + 8 + 8 + 8 + 8))
    if flags & 0x3:
        raise KaldiError("openfst_io: embedded symbol tables unsupported")
    return fsttype, version, properties, start, numstates, numarcs


def write_vector_fst(f: BinaryIO, fst: VectorFst) -> None:
    """VectorFst binary (fsttype 'vector', version 2)."""
    numarcs = sum(len(a) for a in fst.arcs)
    write_fst_header(f, "vector", 2, fst.start, fst.num_states, numarcs)
    for s in range(fst.num_states):
        final = fst.final(s) if fst.is_final(s) else INF
        f.write(struct.pack("<f", final))
        f.write(struct.pack("<q", len(fst.arcs[s])))
        if fst.arcs[s]:
            buf = np.empty((len(fst.arcs[s]), 4), np.int32)
            wts = np.empty(len(fst.arcs[s]), np.float32)
            for i, a in enumerate(fst.arcs[s]):
                buf[i, 0] = a.ilabel
                buf[i, 1] = a.olabel
                buf[i, 3] = a.nextstate
                wts[i] = a.weight
            buf[:, 2] = wts.view(np.int32)
            f.write(buf.tobytes())


def _read_vector_body(f: BinaryIO, numstates: int) -> VectorFst:
    fst = VectorFst()
    for _ in range(numstates):
        fst.add_state()
    for s in range(numstates):
        (final,) = struct.unpack("<f", f.read(4))
        if final != INF:
            fst.set_final(s, final)
        (narcs,) = struct.unpack("<q", f.read(8))
        if narcs:
            raw = np.frombuffer(f.read(16 * narcs), np.int32).reshape(-1, 4)
            wts = raw[:, 2].view(np.float32)
            for i in range(narcs):
                fst.arcs[s].append(Arc(int(raw[i, 0]), int(raw[i, 1]),
                                       float(wts[i]), int(raw[i, 3])))
    return fst


def _skip_padding(f: BinaryIO) -> None:
    """MappedFile alignment: the array start is padded to 16 bytes."""
    pos = f.tell()
    pad = (-pos) % _ALIGN
    if pad:
        f.read(pad)


def _read_const_body(f: BinaryIO, numstates: int, numarcs: int
                     ) -> VectorFst:
    _skip_padding(f)
    st = np.frombuffer(f.read(20 * numstates), np.uint8)
    st = st.view(np.dtype([("final", "<f4"), ("pos", "<u4"),
                           ("narcs", "<u4"), ("nieps", "<u4"),
                           ("noeps", "<u4")]))
    _skip_padding(f)
    arcs = np.frombuffer(f.read(16 * numarcs), np.int32).reshape(-1, 4)
    wts = arcs[:, 2].view(np.float32)
    fst = VectorFst()
    for _ in range(numstates):
        fst.add_state()
    for s in range(numstates):
        if st["final"][s] != np.float32(np.inf):
            fst.set_final(s, float(st["final"][s]))
        lo = int(st["pos"][s])
        for i in range(lo, lo + int(st["narcs"][s])):
            fst.arcs[s].append(Arc(int(arcs[i, 0]), int(arcs[i, 1]),
                                   float(wts[i]), int(arcs[i, 3])))
    return fst


def write_const_fst(f: BinaryIO, fst: VectorFst) -> None:
    """ConstFst binary (fsttype 'const', version 2, 16-byte-aligned
    arrays) — what fstconvert --fst_type=const / mkgraph.sh produce."""
    numarcs = sum(len(a) for a in fst.arcs)
    write_fst_header(f, "const", 2, fst.start, fst.num_states, numarcs)
    pad = (-f.tell()) % _ALIGN
    f.write(b"\0" * pad)
    states = np.zeros(fst.num_states,
                      np.dtype([("final", "<f4"), ("pos", "<u4"),
                                ("narcs", "<u4"), ("nieps", "<u4"),
                                ("noeps", "<u4")]))
    pos = 0
    for s in range(fst.num_states):
        states["final"][s] = fst.final(s) if fst.is_final(s) else INF
        states["pos"][s] = pos
        states["narcs"][s] = len(fst.arcs[s])
        states["nieps"][s] = sum(1 for a in fst.arcs[s] if a.ilabel == 0)
        states["noeps"][s] = sum(1 for a in fst.arcs[s] if a.olabel == 0)
        pos += len(fst.arcs[s])
    f.write(states.tobytes())
    pad = (-f.tell()) % _ALIGN
    f.write(b"\0" * pad)
    arcs = np.zeros((numarcs, 4), np.int32)
    wts = np.zeros(numarcs, np.float32)
    i = 0
    for s in range(fst.num_states):
        for a in fst.arcs[s]:
            arcs[i, 0] = a.ilabel
            arcs[i, 1] = a.olabel
            arcs[i, 3] = a.nextstate
            wts[i] = a.weight
            i += 1
    arcs[:, 2] = wts.view(np.int32)
    f.write(arcs.tobytes())


def read_fst(f: BinaryIO) -> VectorFst:
    """Read a binary OpenFst file (vector or const) into a VectorFst."""
    fsttype, version, _props, start, numstates, numarcs = \
        read_fst_header(f)
    if fsttype == "vector":
        fst = _read_vector_body(f, numstates)
    elif fsttype == "const":
        fst = _read_const_body(f, numstates, numarcs)
    else:
        raise KaldiError(f"openfst_io: unsupported fst type {fsttype!r}")
    if start >= 0:
        fst.set_start(int(start))
    return fst


def read_fst_path(path: str) -> VectorFst:
    with open(path, "rb") as f:
        return read_fst(f)


def write_fst_path(path: str, fst: VectorFst) -> None:
    with open(path, "wb") as f:
        write_vector_fst(f, fst)
