# Copied from kaldi_tpu/core/io.py; imports rewritten to kaldi_tpu_torch.
"""Extended filenames and Kaldi binary-format primitives.

Parity targets:
  - src/util/kaldi-io.h  Input/Output with extended filenames:
      ""/"-"    stdin/stdout
      "cmd |"   read from a pipe (command output)
      "| cmd"   write to a pipe (command input)
      "file:offset"  read starting at byte offset (scp entries)
      plain file paths (transparently gzip if endswith .gz on our side)
  - src/base/io-funcs.h  ReadBasicType/WriteBasicType, tokens, and the
    "\\0B" binary-mode header.

Wire format (Kaldi binary mode). The PRIMITIVES below — the \\0B
header, basic types, tokens, FM/FV/DM/DV matrices and vectors, integer
vectors, and ark/scp table framing — follow the C++ toolkit's byte
layout. Higher-level objects (.mdl in am/serialize.py) use these
primitives but their token layout diverges from the reference's
TransitionModel/AmDiagGmm sections; see am/serialize.py's docstring.
  * a binary item starts with bytes ``\\0B``
  * basic types are written as one size byte (sizeof) followed by the
    little-endian value (io-funcs-inl.h WriteBasicType)
  * tokens are space-terminated ASCII strings (WriteToken)
  * float matrices/vectors: token "FM "/"FV " (or "DM "/"DV " for
    double) then int32 rows[, cols] then raw row-major data
    (kaldi-matrix.cc Matrix::Write)
  * integer vectors: size byte, int32 length, then raw int32 data
    (io-funcs-inl.h WriteIntegerVector)
"""

from __future__ import annotations

import gzip
import io as _pyio
import os
import struct
import subprocess
import sys
from typing import BinaryIO, List, Tuple

import numpy as np

from kaldi_tpu_torch.core.logging import KaldiError

BINARY_HEADER = b"\x00B"


# ---------------------------------------------------------------------------
# Extended filenames
# ---------------------------------------------------------------------------

class _PipeReader:
    def __init__(self, cmd: str):
        self.proc = subprocess.Popen(cmd, shell=True, stdout=subprocess.PIPE)
        self.stream: BinaryIO = self.proc.stdout  # type: ignore

    def __enter__(self):
        return self.stream

    def __exit__(self, *exc):
        self.stream.close()
        rc = self.proc.wait()
        if rc != 0 and not any(exc):
            raise KaldiError(f"Pipe command failed with status {rc}")


class _PipeWriter:
    def __init__(self, cmd: str):
        self.proc = subprocess.Popen(cmd, shell=True, stdin=subprocess.PIPE)
        self.stream: BinaryIO = self.proc.stdin  # type: ignore

    def __enter__(self):
        return self.stream

    def __exit__(self, *exc):
        self.stream.close()
        rc = self.proc.wait()
        if rc != 0 and not any(exc):
            raise KaldiError(f"Pipe command failed with status {rc}")


class _Plain:
    def __init__(self, stream: BinaryIO, close: bool = True):
        self.stream = stream
        self._close = close

    def __enter__(self):
        return self.stream

    def __exit__(self, *exc):
        if self._close:
            self.stream.close()


def parse_rxfilename(rxfilename: str) -> Tuple[str, str, int]:
    """Classify an rxfilename → (kind, path_or_cmd, offset)."""
    if rxfilename in ("", "-"):
        return ("stdin", "", 0)
    if rxfilename.endswith("|"):
        return ("pipe", rxfilename[:-1], 0)
    # file:offset — offset must be all digits after the last colon
    head, sep, tail = rxfilename.rpartition(":")
    if sep and tail.isdigit() and head:
        return ("offset", head, int(tail))
    return ("file", rxfilename, 0)


def open_rxfilename(rxfilename: str):
    """Open an extended filename for binary reading (context manager)."""
    kind, path, offset = parse_rxfilename(rxfilename)
    if kind == "stdin":
        return _Plain(sys.stdin.buffer, close=False)
    if kind == "pipe":
        return _PipeReader(path)
    f: BinaryIO
    if path.endswith(".gz"):
        f = gzip.open(path, "rb")  # type: ignore
    else:
        f = open(path, "rb")
    if kind == "offset":
        f.seek(offset)
    return _Plain(f)


def open_wxfilename(wxfilename: str):
    """Open an extended filename for binary writing (context manager)."""
    if wxfilename in ("", "-"):
        return _Plain(sys.stdout.buffer, close=False)
    if wxfilename.startswith("|"):
        return _PipeWriter(wxfilename[1:])
    d = os.path.dirname(wxfilename)
    if d:
        os.makedirs(d, exist_ok=True)
    if wxfilename.endswith(".gz"):
        return _Plain(gzip.open(wxfilename, "wb"))  # type: ignore
    return _Plain(open(wxfilename, "wb"))


# ---------------------------------------------------------------------------
# Binary basic types (io-funcs semantics)
# ---------------------------------------------------------------------------

def init_kaldi_output_stream(f: BinaryIO, binary: bool = True) -> None:
    if binary:
        f.write(BINARY_HEADER)


def init_kaldi_input_stream(f: BinaryIO) -> bool:
    """Peek the two-byte binary header; returns True if binary mode."""
    pos = f.tell() if f.seekable() else None
    head = f.read(2)
    if head == BINARY_HEADER:
        return True
    if pos is not None:
        f.seek(pos)
    else:  # pragma: no cover - pipes: push back via BufferedReader peek not possible
        raise KaldiError("Text-mode stream on non-seekable input not supported here")
    return False


def write_basic_int32(f: BinaryIO, v: int) -> None:
    f.write(b"\x04" + struct.pack("<i", v))


def read_basic_int32(f: BinaryIO) -> int:
    size = f.read(1)
    if size != b"\x04":
        raise KaldiError(f"Expected int32 size byte, got {size!r}")
    return struct.unpack("<i", f.read(4))[0]


def write_basic_float(f: BinaryIO, v: float) -> None:
    f.write(b"\x04" + struct.pack("<f", v))


def read_basic_float(f: BinaryIO) -> float:
    size = f.read(1)
    if size == b"\x04":
        return struct.unpack("<f", f.read(4))[0]
    if size == b"\x08":
        return struct.unpack("<d", f.read(8))[0]
    raise KaldiError(f"Expected float size byte, got {size!r}")


def write_token(f: BinaryIO, token: str) -> None:
    if " " in token or not token:
        raise KaldiError(f"Invalid token {token!r}")
    f.write(token.encode() + b" ")


def read_token(f: BinaryIO) -> str:
    # Skip leading space (ReadToken consumes one leading space if present).
    chars: List[bytes] = []
    c = f.read(1)
    while c in (b" ", b"\t", b"\n"):
        c = f.read(1)
    while c not in (b" ", b"", b"\n"):
        chars.append(c)
        c = f.read(1)
    if not chars:
        raise KaldiError("Unexpected EOF reading token")
    return b"".join(chars).decode()


def expect_token(f: BinaryIO, token: str) -> None:
    got = read_token(f)
    if got != token:
        raise KaldiError(f"Expected token '{token}', got '{got}'")


def peek_token(f: BinaryIO) -> str:
    pos = f.tell()
    tok = read_token(f)
    f.seek(pos)
    return tok


def write_int_vector(f: BinaryIO, v) -> None:
    v = np.asarray(v, dtype=np.int32)
    f.write(b"\x04" + struct.pack("<i", len(v)))
    # WriteIntegerVector writes each element raw after the size prefix.
    f.write(v.astype("<i4").tobytes())


def read_int_vector(f: BinaryIO) -> np.ndarray:
    size = f.read(1)
    if size != b"\x04":
        raise KaldiError(f"Expected size byte 4, got {size!r}")
    n = struct.unpack("<i", f.read(4))[0]
    return np.frombuffer(f.read(4 * n), dtype="<i4").copy()


# ---------------------------------------------------------------------------
# Matrices / vectors (kaldi-matrix.cc Write/Read binary format)
# ---------------------------------------------------------------------------

def write_matrix(f: BinaryIO, mat: np.ndarray, dtype: str = "float32") -> None:
    mat = np.ascontiguousarray(mat)
    if mat.ndim != 2:
        raise KaldiError("write_matrix needs a 2-D array")
    if dtype == "float32":
        write_token(f, "FM")
        data = mat.astype("<f4")
    else:
        write_token(f, "DM")
        data = mat.astype("<f8")
    write_basic_int32(f, mat.shape[0])
    write_basic_int32(f, mat.shape[1])
    f.write(data.tobytes())


def read_matrix(f: BinaryIO) -> np.ndarray:
    tok = read_token(f)
    if tok in ("CM", "CM2", "CM3"):
        return _read_compressed_body(f, tok)
    if tok == "FM":
        itemsize, dt = 4, "<f4"
    elif tok == "DM":
        itemsize, dt = 8, "<f8"
    else:
        raise KaldiError(f"Expected FM/DM/CM token, got '{tok}'")
    rows = read_basic_int32(f)
    cols = read_basic_int32(f)
    buf = f.read(itemsize * rows * cols)
    return np.frombuffer(buf, dtype=dt).reshape(rows, cols).astype(np.float32)


# ---------------------------------------------------------------------------
# CompressedMatrix (compressed-matrix.cc) — the format feature archives
# use (--compress=true in steps/make_mfcc.sh writes "CM" entries).
#
# Layout (from the public compressed-matrix.cc; the empty reference
# mount — SURVEY.md §0 — means this is round-trip-tested but not yet
# byte-verified against an upstream ark):
#   token "CM" (per-column uint8) | "CM2" (uint16) | "CM3" (flat uint8)
#   GlobalHeader raw struct: float32 min_value, float32 range,
#                            int32 num_rows, int32 num_cols
#   CM:  PerColHeader {uint16 p0,p25,p75,p100} × cols, then uint8 data
#        column-major; elements piecewise-linear within the percentile
#        bands [p0,p25]→[0,64], [p25,p75]→[64,192], [p75,p100]→[192,255]
#   CM2: uint16 row-major, value = min + range·code/65535
#   CM3: uint8 row-major, value = min + range·code/255
# ---------------------------------------------------------------------------

def _u16_to_float(g_min, g_range, codes):
    return g_min + g_range * codes.astype(np.float64) / 65535.0


def _float_to_u16(g_min, g_range, vals):
    f = np.clip((vals - g_min) / max(g_range, 1e-20), 0.0, 1.0)
    return (f * 65535 + 0.499).astype(np.uint16)


def _char_to_float(p0, p25, p75, p100, codes):
    c = codes.astype(np.float64)
    lo = p0 + (p25 - p0) * (c / 64.0)
    mid = p25 + (p75 - p25) * ((c - 64.0) / 128.0)
    hi = p75 + (p100 - p75) * ((c - 192.0) / 63.0)
    return np.where(c <= 64, lo, np.where(c <= 192, mid, hi))


def _float_to_char(p0, p25, p75, p100, vals):
    out = np.empty(vals.shape, np.uint8)
    lo = vals < p25
    hi = vals >= p75
    mid = ~lo & ~hi
    f = (vals - p0) / np.maximum(p25 - p0, 1e-20)
    out_lo = np.clip(f * 64 + 0.5, 0, 64).astype(np.uint8)
    f = (vals - p25) / np.maximum(p75 - p25, 1e-20)
    out_mid = np.clip(64 + f * 128 + 0.5, 64, 192).astype(np.uint8)
    f = (vals - p75) / np.maximum(p100 - p75, 1e-20)
    out_hi = np.clip(192 + f * 63 + 0.5, 192, 255).astype(np.uint8)
    out[lo] = out_lo[lo]
    out[mid] = out_mid[mid]
    out[hi] = out_hi[hi]
    return out


def write_compressed_matrix(f: BinaryIO, mat: np.ndarray,
                            fmt: str = "CM") -> None:
    mat = np.asarray(mat, np.float64)
    rows, cols = mat.shape
    g_min = float(mat.min()) if mat.size else 0.0
    g_range = float(mat.max() - g_min) if mat.size else 1.0
    g_range = max(g_range, 1e-10)
    write_token(f, fmt)
    f.write(struct.pack("<ffii", g_min, g_range, rows, cols))
    if fmt == "CM2":
        codes = _float_to_u16(g_min, g_range, mat)
        f.write(codes.astype("<u2").tobytes())
        return
    if fmt == "CM3":
        fr = np.clip((mat - g_min) / g_range, 0, 1)
        f.write((fr * 255 + 0.5).astype(np.uint8).tobytes())
        return
    if fmt != "CM":
        raise KaldiError(f"bad compressed format {fmt}")
    headers = np.empty((cols, 4), "<u2")
    data = np.empty((cols, rows), np.uint8)
    for c in range(cols):
        col = np.sort(mat[:, c])
        qs = [col[0],
              col[min(rows - 1, rows // 4)],
              col[min(rows - 1, (3 * rows) // 4)],
              col[-1]]
        codes = _float_to_u16(g_min, g_range, np.asarray(qs))
        codes = np.maximum.accumulate(codes)   # monotone percentiles
        headers[c] = codes
        p0, p25, p75, p100 = _u16_to_float(g_min, g_range, codes)
        p25 = max(p25, p0 + 1e-10)
        p75 = max(p75, p25 + 1e-10)
        p100 = max(p100, p75 + 1e-10)
        data[c] = _float_to_char(p0, p25, p75, p100, mat[:, c])
    f.write(headers.tobytes())
    f.write(data.tobytes())


def _read_compressed_body(f: BinaryIO, tok: str) -> np.ndarray:
    g_min, g_range, rows, cols = struct.unpack("<ffii", f.read(16))
    if tok == "CM2":
        codes = np.frombuffer(f.read(2 * rows * cols), "<u2")
        return _u16_to_float(g_min, g_range, codes).reshape(
            rows, cols).astype(np.float32)
    if tok == "CM3":
        codes = np.frombuffer(f.read(rows * cols), np.uint8)
        return (g_min + g_range * codes.astype(np.float64) / 255.0
                ).reshape(rows, cols).astype(np.float32)
    headers = np.frombuffer(f.read(8 * cols), "<u2").reshape(cols, 4)
    data = np.frombuffer(f.read(rows * cols), np.uint8).reshape(cols, rows)
    out = np.empty((rows, cols), np.float32)
    for c in range(cols):
        p0, p25, p75, p100 = _u16_to_float(g_min, g_range, headers[c])
        out[:, c] = _char_to_float(p0, p25, p75, p100, data[c])
    return out


def read_compressed_matrix(f: BinaryIO) -> np.ndarray:
    tok = read_token(f)
    if tok not in ("CM", "CM2", "CM3"):
        raise KaldiError(f"Expected CM/CM2/CM3, got '{tok}'")
    return _read_compressed_body(f, tok)


def write_vector(f: BinaryIO, vec: np.ndarray, dtype: str = "float32") -> None:
    vec = np.ascontiguousarray(vec)
    if vec.ndim != 1:
        raise KaldiError("write_vector needs a 1-D array")
    if dtype == "float32":
        write_token(f, "FV")
        data = vec.astype("<f4")
    else:
        write_token(f, "DV")
        data = vec.astype("<f8")
    write_basic_int32(f, vec.shape[0])
    f.write(data.tobytes())


def read_vector(f: BinaryIO) -> np.ndarray:
    tok = read_token(f)
    if tok == "FV":
        itemsize, dt = 4, "<f4"
    elif tok == "DV":
        itemsize, dt = 8, "<f8"
    else:
        raise KaldiError(f"Expected FV/DV token, got '{tok}'")
    n = read_basic_int32(f)
    return np.frombuffer(f.read(itemsize * n), dtype=dt).astype(np.float32)
