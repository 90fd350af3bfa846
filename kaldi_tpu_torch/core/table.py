# Copied from kaldi_tpu/core/table.py; imports rewritten to kaldi_tpu_torch.
# The chain, xent, discriminative and dense-target egs holders (ceg, xeg,
# deg, dteg) read and write the port's pipelines/egs_io.py.
"""Ark/scp table I/O.

Parity target: src/util/kaldi-table.h — SequentialTableReader,
RandomAccessTableReader, TableWriter over rspecifiers/wspecifiers:

    "ark:file"            archive of key→object pairs
    "scp:file"            script file of "key rxfilename" lines
    "ark,t:file"          text-mode archive
    "ark,scp:a.ark,a.scp" write archive + index together

Holders supported: "mat" (float matrix), "vec" (float vector),
"ivec" (int32 vector, e.g. alignments), "text" (whitespace token list),
"wav" (RIFF wave).  In the reference the holder type is compile-time
(templated); here it is the ``holder=`` argument.

Archives are the reference's inter-stage wire format; in kaldi_tpu most
pipelines pass arrays in memory and use tables at stage boundaries only
(SURVEY.md §2.4: the filesystem is Kaldi's communication backend).
"""

from __future__ import annotations

import io as _pyio
import os
import struct
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from kaldi_tpu_torch.core import io as kio
from kaldi_tpu_torch.core.logging import KaldiError, get_logger

log = get_logger(__name__)


# ---------------------------------------------------------------------------
# Specifiers
# ---------------------------------------------------------------------------

def _parse_specifier(spec: str) -> Tuple[str, List[str], str]:
    """'ark,t:foo' → ('ark', ['t'], 'foo')."""
    head, sep, rest = spec.partition(":")
    if not sep:
        raise KaldiError(f"Bad table specifier '{spec}'")
    parts = head.split(",")
    kind = parts[0]
    opts = parts[1:]
    if kind not in ("ark", "scp"):
        raise KaldiError(f"Bad table specifier kind '{kind}' in '{spec}'")
    return kind, opts, rest


# ---------------------------------------------------------------------------
# Holders: (write_binary, read_binary, write_text, read_text)
# ---------------------------------------------------------------------------

def _wav_write(f, value) -> None:
    """value = (samples float32 in [-1,1] or int16 array, sample_rate)."""
    samples, rate = value
    samples = np.asarray(samples)
    if samples.dtype != np.int16:
        samples = np.clip(samples, -1.0, 1.0)
        samples = (samples * 32767.0).astype("<i2")
    data = samples.tobytes()
    nchan, bps = 1, 2
    f.write(b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVE")
    f.write(b"fmt " + struct.pack("<IHHIIHH", 16, 1, nchan, int(rate),
                                  int(rate) * nchan * bps, nchan * bps, 8 * bps))
    f.write(b"data" + struct.pack("<I", len(data)) + data)


def _wav_read(f) -> Tuple[np.ndarray, int]:
    riff = f.read(4)
    if riff != b"RIFF":
        raise KaldiError("Not a RIFF wave")
    f.read(4)
    if f.read(4) != b"WAVE":
        raise KaldiError("Not a WAVE file")
    rate, nchan, bps = 16000, 1, 16
    data = b""
    while True:
        hdr = f.read(8)
        if len(hdr) < 8:
            break
        tag, size = hdr[:4], struct.unpack("<I", hdr[4:])[0]
        chunk = f.read(size)
        if tag == b"fmt ":
            (_fmt, nchan, rate, _bps_rate, _block, bps) = struct.unpack(
                "<HHIIHH", chunk[:16])
        elif tag == b"data":
            data = chunk
            break
    if bps != 16:
        raise KaldiError(f"Only 16-bit PCM supported, got {bps}")
    samples = np.frombuffer(data, dtype="<i2").astype(np.float32)
    if nchan > 1:
        samples = samples.reshape(-1, nchan)[:, 0].copy()
    return samples, int(rate)


class _Holders:
    @staticmethod
    def write(holder: str, f, value, binary: bool) -> None:
        if holder == "cmat":
            # compressed feature matrix ("CM" entries, the
            # --compress=true archive format of steps/make_mfcc.sh)
            kio.init_kaldi_output_stream(f)
            kio.write_compressed_matrix(f, np.asarray(value))
        elif holder == "mat":
            if binary:
                kio.init_kaldi_output_stream(f)
                kio.write_matrix(f, value)
            else:
                mat = np.asarray(value)
                f.write(b" [\n")
                for row in mat:
                    f.write(("  " + " ".join(f"{x:.7g}" for x in row) + "\n").encode())
                f.write(b"]\n")
        elif holder == "vec":
            if binary:
                kio.init_kaldi_output_stream(f)
                kio.write_vector(f, value)
            else:
                f.write((" [ " + " ".join(f"{x:.7g}" for x in np.asarray(value)) +
                         " ]\n").encode())
        elif holder == "ivec":
            if binary:
                kio.init_kaldi_output_stream(f)
                kio.write_int_vector(f, value)
            else:
                f.write((" ".join(str(int(x)) for x in value) + "\n").encode())
        elif holder == "text":
            if isinstance(value, (list, tuple)):
                value = " ".join(value)
            f.write((value + "\n").encode())
        elif holder == "wav":
            _wav_write(f, value)
        elif holder == "clat":
            from kaldi_tpu_torch.lattice.io import write_compact_lattice
            write_compact_lattice(f, value)
        elif holder == "lat":
            from kaldi_tpu_torch.lattice.io import write_lattice
            write_lattice(f, value)
        elif holder == "fst":
            from kaldi_tpu_torch.fst.openfst_io import write_vector_fst
            write_vector_fst(f, value)
        elif holder == "ceg":
            from kaldi_tpu_torch.pipelines.egs_io import write_chain_eg
            kio.init_kaldi_output_stream(f)
            write_chain_eg(f, value)
        elif holder == "xeg":
            from kaldi_tpu_torch.pipelines.egs_io import write_xent_eg
            kio.init_kaldi_output_stream(f)
            write_xent_eg(f, value)
        elif holder == "deg":
            from kaldi_tpu_torch.pipelines.egs_io import write_disc_eg
            kio.init_kaldi_output_stream(f)
            write_disc_eg(f, value)
        elif holder == "dteg":
            from kaldi_tpu_torch.pipelines.egs_io import write_dense_eg
            kio.init_kaldi_output_stream(f)
            write_dense_eg(f, value)
        elif holder == "post":
            # per-frame [(id, weight), ...] lists (Posterior role)
            frames = list(value)
            kio.init_kaldi_output_stream(f)
            kio.write_basic_int32(f, len(frames))
            for frame in frames:
                kio.write_basic_int32(f, len(frame))
                for i, wgt in frame:
                    kio.write_basic_int32(f, int(i))
                    kio.write_basic_float(f, float(wgt))
        else:
            raise KaldiError(f"Unknown holder '{holder}'")

    @staticmethod
    def read(holder: str, f):
        if holder == "text":
            line = f.readline().decode()
            return line.split()
        if holder == "wav":
            return _wav_read(f)
        if holder == "clat":
            from kaldi_tpu_torch.lattice.io import read_compact_lattice
            return read_compact_lattice(f)
        if holder == "lat":
            from kaldi_tpu_torch.lattice.io import read_lattice
            return read_lattice(f)
        if holder == "fst":
            from kaldi_tpu_torch.fst.openfst_io import read_fst
            return read_fst(f)
        binary = kio.init_kaldi_input_stream(f)
        if holder == "ceg":
            from kaldi_tpu_torch.pipelines.egs_io import read_chain_eg
            return read_chain_eg(f)
        if holder == "xeg":
            from kaldi_tpu_torch.pipelines.egs_io import read_xent_eg
            return read_xent_eg(f)
        if holder == "deg":
            from kaldi_tpu_torch.pipelines.egs_io import read_disc_eg
            return read_disc_eg(f)
        if holder == "dteg":
            from kaldi_tpu_torch.pipelines.egs_io import read_dense_eg
            return read_dense_eg(f)
        if holder == "mat":
            return kio.read_matrix(f) if binary else _read_text_matrix(f)
        if holder == "vec":
            return kio.read_vector(f) if binary else _read_text_vector(f)
        if holder == "ivec":
            if binary:
                return kio.read_int_vector(f)
            line = f.readline().decode()
            return np.array([int(x) for x in line.split()], dtype=np.int32)
        if holder == "post":
            T = kio.read_basic_int32(f)
            out = []
            for _ in range(T):
                n = kio.read_basic_int32(f)
                out.append([(kio.read_basic_int32(f),
                             kio.read_basic_float(f)) for _ in range(n)])
            return out
        raise KaldiError(f"Unknown holder '{holder}'")


def _read_text_matrix(f) -> np.ndarray:
    rows: List[List[float]] = []
    tok = kio.read_token(f)
    if tok != "[":
        raise KaldiError(f"Expected '[' reading text matrix, got '{tok}'")
    cur: List[float] = []
    while True:
        chunk = f.readline().decode()
        if not chunk:
            raise KaldiError("EOF in text matrix")
        parts = chunk.split()
        done = False
        for p in parts:
            if p == "]":
                done = True
                break
            cur.append(float(p))
        rows.append(cur)
        cur = []
        if done:
            break
    rows = [r for r in rows if r]
    return np.array(rows, dtype=np.float32)


def _read_text_vector(f) -> np.ndarray:
    line = f.readline().decode()
    vals = [p for p in line.replace("[", " ").replace("]", " ").split()]
    return np.array([float(v) for v in vals], dtype=np.float32)


# ---------------------------------------------------------------------------
# Writers / readers
# ---------------------------------------------------------------------------

class TableWriter:
    def __init__(self, wspecifier: str, holder: str = "mat"):
        kind, opts, rest = _parse_specifier(wspecifier)
        self.holder = holder
        self.binary = "t" not in opts
        self._scp = None
        if kind == "ark" and "scp" in opts:
            ark_path, scp_path = rest.split(",", 1)
            self._cm = kio.open_wxfilename(ark_path)
            self._scp = open(scp_path, "w")
            self._ark_path = os.path.abspath(ark_path)
        elif kind == "ark":
            self._cm = kio.open_wxfilename(rest)
            self._ark_path = rest
        else:
            raise KaldiError("TableWriter needs an ark[,scp] wspecifier")
        self._f = self._cm.__enter__()

    def write(self, key: str, value) -> None:
        self._f.write((key + " ").encode())
        if self._scp is not None:
            self._f.flush()
            offset = self._f.tell()
            self._scp.write(f"{key} {self._ark_path}:{offset}\n")
        _Holders.write(self.holder, self._f, value, self.binary)

    def __setitem__(self, key: str, value) -> None:
        self.write(key, value)

    def close(self) -> None:
        self._cm.__exit__(None, None, None)
        if self._scp is not None:
            self._scp.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _read_key(f) -> Optional[str]:
    chars: List[bytes] = []
    c = f.read(1)
    while c in (b" ", b"\n", b"\t"):
        c = f.read(1)
    if c == b"":
        return None
    while c not in (b" ", b"\t", b""):
        chars.append(c)
        c = f.read(1)
    return b"".join(chars).decode()


class SequentialTableReader:
    """Iterates (key, value) pairs from an rspecifier."""

    def __init__(self, rspecifier: str, holder: str = "mat"):
        self.kind, self.opts, self.rest = _parse_specifier(rspecifier)
        self.holder = holder

    def __iter__(self) -> Iterator[Tuple[str, object]]:
        if self.kind == "ark":
            with kio.open_rxfilename(self.rest) as f:
                while True:
                    key = _read_key(f)
                    if key is None:
                        return
                    yield key, _Holders.read(self.holder, f)
        else:  # scp
            for key, rxfilename in read_scp(self.rest):
                with kio.open_rxfilename(rxfilename) as f:
                    yield key, _Holders.read(self.holder, f)


class RandomAccessTableReader:
    """Keyed lookup. scp is lazy (seek per key); ark is fully loaded."""

    def __init__(self, rspecifier: str, holder: str = "mat"):
        self.kind, self.opts, self.rest = _parse_specifier(rspecifier)
        self.holder = holder
        self._scp: Dict[str, str] = {}
        self._cache: Dict[str, object] = {}
        if self.kind == "scp":
            self._scp = dict(read_scp(self.rest))
        else:
            for key, val in SequentialTableReader(rspecifier, holder):
                self._cache[key] = val

    def __contains__(self, key: str) -> bool:
        return key in self._cache or key in self._scp

    def __getitem__(self, key: str):
        if key in self._cache:
            return self._cache[key]
        if key not in self._scp:
            raise KeyError(key)
        with kio.open_rxfilename(self._scp[key]) as f:
            val = _Holders.read(self.holder, f)
        self._cache[key] = val
        return val

    def keys(self):
        return list(self._cache) if self._cache else list(self._scp)


def read_scp(path: str) -> List[Tuple[str, str]]:
    out: List[Tuple[str, str]] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            key, _, rx = line.partition(" ")
            out.append((key, rx.strip()))
    return out
