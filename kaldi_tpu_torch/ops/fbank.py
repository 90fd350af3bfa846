"""Fused log-mel fbank: the CUDA kernel's wrapper and its plain version.

Port of kaldi_tpu/ops/pallas_frontend.py.  ``CudaFbank`` holds the
constant tables (window, DFT cos/sin, mel) and the kernel's layout of
them on one device.  Called on a CUDA tensor it launches
``kt_fbank_logmel`` (csrc/fbank.cu) on the current stream; called on a
CPU tensor it runs ``fbank_reference``, the same math as PyTorch
products.  There is no fallback between the two.

The kernel splits the work by mel filter group (``mel_groups``): a group
is a run of filters whose nonzero DFT bins, together, span about
``GROUP_BINS`` bins, and it reads the interleaved cos/sin columns of
those bins only (``group_tables``), split into TF32 hi/lo halves in
mma.sync fragment order (ops/tf32.py).

A group holds at most ``PIECE_BINS`` bins of one filter.  A bank with a
wider filter (at 16 kHz, 17 mel bins or fewer) is cut into pieces of at
most that many bins (``split_filters``); the kernel then writes each
piece's linear energy, with no floor and no log, and a second kernel
(``kt_fbank_sum_pieces``) sums each filter's pieces in bin order, then
floors and takes the log as ``fbank_reference`` does.  A bank with no
such filter keeps the one launch.
"""

from __future__ import annotations

import ctypes
import math
import threading

import numpy as np
import torch

from kaldi_tpu_torch.device import resolve_device
from kaldi_tpu_torch.features.mel import MelBanks, MelBanksOptions
from kaldi_tpu_torch.features.window import (FrameExtractionOptions,
                                             feature_window_function)
from kaldi_tpu_torch.ops import build
from kaldi_tpu_torch.ops.tf32 import fragment_order

_EPS = float(np.finfo(np.float32).tiny)
# target DFT bins per mel filter group: 8 groups at n_fft 512, 4 at 256
GROUP_BINS = 32
# csrc/fbank.cu FB_MAX_TILES: a group spans at most 16 n-tiles of 4 bins
MAX_GROUP_TILES = 16
# csrc/fbank.cu FB_MELW: a group's filters have at most 128 weights
MAX_GROUP_WEIGHTS = 128
# the widest filter piece a group takes
PIECE_BINS = 4 * MAX_GROUP_TILES


def dft_matrices(n_fft: int, n_bins: int):
    """(n_fft, n_bins) float32 cos and sin tables of the real DFT
    (``_dft_matrices`` of the original)."""
    k = np.arange(n_fft)[:, None]
    f = np.arange(n_bins)[None, :]
    ang = -2.0 * math.pi * k * f / n_fft
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


def fbank_reference(frames: torch.Tensor, window: torch.Tensor,
                    cosm: torch.Tensor, sinm: torch.Tensor,
                    mel: torch.Tensor, logfloor: float = _EPS,
                    use_power: bool = True, use_log: bool = True
                    ) -> torch.Tensor:
    """Plain PyTorch version of the kernel (``fbank_xla`` of the
    original): log(max(((f·w)·C)² + ((f·w)·S)²) · Mel, floor)); with
    ``use_power`` off the magnitude (the square root of the power) goes
    into the mel product, and with ``use_log`` off the floored mel
    energies come out without the log (the reference ``Fbank``'s
    ``use_power`` and ``use_log_fbank``)."""
    fw = frames * window[None, :]
    re = fw @ cosm
    im = fw @ sinm
    power = re * re + im * im
    if not use_power:
        power = torch.sqrt(power)
    mel_e = torch.clamp_min(power @ mel, logfloor)
    return torch.log(mel_e) if use_log else mel_e


def filter_ranges(mel: np.ndarray) -> np.ndarray:
    """(n_bins, n_mel) mel matrix → (n_mel, 2) int32: each filter's
    nonzero DFT bins [lo, hi) (contiguous for a triangular filter; an
    all-zero filter gets an empty range)."""
    nz = mel != 0
    out = np.zeros((mel.shape[1], 2), np.int32)
    for m in range(mel.shape[1]):
        idx = np.flatnonzero(nz[:, m])
        if len(idx):
            out[m] = idx[0], idx[-1] + 1
    return out


def filter_weights(mel: np.ndarray, franges: np.ndarray):
    """Each filter's weights over its nonzero bins, one run after
    another in filter order: (flat float32, (n_mel,) int32 offsets)."""
    runs = [mel[lo:hi, m] for m, (lo, hi) in enumerate(franges)]
    offsets = np.cumsum([0] + [len(r) for r in runs[:-1]]).astype(np.int32)
    return np.concatenate(runs).astype(np.float32), offsets


def mel_groups(franges: np.ndarray, target_bins: int = GROUP_BINS
               ) -> np.ndarray:
    """Split the filters into runs whose bin ranges balance bins, not
    filters: filter m goes to group ⌊(centre_m − lo) · G / span⌋ of G
    equal slices of the spectrum, G the span over ``target_bins`` (more
    if a group would pass MAX_GROUP_TILES or MAX_GROUP_WEIGHTS).  → (G,
    4) int32 rows (first bin, n-tiles of 4 bins, first filter, end
    filter).  The filters' centres must not decrease.  A filter wider
    than one group can hold raises ValueError: ``split_filters`` cuts
    such filters first."""
    lo, hi = franges[:, 0], franges[:, 1]
    live = hi > lo
    widest = int((hi - lo).max())
    if -(-widest // 4) > MAX_GROUP_TILES or widest > MAX_GROUP_WEIGHTS:
        # no group could hold that filter alone
        raise ValueError(f"a filter spans {widest} DFT bins; the fbank "
                         f"kernel takes at most {4 * MAX_GROUP_TILES}")
    start, stop = int(lo[live].min()), int(hi[live].max())
    span = stop - start
    centre = np.where(live, (lo + hi) / 2.0, start)
    G = max(1, int(round(span / target_bins)))
    while True:
        gi = np.minimum(((centre - start) * G / span).astype(np.int64),
                        G - 1)
        rows = []
        for g in np.unique(gi):
            ms = np.flatnonzero(gi == g)
            m0, m1 = int(ms[0]), int(ms[-1]) + 1
            sel = live[m0:m1]
            k0 = int(lo[m0:m1][sel].min()) if sel.any() else start
            k1 = int(hi[m0:m1][sel].max()) if sel.any() else start
            rows.append((k0, max(1, -(-(k1 - k0) // 4)), m0, m1,
                         int((hi[m0:m1] - lo[m0:m1]).sum())))
        if (max(r[1] for r in rows) <= MAX_GROUP_TILES
                and max(r[4] for r in rows) <= MAX_GROUP_WEIGHTS):
            return np.array([r[:4] for r in rows], np.int32)
        if G > 2 * span + 1:
            # slices under half a bin part every two distinct centres:
            # only filters sharing one centre are left together
            raise ValueError("filters sharing a centre pass a group's "
                             f"{MAX_GROUP_WEIGHTS} weights")
        G += 1


def split_filters(mel: np.ndarray, franges: np.ndarray):
    """Cut every filter wider than PIECE_BINS bins into near-equal
    pieces of at most that many, one column each, the columns ordered
    by centre (as ``mel_groups`` needs them).  → (columns (n_bins,
    n_cols) float32, piece_off (n_mel + 1,) int32, piece_cols (n_cols,)
    int32): filter m's pieces are columns piece_cols[piece_off[m]:
    piece_off[m + 1]], in bin order.  A bank with no such filter gives
    (mel, None, None)."""
    width = franges[:, 1] - franges[:, 0]
    if width.max() <= PIECE_BINS:
        return mel, None, None
    pieces = []                                  # (centre, filter, lo, hi)
    for m, (lo, hi) in enumerate(franges):
        n = max(1, -(-int(hi - lo) // PIECE_BINS))
        cuts = lo + ((hi - lo) * np.arange(n + 1)) // n
        for a, b in zip(cuts[:-1], cuts[1:]):
            pieces.append(((a + b) / 2.0 if b > a else -1.0, m, a, b))
    order = sorted(range(len(pieces)), key=lambda i: pieces[i][0])
    cols = np.zeros((mel.shape[0], len(pieces)), np.float32)
    owner = np.zeros(len(pieces), np.int64)
    for c, i in enumerate(order):
        _, m, a, b = pieces[i]
        cols[a:b, c] = mel[a:b, m]
        owner[c] = m
    piece_cols = np.argsort(owner, kind="stable").astype(np.int32)
    piece_off = np.searchsorted(owner[piece_cols],
                                np.arange(mel.shape[1] + 1)).astype(np.int32)
    return cols, piece_off, piece_cols


def group_tables(cosm: np.ndarray, sinm: np.ndarray, groups: np.ndarray,
                 kp: int):
    """The DFT tables the kernel reads: for each group, the (kp × 8·nt)
    matrix whose column 2c is cos and 2c + 1 sin of bin k0 + c (rows
    past the window and bins past the last are zero), in fragment order.
    → (flat float32 tables, (G,) int32 offsets in floats)."""
    win, n_bins = cosm.shape
    pad = 4 * MAX_GROUP_TILES
    cs = np.zeros((kp, n_bins + pad, 2), np.float32)
    cs[:win, :n_bins, 0] = cosm
    cs[:win, :n_bins, 1] = sinm
    parts, offsets, off = [], [], 0
    for k0, nt, _, _ in groups:
        b = torch.from_numpy(np.ascontiguousarray(
            cs[:, k0:k0 + 4 * nt].reshape(kp, 8 * nt)))
        f = fragment_order(b).reshape(-1)
        parts.append(f)
        offsets.append(off)
        off += f.numel()
    return torch.cat(parts), np.array(offsets, np.int32)


# guards the ctypes declarations and the launch counts: the servers'
# handler threads launch the kernel concurrently
_LOCK = threading.Lock()


def _load():
    lib = build.load_library("kt_fbank", build.KERNELS["kt_fbank"])
    fn, fsum = lib.kt_fbank_logmel, lib.kt_fbank_sum_pieces
    with _LOCK:
        if fsum.argtypes is None:
            # pointers and the stream as c_void_p: undeclared, ctypes
            # would pass each Python int as a 32-bit int and cut the
            # address
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 \
                + [ctypes.c_void_p]
            fsum.restype = ctypes.c_int
            fsum.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 \
                + [ctypes.c_void_p]
    return fn, fsum


class CudaFbank:
    """Log-mel fbank of pre-processed frames (N, window_size) float32
    → (N, num_bins): of the power spectrum, or of the magnitude with
    ``use_power`` off; linear mel energies with ``use_log`` off.
    ``filters`` (n_fft/2 + 1, n_out) float32, nonnegative, replaces the
    mel bank (default ``MelBanks(mel_opts, frame_opts).matrix.T``): the
    identity gives the log power spectrum (``Spectrogram``).
    ``launches`` counts launches of the fbank kernel, ``sum_launches``
    those of the kernel that sums a wide bank's pieces; the class's
    ``total_launches`` and ``total_sum_launches`` count those of every
    instance (a recipe makes its own computers)."""

    total_launches = 0
    total_sum_launches = 0

    def __init__(self, frame_opts: FrameExtractionOptions = None,
                 mel_opts: MelBanksOptions = None,
                 device: torch.device | str = "cuda",
                 use_power: bool = True, use_log: bool = True,
                 filters: np.ndarray | None = None):
        fo = frame_opts or FrameExtractionOptions()
        mo = mel_opts or MelBanksOptions()
        self.device = resolve_device(device)
        self.use_power, self.use_log = bool(use_power), bool(use_log)
        self.win_size = fo.window_size
        self.kp = -(-self.win_size // 8) * 8
        n_fft = fo.padded_window_size
        self.n_bins = n_fft // 2 + 1
        # frames are zero-padded from window_size to n_fft, so only the
        # first window_size rows of the DFT tables ever multiply data
        cosm, sinm = dft_matrices(n_fft, self.n_bins)
        cosm, sinm = cosm[:self.win_size], sinm[:self.win_size]
        if filters is None:
            mel = MelBanks(mo, fo).matrix.T             # (n_bins, n_mel)
        else:
            mel = np.asarray(filters, np.float32)
            if mel.ndim != 2 or mel.shape[0] != self.n_bins \
                    or (mel < 0).any():
                raise ValueError(f"filters must be ({self.n_bins}, n_out) "
                                 "and nonnegative")
        self.n_mel = mel.shape[1]
        # the kernel's columns: the filters, or their pieces
        cols, piece_off, piece_cols = split_filters(mel,
                                                    filter_ranges(mel))
        self.n_cols = cols.shape[1]
        self.franges = filter_ranges(cols)
        melw, woff = filter_weights(cols, self.franges)
        groups = mel_groups(self.franges)
        tables, offsets = group_tables(cosm, sinm, groups, self.kp)
        self.groups = np.concatenate([groups, offsets[:, None]], axis=1)

        def dev(a):
            if isinstance(a, np.ndarray):
                a = torch.from_numpy(np.ascontiguousarray(a))
            return a.to(self.device)

        self.window = dev(feature_window_function(fo))
        self.cos = dev(cosm)
        self.sin = dev(sinm)
        self.mel = dev(mel)
        self.tables = dev(tables)
        self.groups_dev = dev(self.groups)
        # per filter (lo, hi, offset of its weights in melw)
        self.franges_dev = dev(np.concatenate([self.franges, woff[:, None]],
                                              axis=1))
        self.melw = dev(melw)
        self.piece_off = self.piece_cols = None
        if piece_off is not None:
            self.piece_off, self.piece_cols = dev(piece_off), dev(piece_cols)
        # "cuda" → "cuda:<current>", so that it compares equal to the
        # device of a tensor moved there
        self.device = self.mel.device
        self.launches = 0
        self.sum_launches = 0

    def reference(self, frames: torch.Tensor) -> torch.Tensor:
        """The plain version on this computer's tables."""
        return fbank_reference(frames, self.window, self.cos, self.sin,
                               self.mel, use_power=self.use_power,
                               use_log=self.use_log)

    def __call__(self, frames: torch.Tensor) -> torch.Tensor:
        if frames.dim() != 2 or frames.shape[1] != self.win_size:
            raise ValueError(f"frames must be (N, {self.win_size}), got "
                             f"{tuple(frames.shape)}")
        if frames.dtype != torch.float32:
            raise TypeError(f"frames must be float32, got {frames.dtype}")
        if frames.device != self.device:
            raise ValueError(f"frames on {frames.device}, tables on "
                             f"{self.device}")
        if frames.device.type == "cpu":
            return self.reference(frames)
        if frames.device.type != "cuda":
            raise ValueError(f"unsupported device {frames.device}")
        if not frames.is_contiguous():
            raise ValueError("frames must be contiguous")
        fn, fsum = _load()
        n = frames.shape[0]
        out = torch.empty((n, self.n_mel), dtype=torch.float32,
                          device=frames.device)
        wide = self.piece_off is not None
        parts = torch.empty((n, self.n_cols), dtype=torch.float32,
                            device=frames.device) if wide else out
        stream = torch.cuda.current_stream(frames.device).cuda_stream
        rc = fn(frames.data_ptr(), self.window.data_ptr(),
                self.tables.data_ptr(), self.groups_dev.data_ptr(),
                self.franges_dev.data_ptr(), self.melw.data_ptr(),
                parts.data_ptr(), n, self.win_size, self.kp,
                len(self.groups), self.n_cols, int(self.use_power),
                int(self.use_log), int(wide), stream)
        if rc != 0:
            raise RuntimeError(f"kt_fbank_logmel failed: cudaError {rc}")
        with _LOCK:
            self.launches += 1
            CudaFbank.total_launches += 1
        if wide:
            rc = fsum(parts.data_ptr(), self.piece_off.data_ptr(),
                      self.piece_cols.data_ptr(), out.data_ptr(), n,
                      self.n_cols, self.n_mel, int(self.use_log), stream)
            if rc != 0:
                raise RuntimeError(f"kt_fbank_sum_pieces failed: "
                                   f"cudaError {rc}")
            with _LOCK:
                self.sum_launches += 1
                CudaFbank.total_sum_launches += 1
        return out
