"""Chain training-example (egs) archives.

Port of the chain part of kaldi_tpu/pipelines/egs_io.py (``ChainEg``,
``write_chain_eg``, ``read_chain_eg``, ``egs_to_list``, ``list_to_egs``,
``write_egs_ark``, ``read_egs_ark``), host numpy in the original's wire
format: an archive written by either package reads in the other.  One
entry (holder ``ceg``) is one fixed-size chunk: feats, the fixed-path
pdf alignment and mask, the flexible-boundary segments with their
normalization weights, and optionally a whole supervision FSA
(lattice-derived or end-to-end, am/chain_supervision.py; the wire format
carries no phone array, so an FSA read back has ``phone=None``, as in
the original).  ``XentEg`` (holder ``xeg``) is the cross-entropy egs'
entry, the x-vector egs' too.  ``DiscEg`` (holder ``deg``) is the
discriminative (sequence-training) egs' entry, written through the
original's ``write_pytree`` format.  ``DenseEg`` (holder ``dteg``) is a
chunk with dense float targets (nnet3-get-egs-dense-targets); the
original has no trainer that reads them.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from kaldi_tpu_torch.am.chain_supervision import (SupervisionFsa,
                                                  pack_supervisions)
from kaldi_tpu_torch.core import io as kio
from kaldi_tpu_torch.core.logging import KaldiError, get_logger
from kaldi_tpu_torch.core.table import SequentialTableReader, TableWriter
from kaldi_tpu_torch.pipelines.chain import ChainEgs

log = get_logger(__name__)


@dataclasses.dataclass
class ChainEg:
    """One chunk (one archive entry)."""
    feats: np.ndarray            # (T, D) f32
    pdf_ali: np.ndarray          # (T // sub,) i32
    mask: np.ndarray             # (T // sub,) bool
    entry_pdf: Optional[np.ndarray] = None   # (S,) i32
    self_pdf: Optional[np.ndarray] = None    # (S,) i32
    entry_w: Optional[np.ndarray] = None     # (S,) f32
    self_w: Optional[np.ndarray] = None      # (S,) f32
    init_w: float = 0.0
    final_w: float = 0.0
    # full supervision FSA (lattice-derived / e2e egs): a
    # chain_supervision.SupervisionFsa; overrides the linear-segment
    # numerator when present
    fsa: Optional[SupervisionFsa] = None


def write_chain_eg(f, eg: ChainEg) -> None:
    kio.write_token(f, "<ChainEg>")
    kio.write_token(f, "<Feats>")
    kio.write_matrix(f, np.asarray(eg.feats, np.float32))
    kio.write_token(f, "<PdfAli>")
    kio.write_int_vector(f, np.asarray(eg.pdf_ali, np.int32))
    kio.write_token(f, "<Mask>")
    kio.write_int_vector(f, np.asarray(eg.mask, np.int32))
    has_segs = eg.entry_pdf is not None
    kio.write_token(f, "<NumSegs>")
    kio.write_basic_int32(f, len(eg.entry_pdf) if has_segs else 0)
    if has_segs:
        kio.write_token(f, "<EntryPdf>")
        kio.write_int_vector(f, np.asarray(eg.entry_pdf, np.int32))
        kio.write_token(f, "<SelfPdf>")
        kio.write_int_vector(f, np.asarray(eg.self_pdf, np.int32))
        kio.write_token(f, "<EntryW>")
        kio.write_vector(f, np.asarray(eg.entry_w, np.float32))
        kio.write_token(f, "<SelfW>")
        kio.write_vector(f, np.asarray(eg.self_w, np.float32))
        kio.write_token(f, "<InitW>")
        kio.write_basic_float(f, float(eg.init_w))
        kio.write_token(f, "<FinalW>")
        kio.write_basic_float(f, float(eg.final_w))
    kio.write_token(f, "<HasFsa>")
    kio.write_basic_int32(f, 1 if eg.fsa is not None else 0)
    if eg.fsa is not None:
        fsa = eg.fsa
        zeros = np.zeros(len(fsa.src))
        kio.write_int_vector(f, np.asarray(fsa.src, np.int32))
        kio.write_int_vector(f, np.asarray(fsa.dst, np.int32))
        kio.write_int_vector(f, np.asarray(fsa.entry_pdf, np.int32))
        kio.write_int_vector(f, np.asarray(fsa.self_pdf, np.int32))
        kio.write_vector(f, np.asarray(fsa.weight, np.float32))
        kio.write_vector(f, np.asarray(
            fsa.self_w if fsa.self_w is not None else zeros, np.float32))
        kio.write_vector(f, np.asarray(
            fsa.final_w if fsa.final_w is not None else zeros, np.float32))
        kio.write_int_vector(f, np.asarray(fsa.bt, np.int32))
        kio.write_int_vector(f, np.asarray(fsa.final, np.int32))
        kio.write_basic_int32(f, int(fsa.start))
        kio.write_basic_int32(f, int(fsa.num_frames))
        kio.write_basic_int32(f, int(fsa.mid_start))
        kio.write_basic_int32(f, int(fsa.mid_end))
    kio.write_token(f, "</ChainEg>")


def read_chain_eg(f) -> ChainEg:
    kio.expect_token(f, "<ChainEg>")
    kio.expect_token(f, "<Feats>")
    feats = kio.read_matrix(f)
    kio.expect_token(f, "<PdfAli>")
    pdf_ali = kio.read_int_vector(f)
    kio.expect_token(f, "<Mask>")
    mask = kio.read_int_vector(f).astype(bool)
    kio.expect_token(f, "<NumSegs>")
    n = kio.read_basic_int32(f)
    eg = ChainEg(feats=feats, pdf_ali=pdf_ali, mask=mask)
    if n:
        kio.expect_token(f, "<EntryPdf>")
        eg.entry_pdf = kio.read_int_vector(f)
        kio.expect_token(f, "<SelfPdf>")
        eg.self_pdf = kio.read_int_vector(f)
        kio.expect_token(f, "<EntryW>")
        eg.entry_w = kio.read_vector(f)
        kio.expect_token(f, "<SelfW>")
        eg.self_w = kio.read_vector(f)
        kio.expect_token(f, "<InitW>")
        eg.init_w = kio.read_basic_float(f)
        kio.expect_token(f, "<FinalW>")
        eg.final_w = kio.read_basic_float(f)
        if len(eg.entry_pdf) != n:
            raise KaldiError(f"ChainEg: NumSegs {n} != segment array "
                             f"length {len(eg.entry_pdf)}")
    kio.expect_token(f, "<HasFsa>")
    if kio.read_basic_int32(f):
        src = kio.read_int_vector(f)
        dst = kio.read_int_vector(f)
        epdf = kio.read_int_vector(f)
        spdf = kio.read_int_vector(f)
        weight = np.asarray(kio.read_vector(f), np.float32)
        self_w = np.asarray(kio.read_vector(f), np.float32)
        final_w = np.asarray(kio.read_vector(f), np.float32)
        bt = kio.read_int_vector(f)
        final = kio.read_int_vector(f).astype(bool)
        start = kio.read_basic_int32(f)
        num_frames = kio.read_basic_int32(f)
        mid_start = bool(kio.read_basic_int32(f))
        mid_end = bool(kio.read_basic_int32(f))
        eg.fsa = SupervisionFsa(
            src=src, dst=dst, entry_pdf=epdf, self_pdf=spdf,
            weight=weight, bt=bt, start=start, final=final,
            num_frames=num_frames, self_w=self_w, final_w=final_w,
            mid_start=mid_start, mid_end=mid_end)
    kio.expect_token(f, "</ChainEg>")
    return eg


def egs_to_list(egs: ChainEgs) -> List[ChainEg]:
    """Unstack a batched ChainEgs into per-chunk entries (dropping
    per-chunk segment padding: num_segs gives each true length)."""
    out = []
    has_segs = egs.entry_pdf is not None
    sup = egs.sup
    for i in range(egs.feats.shape[0]):
        eg = ChainEg(feats=egs.feats[i], pdf_ali=egs.pdf_ali[i],
                     mask=egs.mask[i])
        if has_segs:
            s = int(egs.num_segs[i])
            eg.entry_pdf = egs.entry_pdf[i, :s]
            eg.self_pdf = egs.self_pdf[i, :s]
            eg.entry_w = egs.entry_w[i, :s]
            eg.self_w = egs.self_w[i, :s]
            eg.init_w = float(egs.init_w[i])
            eg.final_w = float(egs.final_w[i])
        if sup is not None:
            a = int(sup["n_arcs"][i])
            ns = int(sup["n_states"][i])
            eg.fsa = SupervisionFsa(
                src=sup["src"][i, :a], dst=sup["dst"][i, :a],
                entry_pdf=sup["entry_pdf"][i, :a],
                self_pdf=sup["self_pdf"][i, :a],
                weight=sup["weight"][i, :a],
                bt=sup["bt"][i, :ns], start=int(sup["start"][i]),
                final=sup["final"][i, :ns],
                num_frames=int(sup["num_frames"][i]),
                self_w=sup["self_w"][i, :a],
                final_w=sup["final_w"][i, :a],
                mid_start=bool(sup["mid_start"][i]),
                mid_end=bool(sup["mid_end"][i]))
        out.append(eg)
    return out


def list_to_egs(entries: List[ChainEg]) -> ChainEgs:
    """Stack archive entries back into the batched ChainEgs tensors,
    re-padding segment arrays to the batch max."""
    if not entries:
        raise KaldiError("empty egs archive")
    feats = np.stack([e.feats for e in entries])
    pdf_ali = np.stack([e.pdf_ali for e in entries])
    mask = np.stack([e.mask for e in entries])
    sup = None
    if entries[0].fsa is not None:
        sup = pack_supervisions([e.fsa for e in entries])
    if entries[0].entry_pdf is None:
        return ChainEgs(feats=feats, pdf_ali=pdf_ali, mask=mask, sup=sup)
    smax = max(len(e.entry_pdf) for e in entries)

    def pad_i(a):
        return np.pad(a, (0, smax - len(a)))

    return ChainEgs(
        feats=feats, pdf_ali=pdf_ali, mask=mask,
        entry_pdf=np.stack([pad_i(e.entry_pdf) for e in entries]),
        self_pdf=np.stack([pad_i(e.self_pdf) for e in entries]),
        num_segs=np.array([len(e.entry_pdf) for e in entries],
                          np.int32),
        entry_w=np.stack([pad_i(e.entry_w).astype(np.float32)
                          for e in entries]),
        self_w=np.stack([pad_i(e.self_w).astype(np.float32)
                         for e in entries]),
        init_w=np.array([e.init_w for e in entries], np.float32),
        final_w=np.array([e.final_w for e in entries], np.float32),
        sup=sup)


def write_egs_ark(wspecifier: str, egs: ChainEgs,
                  prefix: str = "eg") -> int:
    """ChainEgs → archive (the get_egs.sh output contract)."""
    n = 0
    with TableWriter(wspecifier, holder="ceg") as w:
        for i, eg in enumerate(egs_to_list(egs)):
            w[f"{prefix}-{i:06d}"] = eg
            n += 1
    log.info("wrote %d chain egs to %s", n, wspecifier)
    return n


def read_egs_ark(rspecifier: str) -> ChainEgs:
    """Archive → ChainEgs ready for ChainTrainer.train."""
    entries = [eg for _, eg in
               SequentialTableReader(rspecifier, holder="ceg")]
    log.info("read %d chain egs from %s", len(entries), rspecifier)
    return list_to_egs(entries)


# Copied from kaldi_tpu/pipelines/egs_io.py XentEg.
@dataclasses.dataclass
class XentEg:
    """One cross-entropy training chunk (nnet3bin/nnet3-get-egs role):
    a minibatch of B chunks of T frames with per-frame pdf targets."""
    feats: np.ndarray            # (B, T, D) f32
    pdfs: np.ndarray             # (B, T) i32


# Copied from kaldi_tpu/pipelines/egs_io.py write_xent_eg.
def write_xent_eg(f, eg: XentEg) -> None:
    feats = np.asarray(eg.feats, np.float32)
    pdfs = np.asarray(eg.pdfs, np.int32)
    if feats.ndim != 3 or pdfs.shape != feats.shape[:2]:
        raise KaldiError("XentEg: feats must be (B,T,D), pdfs (B,T)")
    B, T, D = feats.shape
    kio.write_token(f, "<XentEg>")
    kio.write_basic_int32(f, B)
    kio.write_basic_int32(f, T)
    kio.write_token(f, "<Feats>")
    kio.write_matrix(f, feats.reshape(B * T, D))
    kio.write_token(f, "<Pdfs>")
    kio.write_int_vector(f, pdfs.reshape(-1))
    kio.write_token(f, "</XentEg>")


# Copied from kaldi_tpu/pipelines/egs_io.py read_xent_eg.
def read_xent_eg(f) -> XentEg:
    kio.expect_token(f, "<XentEg>")
    B = kio.read_basic_int32(f)
    T = kio.read_basic_int32(f)
    kio.expect_token(f, "<Feats>")
    feats = np.asarray(kio.read_matrix(f), np.float32)
    kio.expect_token(f, "<Pdfs>")
    pdfs = np.asarray(kio.read_int_vector(f), np.int32)
    kio.expect_token(f, "</XentEg>")
    return XentEg(feats.reshape(B, T, -1), pdfs.reshape(B, T))


# Copied from kaldi_tpu/pipelines/egs_io.py DenseEg.
@dataclasses.dataclass
class DenseEg:
    """Training chunk with DENSE (float-matrix) targets — regression
    or soft-label training (nnet3bin/nnet3-get-egs-dense-targets
    NnetExample shape): feats (T, D), targets (T', Dt)."""
    feats: np.ndarray
    targets: np.ndarray


# Copied from kaldi_tpu/pipelines/egs_io.py write_dense_eg.
def write_dense_eg(f, eg: DenseEg) -> None:
    kio.write_token(f, "<DenseEg>")
    kio.write_token(f, "<Feats>")
    kio.write_matrix(f, np.asarray(eg.feats, np.float32))
    kio.write_token(f, "<Targets>")
    kio.write_matrix(f, np.asarray(eg.targets, np.float32))
    kio.write_token(f, "</DenseEg>")


# Copied from kaldi_tpu/pipelines/egs_io.py read_dense_eg.
def read_dense_eg(f) -> DenseEg:
    kio.expect_token(f, "<DenseEg>")
    kio.expect_token(f, "<Feats>")
    feats = np.asarray(kio.read_matrix(f), np.float32)
    kio.expect_token(f, "<Targets>")
    targets = np.asarray(kio.read_matrix(f), np.float32)
    kio.expect_token(f, "</DenseEg>")
    return DenseEg(feats, targets)


# Copied from kaldi_tpu/pipelines/egs_io.py DiscEg.
@dataclasses.dataclass
class DiscEg:
    """One discriminative (sequence-training) example: an utterance's
    feats + numerator pdf alignment + its DENSE denominator lattice
    (nnet3/nnet-discriminative-example.h NnetDiscriminativeExample
    role; the lattice is stored pre-compiled to the padded
    time-synchronous arrays am/discriminative.DenseLattice trains
    on)."""
    feats: np.ndarray            # (T, D) f32
    num_ali: np.ndarray          # (T,) i32
    src: np.ndarray              # (T, A) i32
    dst: np.ndarray              # (T, A) i32
    pdf: np.ndarray              # (T, A) i32
    w: np.ndarray                # (T, A) f32
    mask: np.ndarray             # (T, A) f32
    final: np.ndarray            # (K,) f32

    def dense_lattice(self):
        from kaldi_tpu_torch.am.discriminative import DenseLattice
        return DenseLattice(src=self.src, dst=self.dst, pdf=self.pdf,
                            w=self.w, mask=self.mask, final=self.final,
                            num_states=None)


# Copied from kaldi_tpu/pipelines/egs_io.py write_disc_eg.
def write_disc_eg(f, eg: DiscEg) -> None:
    from kaldi_tpu_torch.am.serialize import write_pytree
    kio.write_token(f, "<DiscEg>")
    write_pytree(f, {
        "feats": np.asarray(eg.feats, np.float32),
        "num_ali": np.asarray(eg.num_ali, np.int32),
        "src": np.asarray(eg.src, np.int32),
        "dst": np.asarray(eg.dst, np.int32),
        "pdf": np.asarray(eg.pdf, np.int32),
        "w": np.asarray(eg.w, np.float32),
        "mask": np.asarray(eg.mask, np.float32),
        "final": np.asarray(eg.final, np.float32)})
    kio.write_token(f, "</DiscEg>")


# Copied from kaldi_tpu/pipelines/egs_io.py read_disc_eg.
def read_disc_eg(f) -> DiscEg:
    from kaldi_tpu_torch.am.serialize import read_pytree
    kio.expect_token(f, "<DiscEg>")
    d = read_pytree(f)
    kio.expect_token(f, "</DiscEg>")
    return DiscEg(**d)
