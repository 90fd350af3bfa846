# Copied from kaldi_tpu/lattice/io.py; imports rewritten to kaldi_tpu_torch.
"""CompactLattice binary serialization for ark tables.

Parity target: src/lat/kaldi-lattice.h CompactLatticeHolder — lattices
as table values ('ark:|gzip -c > lat.1.gz' in decode scripts).
"""

from __future__ import annotations

from typing import BinaryIO

from kaldi_tpu_torch.core import io as kio
from kaldi_tpu_torch.core.logging import KaldiError
from kaldi_tpu_torch.lattice.lattice import (CompactArc, CompactLattice,
                                       Lattice, LatticeArc)


def write_compact_lattice(f: BinaryIO, clat: CompactLattice) -> None:
    kio.init_kaldi_output_stream(f)
    kio.write_token(f, "<CLat>")
    kio.write_basic_int32(f, clat.num_states)
    kio.write_basic_int32(f, clat.start)
    for s in range(clat.num_states):
        kio.write_basic_int32(f, len(clat.arcs[s]))
        for a in clat.arcs[s]:
            kio.write_basic_int32(f, a.word)
            kio.write_basic_float(f, a.graph_cost)
            kio.write_basic_float(f, a.acoustic_cost)
            kio.write_int_vector(f, list(a.tids))
            kio.write_basic_int32(f, a.nextstate)
    kio.write_basic_int32(f, len(clat.finals))
    for s, (gc, ac, tids) in sorted(clat.finals.items()):
        kio.write_basic_int32(f, s)
        kio.write_basic_float(f, gc)
        kio.write_basic_float(f, ac)
        kio.write_int_vector(f, list(tids))
    kio.write_token(f, "</CLat>")


def read_compact_lattice(f: BinaryIO) -> CompactLattice:
    if not kio.init_kaldi_input_stream(f):
        raise KaldiError("expected binary lattice")
    kio.expect_token(f, "<CLat>")
    n = kio.read_basic_int32(f)
    clat = CompactLattice()
    for _ in range(n):
        clat.add_state()
    clat.start = kio.read_basic_int32(f)
    for s in range(n):
        na = kio.read_basic_int32(f)
        for _ in range(na):
            word = kio.read_basic_int32(f)
            gc = kio.read_basic_float(f)
            ac = kio.read_basic_float(f)
            tids = tuple(kio.read_int_vector(f).tolist())
            ns = kio.read_basic_int32(f)
            clat.arcs[s].append(CompactArc(word, gc, ac, tids, ns))
    nf = kio.read_basic_int32(f)
    for _ in range(nf):
        s = kio.read_basic_int32(f)
        gc = kio.read_basic_float(f)
        ac = kio.read_basic_float(f)
        tids = tuple(kio.read_int_vector(f).tolist())
        clat.finals[s] = (gc, ac, tids)
    kio.expect_token(f, "</CLat>")
    return clat


def write_lattice(f: BinaryIO, lat: Lattice) -> None:
    """Raw state-level Lattice as a table value (kaldi-lattice.h
    LatticeHolder role — 'ark:...' tables of non-compact lattices,
    the lattice-determinize-non-compact / --write-compact=false
    format)."""
    kio.init_kaldi_output_stream(f)
    kio.write_token(f, "<Lat>")
    kio.write_basic_int32(f, lat.num_states)
    kio.write_basic_int32(f, lat.start)
    for s in range(lat.num_states):
        kio.write_basic_int32(f, len(lat.arcs[s]))
        for a in lat.arcs[s]:
            kio.write_basic_int32(f, a.ilabel)
            kio.write_basic_int32(f, a.olabel)
            kio.write_basic_float(f, a.graph_cost)
            kio.write_basic_float(f, a.acoustic_cost)
            kio.write_basic_int32(f, a.nextstate)
    kio.write_basic_int32(f, len(lat.finals))
    for s, (gc, ac) in sorted(lat.finals.items()):
        kio.write_basic_int32(f, s)
        kio.write_basic_float(f, gc)
        kio.write_basic_float(f, ac)
    kio.write_token(f, "</Lat>")


def read_lattice(f: BinaryIO) -> Lattice:
    if not kio.init_kaldi_input_stream(f):
        raise KaldiError("expected binary lattice")
    kio.expect_token(f, "<Lat>")
    n = kio.read_basic_int32(f)
    lat = Lattice()
    for _ in range(n):
        lat.add_state()
    lat.start = kio.read_basic_int32(f)
    for s in range(n):
        na = kio.read_basic_int32(f)
        for _ in range(na):
            il = kio.read_basic_int32(f)
            ol = kio.read_basic_int32(f)
            gc = kio.read_basic_float(f)
            ac = kio.read_basic_float(f)
            ns = kio.read_basic_int32(f)
            lat.arcs[s].append(LatticeArc(il, ol, gc, ac, ns))
    nf = kio.read_basic_int32(f)
    for _ in range(nf):
        s = kio.read_basic_int32(f)
        gc = kio.read_basic_float(f)
        ac = kio.read_basic_float(f)
        lat.finals[s] = (gc, ac)
    kio.expect_token(f, "</Lat>")
    return lat
