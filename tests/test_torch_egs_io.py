"""Chain egs archives (kaldi_tpu_torch/pipelines/egs_io.py and the port's
``ceg`` table holder) crossing to and from the JAX package's
pipelines/egs_io.py.  Arrays must come back exactly.
"""

import numpy as np
import pytest

from kaldi_tpu.am import chain as jc
from kaldi_tpu.am.topology import HmmTopology as JTopo
from kaldi_tpu.am.tree import MonophoneContextDependency as JMono
from kaldi_tpu.pipelines import chain as jpc
from kaldi_tpu.pipelines import egs_io as jeio
from kaldi_tpu_torch.core.table import SequentialTableReader, TableWriter
from kaldi_tpu_torch.pipelines import chain as tpc
from kaldi_tpu_torch.pipelines import egs_io as teio

FIELDS = ("feats", "pdf_ali", "mask", "entry_pdf", "self_pdf", "num_segs",
          "entry_w", "self_w", "init_w", "final_w")


def _egs():
    """Egs with segments and normalization weights (JAX-made; the port
    makes the same, tests/test_torch_chain_train.py)."""
    phones = [1, 2, 3]
    topo = JTopo.chain(phones)
    tree = JMono(phones, topo)
    den = jc.make_denominator_graph([[1, 2, 3, 1], [2, 3, 1]], tree, topo)
    rng = np.random.default_rng(0)
    runs = {f"u{i}": [(int(rng.integers(1, 4)), int(rng.integers(3, 9)))
                      for _ in range(10)] for i in range(3)}
    feats = {u: rng.standard_normal((sum(d for _, d in r), 4))
             .astype(np.float32) for u, r in runs.items()}
    return jpc.make_chain_egs(feats, runs, tree, topo, chunk_size=24,
                              subsample=3, den=den)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_egs_archive_crosses(tmp_path, writer):
    egs = _egs()
    spec = f"ark:{tmp_path}/egs.ark"
    if writer == "jax":
        assert jeio.write_egs_ark(spec, egs) == egs.feats.shape[0]
        back = teio.read_egs_ark(spec)
    else:
        port = tpc.ChainEgs(**{f: getattr(egs, f) for f in FIELDS})
        assert teio.write_egs_ark(spec, port) == egs.feats.shape[0]
        back = jeio.read_egs_ark(spec)
    for f in FIELDS:
        got, want = getattr(back, f), getattr(egs, f)
        if f in ("entry_pdf", "self_pdf", "entry_w", "self_w"):
            # an entry keeps its own segments; reading pads them to the
            # archive's longest, not to the chunk's frame count
            assert got.shape[1] == egs.num_segs.max()
            assert not want[:, got.shape[1]:].any()
            want = want[:, :got.shape[1]]
        np.testing.assert_array_equal(got, want, err_msg=f)


def test_egs_without_segments_round_trip(tmp_path):
    """Fixed-path egs (no segment arrays) through the port's table."""
    rng = np.random.default_rng(1)
    egs = tpc.ChainEgs(feats=rng.standard_normal((3, 12, 4))
                       .astype(np.float32),
                       pdf_ali=rng.integers(0, 6, (3, 4)).astype(np.int32),
                       mask=np.ones((3, 4), bool))
    teio.write_egs_ark(f"ark:{tmp_path}/e.ark", egs)
    back = jeio.read_egs_ark(f"ark:{tmp_path}/e.ark")
    assert back.entry_pdf is None
    np.testing.assert_array_equal(back.feats, egs.feats)
    np.testing.assert_array_equal(back.mask, egs.mask)


def test_supervision_fsas_are_not_ported(tmp_path):
    """Supervision FSAs, once unported here, now cross: an archive of
    FSA-carrying egs (lattice-derived, chunked, with normalization
    weights) written by either package reads back equal in the other,
    through ``egs_to_list`` / ``list_to_egs`` and ``ChainEgs.sup``; the
    dense-target holder crosses too, byte for byte."""
    from kaldi_tpu.am import chain_supervision as js
    from kaldi_tpu.am.transitions import TransitionModel as JTm
    from kaldi_tpu.lattice.lattice import CompactArc, CompactLattice
    phones = [1, 2, 3]
    topo = JTopo.chain(phones)
    tree = JMono(phones, topo)
    tm = JTm(topo, tree)
    den = jc.make_denominator_graph([[1, 2, 3, 1], [2, 3, 1]], tree, topo)
    fwd, slf = {}, {}
    for tid in range(1, tm.num_transition_ids + 1):
        (slf if tm.is_self_loop(tid) else fwd).setdefault(
            tm.transition_id_to_phone(tid), tid)

    def lattice(paths):
        c = CompactLattice()
        s0, s1 = c.add_state(), c.add_state()
        c.start = s0
        for i, path in enumerate(paths):
            tids = []
            for ph, d in path:
                tids.extend([fwd[ph]] + [slf[ph]] * (d - 1))
            c.arcs[s0].append(CompactArc(1, 0.5 * i, 0.0, tuple(tids), s1))
        c.finals[s1] = (0.0, 0.0, ())
        return c

    rng = np.random.default_rng(2)
    lats = {"a": lattice([[(1, 12), (2, 9), (3, 15)],
                          [(1, 9), (2, 12), (3, 15)]]),
            "b": lattice([[(3, 18), (1, 6), (2, 12)]])}
    feats = {u: rng.standard_normal((36, 4)).astype(np.float32)
             for u in lats}
    egs = js.make_chain_egs_from_lattices(feats, lats, tm, tree, topo,
                                          subsample=3, den=den, chunk_size=6)
    assert egs.sup["mid_start"].any()
    for writer in ("jax", "port"):
        spec = f"ark:{tmp_path}/{writer}.ark"
        if writer == "jax":
            jeio.write_egs_ark(spec, egs)
            back = teio.read_egs_ark(spec)
        else:
            port = tpc.ChainEgs(feats=egs.feats, pdf_ali=egs.pdf_ali,
                                mask=egs.mask, sup=egs.sup)
            teio.write_egs_ark(spec, port)
            back = jeio.read_egs_ark(spec)
        for f in ("feats", "pdf_ali", "mask"):
            np.testing.assert_array_equal(getattr(back, f), getattr(egs, f))
        assert back.entry_pdf is None
        assert set(back.sup) == set(egs.sup)
        for k, v in egs.sup.items():
            assert back.sup[k].dtype == v.dtype, k
            np.testing.assert_array_equal(back.sup[k], v, err_msg=k)
    with open(f"{tmp_path}/jax.ark", "rb") as a, \
            open(f"{tmp_path}/port.ark", "rb") as b:
        assert a.read() == b.read()
    from kaldi_tpu.core.table import TableWriter as JWriter
    eg = teio.egs_to_list(teio.read_egs_ark(f"ark:{tmp_path}/jax.ark"))[0]
    dense = dict(feats=eg.feats, targets=np.tanh(eg.feats[:, :2]))
    with TableWriter(f"ark:{tmp_path}/x.ark", holder="dteg") as w:
        w["a"] = teio.DenseEg(**dense)
    with JWriter(f"ark:{tmp_path}/jx.ark", holder="dteg") as w:
        w["a"] = jeio.DenseEg(**dense)
    with open(f"{tmp_path}/x.ark", "rb") as a, \
            open(f"{tmp_path}/jx.ark", "rb") as b:
        assert a.read() == b.read()


def test_ceg_holder_reads_one_entry_at_a_time(tmp_path):
    egs = _egs()
    jeio.write_egs_ark(f"ark:{tmp_path}/egs.ark", egs, prefix="x")
    keys = [k for k, eg in SequentialTableReader(f"ark:{tmp_path}/egs.ark",
                                                 holder="ceg")]
    assert keys == [f"x-{i:06d}" for i in range(egs.feats.shape[0])]
