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
from kaldi_tpu_torch.core.logging import KaldiError
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
    """An eg the JAX package wrote with a lattice-derived supervision FSA
    raises in the port's reader, and the other training holders stay
    unported."""
    from kaldi_tpu.am.chain_supervision import SupervisionFsa
    from kaldi_tpu.core.table import TableWriter as JTableWriter
    one = np.zeros(1, np.int32)
    fsa = SupervisionFsa(src=one, dst=one + 1, entry_pdf=one, self_pdf=one,
                         weight=np.zeros(1, np.float32),
                         bt=np.zeros(2, np.int32), start=0,
                         final=np.array([False, True]), num_frames=1)
    eg = jeio.ChainEg(feats=np.zeros((3, 2), np.float32), pdf_ali=one,
                      mask=np.ones(1, bool), fsa=fsa)
    with JTableWriter(f"ark:{tmp_path}/f.ark", holder="ceg") as w:
        w["a"] = eg
    with pytest.raises(KaldiError, match="not ported"):
        teio.read_egs_ark(f"ark:{tmp_path}/f.ark")
    with pytest.raises(KaldiError, match="not ported"):
        with TableWriter(f"ark:{tmp_path}/x.ark", holder="xeg") as w:
            w["a"] = eg


def test_ceg_holder_reads_one_entry_at_a_time(tmp_path):
    egs = _egs()
    jeio.write_egs_ark(f"ark:{tmp_path}/egs.ark", egs, prefix="x")
    keys = [k for k, eg in SequentialTableReader(f"ark:{tmp_path}/egs.ark",
                                                 holder="ceg")]
    assert keys == [f"x-{i:06d}" for i in range(egs.feats.shape[0])]
