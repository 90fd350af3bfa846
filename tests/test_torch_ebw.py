"""The port's EBW module (kaldi_tpu_torch/am/ebw.py) and its tools
(gmm-acc-stats, gmm-scale-accs, gmm-ismooth-stats,
gmm-est-gaussians-ebw, gmm-est-weights-ebw) against the JAX package's,
on the CPU (``device="cpu"`` / ``--device=cpu``), mirroring
tests/test_nnet_ebw_ckpt.py (lattice posteriors, the EBW update) and
tests/test_cli_bank12.py (the tools).

Tolerances, with their reasons:

* ``raw_lattice_pdf_posteriors``, ``ebw_update`` and the accumulator
  tools are host numpy copied from the original: equal arrays on equal
  inputs (the update at 1e-12, the tools' files byte for byte);
* ``accumulate_den_stats`` and gmm-acc-stats take the mixture
  posteriors in float32 (on both sides, in other orders; see
  tests/test_torch_gmm_train.py) and sum in float64: the statistics
  agree within rtol 1e-5, and an EBW update from each side's own
  statistics within 1e-4.
"""

import math

import numpy as np
import pytest
import torch

from kaldi_tpu.am import ebw as jebw
from kaldi_tpu.am import gmm as jgmm
from kaldi_tpu.am.serialize import write_mdl as j_write_mdl
from kaldi_tpu.am.topology import HmmTopology as JTopo
from kaldi_tpu.am.transitions import TransitionModel as JTM
from kaldi_tpu.am.tree import MonophoneContextDependency as JMono
from kaldi_tpu.cli import tools as jtools
from kaldi_tpu.lattice.lattice import Lattice as JLattice
from kaldi_tpu.lattice.lattice import LatticeArc as JArc
from kaldi_tpu_torch.am import ebw as tebw
from kaldi_tpu_torch.am import gmm as tgmm
from kaldi_tpu_torch.cli import tools as ttools
from kaldi_tpu_torch.cli.tools_extra import read_gmm_accs
from kaldi_tpu_torch.core.table import TableWriter
from kaldi_tpu_torch.lattice.lattice import Lattice as TLattice
from kaldi_tpu_torch.lattice.lattice import LatticeArc as TArc
from test_torch_tree_tools import both, same_bytes

torch.set_num_threads(1)


def accs_close(got, want, rtol):
    for name in ("occ", "mean_acc", "var_acc"):
        w = getattr(want, name)
        np.testing.assert_allclose(getattr(got, name), w, rtol=rtol,
                                   atol=rtol * np.abs(w).max())


def _lattice(Lat, Arc, rng):
    """A frame lattice of 6 frames, two competing paths a frame with
    random costs, over tids 1..6."""
    lat = Lat()
    s = [lat.add_state() for _ in range(7)]
    lat.start = s[0]
    for t in range(6):
        for tid in (1 + t % 3, 4 + t % 3):
            lat.arcs[s[t]].append(Arc(tid, 0, float(rng[t, tid % 2, 0]),
                                      float(rng[t, tid % 2, 1]), s[t + 1]))
    lat.set_final(s[6], 0.5, 0.25)
    return lat


@pytest.mark.parametrize("scale", [1.0, 0.3])
def test_raw_lattice_pdf_posteriors_equal_jax(scale):
    costs = np.random.default_rng(3).random((6, 2, 2)) * 3
    tid_to_pdf = np.array([0, 0, 1, 2, 3, 4, 5])
    want = jebw.raw_lattice_pdf_posteriors(_lattice(JLattice, JArc, costs),
                                           6, tid_to_pdf, 6, scale)
    got = tebw.raw_lattice_pdf_posteriors(_lattice(TLattice, TArc, costs),
                                          6, tid_to_pdf, 6, scale)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got.sum(axis=1), 1.0, atol=1e-9)
    # the two-path case of the original's test
    lat = TLattice()
    s = [lat.add_state() for _ in range(4)]
    lat.start = s[0]
    lat.arcs[s[0]].append(TArc(1, 0, 0.0, 0.0, s[1]))
    lat.arcs[s[0]].append(TArc(2, 0, 1.0, 0.0, s[2]))
    lat.arcs[s[1]].append(TArc(3, 0, 0.0, 0.0, s[3]))
    lat.arcs[s[2]].append(TArc(3, 0, 0.0, 0.0, s[3]))
    lat.set_final(s[3])
    post = tebw.raw_lattice_pdf_posteriors(lat, 2, np.array([0, 0, 1, 2]), 3)
    p0 = 1.0 / (1.0 + math.exp(-1.0))
    np.testing.assert_allclose(post[0, :2], [p0, 1 - p0], atol=1e-6)
    np.testing.assert_allclose(post[1, 2], 1.0, atol=1e-6)


def test_den_stats_and_ebw_update_equal_jax():
    """Numerator = true alignment; denominator = confusable posteriors.
    After EBW the correct pdf's loglike margin must grow."""
    rng = np.random.default_rng(0)
    P, M, D, T = 3, 2, 5, 600
    w = rng.dirichlet(np.ones(M), size=P)
    mu = rng.standard_normal((P, M, D)) * 2.0
    var = 0.8 + 0.4 * rng.random((P, M, D))
    jam = jgmm.AmDiagGmm(w.copy(), mu.copy(), var.copy())
    tam = tgmm.AmDiagGmm(w.copy(), mu.copy(), var.copy(), device="cpu")
    ali = rng.integers(0, P, T).astype(np.int32)
    comp = rng.integers(0, M, T)
    feats = (mu[ali, comp] + np.sqrt(var[ali, comp])
             * rng.standard_normal((T, D))).astype(np.float32)

    def margin(am):
        ll = np.asarray(am.loglikes(feats))
        correct = ll[np.arange(T), ali]
        other = np.where(np.eye(P)[ali].astype(bool), -np.inf, ll).max(1)
        return float((correct - other).mean())

    jnum, tnum = jgmm.GmmAccs.zeros(P, M, D), tgmm.GmmAccs.zeros(P, M, D)
    jgmm.accumulate_stats(jam, feats, ali, jnum)
    tgmm.accumulate_stats(tam, feats, ali, tnum)
    ll = np.asarray(jam.loglikes(feats))
    post = np.exp(0.5 * (ll - ll.max(1, keepdims=True)))
    post /= post.sum(1, keepdims=True)
    jden, tden = jgmm.GmmAccs.zeros(P, M, D), tgmm.GmmAccs.zeros(P, M, D)
    jebw.accumulate_den_stats(jam, feats, post, jden)
    tebw.accumulate_den_stats(tam, feats, post, tden)
    accs_close(tnum, jnum, 1e-5)
    accs_close(tden, jden, 1e-5)
    m0 = margin(tam)
    # the update from the JAX statistics on both sides: the same numpy
    own = tgmm.AmDiagGmm(w.copy(), mu.copy(), var.copy(), device="cpu")
    tebw.ebw_update(own, tnum, tden)
    jimpr = jebw.ebw_update(jam, jnum, jden)
    timpr = tebw.ebw_update(tam, jnum, jden)
    assert timpr == jimpr
    for name in ("means", "vars"):
        np.testing.assert_allclose(getattr(tam, name), getattr(jam, name),
                                   rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(getattr(own, name), getattr(jam, name),
                                   rtol=1e-4, atol=1e-4)
    assert margin(tam) > m0 + 0.05
    assert np.all(tam.vars > 0)


@pytest.fixture(scope="module")
def mdl(tmp_path_factory):
    """A small monophone model (the JAX package's flat start) and
    matching features, alignment and posteriors on disk."""
    d = tmp_path_factory.mktemp("ebwtools")
    rng = np.random.default_rng(12)
    topo = JTopo.three_state([1, 2])
    tree = JMono([1, 2], topo)
    tm = JTM(topo, tree)
    am = jgmm.AmDiagGmm.flat_start(tree.num_pdfs, np.zeros(4), np.ones(4),
                                   perturb=0.1)
    am = jgmm.mixup(am, 2 * tree.num_pdfs)
    j_write_mdl(str(d / "final.mdl"), tm, am)
    T = 40
    with TableWriter(f"ark:{d}/feats.ark", holder="mat") as w:
        w["u1"] = rng.normal(size=(T, 4)).astype(np.float32)
        w["u2"] = rng.normal(size=(T, 4)).astype(np.float32)
    with TableWriter(f"ark:{d}/ali.ark", holder="ivec") as w:
        w["u1"] = np.ones(T, np.int32)
        w["u2"] = np.full(T, 3, np.int32)
    with TableWriter(f"ark:{d}/p1.ark", holder="post") as w:
        w["u1"] = [[(1, 1.0)] for _ in range(T)]
        w["u2"] = [[(3, 1.0)] for _ in range(T)]
    with TableWriter(f"ark:{d}/post.ark", holder="post") as w:
        w["u1"] = [[(1, 0.6), (2, 0.4)] for _ in range(T)]
        w["u2"] = [[(3, 0.5), (5, 0.3), (7, 0.2)] for _ in range(T)]
    return d


def test_gmm_acc_stats_posts_vs_ali_and_jax(mdl):
    """Posterior accumulation with weight 1 on the aligned tid equals
    gmm-acc-stats-ali; soft posteriors equal the JAX tool's."""
    d = mdl
    cpu = ["--device=cpu"]
    assert ttools.main(["gmm-acc-stats", *cpu, f"{d}/final.mdl",
                        f"ark:{d}/feats.ark", f"ark:{d}/p1.ark",
                        f"{d}/acc1"]) == 0
    assert ttools.main(["gmm-acc-stats-ali", *cpu, f"{d}/final.mdl",
                        f"ark:{d}/feats.ark", f"ark:{d}/ali.ark",
                        f"{d}/acc2"]) == 0
    accs_close(read_gmm_accs(f"{d}/acc1"), read_gmm_accs(f"{d}/acc2"), 1e-5)
    port, jax = both(d, "gmm-acc-stats",
                     ["{d}/final.mdl", "ark:{d}/feats.ark", "ark:{d}/post.ark",
                      "{out}"], port_opts=cpu)
    pa, ja = read_gmm_accs(port), read_gmm_accs(jax)
    accs_close(pa, ja, 1e-5)
    assert pa.tot_frames == ja.tot_frames == 80
    assert pa.occ.sum() == pytest.approx(80.0)


def test_gmm_acc_algebra_and_ebw_equal_jax(mdl):
    d = mdl
    assert jtools.main(["gmm-acc-stats-ali", f"{d}/final.mdl",
                        f"ark:{d}/feats.ark", f"ark:{d}/ali.ark",
                        f"{d}/num"]) == 0
    assert jtools.main(["gmm-acc-stats", f"{d}/final.mdl",
                        f"ark:{d}/feats.ark", f"ark:{d}/post.ark",
                        f"{d}/soft"]) == 0
    port, jax = both(d, "gmm-scale-accs", ["0.5", "{d}/soft", "{out}"])
    assert same_bytes(port, jax)
    den = jax
    port, jax = both(d, "gmm-ismooth-stats",
                     ["--tau=10", "{d}/final.mdl", "{d}/num", "{out}"])
    assert same_bytes(port, jax)
    sm = read_gmm_accs(port)
    assert np.all(sm.occ >= read_gmm_accs(f"{d}/num").occ)
    port, jax = both(d, "gmm-est-gaussians-ebw",
                     ["--e=2.0", "{d}/final.mdl", "{d}/num", den, "{out}"])
    assert same_bytes(port, jax)
    port, jax = both(d, "gmm-est-weights-ebw",
                     [jax, "{d}/num", den, "{out}"])
    assert same_bytes(port, jax)
    from kaldi_tpu_torch.am.serialize import read_mdl
    _, am2 = read_mdl(port, device="cpu")
    assert np.allclose(am2.weights.sum(axis=1), 1.0)
    assert (am2.weights >= 0).all()
