"""GMM training in the PyTorch port against the JAX package.

The same seeded numpy model, features and pdf alignment go through
kaldi_tpu.am.gmm and kaldi_tpu_torch.am.gmm (on the CPU,
``device="cpu"``).  Tolerances:

* ``component_posteriors``: 1e-5 absolute (float32 products and a
  softmax summed in other orders; posteriors lie in [0, 1]).
* ``accumulate_stats``: the occupancy, mean and variance accumulators
  at rtol 1e-5 (+ atol 1e-5 · the accumulator's largest entry, for
  components that take almost nothing), ``tot_like`` at 1e-4 relative,
  as float32 sums of ~600 frames in other orders.
* ``accumulate_stats_twofeats``: the posteriors' 1e-5 carried through
  float64 sums: rtol 1e-5 as above.
* ``mle_update``, ``map_update``, ``mixup``, ``flat_start`` and
  ``global_stats`` are numpy copies: given identical inputs, equal to
  1e-12 (``mle_update``, ``map_update``) or bit for bit.
* The stale-table check: after ``mle_update`` and after ``mixup`` the
  model's log-likelihoods equal those of a freshly built model.
"""

import numpy as np
import pytest
import torch

from kaldi_tpu.am import gmm as jgmm
from kaldi_tpu_torch.am import gmm as tgmm

torch.set_num_threads(1)

P, M, D, T = 9, 4, 13, 600


def _model(seed, dead=True):
    """A seeded model; with ``dead``, some pdfs use fewer slots (padding
    weight 0, as a mixed-up model's)."""
    rng = np.random.default_rng(seed)
    w = rng.dirichlet(np.ones(M), size=P)
    if dead:
        live = rng.integers(1, M + 1, size=P)
        w = w * (np.arange(M)[None, :] < live[:, None])
        w /= w.sum(axis=1, keepdims=True)
    means = rng.standard_normal((P, M, D))
    variances = 0.5 + rng.random((P, M, D))
    return w, means, variances


def _pair(seed, dead=True):
    w, m, v = _model(seed, dead)
    return jgmm.AmDiagGmm(w, m, v), tgmm.AmDiagGmm(w, m, v, device="cpu")


def _data(seed, n=T):
    rng = np.random.default_rng(seed)
    pdfs = rng.integers(0, P, size=n).astype(np.int32)
    feats = (rng.standard_normal((n, D)) * 1.3 + 0.2).astype(np.float32)
    return feats, pdfs


def _close(got, want, rtol=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


@pytest.mark.parametrize("dead", [False, True])
def test_component_posteriors_match_jax(dead):
    jam, tam = _pair(3, dead)
    feats, pdfs = _data(4)
    want = np.asarray(jam.component_posteriors(feats, pdfs))
    got = tam.component_posteriors(feats, pdfs)
    assert got.dtype == torch.float32 and got.shape == (T, M)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    if dead:
        # unused slots take nothing
        assert (got.numpy()[tam.weights[pdfs] == 0] == 0).all()


@pytest.mark.parametrize("dead", [False, True])
def test_accumulate_stats_matches_jax(dead):
    jam, tam = _pair(5, dead)
    feats, pdfs = _data(6)
    ja = jgmm.GmmAccs.zeros(P, M, D)
    ta = tgmm.GmmAccs.zeros(P, M, D)
    jt = jgmm.accumulate_stats(jam, feats, pdfs, ja)
    tt = tgmm.accumulate_stats(tam, feats, pdfs, ta)
    for name in ("occ", "mean_acc", "var_acc"):
        assert getattr(ta, name).dtype == np.float64
        _close(getattr(ta, name), getattr(ja, name))
    np.testing.assert_allclose(tt, jt, rtol=1e-4)
    np.testing.assert_allclose(ta.tot_like, ja.tot_like, rtol=1e-4)
    assert ta.tot_frames == ja.tot_frames == T
    # a second utterance adds on
    feats2, pdfs2 = _data(7, 200)
    jgmm.accumulate_stats(jam, feats2, pdfs2, ja)
    tgmm.accumulate_stats(tam, feats2, pdfs2, ta)
    _close(ta.occ, ja.occ)
    assert ta.tot_frames == T + 200


def test_accumulate_stats_twofeats_matches_jax():
    jam, tam = _pair(8)
    feats, pdfs = _data(9)
    other = (feats * 0.7 + 0.1).astype(np.float32)
    ja = jgmm.GmmAccs.zeros(P, M, D)
    ta = tgmm.GmmAccs.zeros(P, M, D)
    jgmm.accumulate_stats_twofeats(jam, feats, other, pdfs, ja)
    tgmm.accumulate_stats_twofeats(tam, feats, other, pdfs, ta)
    for name in ("occ", "mean_acc", "var_acc"):
        _close(getattr(ta, name), getattr(ja, name))
    assert ta.tot_frames == ja.tot_frames


def _accs_pair(seed):
    """Identical accumulators on both sides (from the JAX one)."""
    jam, _ = _pair(seed)
    feats, pdfs = _data(seed + 1)
    ja = jgmm.GmmAccs.zeros(P, M, D)
    jgmm.accumulate_stats(jam, feats, pdfs, ja)
    ta = tgmm.GmmAccs(ja.occ.copy(), ja.mean_acc.copy(), ja.var_acc.copy(),
                      ja.tot_like, ja.tot_frames)
    return ja, ta


@pytest.mark.parametrize("remove_low_count", [True, False])
def test_mle_update_matches_jax(remove_low_count):
    ja, ta = _accs_pair(11)
    jam, tam = _pair(12)
    jgmm.mle_update(jam, ja, remove_low_count=remove_low_count)
    tgmm.mle_update(tam, ta, remove_low_count=remove_low_count)
    for name in ("weights", "means", "vars"):
        np.testing.assert_allclose(getattr(tam, name), getattr(jam, name),
                                   rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("taus", [(10.0, 0.0, 0.0), (5.0, 3.0, 2.0)])
def test_map_update_matches_jax(taus):
    mean_tau, weight_tau, var_tau = taus
    ja, ta = _accs_pair(13)
    jam, tam = _pair(14)
    jgmm.map_update(jam, ja, mean_tau, weight_tau, var_tau)
    tgmm.map_update(tam, ta, mean_tau, weight_tau, var_tau)
    for name in ("weights", "means", "vars"):
        np.testing.assert_allclose(getattr(tam, name), getattr(jam, name),
                                   rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("target", [40, 57])
def test_mixup_same_seed_same_model(target):
    jam, tam = _pair(15)
    jout = jgmm.mixup(jam, target, perturb=0.02, seed=3)
    tout = tgmm.mixup(tam, target, perturb=0.02, seed=3)
    assert tout.num_gauss() == jout.num_gauss() == target
    assert tout is not tam and tout.device == tam.device
    for name in ("weights", "means", "vars"):
        np.testing.assert_array_equal(getattr(tout, name),
                                      getattr(jout, name))


def test_flat_start_and_global_stats_match_jax():
    rng = np.random.default_rng(16)
    mats = [rng.standard_normal((int(rng.integers(20, 60)), D)) * 2 + 1
            for _ in range(5)]
    jm, jv = jgmm.global_stats(iter(mats))
    tm, tv = tgmm.global_stats(iter(mats))
    np.testing.assert_array_equal(tm, jm)
    np.testing.assert_array_equal(tv, jv)
    for perturb in (0.0, 0.01):
        j = jgmm.AmDiagGmm.flat_start(P, jm, jv, perturb=perturb, seed=4)
        t = tgmm.AmDiagGmm.flat_start(P, tm, tv, perturb=perturb, seed=4,
                                      device="cpu")
        for name in ("weights", "means", "vars"):
            np.testing.assert_array_equal(getattr(t, name), getattr(j, name))


def test_tables_follow_updates_and_mixup():
    """The kernel's tables are cached until ``refresh``: after
    ``mle_update`` and after ``mixup`` the model's log-likelihoods equal
    a freshly built model's (a stale table would give the old ones)."""
    _, tam = _pair(17)
    feats, pdfs = _data(18)

    def fresh(am):
        return tgmm.AmDiagGmm(am.weights, am.means, am.vars,
                              device="cpu").loglikes(feats)

    before = tam.loglikes(feats)
    accs = tgmm.GmmAccs.zeros(P, M, D)
    tgmm.accumulate_stats(tam, feats, pdfs, accs)
    tgmm.mle_update(tam, accs)
    after = tam.loglikes(feats)
    assert not torch.allclose(before, after)
    torch.testing.assert_close(after, fresh(tam), rtol=0, atol=0)
    mixed = tgmm.mixup(tam, tam.num_gauss() + 11, seed=1)
    assert mixed.max_mix >= tam.max_mix
    torch.testing.assert_close(mixed.loglikes(feats), fresh(mixed),
                               rtol=0, atol=0)
    tgmm.map_update(mixed, tgmm.GmmAccs.zeros(P, mixed.max_mix, D)
                    + _occupied(mixed, feats, pdfs))
    torch.testing.assert_close(mixed.loglikes(feats), fresh(mixed),
                               rtol=0, atol=0)


def _occupied(am, feats, pdfs):
    accs = tgmm.GmmAccs.zeros(am.num_pdfs, am.max_mix, am.dim)
    tgmm.accumulate_stats(am, feats, pdfs, accs)
    return accs
