"""The port's LDA+MLLT, posterior, SAT/fMLLR and MAP tools against the
JAX package's, on the same files: acc-lda, sum-lda-accs, est-lda,
gmm-acc-mllt, est-mllt, ali-to-post, weight-silence-post,
lattice-to-post, gmm-boost-silence, compose-transforms,
gmm-transform-means, gmm-adapt-map, gmm-est-fmllr,
gmm-acc-stats-twofeats and gmm-compute-likes (mirroring
tests/test_cli_bank9.py, test_cli_bank3.py, test_cli_bank5.py,
test_cli_bank12.py and test_map_adapt.py).  The port's tools that
compute with tensors run with ``--device=cpu``.

Tolerances, with their reasons:

* host code copied from the original (the LDA statistics and
  estimator, est-mllt, the posterior and lattice tools,
  gmm-boost-silence, compose-transforms, gmm-transform-means): output
  files equal byte for byte, each side reading the same input files;
* statistics through the GMM's mixture posteriors (gmm-acc-mllt,
  gmm-acc-stats-twofeats, gmm-adapt-map's accumulators): the posteriors
  are float32 products in another order (tests/test_torch_gmm_train.py),
  so the statistics agree within rtol 1e-5 and what is estimated from
  them (the MLLT matrix, the MAP means) within 1e-4, the bar of
  tests/test_torch_tri.py for estimated transforms;
* gmm-compute-likes: the GMM kernel's plain version against the JAX
  log-likelihoods, rtol = atol = 1e-4 (tests/test_torch_gmm.py);
* gmm-est-fmllr: the original's tool hands a (frames × pdfs) weight
  matrix to ``accumulate_fmllr_for_utt`` as a pdf alignment and fails,
  so the port's tool is held against the JAX library on the same
  inputs (``accumulate_fmllr_from_post`` per speaker, then
  ``FmllrAccs.update``), at the fMLLR bar of tests/test_torch_tri.py:
  1e-4.
"""

import math

import numpy as np
import pytest
import torch

from kaldi_tpu.am import transforms as jtr
from kaldi_tpu.am.gmm import AmDiagGmm as JGmm
from kaldi_tpu.am.serialize import read_mdl as j_read_mdl
from kaldi_tpu.am.serialize import write_mdl as j_write_mdl
from kaldi_tpu.am.topology import HmmTopology as JTopo
from kaldi_tpu.am.transitions import TransitionModel as JTM
from kaldi_tpu.am.tree import MonophoneContextDependency as JMono
from kaldi_tpu.lattice.lattice import CompactArc as JArc
from kaldi_tpu.lattice.lattice import CompactLattice as JClat
from kaldi_tpu_torch.am.serialize import read_mdl
from kaldi_tpu_torch.cli import tools as ttools
from kaldi_tpu_torch.cli.tools_extra import read_gmm_accs
from kaldi_tpu_torch.core import io as tio
from kaldi_tpu_torch.core.table import SequentialTableReader, TableWriter
from test_torch_tree_tools import both, same_bytes

torch.set_num_threads(1)

CPU = ["--device=cpu"]
D = 5
T = 600    # frames an utterance: above FmllrAccs.update's min_count 500
SPK = {"a": ["a1", "a2"], "b": ["b1", "b2"]}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """A 3-phone monophone model (the JAX package's), 4 utterances of 2
    speakers whose features depend on the aligned pdf, their
    alignments, posteriors (the alignment's, and a soft one with a
    second tid each frame) and a second, shifted feature stream."""
    d = tmp_path_factory.mktemp("ldasat")
    rng = np.random.default_rng(42)
    phones = [1, 2, 3]
    topo = JTopo.three_state(phones)
    tree = JMono(phones, topo)
    tm = JTM(topo, tree)
    P = tree.num_pdfs
    am = JGmm(rng.dirichlet(np.ones(2), size=P),
              2.0 * rng.standard_normal((P, 2, D)),
              0.5 + rng.random((P, 2, D)))
    j_write_mdl(str(d / "0.mdl"), tm, am)
    n_tid = tm.num_transition_ids
    feats = {}
    with TableWriter(f"ark:{d}/feats.ark", holder="mat") as wf, \
            TableWriter(f"ark:{d}/feats2.ark", holder="mat") as wf2, \
            TableWriter(f"ark:{d}/ali.ark", holder="ivec") as wa, \
            TableWriter(f"ark:{d}/soft.ark", holder="post") as wp:
        for spk, utts in SPK.items():
            shift = 0.5 if spk == "a" else -0.5
            for u in utts:
                tids = rng.integers(1, n_tid + 1, T)
                pdfs = tm.tid_to_pdf_array[tids]
                x = (am.means[pdfs, 0] + shift
                     + 0.3 * rng.standard_normal((T, D))).astype(np.float32)
                feats[u] = x
                wf[u] = x
                wf2[u] = (1.5 * x + 0.2).astype(np.float32)
                wa[u] = tids.astype(np.int32)
                other = rng.integers(1, n_tid + 1, T)
                wp[u] = [[(int(a), 0.7), (int(b), 0.3)]
                         for a, b in zip(tids, other)]
    (d / "spk2utt").write_text(
        "".join(f"{s} {' '.join(u)}\n" for s, u in SPK.items()))
    return {"d": d, "tm": tm, "am": am, "feats": feats}


def read_mat(path):
    with open(path, "rb") as f:
        assert tio.init_kaldi_input_stream(f)
        return tio.read_matrix(f)


def write_mat(path, m):
    with open(path, "wb") as f:
        tio.init_kaldi_output_stream(f)
        tio.write_matrix(f, np.asarray(m, np.float32))


def read_mllt_accs(path):
    with open(path, "rb") as f:
        assert tio.init_kaldi_input_stream(f)
        tio.expect_token(f, "<MLLTACCS>")
        beta = tio.read_basic_float(f)
        G = [tio.read_matrix(f) for _ in range(D)]
        tio.expect_token(f, "</MLLTACCS>")
    return beta, np.stack(G)


def models_close(a, b, rtol):
    (ta, aa), (tb, ab) = read_mdl(a, device="cpu"), read_mdl(b, device="cpu")
    np.testing.assert_array_equal(ta.tid_to_pdf_array, tb.tid_to_pdf_array)
    for name in ("weights", "means", "vars"):
        np.testing.assert_allclose(getattr(aa, name), getattr(ab, name),
                                   rtol=rtol, atol=rtol)


def test_acc_sum_est_lda_equal_jax(setup):
    d = setup["d"]
    port, jax = both(d, "ali-to-post", ["ark:{d}/ali.ark", "ark:{out}"])
    assert same_bytes(port, jax)
    port, jax = both(d, "acc-lda", ["{d}/0.mdl", "ark:{d}/feats.ark",
                                    f"ark:{jax}", "{out}"])
    assert same_bytes(port, jax)
    acc = jax
    port, jax = both(d, "sum-lda-accs", ["{out}", acc, acc])
    assert same_bytes(port, jax)
    port, jax = both(d, "est-lda", ["--dim=3", "{out}", acc])
    assert same_bytes(port, jax)
    mat = read_mat(port)
    assert mat.shape == (3, D + 1)
    # the classes the features were drawn around are spread apart
    proj = setup["am"].means[:, 0] @ mat[:, :D].T
    assert np.ptp(proj, axis=0).max() > 1.0


def test_acc_est_mllt_equal_jax(setup):
    d = setup["d"]
    port, jax = both(d, "gmm-acc-mllt", ["{d}/0.mdl", "ark:{d}/feats.ark",
                                         "ark:{d}/ali.ark", "{out}"],
                     port_opts=CPU)
    (pb, pg), (jb, jg) = read_mllt_accs(port), read_mllt_accs(jax)
    np.testing.assert_allclose(pb, jb, rtol=1e-5)
    np.testing.assert_allclose(pg, jg, rtol=1e-5, atol=1e-5 * np.abs(jg).max())
    port_acc = port
    port, jax = both(d, "est-mllt", ["{out}", jax])
    assert same_bytes(port, jax)
    assert ttools.main(["est-mllt", str(d / "own.mllt"), port_acc]) == 0
    want = read_mat(jax)
    assert want.shape == (D, D) and abs(np.linalg.det(want)) > 1e-6
    np.testing.assert_allclose(read_mat(str(d / "own.mllt")), want,
                               rtol=1e-4, atol=1e-4 * np.abs(want).max())


def test_posterior_tool_chain_equal_jax(setup):
    d = setup["d"]
    port, jax = both(d, "weight-silence-post",
                     ["0.0", "1", "{d}/0.mdl", "ark:{d}/soft.ark",
                      "ark:{out}"])
    assert same_bytes(port, jax)
    tm = setup["tm"]
    got = dict(SequentialTableReader(f"ark:{port}", holder="post"))
    for frame in got["a1"]:
        assert all(tm.transition_id_to_phone(t) != 1 for t, _ in frame)


def test_gmm_boost_silence_equal_jax(setup):
    d = setup["d"]
    port, jax = both(d, "gmm-boost-silence",
                     ["--boost=2.0", "1", "{d}/0.mdl", "{out}"])
    assert same_bytes(port, jax)
    tm, am = setup["tm"], setup["am"]
    _, am2 = read_mdl(port, device="cpu")
    sil = {int(tm.tid_to_pdf_array[t]) for t in range(1, tm.num_transition_ids
                                                      + 1)
           if tm.transition_id_to_phone(t) == 1}
    x = setup["feats"]["a1"][:8]
    ll1 = np.asarray(am.loglikes(x))
    ll2 = am2.loglikes(x).numpy()
    for p in range(am.num_pdfs):
        np.testing.assert_allclose(
            ll2[:, p], ll1[:, p] + (math.log(2) if p in sil else 0.0),
            atol=1e-4)


def test_lattice_to_post_equal_jax(setup):
    d = setup["d"]
    c = JClat()
    s = [c.add_state() for _ in range(3)]
    c.start = s[0]
    c.arcs[s[0]].append(JArc(1, 1.0, 0.5, (11, 12), s[1]))
    c.arcs[s[0]].append(JArc(2, 2.0, 0.5, (21,), s[1]))
    c.arcs[s[1]].append(JArc(3, 0.5, 0.5, (31,), s[2]))
    c.finals[s[2]] = (0.0, 0.0, ())
    with TableWriter(f"ark:{d}/lat.ark", holder="clat") as w:
        w["u1"] = c
    for scale in ("1.0", "0.5"):
        port, jax = both(d, "lattice-to-post",
                         [f"--acoustic-scale={scale}", "ark:{d}/lat.ark",
                          "ark:{out}"])
        assert same_bytes(port, jax)
    post = dict(SequentialTableReader(f"ark:{port}", holder="post"))["u1"]
    assert abs(dict(post[2])[31] - 1.0) < 1e-5


def test_compose_transforms_equal_jax(setup):
    d = setup["d"]
    rng = np.random.default_rng(7)
    write_mat(str(d / "a.mat"), rng.standard_normal((2, 4)))
    write_mat(str(d / "b.mat"), rng.standard_normal((3, 5)))
    write_mat(str(d / "c.mat"), rng.standard_normal((3, 3)))
    for opts, a, b in ((["--b-is-affine=true"], "a.mat", "b.mat"),
                       ([], "a.mat", "c.mat")):
        port, jax = both(d, "compose-transforms",
                         [*opts, f"{{d}}/{a}", f"{{d}}/{b}", "{out}"])
        assert same_bytes(port, jax)
    # the last pair: the affine a after the linear c, on 3-dim frames
    a, c = read_mat(str(d / "a.mat")), read_mat(str(d / "c.mat"))
    ac = read_mat(str(d / "compose-transforms.port"))
    x = rng.standard_normal((5, 3))
    want = (x @ c.T) @ a[:, :3].T + a[:, 3]
    np.testing.assert_allclose(x @ ac[:, :3].T + ac[:, 3], want, atol=1e-4)


def test_gmm_transform_means_equal_jax(setup):
    d = setup["d"]
    write_mat(str(d / "t.mat"), np.hstack([2.0 * np.eye(D),
                                           np.ones((D, 1))]))
    port, jax = both(d, "gmm-transform-means",
                     ["{d}/t.mat", "{d}/0.mdl", "{out}"])
    assert same_bytes(port, jax)
    _, am2 = read_mdl(port, device="cpu")
    np.testing.assert_allclose(am2.means, 2.0 * setup["am"].means + 1.0,
                               rtol=1e-6)


def test_gmm_adapt_map_equal_jax(setup):
    d = setup["d"]
    port, jax = both(d, "gmm-adapt-map",
                     ["--mean-tau=5.0", "--var-tau=3.0", "--weight-tau=2.0",
                      "{d}/0.mdl", "ark:{d}/feats2.ark", "ark:{d}/ali.ark",
                      "{out}"], port_opts=CPU)
    models_close(port, jax, 1e-4)
    _, adapted = read_mdl(port, device="cpu")
    assert np.abs(adapted.means - setup["am"].means).max() > 0.3


@pytest.mark.parametrize("per", ["speaker", "utterance"])
def test_gmm_est_fmllr_equals_jax_library(setup, per):
    d = setup["d"]
    opts = [f"--spk2utt={d}/spk2utt"] if per == "speaker" else []
    out = d / f"trans.{per}"
    assert ttools.main(["gmm-est-fmllr", *CPU, *opts, str(d / "0.mdl"),
                        f"ark:{d}/feats.ark", f"ark:{d}/soft.ark",
                        f"ark:{out}"]) == 0
    got = dict(SequentialTableReader(f"ark:{out}", holder="mat"))
    tm, am = j_read_mdl(str(d / "0.mdl"))
    soft = dict(SequentialTableReader(f"ark:{d}/soft.ark", holder="post"))
    groups = SPK if per == "speaker" else {u: [u] for v in SPK.values()
                                           for u in v}
    assert sorted(got) == sorted(groups)
    for key, utts in groups.items():
        accs = jtr.FmllrAccs(D)
        for u in utts:
            frames = [[(int(tm.tid_to_pdf_array[t]), p) for t, p in fr]
                      for fr in soft[u]]
            jtr.accumulate_fmllr_from_post(accs, am, setup["feats"][u],
                                           frames)
        want, _ = accs.update()
        assert not np.allclose(want, np.eye(D, D + 1))
        np.testing.assert_allclose(got[key], want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max())


def test_gmm_acc_stats_twofeats_equal_jax(setup):
    d = setup["d"]
    port, jax = both(d, "gmm-acc-stats-twofeats",
                     ["{d}/0.mdl", "ark:{d}/feats.ark", "ark:{d}/feats2.ark",
                      "ark:{d}/ali.ark", "{out}"], port_opts=CPU)
    pa, ja = read_gmm_accs(port), read_gmm_accs(jax)
    for name in ("occ", "mean_acc", "var_acc"):
        want = getattr(ja, name)
        np.testing.assert_allclose(getattr(pa, name), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())
    assert pa.tot_frames == ja.tot_frames == 4 * T


def test_gmm_compute_likes_equal_jax(setup):
    d = setup["d"]
    port, jax = both(d, "gmm-compute-likes",
                     ["{d}/0.mdl", "ark:{d}/feats.ark", "ark:{out}"],
                     port_opts=CPU)
    got = dict(SequentialTableReader(f"ark:{port}", holder="mat"))
    want = dict(SequentialTableReader(f"ark:{jax}", holder="mat"))
    assert sorted(got) == sorted(want) == sorted(setup["feats"])
    for k in got:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-4)
