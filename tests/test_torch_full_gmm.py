"""The port's full-covariance GMM (kaldi_tpu_torch/am/full_gmm.py) and
its tools (cli/tools_bank13.py) against the JAX package's, on the CPU
(``device="cpu"`` / ``--device=cpu``).

* ``FullGmm`` / ``AccumFullGmm`` / ``mle_full_gmm_update`` on the same
  arrays, as the GMM part of tests/test_fullgmm_ctm.py: the frame work
  is float64 on both sides, in other orders of summation, so
  log-likelihoods, posteriors, statistics and updated parameters agree
  within 1e-10 relative, and so do the inverse covariances and Gaussian
  constants that ``refresh`` (copied host code) derives from them.
* The fgmm tool family, mirroring
  tests/test_cli_bank13.py::test_fgmm_family_em_improves.  The file
  helpers are copies: a model or accumulators file read by either side
  and written by either gives the same bytes, and the host tools
  (gmm-global-to-fgmm, fgmm-global-to-gmm, -copy, -info, -sum-accs,
  -est) give equal files on the same input files.  The tools that
  score frames (fgmm-global-acc-stats, -get-frame-likes, fgmm-gselect)
  agree within 1e-10 relative (float64, as above; the frame likes are
  written as float32, so within float32 rounding).
"""

import numpy as np
import pytest
import torch

from kaldi_tpu.am import full_gmm as jfg
from kaldi_tpu.cli import tools as jtools
from kaldi_tpu.cli import tools_bank13 as jb13
from kaldi_tpu_torch.am import full_gmm as tfg
from kaldi_tpu_torch.cli import tools as ttools
from kaldi_tpu_torch.cli import tools_bank13 as tb13
from kaldi_tpu_torch.core.table import SequentialTableReader, TableWriter
from test_torch_tree_tools import both, same_bytes

torch.set_num_threads(1)

CPU = ["--device=cpu"]


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def clusters(rng, n=2000):
    A1 = np.array([[1.0, 0.8, 0.0], [0.8, 1.0, 0.0], [0.0, 0.0, 0.3]])
    A2 = np.array([[0.5, -0.3, 0.0], [-0.3, 0.5, 0.2], [0.0, 0.2, 0.8]])
    mu1, mu2 = np.array([3.0, 0, 0]), np.array([-3.0, 0, 0])
    x = np.concatenate([rng.multivariate_normal(mu1, A1, n // 2),
                        rng.multivariate_normal(mu2, A2, n // 2)])
    rng.shuffle(x)
    return x, mu1, mu2


def test_full_gmm_em_equals_jax():
    rng = np.random.default_rng(0)
    x, mu1, mu2 = clusters(rng)
    M, D = 2, 3
    init = (np.ones(M) / M, np.stack([mu1 + 0.5, mu2 - 0.5]),
            np.ones((M, D)))
    jg = jfg.FullGmm.from_diag(*init)
    tg = tfg.FullGmm.from_diag(*init, device="cpu")
    ll_prev = None
    for it in range(6):
        for name in ("inv_covars", "gconsts"):
            assert rel(getattr(tg, name), getattr(jg, name)) < 1e-10, name
        assert rel(tg.component_loglikes(x).numpy(),
                   jg.component_loglikes(x)) < 1e-10
        assert rel(tg.loglikes(x).numpy(), jg.loglikes(x)) < 1e-10
        assert rel(tg.posteriors(x).numpy(), jg.posteriors(x)) < 1e-10
        ja, ta = jfg.AccumFullGmm(M, D), tfg.AccumFullGmm(M, D)
        jll, tll = ja.accumulate(jg, x), ta.accumulate(tg, x)
        assert abs(tll - jll) <= 1e-10 * abs(jll)
        for name in ("occ", "mean_acc", "cov_acc"):
            assert rel(getattr(ta, name), getattr(ja, name)) < 1e-10, name
        if ll_prev is not None:
            assert tll / len(x) >= ll_prev - 1e-6       # EM monotonicity
        ll_prev = tll / len(x)
        jfg.mle_full_gmm_update(jg, ja)
        tfg.mle_full_gmm_update(tg, ta)
        for name in ("weights", "means", "covars"):
            assert rel(getattr(tg, name), getattr(jg, name)) < 1e-10, name
    m1 = int(np.argmin(np.linalg.norm(tg.means - mu1, axis=1)))
    assert tg.covars[m1][0, 1] > 0.3


def test_accumulate_in_chunks_equals_whole(monkeypatch):
    """γxxᵀ summed over frame chunks equals one product over all."""
    rng = np.random.default_rng(1)
    x, mu1, mu2 = clusters(rng, 600)
    g = tfg.FullGmm.from_diag(np.ones(2) / 2, np.stack([mu1, mu2]),
                              np.ones((2, 3)), device="cpu")
    whole = tfg.AccumFullGmm(2, 3)
    whole.accumulate(g, x)
    monkeypatch.setattr(tfg.AccumFullGmm, "CHUNK", 97)
    parts = tfg.AccumFullGmm(2, 3)
    parts.accumulate(g, x)
    assert rel(parts.cov_acc, whole.cov_acc) < 1e-12


@pytest.fixture(scope="module")
def ubm(tmp_path_factory):
    """Features of a 2-component correlated mixture in two utterances,
    one per file too, and a diagonal UBM from the JAX package's
    gmm-global-init-from-feats."""
    d = tmp_path_factory.mktemp("fgmm")
    rng = np.random.default_rng(13)
    n = 400
    a = rng.normal(size=(n, 3)) @ np.array(
        [[1.0, 0.5, 0.0], [0.0, 1.0, 0.3], [0.0, 0.0, 1.0]])
    b = rng.normal(size=(n, 3)) @ np.array(
        [[1.0, -0.4, 0.0], [0.0, 1.0, 0.0], [0.2, 0.0, 1.0]]) + 4.0
    feats = np.concatenate([a, b]).astype(np.float32)
    with TableWriter(f"ark:{d}/feats.ark", holder="mat") as w:
        w["u1"], w["u2"] = feats[:n], feats[n:]
    for k, part in ((1, feats[:n]), (2, feats[n:])):
        with TableWriter(f"ark:{d}/f{k}.ark", holder="mat") as w:
            w[f"u{k}"] = part
    assert jtools.main(["gmm-global-init-from-feats", "--num-gauss=4",
                        "--num-iters=6", f"ark:{d}/feats.ark",
                        str(d / "diag.ubm")]) == 0
    return d


def test_fgmm_tools_equal_jax(ubm, capsys):
    d = ubm
    port, jax = both(d, "gmm-global-to-fgmm", ["{d}/diag.ubm", "{out}"])
    assert same_bytes(port, jax)
    fgmm0 = jax
    for side, main in (("port", ttools.main), ("jax", jtools.main)):
        assert main(["fgmm-global-info", fgmm0]) == 0
        assert "feature dimension 3" in capsys.readouterr().out, side
    likes = {}
    for k in (1, 2):
        port, jax = both(d, "fgmm-global-acc-stats",
                         [fgmm0, f"ark:{{d}}/f{k}.ark", f"{{out}}{k}"],
                         port_opts=CPU)
        pa, ja = tb13._read_full_accs(port + str(k)), \
            jb13._read_full_accs(jax + str(k))
        for name in ("occ", "mean_acc", "cov_acc"):
            assert rel(getattr(pa, name), getattr(ja, name)) < 1e-10, name
    accs = [f"{d}/fgmm-global-acc-stats.jax{k}" for k in (1, 2)]
    port, jax = both(d, "fgmm-global-sum-accs", ["{out}", *accs])
    assert same_bytes(port, jax)
    port, jax = both(d, "fgmm-global-est", [fgmm0, jax, "{out}"])
    assert same_bytes(port, jax)
    fgmm1 = jax
    for name, model in (("likes0", fgmm0), ("likes1", fgmm1)):
        port, jax = both(d, "fgmm-global-get-frame-likes",
                         ["--average=true", model, "ark:{d}/feats.ark",
                          f"ark:{{out}}.{name}"], port_opts=CPU)
        got = dict(SequentialTableReader(f"ark:{port}.{name}", holder="vec"))
        want = dict(SequentialTableReader(f"ark:{jax}.{name}", holder="vec"))
        assert sorted(got) == sorted(want) == ["u1", "u2"]
        for k in got:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6)
        likes[name] = sum(float(v[0]) for v in got.values())
    # full-covariance EM on correlated data beats the diagonal start
    assert likes["likes1"] > likes["likes0"] + 0.01
    port, jax = both(d, "fgmm-global-copy", [fgmm1, "{out}"])
    assert same_bytes(port, jax) and same_bytes(port, fgmm1)
    port, jax = both(d, "fgmm-gselect", ["--n=2", fgmm1, "ark:{d}/feats.ark",
                                         "ark:{out}"], port_opts=CPU)
    got = dict(SequentialTableReader(f"ark:{port}", holder="post"))
    want = dict(SequentialTableReader(f"ark:{jax}", holder="post"))
    for k in want:
        assert [[i for i, _ in fr] for fr in got[k]] == \
            [[i for i, _ in fr] for fr in want[k]]
        np.testing.assert_allclose([[p for _, p in fr] for fr in got[k]],
                                   [[p for _, p in fr] for fr in want[k]],
                                   rtol=1e-6, atol=1e-7)
    port, jax = both(d, "fgmm-global-to-gmm", [fgmm1, "{out}"])
    assert same_bytes(port, jax)
    diag = tb13._read_full_gmm(fgmm1, "cpu")
    from kaldi_tpu_torch.cli.tools_bank5 import _read_global_gmm
    np.testing.assert_allclose(_read_global_gmm(port, "cpu").means[0],
                               diag.means, rtol=1e-5)


def test_fgmm_files_cross_both_ways(ubm):
    """A model or accumulators file one side wrote, read by either side
    and written by either, gives the same bytes; a model file (float32
    on disk) gives its own bytes back.  (Both packages' readers round a
    float64 matrix to float32, so an accumulators file read and written
    again is the rounded one, on both sides alike.)"""
    d = ubm
    assert jtools.main(["gmm-global-to-fgmm", str(d / "diag.ubm"),
                        str(d / "x.fubm")]) == 0
    assert ttools.main(["fgmm-global-acc-stats", "--device=cpu",
                        str(d / "x.fubm"), f"ark:{d}/feats.ark",
                        str(d / "x.acc")]) == 0
    readers = {"x.fubm": (jb13._read_full_gmm,
                          lambda p: tb13._read_full_gmm(p, "cpu")),
               "x.acc": (jb13._read_full_accs, tb13._read_full_accs)}
    writers = {"x.fubm": (jb13._write_full_gmm, tb13._write_full_gmm),
               "x.acc": (jb13._write_full_accs, tb13._write_full_accs)}
    for src in ("x.fubm", "x.acc"):
        outs = []
        for i, read in enumerate(readers[src]):
            for j, write in enumerate(writers[src]):
                out = str(d / f"{src}.{i}{j}")
                write(out, read(str(d / src)))
                outs.append(out)
        assert all(same_bytes(o, outs[0]) for o in outs), src
    assert same_bytes(str(d / "x.fubm.11"), str(d / "x.fubm"))
