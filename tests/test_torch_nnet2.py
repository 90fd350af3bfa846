"""The port's nnet2 library (am/nnet2.py, am/raw_nnet.py) against
kaldi_tpu/am/nnet2.py and kaldi_tpu/am/raw_nnet.py on the CPU.

The same seeded numpy inputs and the JAX package's own initialisation
(flax's ``init``, carried to the port through ``nnet2_state_dict``) go
through both sides: ``pnorm`` (p = 2 and p ≠ 2), ``normalize_rms``,
``Nnet2Model`` with and without a mixed-up softmax and on pre-spliced
input, the weight carry both ways, ``<Nnet2>`` and ``<RawNnet>`` files
byte-equal both ways, the raw-net conversions and forward, and
``train_parallel_averaging`` from the JAX init.  Bars: outputs within
1e-5 of the largest entry (float32 sums in another order), trained
parameters within 1e-4 of each tensor's largest.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kaldi_tpu.am import nnet2 as jn
from kaldi_tpu.am import raw_nnet as jr
from kaldi_tpu_torch.am import nnet2 as tn
from kaldi_tpu_torch.am import raw_nnet as tr
from kaldi_tpu_torch.core.logging import KaldiError

torch.set_num_threads(1)

TOL = 1e-5
CFG = tn.Nnet2Config(feat_dim=6, num_pdfs=7, num_hidden_layers=2,
                     pnorm_input_dim=24, pnorm_output_dim=8)


def close(got, want, tol=TOL):
    got = np.asarray(got.detach().cpu() if torch.is_tensor(got) else got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(1.0, np.abs(want).max()))


def jcfg(cfg):
    return jn.Nnet2Config(**dataclasses.asdict(cfg))


def jax_init(cfg, seed=0):
    params = jn.Nnet2Model(jcfg(cfg)).init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 4, cfg.feat_dim)))["params"]
    return jax.tree_util.tree_map(np.asarray, dict(params))


def tree_leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves(tree[k], path + (k,))
    else:
        yield path, np.asarray(tree)


def trees_equal(a, b):
    la, lb = list(tree_leaves(a)), list(tree_leaves(b))
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (p, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape, p
        np.testing.assert_array_equal(x, y, err_msg=str(p))


MIXED = dataclasses.replace(CFG, mix2pdf=(0, 0, 1, 2, 2, 2, 3, 4, 5, 6, 6))


@pytest.fixture(scope="module")
def params():
    return {"plain": jax_init(CFG, 0), "mixed": jax_init(MIXED, 1)}


# ---------------------------------------------------------------------------
# the p-norm pieces

@pytest.mark.parametrize("p", [2.0, 3.0, 1.5])
def test_pnorm(p):
    x = np.random.default_rng(1).standard_normal((3, 5, 24)).astype(
        np.float32)
    want = np.asarray(jn.pnorm(jnp.asarray(x), 8, p))
    close(tn.pnorm(torch.from_numpy(x), 8, p), want)


def test_pnorm_keeps_the_floor_inside_the_root():
    x = np.zeros((2, 12), np.float32)
    want = np.asarray(jn.pnorm(jnp.asarray(x), 4, 2.0))
    got = tn.pnorm(torch.from_numpy(x), 4, 2.0).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[0, 0] == np.float32(1e-10)
    with pytest.raises(ValueError):
        tn.pnorm(torch.zeros(2, 10), 4)


@pytest.mark.parametrize("target", [1.0, 2.5])
def test_normalize_rms(target):
    x = np.random.default_rng(2).standard_normal((4, 9)).astype(np.float32)
    x[0] = 0.0
    want = np.asarray(jn.normalize_rms(jnp.asarray(x), target))
    got = tn.normalize_rms(torch.from_numpy(x), target)
    close(got, want)
    assert np.all(np.isfinite(got.numpy()))


# ---------------------------------------------------------------------------
# the model

@pytest.mark.parametrize("kind", ["plain", "mixed"])
@pytest.mark.parametrize("spliced", [False, True])
def test_model_forward(params, kind, spliced):
    cfg = CFG if kind == "plain" else MIXED
    p = params[kind]
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 11, cfg.feat_dim)).astype(np.float32)
    if spliced:
        from kaldi_tpu.am.tdnn import splice
        x = np.array(splice(jnp.asarray(x), cfg.splice))
    want = np.asarray(jn.Nnet2Model(jcfg(cfg)).apply({"params": p},
                                                     jnp.asarray(x)))
    model = tn.nnet2_model(p, cfg, "cpu")
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert got.shape == (2, 11, cfg.num_pdfs)
    close(got, want)
    np.testing.assert_allclose(np.exp(got.numpy()).sum(-1), 1.0, atol=1e-5)


def test_spliced_and_raw_input_agree(params):
    x = np.random.default_rng(4).standard_normal((1, 9, 6)).astype(
        np.float32)
    from kaldi_tpu_torch.am.tdnn import splice
    model = tn.nnet2_model(params["plain"], CFG, "cpu")
    with torch.no_grad():
        a = model(torch.from_numpy(x))
        b = model(splice(torch.from_numpy(x), CFG.splice))
    np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("kind", ["plain", "mixed"])
def test_weight_carry_both_ways(params, kind):
    cfg = CFG if kind == "plain" else MIXED
    model = tn.nnet2_model(params[kind], cfg, "cpu")
    assert model.pnorm1.affine.weight.shape == (24, 30)
    assert model.output_affine.weight.shape[0] == (
        cfg.num_pdfs if cfg.mix2pdf is None else len(cfg.mix2pdf))
    back = tn.nnet2_params(model)
    trees_equal(back, params[kind])
    # the module's tensors are copies: the JAX side's arrays stay put
    with torch.no_grad():
        model.pnorm1.affine.weight.add_(1.0)
    trees_equal(params[kind], jax_init(cfg, 0 if kind == "plain" else 1))


def test_model_device_defaults_to_the_card(params, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(KaldiError):
        tn.nnet2_model(params["plain"], CFG)
    with pytest.raises(KaldiError):
        tr.forward([("logsoftmax", {})], np.zeros((2, 3), np.float32))


def test_init_draws_flax_distributions():
    cfg = dataclasses.replace(CFG, pnorm_input_dim=400, pnorm_output_dim=40,
                              num_hidden_layers=2)
    p = tn.init_nnet2(cfg, torch.Generator().manual_seed(0))
    want = jax_init(cfg)
    assert [(k, v.shape, v.dtype) for k, v in tree_leaves(p)] == \
        [(k, v.shape, v.dtype) for k, v in tree_leaves(want)]
    for (k, v), (_, w) in zip(tree_leaves(p), tree_leaves(want)):
        if k[-1] == "bias":
            assert not v.any() and not w.any()
        else:
            fan_in = v.shape[0]
            assert np.std(v) * np.sqrt(fan_in) == pytest.approx(
                np.std(w) * np.sqrt(fan_in), rel=0.1)
            assert np.abs(v).max() <= 2.0 / np.sqrt(fan_in) / 0.8796 + 1e-6
    again = tn.init_nnet2(cfg, torch.Generator().manual_seed(0))
    trees_equal(p, again)


# ---------------------------------------------------------------------------
# files

VARIANTS = {
    "plain": {},
    "mixed": {"cfg": MIXED},
    "priors": {"priors": np.linspace(0.5, 2.0, 7)},
    "all": {"cfg": dataclasses.replace(
        MIXED, preconditioned=True,
        learn_rates=(2.0 ** -10, 2.0 ** -9, 2.0 ** -11)),
            "priors": np.arange(1, 8, dtype=np.float64)},
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_nnet2_files_cross_byte_for_byte(params, tmp_path, variant):
    v = VARIANTS[variant]
    cfg = v.get("cfg", CFG)
    p = params["mixed" if cfg.mix2pdf else "plain"]
    pri = v.get("priors")
    jn.save_nnet2(f"{tmp_path}/j.mdl", p, jcfg(cfg), priors=pri)
    tn.save_nnet2(f"{tmp_path}/t.mdl", p, cfg, priors=pri)
    with open(f"{tmp_path}/j.mdl", "rb") as a, \
            open(f"{tmp_path}/t.mdl", "rb") as b:
        assert a.read() == b.read()
    # each side reads the other's file
    tp, tc, tpri = tn.load_nnet2_full(f"{tmp_path}/j.mdl")
    jp, jc, jpri = jn.load_nnet2_full(f"{tmp_path}/t.mdl")
    trees_equal(tp, jax.tree_util.tree_map(np.asarray, dict(jp)))
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert tc == cfg
    if pri is None:
        assert tpri is None and jpri is None
    else:
        np.testing.assert_array_equal(tpri, jpri)
    # the module writes the same bytes as its tree
    tn.save_nnet2(f"{tmp_path}/m.mdl", tn.nnet2_model(p, cfg, "cpu"), cfg,
                  priors=pri)
    with open(f"{tmp_path}/m.mdl", "rb") as a, \
            open(f"{tmp_path}/t.mdl", "rb") as b:
        assert a.read() == b.read()
    assert tn.load_nnet2(f"{tmp_path}/m.mdl")[1] == cfg


def test_log_priors():
    pri = np.array([0.0, 1.0, 3.0])
    want = np.log(np.maximum(pri / pri.sum(), 1e-20)).astype(np.float32)
    np.testing.assert_array_equal(tn.log_priors(pri), want)


def test_layer_names_and_update_scaling():
    cfg = dataclasses.replace(CFG, learn_rates=(1e-3, 4e-3))
    assert tn.layer_names(cfg) == jn.layer_names(jcfg(cfg)) == (
        "pnorm1", "pnorm2", "output_affine")
    ups = {n: {"affine": {"kernel": np.ones((2, 2), np.float32)}}
           for n in ("pnorm1", "pnorm2")}
    ups["output_affine"] = {"bias": np.ones(3, np.float32)}
    want = jn.scale_updates_per_layer(ups, jcfg(cfg), 2e-3)
    got = tn.scale_updates_per_layer(ups, cfg, 2e-3)
    for (k, a), (_, b) in zip(tree_leaves(got), tree_leaves(
            jax.tree_util.tree_map(np.asarray, want))):
        np.testing.assert_allclose(a, b, rtol=1e-7, err_msg=str(k))
    assert tn.scale_updates_per_layer(ups, CFG, 2e-3) is ups


# ---------------------------------------------------------------------------
# raw nets

def nnet1_params(rng, dims=(6, 10, 10, 7)):
    out = {}
    for i in range(len(dims) - 1):
        name = "output_affine" if i == len(dims) - 2 else f"hidden{i + 1}"
        out[name] = {
            "kernel": rng.standard_normal(dims[i:i + 2]).astype(np.float32),
            "bias": rng.standard_normal(dims[i + 1]).astype(np.float32)}
    return out


def raw_nets(params):
    rng = np.random.default_rng(5)
    n1 = nnet1_params(rng)
    return {
        "nnet2": (tr.from_nnet2(params["plain"], CFG),
                  jr.from_nnet2(params["plain"], jcfg(CFG))),
        "nnet1": (tr.from_nnet1(n1, (10, 10), 7),
                  jr.from_nnet1(n1, (10, 10), 7)),
        "pnorm3": (tr.from_nnet2(params["plain"],
                                 dataclasses.replace(CFG, p=3.0)),
                   jr.from_nnet2(params["plain"],
                                 jcfg(dataclasses.replace(CFG, p=3.0)))),
    }


@pytest.mark.parametrize("kind", ["nnet2", "nnet1", "pnorm3"])
def test_raw_conversion_forward_and_files(params, tmp_path, kind):
    got, want = raw_nets(params)[kind]
    assert [c for c, _ in got] == [c for c, _ in want]
    for (_, a), (_, b) in zip(got, want):
        trees_equal(a, b)
    assert [tr.component_dims(c) for c in got] == \
        [jr.component_dims(c) for c in want]
    x = np.random.default_rng(6).standard_normal((13, 6)).astype(np.float32)
    out = tr.forward(got, x, "cpu")
    close(out, np.asarray(jr.forward(want, x)))
    assert out.shape == (13, 7)
    close(tr.forward(got, x[None], "cpu"), np.asarray(jr.forward(want,
                                                                 x[None])))
    # byte-equal files, read by the other side
    tr.save_raw_nnet(f"{tmp_path}/t.raw", got)
    jr.save_raw_nnet(f"{tmp_path}/j.raw", want)
    with open(f"{tmp_path}/t.raw", "rb") as a, \
            open(f"{tmp_path}/j.raw", "rb") as b:
        assert a.read() == b.read()
    back_t = tr.load_raw_nnet(f"{tmp_path}/j.raw")
    back_j = jr.load_raw_nnet(f"{tmp_path}/t.raw")
    for (ca, a), (cb, b) in zip(back_t, back_j):
        assert ca == cb
        trees_equal(a, jax.tree_util.tree_map(np.asarray, dict(b)))


def test_raw_nnet2_equals_the_model(params):
    x = np.random.default_rng(7).standard_normal((10, 6)).astype(np.float32)
    model = tn.nnet2_model(params["plain"], CFG, "cpu")
    with torch.no_grad():
        want = model(torch.from_numpy(x)[None])[0]
    got = tr.forward(tr.from_nnet2(params["plain"], CFG), x, "cpu")
    close(got, want.numpy())


def test_raw_nnet_rejects_unknown_types(tmp_path):
    with pytest.raises(KaldiError):
        tr.save_raw_nnet(f"{tmp_path}/x.raw", [("relu", {})])


# ---------------------------------------------------------------------------
# parallel SGD with averaging

def test_train_parallel_averaging_from_the_jax_init():
    cfg = dataclasses.replace(CFG, num_pdfs=5)
    rng = np.random.default_rng(8)
    feats = rng.standard_normal((32, 6, 6)).astype(np.float32)
    targets = rng.integers(0, 5, (32, 6)).astype(np.int32)
    want, wd = jn.train_parallel_averaging(jcfg(cfg), feats, targets,
                                           num_jobs=2, num_iters=3,
                                           learning_rate=0.05, seed=3)
    got, gd = tn.train_parallel_averaging(cfg, feats, targets, num_jobs=2,
                                          num_iters=3, learning_rate=0.05,
                                          params=jax_init(cfg, 3),
                                          device="cpu")
    start = jax_init(cfg, 3)
    for (k, a), (_, b), (_, s) in zip(
            tree_leaves(got), tree_leaves(
                jax.tree_util.tree_map(np.asarray, dict(want))),
            tree_leaves(start)):
        close(a, b, 1e-4)
        assert np.abs(b - s).max() > 1e-4, k      # the run moved it
    assert gd["xent"] == pytest.approx(wd["xent"], rel=1e-5)


def test_train_parallel_averaging_draws_from_its_generator():
    cfg = dataclasses.replace(CFG, num_pdfs=5)
    rng = np.random.default_rng(9)
    feats = rng.standard_normal((20, 4, 6)).astype(np.float32)
    targets = rng.integers(0, 5, (20, 4)).astype(np.int64)
    a, da = tn.train_parallel_averaging(
        cfg, feats, targets, num_jobs=2, num_iters=1,
        generator=torch.Generator().manual_seed(4), device="cpu")
    b, db = tn.train_parallel_averaging(cfg, feats, targets, num_jobs=2,
                                        num_iters=1, seed=4, device="cpu")
    trees_equal(a, b)
    assert np.isfinite(da["xent"]) and da["xent"] == db["xent"]
