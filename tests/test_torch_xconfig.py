"""The port's xconfig language (kaldi_tpu_torch/am/xconfig.py) against
the JAX package's (kaldi_tpu/am/xconfig.py), mirroring
tests/test_xconfig.py's seven tests, then one NG-SGD ChainTrainer step on
an xconfig model that holds every layer type, and the dropout repair.

Each side builds its model from the same xconfig text; the flax
variables (drawn from numpy where the test says so) cross to the port
through ``state_dict_from_flax``.  Tolerances: eval-mode outputs 1e-5
of their largest entry; training-mode outputs, gradients, parameters
and batch statistics after NG-SGD steps 1e-4 of each tensor's largest
entry (float32 sums in other orders; the NG-SGD estimates go through
two libraries' QR and eigh).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kaldi_tpu.am import chain as jc
from kaldi_tpu.am import tree as jtree
from kaldi_tpu.am import xconfig as jx
from kaldi_tpu.am.topology import HmmTopology as JTopo
from kaldi_tpu.core.logging import KaldiError as JKaldiError
from kaldi_tpu.pipelines import chain as jpc
from kaldi_tpu_torch.am import chain as tc
from kaldi_tpu_torch.am import tdnn as ttdnn
from kaldi_tpu_torch.am import tree as ttree
from kaldi_tpu_torch.am import xconfig as tx
from kaldi_tpu_torch.am.topology import HmmTopology as TTopo
from kaldi_tpu_torch.core.logging import KaldiError
from kaldi_tpu_torch.pipelines import chain as tpc

torch.set_num_threads(1)

CHAIN_XCONFIG = """
# librispeech 1d-style factored TDNN (trimmed)
input name=input dim=40
relu-batchnorm-layer name=tdnn1 input=Append(-1,0,1) dim=64
tdnnf-layer name=tdnnf2 dim=64 bottleneck-dim=16 time-stride=1
tdnnf-layer name=tdnnf3 dim=64 bottleneck-dim=16 time-stride=3
relu-batchnorm-layer name=prefinal-chain dim=64
output-layer name=output dim=50 include-log-softmax=false
output-layer name=output-xent input=prefinal-chain dim=50
"""

# every layer type of the grammar, at tiny widths
ALL_LAYERS = """
input name=input dim=8
conv-relu-batchnorm-layer name=cnn1 height-in=8 num-filters-out=2
conv-relu-batchnorm-layer name=cnn2 height-in=8 num-filters-out=2 height-subsample-out=2
relu-batchnorm-layer name=tdnn1 input=Append(-1,0,1) dim=12
tdnnf-layer name=tdnnf2 dim=12 bottleneck-dim=4 time-stride=1
tdnnf-layer name=tdnnf3 dim=12 bottleneck-dim=4 time-stride=3
fast-lstmp-layer name=lstm1 cell-dim=10 recurrent-projection-dim=6
relu-batchnorm-layer name=tdnn4 input=Append(-3,0,3) dim=12
attention-relu-batchnorm-layer name=att1 dim=12 num-heads=2 num-left-inputs=3 num-right-inputs=3
stats-layer name=stats1 config=mean+stddev(-9:3:9:9)
relu-batchnorm-layer name=prefinal-chain dim=12
output-layer name=output dim={P} include-log-softmax=false
"""


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-6))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _draw(variables, seed, scale=0.3):
    """Every parameter drawn from numpy (kernels of the output layers
    too, which flax starts at zero), batch-norm variances in [0.5, 1.5]."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        shape = np.shape(leaf)
        if getattr(path[-1], "key", "") == "var":
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, _np(variables))


def _port(text, variables, sub=1):
    model, _, _ = tx.model_from_xconfig(text, sub)
    model.load_state_dict(ttdnn.state_dict_from_flax(variables))
    return model


def _lines(lines):
    return [(l.layer_type, l.name, l.inputs, l.opts) for l in lines]


def test_parse_descriptor_forms():
    """The original's descriptor forms parse to the original's tuples."""
    for desc in ("tdnn1", "-3", "Offset(tdnn1, -3)", "Append(-1,0,1)",
                 "Append(Offset(a,-1), b, 2)"):
        assert tx._parse_descriptor(desc) == jx._parse_descriptor(desc)
    assert tx._parse_descriptor("Append(Offset(a,-1), b, 2)") == \
        (("a", -1), ("b", 0), ("", 2))
    with pytest.raises(KaldiError):
        tx._parse_descriptor("Sum(a, b)")


@pytest.mark.parametrize("text", [
    "input name=input dim=4\nrelu-batchnorm-layer name=a input=zzz dim=8\n"
    "output-layer name=output dim=4",
    "input name=input dim=4\nrelu-batchnorm-layer name=a dim=8\n"
    "relu-batchnorm-layer name=a dim=8\noutput-layer name=output dim=4",
    "input name=input dim=4\nrelu-batchnorm-layer name=a dim=8",
    "relu-batchnorm-layer name=a dim=8\noutput-layer name=output dim=4"],
    ids=["undefined", "duplicate", "no-output", "input-not-first"])
def test_parse_validation(text):
    """Both packages refuse the same texts; both parse the same lines
    (the unknown options kept and ignored, as the original does)."""
    with pytest.raises(KaldiError):
        tx.parse_xconfig(text)
    with pytest.raises(JKaldiError):
        jx.parse_xconfig(text)
    ok = CHAIN_XCONFIG + "relu-batchnorm-layer name=z dim=4 delay=-1\n"
    assert _lines(tx.parse_xconfig(ok)) == _lines(jx.parse_xconfig(ok))


def test_chain_model_shapes_and_grads():
    """Both heads' shapes and values (×3 subsampled), the xent head a
    log-softmax, and the gradients of Σ output² in training mode equal
    flax's, the output kernels nonzero."""
    jm, in_dim, out_dims = jx.model_from_xconfig(CHAIN_XCONFIG, 3)
    x = np.random.default_rng(0).standard_normal((2, 30, 40)) \
        .astype(np.float32)
    v = _draw(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), seed=1)
    tm = _port(CHAIN_XCONFIG, v, 3)
    assert (in_dim, out_dims) == (40, {"output": 50, "output-xent": 50})
    tm.eval()
    jo = jm.apply(v, jnp.asarray(x))
    with torch.no_grad():
        to = tm(torch.from_numpy(x))
    for k in ("output", "output-xent"):
        assert tuple(to[k].shape) == (2, 10, 50)
        assert _rel(to[k], jo[k]) < 1e-5, k
    assert float(to["output-xent"][0, 0].exp().sum()) == \
        pytest.approx(1.0, abs=1e-3)

    def loss(params):
        o, _ = jm.apply({"params": params, "batch_stats": v["batch_stats"]},
                        jnp.asarray(x), train=True, mutable=["batch_stats"])
        return jnp.sum(o["output"] ** 2)

    jg = ttdnn.state_dict_from_flax({"params": _np(jax.grad(loss)(
        v["params"]))})
    tm.train()
    (tm(torch.from_numpy(x))["output"] ** 2).sum().backward()
    # the xent head takes no gradient here (None; zeros in flax)
    tg = {k: torch.zeros_like(p) if p.grad is None else p.grad
          for k, p in tm.named_parameters()}
    assert set(tg) == set(jg)
    for k in jg:
        assert torch.isfinite(tg[k]).all()
        assert _rel(tg[k], jg[k]) < 1e-4, k
    assert any(float(g.abs().max()) > 0 for g in tg.values())


def test_descriptor_append_equals_manual_splice():
    """Append(-1,0,1) into a relu layer == a manual edge-clamped splice
    through the same kernel, on both sides."""
    text = ("input name=input dim=4\n"
            "relu-batchnorm-layer name=a input=Append(-1,0,1) dim=8\n"
            "output-layer name=output input=a dim=8 "
            "include-log-softmax=false\n")
    jm, _, _ = jx.model_from_xconfig(text)
    x = np.random.default_rng(1).standard_normal((1, 7, 4)) \
        .astype(np.float32)
    v = _np(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    _, state = jm.apply(v, jnp.asarray(x), capture_intermediates=True,
                        mutable=["intermediates"])
    jdense = np.asarray(state["intermediates"]["a.affine"]["__call__"][0])
    tm = _port(text, v).eval()
    seen = []
    tm.a.affine.register_forward_hook(lambda m, i, o: seen.append(o))
    with torch.no_grad():
        tm(torch.from_numpy(x))
    kern = np.asarray(v["params"]["a.affine"]["kernel"])
    bias = np.asarray(v["params"]["a.affine"]["bias"])
    idx = np.arange(7)
    spliced = np.concatenate(
        [x[0][np.clip(idx + o, 0, 6)] for o in (-1, 0, 1)], axis=-1)
    np.testing.assert_allclose(seen[0][0].numpy(), spliced @ kern + bias,
                               atol=1e-5)
    np.testing.assert_allclose(seen[0][0].numpy(), jdense[0], atol=1e-5)


def test_lstm_attention_stats_layers():
    """fast-lstmp, attention and stats layers: the stats layer doubles
    the width before the output (16 = 2 × 8), and the outputs equal
    flax's."""
    text = ("input name=input dim=6\n"
            "fast-lstmp-layer name=lstm1 cell-dim=16 "
            "recurrent-projection-dim=8\n"
            "attention-relu-batchnorm-layer name=att1 dim=8 num-heads=2 "
            "num-left-inputs=3 num-right-inputs=3\n"
            "stats-layer name=stats1 config=mean+stddev(-4:1:1:4)\n"
            "output-layer name=output dim=5\n")
    jm, _, _ = jx.model_from_xconfig(text)
    x = np.random.default_rng(2).standard_normal((2, 12, 6)) \
        .astype(np.float32)
    v = _draw(jm.init(jax.random.PRNGKey(1), jnp.asarray(x)), seed=3)
    tm = _port(text, v).eval()
    assert tm.output.affine.weight.shape == (5, 16)
    with torch.no_grad():
        out = tm(torch.from_numpy(x))["output"]
    assert tuple(out.shape) == (2, 12, 5)
    assert _rel(out, jm.apply(v, jnp.asarray(x))["output"]) < 1e-5


def _tiny_chain():
    """Two phones, a monophone chain tree, each package's den graph
    and the same egs (tests/test_xconfig.py's corpus)."""
    rng = np.random.default_rng(7)
    runs = {"u0": [(1, 12), (2, 12), (1, 12)],
            "u1": [(2, 12), (1, 12), (2, 12)]}
    D = 6
    proto = {1: rng.standard_normal(D), 2: rng.standard_normal(D)}
    feats = {u: np.asarray(
        [proto[ph] + 0.1 * rng.standard_normal(D)
         for ph, dur in rr for _ in range(dur)], np.float32)
        for u, rr in runs.items()}
    topo = TTopo.chain([1, 2])
    tree = ttree.MonophoneContextDependency([1, 2], topo)
    den = tc.make_denominator_graph([[1, 2, 1], [2, 1, 2]], tree, topo)
    egs = tpc.make_chain_egs(feats, runs, tree, topo, chunk_size=18,
                             subsample=3)
    return D, tree, den, egs


def test_xconfig_chain_training():
    """chain_model_from_xconfig plugs into the port's ChainTrainer:
    training on tiny egs learns (objf > −5, as the original's test asks);
    the semi-orthogonal penalty sees the xconfig model's TDNN-F factor;
    a log-softmax chain head is refused."""
    D, tree, den, egs = _tiny_chain()
    text = f"""
input name=input dim={D}
relu-batchnorm-layer name=tdnn1 input=Append(-1,0,1) dim=16
tdnnf-layer name=tdnnf2 dim=16 bottleneck-dim=8 time-stride=1
output-layer name=output dim={tree.num_pdfs} include-log-softmax=false
"""
    model = tx.chain_model_from_xconfig(text, frame_subsampling_factor=3)
    assert model.feat_dim == D
    tr = tpc.ChainTrainer(model, den, tpc.ChainTrainConfig(
        num_epochs=30, batch_size=4, learning_rate=5e-3), device="cpu")
    w = tr.model.net.tdnnf2.linear.weight
    p = w @ w.T
    want = ((p - torch.trace(p) / 8 * torch.eye(8)) ** 2).sum().detach()
    assert float(ttdnn.semi_orthogonal_penalty(tr.model).detach()) == \
        pytest.approx(float(want), rel=1e-6)
    out = tr.train(egs, log_every=1000)
    assert np.isfinite(out["loss"])
    assert out["objf"] > -5.0
    with pytest.raises(KaldiError):
        tx.chain_model_from_xconfig(
            f"input name=input dim={D}\n"
            f"output-layer name=output dim={tree.num_pdfs}\n")


def test_stats_layer_windowed_moments():
    """stats-layer == host-side windowed mean/stddev (the output kernel
    set to identity so the output IS the stats tensor), and == flax's."""
    text = ("input name=input dim=3\n"
            "stats-layer name=s config=mean+stddev(-2:1:1:2)\n"
            "output-layer name=output dim=6 include-log-softmax=false\n")
    jm, _, _ = jx.model_from_xconfig(text)
    x = np.random.default_rng(3).standard_normal((1, 9, 3)) \
        .astype(np.float32)
    v = _np(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    v["params"]["output.affine"] = {"kernel": np.eye(6, dtype=np.float32),
                                    "bias": np.zeros(6, np.float32)}
    tm = _port(text, v).eval()
    with torch.no_grad():
        out = tm(torch.from_numpy(x))["output"][0].numpy()
    T = x.shape[1]
    expect = []
    for t in range(T):
        win = x[0][max(0, t - 2):min(T - 1, t + 2) + 1]
        expect.append(np.concatenate(
            [win.mean(axis=0), np.sqrt(np.maximum(win.var(axis=0), 1e-6))]))
    np.testing.assert_allclose(out, np.stack(expect), atol=1e-5)
    np.testing.assert_allclose(out, np.asarray(jm.apply(v, x)["output"])[0],
                               atol=1e-5)


PHONES = [1, 2, 3]
SEQS = [[1, 2, 3, 1, 2], [2, 1, 3, 3], [1, 2, 1, 2, 3], [3, 1, 2]]


@pytest.fixture(scope="module")
def two_ngsgd_steps():
    """Both packages' ChainTrainers (NG-SGD, f32) on the all-layer
    xconfig model from the same numpy-drawn variables: two steps on the
    same egs.  → [(JAX loss, port loss, JAX variables, port state)]."""
    rng = np.random.default_rng(0)
    runs = {f"u{i}": [(int(rng.integers(1, 4)), int(rng.integers(3, 10)))
                      for _ in range(12)] for i in range(4)}
    feats = {u: rng.standard_normal((sum(d for _, d in r), 8))
             .astype(np.float32) for u, r in runs.items()}
    sides = []
    for topo_cls, tree_mod, chain, pc in ((JTopo, jtree, jc, jpc),
                                          (TTopo, ttree, tc, tpc)):
        topo = topo_cls.chain(PHONES)
        tree = tree_mod.MonophoneContextDependency(PHONES, topo)
        den = chain.make_denominator_graph(SEQS, tree, topo, order=2)
        egs = pc.make_chain_egs(feats, runs, tree, topo, chunk_size=24,
                                subsample=3, den=den)
        sides.append((tree, den, egs))
    (jtr, jden, jeg), (ttr, tden, teg) = sides
    text = ALL_LAYERS.format(P=jtr.num_pdfs)
    cfg = dict(num_epochs=1, batch_size=4, learning_rate=1e-2,
               total_steps=10, optimizer="ngsgd")
    jt = jpc.ChainTrainer(jx.chain_model_from_xconfig(text), jden,
                          jpc.ChainTrainConfig(**cfg))
    v = _draw({"params": jt.params, "batch_stats": dict(jt.batch_stats)},
              seed=4)
    jt.params = jax.tree_util.tree_map(jnp.asarray, v["params"])
    jt.batch_stats = jax.tree_util.tree_map(jnp.asarray, v["batch_stats"])
    jt.opt_state = jt.tx.init(jt.params)
    tt = tpc.ChainTrainer(tx.chain_model_from_xconfig(text), tden,
                          tpc.ChainTrainConfig(**cfg), device="cpu")
    tt.model.load_state_dict(ttdnn.state_dict_from_flax(v))
    out = []
    for i in range(2):
        idx = np.arange(4 * i, 4 * i + 4) % jeg.feats.shape[0]
        ng = tuple(jnp.asarray(getattr(jeg, f)[idx]) for f in
                   ("entry_pdf", "self_pdf", "num_segs", "entry_w",
                    "self_w", "init_w", "final_w"))
        (jt.params, jt.batch_stats, jt.opt_state, jl, _) = jt._step(
            jt.params, jt.batch_stats, jt.opt_state,
            jnp.asarray(jeg.feats[idx]), jnp.asarray(jeg.pdf_ali[idx]),
            jnp.asarray(jeg.mask[idx]), ng)
        tl, _ = tt._step(*tt.batches(teg, idx))
        out.append((float(jl), float(tl), ttdnn.state_dict_from_flax(
            _np({"params": jt.params, "batch_stats": dict(jt.batch_stats)})),
            {k: v.clone() for k, v in tt.model.state_dict().items()}))
    return out


@pytest.mark.parametrize("n", [1, 2])
def test_ngsgd_step_on_every_layer_type_matches_jax(two_ngsgd_steps, n):
    """After steps 1 and 2 (the second one preconditioned): the loss and
    every parameter and batch statistic of the CNN, TDNN-F, LSTMP,
    attention, stats and dense layers."""
    jl, tl, want, got = two_ngsgd_steps[n - 1]
    assert tl == pytest.approx(jl, rel=1e-4)
    assert set(got) == set(want)
    for k in want:
        assert _rel(got[k], want[k]) < 1e-4, k


def test_dropout_is_repaired():
    """tdnnf-layer dropout-proportion=0.1 cannot train in the original
    (flax's Dropout gets no random key).  The port's trainer trains it:
    the masks come from the trainer's generator (two trainers with one
    seed take equal steps), a training-mode forward drops about 10% of
    a layer's outputs, and eval mode is the identity (the model's
    outputs equal those of the same weights without dropout)."""
    D, tree, den, egs = _tiny_chain()
    text = f"""
input name=input dim={D}
relu-batchnorm-layer name=tdnn1 input=Append(-1,0,1) dim=64
tdnnf-layer name=tdnnf2 dim=64 bottleneck-dim=8 time-stride=1 dropout-proportion=0.1
output-layer name=output dim={tree.num_pdfs} include-log-softmax=false
"""
    jm = jx.chain_model_from_xconfig(text)
    x = jnp.asarray(egs.feats[:2])
    jv = jm.init(jax.random.PRNGKey(0), x)
    with pytest.raises(Exception, match="PRNG"):
        jm.apply(jv, x, train=True, mutable=["batch_stats"])
    steps = []
    for _ in range(2):
        tr = tpc.ChainTrainer(tx.chain_model_from_xconfig(text), den,
                              tpc.ChainTrainConfig(batch_size=4),
                              seed=3, device="cpu")
        loss, _ = tr._step(*tr.batches(egs, np.arange(4)))
        steps.append((float(loss), tr.model.state_dict()))
    assert np.isfinite(steps[0][0]) and steps[0][0] == steps[1][0]
    for k, v in steps[0][1].items():
        assert torch.equal(v, steps[1][1][k]), k
    layer = tr.model.net.tdnnf2.train()
    seen = []
    layer.batchnorm.register_forward_hook(lambda m, i, o: seen.append(o))
    x64 = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (8, 30, 64)).astype(np.float32))
    with torch.no_grad():
        d = layer(x64) - layer.bypass_scale * x64
    share = float((d == 0).float().mean())
    assert 0.08 < share < 0.12, share
    nz = d != 0
    torch.testing.assert_close(d[nz], seen[0][nz] / 0.9)
    ref = tx.chain_model_from_xconfig(text.replace(
        " dropout-proportion=0.1", ""))
    ref.load_state_dict(tr.model.state_dict())
    tr.model.eval()
    ref.eval()
    with torch.no_grad():
        xe = torch.from_numpy(egs.feats[:2])
        assert torch.equal(tr.model(xe), ref(xe))


def test_chain_recipe_xconfig_default_trains(monkeypatch):
    """pipelines/chain_recipe.py with xconfig="default" on the CPU at
    the smallest settings that still train here (24 utterances, 12
    epochs, hidden 32): the chain objective rises by more than 0.2 over
    the run and the decode gets words right (WER below 100)."""
    from kaldi_tpu_torch.pipelines import chain_recipe
    objf = []
    real = tpc.ChainTrainer._step

    def step(self, *a, **kw):
        loss, diag = real(self, *a, **kw)
        objf.append(float(diag["objf"]))
        return loss, diag

    monkeypatch.setattr(tpc.ChainTrainer, "_step", step)
    wer = chain_recipe.run(num_utts=24, num_test=4, num_epochs=12,
                           hidden=32, xconfig="default", device="cpu")
    assert objf[-1] > objf[0] + 0.2, (objf[0], objf[-1])
    assert wer.wer < 100.0 and wer.ref_words > 0
