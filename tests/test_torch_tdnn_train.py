"""The port's TdnnChain in training mode (kaldi_tpu_torch/am/tdnn.py)
against flax's TdnnChain (kaldi_tpu/am/tdnn.py).

Parameters and batch statistics are drawn from numpy and converted with
``params_from_flax``.  Tolerances: float32 forward, batch statistics and
penalty rtol/atol 1e-4 (float32 sums in other orders); the loss's
gradient w.r.t. every parameter 1e-4 of that tensor's largest entry;
bfloat16 compute 2e-2 of the output's largest entry (bf16 rounds at
other places in the two frameworks).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kaldi_tpu.am import tdnn as jtdnn
from kaldi_tpu_torch.am import tdnn as ttdnn

torch.set_num_threads(1)

CFG = dict(feat_dim=12, num_pdfs=10, hidden_dim=32, bottleneck_dim=8,
           num_layers=4, frame_subsampling_factor=3)


def _variables(seed, dtype="float32"):
    cfg = jtdnn.TdnnConfig(**CFG, compute_dtype=dtype)
    model = jtdnn.TdnnChain(cfg)
    init = model.init(jax.random.PRNGKey(0),
                      np.zeros((1, 9, CFG["feat_dim"]), np.float32),
                      train=False)
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = getattr(path[-1], "key", "")
        shape = np.shape(leaf)
        if name == "var":
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        scale = 1.0 / np.sqrt(shape[0]) if name == "kernel" else 0.2
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    variables = jax.tree_util.tree_map_with_path(
        draw, jax.tree_util.tree_map(np.asarray, dict(init)))
    return model, variables


def _port(variables, dtype="float32"):
    m = ttdnn.TdnnChain(ttdnn.TdnnConfig(**CFG, compute_dtype=dtype))
    m.load_state_dict(ttdnn.params_from_flax(variables))
    return m


def _x(seed, B=3, T=16):
    return np.random.default_rng(seed).standard_normal(
        (B, T, CFG["feat_dim"])).astype(np.float32)


def _rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max()
                 / max(np.abs(np.asarray(b)).max(), 1e-12))


@pytest.mark.parametrize("T", [13, 24])
def test_train_forward_and_batch_stats_match_flax(T):
    """Train mode: normalization by the batch's biased statistics, and
    the running statistics after one forward (mutable apply)."""
    model, variables = _variables(seed=T)
    x = _x(T, T=T)
    want, upd = model.apply(variables, x, train=True,
                            mutable=["batch_stats"])
    net = _port(variables).train()
    got = net(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-4)
    back = ttdnn.params_to_flax(net.state_dict())["batch_stats"]
    flat_w = jax.tree_util.tree_leaves_with_path(upd["batch_stats"])
    for path, leaf in flat_w:
        node = back
        for p in path:
            node = node[p.key]
        np.testing.assert_allclose(node, np.asarray(leaf), rtol=1e-4,
                                   atol=1e-5, err_msg=str(path))


@pytest.mark.parametrize("train", [False, True])
def test_bfloat16_compute_matches_flax(train):
    """compute_dtype="bfloat16": dense layers in bf16 from float32
    parameters, batch norm and the output layer in float32."""
    model, variables = _variables(seed=5, dtype="bfloat16")
    x = _x(6)
    if train:
        want, _ = model.apply(variables, x, train=True,
                              mutable=["batch_stats"])
    else:
        want = model.apply(variables, x, train=False)
    net = _port(variables, "bfloat16").train(train)
    got = net(torch.from_numpy(x))
    assert got.dtype == torch.float32
    assert _rel(got.detach().numpy(), want) < 2e-2
    # and bf16 is not float32: the f32 forward differs measurably
    f32 = _port(variables).train(train)(torch.from_numpy(x))
    assert _rel(got.detach().numpy(), f32.detach().numpy()) > 1e-4


def test_semi_orthogonal_penalty_matches():
    _, variables = _variables(seed=2)
    want = float(jtdnn.semi_orthogonal_penalty(variables["params"]))
    got = float(ttdnn.semi_orthogonal_penalty(_port(variables)).detach())
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_gradient_matches_jax_grad():
    """d loss / d every parameter, loss = Σ outputs² / 2 + penalty, in
    training mode (the gradient flows through the batch statistics)."""
    model, variables = _variables(seed=7)
    x = _x(7)
    bs = variables["batch_stats"]

    def loss(params):
        out, _ = model.apply({"params": params, "batch_stats": bs}, x,
                             train=True, mutable=["batch_stats"])
        return 0.5 * jnp.sum(out ** 2) + jtdnn.semi_orthogonal_penalty(
            params)
    jg = jax.grad(loss)(variables["params"])
    net = _port(variables).train()
    out = net(torch.from_numpy(x))
    (0.5 * (out ** 2).sum() + ttdnn.semi_orthogonal_penalty(net)).backward()
    grads = dict(net.state_dict())          # the statistics' slots
    grads.update({k: p.grad for k, p in net.named_parameters()})
    tg = ttdnn.params_to_flax(grads)["params"]
    for path, leaf in jax.tree_util.tree_leaves_with_path(jg):
        node = tg
        for p in path:
            node = node[p.key]
        assert _rel(node, leaf) < 1e-4, path


def test_params_to_flax_round_trip():
    _, variables = _variables(seed=3)
    sd = ttdnn.params_from_flax(variables)
    back = ttdnn.params_to_flax(sd)
    for tree in ("params", "batch_stats"):
        a = jax.tree_util.tree_leaves_with_path(variables[tree])
        b = dict(jax.tree_util.tree_leaves_with_path(back[tree]))
        assert len(a) == len(b)
        for path, leaf in a:
            np.testing.assert_array_equal(b[path], leaf)


def test_init_draws_flax_distributions():
    """Fresh weights as flax's initialisers draw them: lecun-normal
    kernels (std 1/√fan_in), zero biases, a zero output kernel,
    statistics (0, 1)."""
    cfg = ttdnn.TdnnConfig(feat_dim=40, num_pdfs=16, hidden_dim=256,
                           bottleneck_dim=64, num_layers=3)
    net = ttdnn.init_tdnn(ttdnn.TdnnChain(cfg), seed=1)
    w = net.tdnnf[1].affine.weight.detach()
    assert float(w.std()) == pytest.approx(1 / np.sqrt(128), rel=0.05)
    assert float(w.abs().max()) <= 2.0 / np.sqrt(128) / 0.8796 + 1e-6
    assert float(net.output_affine.weight.abs().max()) == 0.0
    assert float(net.prefinal.bias.abs().max()) == 0.0
    assert float(net.input_bn.var.min()) == 1.0
    again = ttdnn.init_tdnn(ttdnn.TdnnChain(cfg), seed=1)
    assert torch.equal(again.tdnnf[1].affine.weight, w)
    assert dataclasses.asdict(cfg)["compute_dtype"] == "float32"
