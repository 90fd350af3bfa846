"""The port's time-height convolution (kaldi_tpu_torch/am/cnn.py)
against flax's (kaldi_tpu/am/cnn.py), mirroring tests/test_cnn.py: the
numpy direct-convolution oracle, height subsampling, contiguous offsets,
the conv-relu-batchnorm-layer CNN-TDNN front end through xconfig, and
float32 whatever cuDNN's TF32 flag says.

flax's variables cross through ``state_dict_from_flax`` (HWIO kernels
to torch's OIHW).  Tolerances: the oracle and flax's outputs within 1e-4
absolute (float32 sums in other orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kaldi_tpu.am.cnn import TimeHeightConv as JConv
from kaldi_tpu.am.xconfig import model_from_xconfig as jmodel
from kaldi_tpu_torch.am import cnn as tcnn
from kaldi_tpu_torch.am.tdnn import state_dict_from_flax
from kaldi_tpu_torch.am.xconfig import model_from_xconfig as tmodel

torch.set_num_threads(1)


def conv_oracle(x, kernel, bias, height_in, t_offs, h_offs, sub):
    """Direct-sum reference: out[b,t,h,f] = Σ_{dt,dh,c}
    x[b,t+dt,h*sub+dh,c]·K[dt,dh,c,f], zero-padded out of range."""
    B, T, D = x.shape
    cin = D // height_in
    img = x.reshape(B, T, height_in, cin)
    hout = (height_in - 1) // sub + 1
    F = kernel.shape[-1]
    out = np.zeros((B, T, hout, F), np.float32)
    for b in range(B):
        for t in range(T):
            for h in range(hout):
                acc = np.zeros(F, np.float32)
                for i, dt in enumerate(t_offs):
                    for j, dh in enumerate(h_offs):
                        ts, hs = t + dt, h * sub + dh
                        if 0 <= ts < T and 0 <= hs < height_in:
                            acc += img[b, ts, hs] @ kernel[i, j]
                out[b, t, h] = acc + bias
    return out.reshape(B, T, hout * F)


@pytest.mark.parametrize("sub,h_offs", [(1, (-1, 0, 1)), (2, (0, 1))])
def test_time_height_conv_matches_oracle(sub, h_offs):
    rng = np.random.default_rng(0)
    B, T, H, cin, F = 2, 9, 8, 3, 4
    t_offs = (-2, -1, 0, 1, 2)
    x = rng.standard_normal((B, T, H * cin)).astype(np.float32)
    jlayer = JConv(height_in=H, num_filters_out=F, time_offsets=t_offs,
                   height_offsets=h_offs, height_subsample=sub)
    v = jax.tree_util.tree_map(np.asarray, jlayer.init(
        jax.random.PRNGKey(0), jnp.asarray(x)))
    layer = tcnn.TimeHeightConv(H, H * cin, F, t_offs, h_offs, sub)
    layer.load_state_dict(state_dict_from_flax(v))
    with torch.no_grad():
        out = layer(torch.from_numpy(x)).numpy()
    ref = conv_oracle(x, v["params"]["kernel"], v["params"]["bias"], H,
                      t_offs, h_offs, sub)
    assert out.shape == ref.shape
    assert layer.height_out == (H - 1) // sub + 1
    np.testing.assert_allclose(out, ref, atol=1e-4)
    np.testing.assert_allclose(out, np.asarray(jlayer.apply(
        v, jnp.asarray(x))[0]), atol=1e-4)


def test_noncontiguous_offsets_rejected():
    with pytest.raises(ValueError):
        tcnn.TimeHeightConv(4, 8, 2, time_offsets=(-3, 0, 3))
    with pytest.raises(ValueError):
        JConv(height_in=4, num_filters_out=2, time_offsets=(-3, 0, 3)) \
            .init(jax.random.PRNGKey(0), jnp.zeros((1, 4, 8)))


def test_xconfig_cnn_tdnnf_front_end():
    """The CNN-TDNN recipe shape: conv front end (with height
    subsampling) feeding a TDNN-F trunk, via xconfig; widths resolved at
    construction (cnn2's 20 heights × 8 filters = 160 into tdnnf3's two
    splice taps), outputs equal to flax's."""
    text = """
input name=input dim=40
conv-relu-batchnorm-layer name=cnn1 height-in=40 num-filters-out=8 time-offsets=-1,0,1 height-offsets=-1,0,1
conv-relu-batchnorm-layer name=cnn2 height-in=40 num-filters-out=8 time-offsets=-1,0,1 height-offsets=-1,0,1 height-subsample-out=2
tdnnf-layer name=tdnnf3 dim=32 bottleneck-dim=8 time-stride=1
output-layer name=output dim=20 include-log-softmax=false
"""
    jm, _, _ = jmodel(text)
    x = np.random.default_rng(1).standard_normal((2, 11, 40)) \
        .astype(np.float32)
    v = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0),
                                                   jnp.asarray(x)))
    v["params"]["output.affine"]["kernel"] = np.random.default_rng(2) \
        .standard_normal((32, 20)).astype(np.float32)
    tm, _, _ = tmodel(text)
    assert tuple(tm.tdnnf3.linear.weight.shape) == (8, 2 * 160)
    tm.load_state_dict(state_dict_from_flax(v))
    tm.train()
    out = tm(torch.from_numpy(x))["output"]
    want = jm.apply(v, jnp.asarray(x), train=True,
                    mutable=["batch_stats"])[0]["output"]
    assert tuple(out.shape) == (2, 11, 20)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               atol=1e-4)


def test_conv_runs_cudnn_without_tf32(monkeypatch):
    """With a card present, the layer's conv2d and its gradient both run
    under cuDNN flags with allow_tf32 off, whatever the global flag; the
    global flags stay as they were; values and gradients are those of
    the plain call."""
    seen = []
    real = torch.nn.functional.conv2d

    def spy(*a, **kw):
        seen.append(("forward", torch.backends.cudnn.allow_tf32))
        out = real(*a, **kw)
        out.register_hook(lambda g: seen.append(
            ("backward", torch.backends.cudnn.allow_tf32)))
        return out

    layer = tcnn.TimeHeightConv(4, 8, 2)
    torch.nn.init.normal_(layer.weight)
    x = torch.randn(2, 5, 8, generator=torch.Generator().manual_seed(0),
                    requires_grad=True)
    plain = layer(x)
    (plain ** 2).sum().backward()
    want = [x.grad.clone(), layer.weight.grad.clone()]
    x.grad = layer.weight.grad = layer.bias.grad = None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(tcnn.F, "conv2d", spy)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    out = layer(x)
    (out ** 2).sum().backward()
    assert seen == [("forward", False), ("backward", False)]
    assert torch.backends.cudnn.allow_tf32 is True
    torch.testing.assert_close(out, plain)
    torch.testing.assert_close(x.grad, want[0])
    torch.testing.assert_close(layer.weight.grad, want[1])
