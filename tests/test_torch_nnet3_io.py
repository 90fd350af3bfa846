"""The port's nnet3 reader/writer against kaldi_tpu's, both ways.

A TDNN-F written by the JAX package (``write_raw_model`` of flax
variables) reads into the port's ``TdnnChain`` with the same forward,
and one written by the port reads into the flax model with the same
forward (within 1e-5; on each side the weights come back bit for bit).
``infer_tdnn_config`` recovers the port's config from the file, and the
tool's loader defaults to the card.
"""

import inspect

import numpy as np
import pytest
import torch

from kaldi_tpu.am import nnet3_io as jio
from kaldi_tpu.am import tdnn as jtdnn
from kaldi_tpu_torch.am import nnet3_io as tio
from kaldi_tpu_torch.am import tdnn as ttdnn
from kaldi_tpu_torch.cli.online2 import _load_tdnn
from kaldi_tpu_torch.core.logging import KaldiError
from test_torch_online_nnet import random_tdnn

torch.set_num_threads(1)

CFG = dict(feat_dim=13, num_pdfs=12, hidden_dim=24, bottleneck_dim=8,
           num_layers=4, frame_subsampling_factor=3)


@pytest.fixture(scope="module")
def model():
    apply_fn, variables, net = random_tdnn(3, **CFG)
    x = np.random.default_rng(4).standard_normal(
        (2, 31, CFG["feat_dim"])).astype(np.float32)
    return apply_fn, variables, net, x


def _forward(net, x):
    with torch.no_grad():
        return net(torch.from_numpy(x)).numpy()


def test_jax_written_model_reads_into_the_port(model, tmp_path):
    apply_fn, variables, net, x = model
    path = str(tmp_path / "final.raw")
    jio.write_raw_model(path, variables["params"], variables["batch_stats"],
                        jtdnn.TdnnConfig(**CFG))
    cfg = tio.infer_tdnn_config(tio.read_nnet3_path(path))
    assert cfg == ttdnn.TdnnConfig(**CFG)
    got = ttdnn.TdnnChain(cfg)
    got.load_state_dict(tio.read_raw_model(path, cfg))
    for k, v in net.state_dict().items():
        assert torch.equal(got.state_dict()[k], v), k
    np.testing.assert_allclose(_forward(got.eval(), x),
                               np.asarray(apply_fn(x)), rtol=1e-5, atol=1e-5)


def test_port_written_model_reads_into_jax(model, tmp_path):
    apply_fn, variables, net, x = model
    path = str(tmp_path / "final.raw")
    tio.write_raw_model(path, net.state_dict(), ttdnn.TdnnConfig(**CFG))
    jcfg = jtdnn.TdnnConfig(**CFG)
    params, stats = jio.read_raw_model(path, jcfg)
    import jax
    same = jax.tree_util.tree_map(
        lambda a, b: bool(np.array_equal(np.asarray(a), np.asarray(b))),
        {"params": params, "batch_stats": stats}, variables)
    assert all(jax.tree_util.tree_leaves(same))
    back = jtdnn.TdnnChain(jcfg).apply(
        {"params": params, "batch_stats": stats}, x, train=False)
    np.testing.assert_allclose(np.asarray(back), _forward(net, x),
                               rtol=1e-5, atol=1e-5)
    # and the component list is what the JAX writer gives
    jm = jio.tdnn_to_nnet3(variables["params"], variables["batch_stats"],
                           jcfg)
    tm = tio.state_dict_to_nnet3(net.state_dict(), ttdnn.TdnnConfig(**CFG))
    assert tm.config_lines == jm.config_lines
    assert [(c.name, c.ctype, list(c.fields)) for c in tm.components] == \
        [(c.name, c.ctype, list(c.fields)) for c in jm.components]


def test_load_tdnn_builds_the_model(model, tmp_path):
    _, _, net, x = model
    path = str(tmp_path / "final.raw")
    tio.write_raw_model(path, net.state_dict(), ttdnn.TdnnConfig(**CFG))
    cfg, loaded = _load_tdnn(path, 3, device="cpu")
    assert cfg.num_layers == 4 and not loaded.training
    np.testing.assert_array_equal(_forward(loaded, x), _forward(net, x))
    assert inspect.signature(_load_tdnn).parameters["device"].default \
        == "cuda"
    with open(path, "r+b") as f:
        f.write(b"\0X")
    with pytest.raises(KaldiError, match="binary header"):
        tio.read_nnet3_path(path)
