"""PyTorch TdnnChain against the flax TdnnChain (inference forward).

Every parameter and batch statistic, the output layer included, is
drawn from numpy (flax initialises output_affine to zeros, which would
make every output equal) and converted with ``params_from_flax``.
Tolerance rtol/atol 1e-4: float32 products summed in another order.
"""

import jax
import numpy as np
import pytest
import torch

from kaldi_tpu.am import tdnn as jtdnn
from kaldi_tpu_torch.am import tdnn as ttdnn

torch.set_num_threads(1)

CFG = dict(feat_dim=40, num_pdfs=24, hidden_dim=64, bottleneck_dim=16,
           num_layers=4, frame_subsampling_factor=3)


def _random_variables(seed):
    model = jtdnn.TdnnChain(jtdnn.TdnnConfig(**CFG))
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


def _port(variables):
    m = ttdnn.TdnnChain(ttdnn.TdnnConfig(**CFG))
    m.load_state_dict(ttdnn.params_from_flax(variables))
    return m.eval()


@pytest.mark.parametrize("T", [7, 13, 20])
def test_tdnn_chain_matches_flax(T):
    model, variables = _random_variables(seed=T)
    x = np.random.default_rng(100 + T).standard_normal(
        (2, T, CFG["feat_dim"])).astype(np.float32)
    want = np.asarray(model.apply(variables, x, train=False))
    with torch.no_grad():
        got = _port(variables)(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, -(-T // 3), CFG["num_pdfs"])
    assert np.std(want) > 0.1          # outputs are not all equal
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_params_from_flax_layout():
    _, variables = _random_variables(seed=1)
    sd = ttdnn.params_from_flax(variables)
    k = np.asarray(variables["params"]["tdnnf2"]["affine"]["kernel"])
    np.testing.assert_array_equal(sd["tdnnf.1.affine.weight"].numpy(), k.T)
    np.testing.assert_array_equal(
        sd["tdnnf.3.batchnorm.var"].numpy(),
        np.asarray(variables["batch_stats"]["tdnnf4"]["batchnorm"]["var"]))
    # strict load: the converted dict names every tensor of the module
    assert set(sd) == set(_port(variables).state_dict())


@pytest.mark.parametrize("offsets", [(-1, 0, 1), (0, 3), (-3, 0), (0,)])
def test_splice_matches(offsets):
    x = np.random.default_rng(3).standard_normal((2, 5, 3)).astype(
        np.float32)
    want = np.asarray(jtdnn.splice(x, offsets))
    got = ttdnn.splice(torch.from_numpy(x), offsets).numpy()
    np.testing.assert_array_equal(got, want)
