"""The port's xconfig, cross-entropy and x-vector tools
(kaldi_tpu_torch/cli/tools_nnet.py) against the JAX package's tools of
the same names, on the same input files.

* xconfig-to-configs: final.xconfig and network.txt byte for byte where
  every stats-layer reads the line before it; where one reads another
  layer, only that row differs (the port takes the width from its input
  descriptor, the original from the line before it).
* nnet3-train: from the same initial weights (the port's trainer is
  handed flax's), one Adam step on one batch; the raw nnet3 files hold
  the same components, every weight within the first Adam step's bar
  (tests/test_torch_rnnlm.py's: 1e-3·lr plus the step's sensitivity
  lr·eps·δg/(|g| + eps)² to a gradient error δg of 1e-5 of the tensor's
  largest gradient).
* nnet3-xvector-get-egs: archive and speaker list byte for byte.
* nnet3-xvector-compute and -batched: on a model file the JAX package
  wrote, embeddings within 1e-5 of their largest; the port's tools equal
  its library.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kaldi_tpu.cli import TOOLS as JTOOLS
from kaldi_tpu_torch.cli import TOOLS
from kaldi_tpu_torch.core.table import SequentialTableReader, TableWriter

torch.set_num_threads(1)

AGREE = """
input name=input dim=8
conv-relu-batchnorm-layer name=cnn1 height-in=8 num-filters-out=2
relu-batchnorm-layer name=tdnn1 input=Append(-1,0,1) dim=12
fast-lstmp-layer name=lstm1 cell-dim=10 recurrent-projection-dim=6
attention-relu-batchnorm-layer name=att1 dim=12 num-heads=2
stats-layer name=stats1 config=mean+stddev(-9:3:9:9)
relu-batchnorm-layer name=prefinal-chain dim=12
output-layer name=output dim=5 include-log-softmax=false
"""
# stats1 reads tdnn1 (12 wide) while the line before it is lstm1 (6)
DIFFER = AGREE.replace("attention-relu-batchnorm-layer name=att1 dim=12 "
                       "num-heads=2\n", "").replace(
    "stats-layer name=stats1", "stats-layer name=stats1 input=tdnn1")


def _run(tools, name, args):
    assert tools[name](args) == 0, name


def _configs(tmp_path, text):
    (tmp_path / "x.xconfig").write_text(text)
    out = {}
    for side, tools in (("port", TOOLS), ("jax", JTOOLS)):
        d = tmp_path / side
        _run(tools, "xconfig-to-configs",
             [f"--xconfig-file={tmp_path}/x.xconfig", f"--config-dir={d}",
              "--frame-subsampling-factor=3"])
        out[side] = d
    return out["port"], out["jax"]


def test_xconfig_to_configs_where_they_agree(tmp_path):
    a, b = _configs(tmp_path, AGREE)
    for f in ("final.xconfig", "network.txt"):
        assert (a / f).read_bytes() == (b / f).read_bytes(), f
    assert "stats1 stats-layer 24" in (a / "network.txt").read_text()


def test_xconfig_to_configs_stats_width_from_its_input(tmp_path):
    """stats1 reads tdnn1: the port's row says 2 × 12, the original's
    2 × 6 (lstm1, the line before it); the other rows are equal."""
    a, b = _configs(tmp_path, DIFFER)
    ra = (a / "network.txt").read_text().splitlines()
    rb = (b / "network.txt").read_text().splitlines()
    diff = [(x, y) for x, y in zip(ra, rb) if x != y]
    assert len(ra) == len(rb)
    assert diff == [("stats1 stats-layer 24", "stats1 stats-layer 12")]


def test_xconfig_parameter_count_equals_flax(caplog):
    """The tool's parameter count (batch statistics included) is the
    flax variables' count."""
    from kaldi_tpu.am.xconfig import model_from_xconfig as jmodel
    from kaldi_tpu_torch.am.xconfig import model_from_xconfig as tmodel
    jm, _, _ = jmodel(AGREE, 3)
    v = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 21, 8)))
    want = sum(int(x.size) for x in jax.tree_util.tree_leaves(v))
    tm, _, _ = tmodel(AGREE, 3)
    assert sum(t.numel() for t in tm.state_dict().values()) == want


def _xent_data(tmp_path, n_utts=3, T=40, D=6, P=7):
    rng = np.random.default_rng(0)
    with TableWriter(f"ark:{tmp_path}/feats.ark", holder="mat") as wf, \
            TableWriter(f"ark:{tmp_path}/ali.ark", holder="ivec") as wa:
        for i in range(n_utts):
            a = rng.integers(0, P, T).astype(np.int32)
            wf[f"u{i}"] = (rng.standard_normal((T, D))
                           + 0.5 * a[:, None]).astype(np.float32)
            wa[f"u{i}"] = a
    return P


def test_nnet3_train_one_step_matches_original(tmp_path, monkeypatch):
    """3 utterances of 40 frames = 3 egs of the 64-frame chunk: one batch,
    one Adam step at --num-epochs=1 from flax's initial weights."""
    from kaldi_tpu.am.tdnn import TdnnChain as JChain
    from kaldi_tpu.am.tdnn import TdnnConfig as JCfg
    from kaldi_tpu_torch.am import nnet3_io
    from kaldi_tpu_torch.am.tdnn import TdnnConfig, params_from_flax
    from kaldi_tpu_torch.pipelines import nnet as tn
    P = _xent_data(tmp_path)
    opts = [f"--num-pdfs={P}", "--hidden-dim=16", "--bottleneck-dim=4",
            "--num-layers=2", "--num-epochs=1", "--learning-rate=1e-2"]
    cfg = dict(feat_dim=6, num_pdfs=P, hidden_dim=16, bottleneck_dim=4,
               num_layers=2, frame_subsampling_factor=1)
    v = jax.tree_util.tree_map(np.asarray, JChain(JCfg(**cfg)).init(
        jax.random.PRNGKey(0), jnp.zeros((2, 16, 6)), train=False))

    def init(model, seed=0):
        model.load_state_dict(params_from_flax(v))
        return model

    monkeypatch.setattr(tn, "init_tdnn", init)
    grads = {}
    real_step = torch.optim.Adam.step

    def spy(self, *a, **kw):
        for group in self.param_groups:
            for i, p in enumerate(group["params"]):
                grads[i] = p.grad.detach().clone()
        return real_step(self, *a, **kw)

    monkeypatch.setattr(torch.optim.Adam, "step", spy)
    args = [f"ark:{tmp_path}/feats.ark", f"ark:{tmp_path}/ali.ark"]
    _run(TOOLS, "nnet3-train", opts + ["--device=cpu"] + args
         + [f"{tmp_path}/port.raw"])
    _run(JTOOLS, "nnet3-train", opts + args + [f"{tmp_path}/jax.raw"])
    tcfg = TdnnConfig(**cfg)
    got = nnet3_io.read_raw_model(f"{tmp_path}/port.raw", tcfg)
    want = nnet3_io.read_raw_model(f"{tmp_path}/jax.raw", tcfg)
    assert [c.name for c in nnet3_io.read_nnet3_path(
        f"{tmp_path}/port.raw").components] == \
        [c.name for c in nnet3_io.read_nnet3_path(
            f"{tmp_path}/jax.raw").components]
    names = [n for n, _ in tn.TdnnChain(tcfg).named_parameters()]
    lr = 1e-2
    for i, n in enumerate(names):
        g = grads[i].double().abs()
        tol = lr * 1e-3 + lr * 1e-8 * (1e-5 * float(g.max())) / \
            (g + 1e-8) ** 2
        assert bool(((got[n].double() - want[n].double()).abs()
                     <= tol).all()), n
    for n in got:
        if n.endswith((".mean", ".var")):
            assert float((got[n] - want[n]).abs().max()) <= \
                1e-5 * float(want[n].abs().max()), n


def _speaker_feats(tmp_path, n_spk=3, n_utt=2, T=150, D=10):
    rng = np.random.default_rng(1)
    with TableWriter(f"ark:{tmp_path}/feats.ark", holder="mat") as wf, \
            TableWriter(f"ark,t:{tmp_path}/utt2spk", holder="text") as ws:
        for s in range(n_spk):
            off = 3.0 * rng.standard_normal(D)
            for j in range(n_utt):
                u = f"s{s}u{j}"
                wf[u] = (off + rng.standard_normal(
                    (T + 17 * j, D))).astype(np.float32)
                ws[u] = [f"s{s}"]


def test_nnet3_xvector_get_egs_equals_original(tmp_path):
    _speaker_feats(tmp_path)
    args = [f"ark:{tmp_path}/feats.ark", f"ark:{tmp_path}/utt2spk"]
    for side, tools in (("port", TOOLS), ("jax", JTOOLS)):
        _run(tools, "nnet3-xvector-get-egs",
             ["--chunk-size=32", f"--spk-list={tmp_path}/{side}.spk"]
             + args + [f"ark:{tmp_path}/{side}.ark"])
    for ext in ("ark", "spk"):
        assert (tmp_path / f"port.{ext}").read_bytes() == \
            (tmp_path / f"jax.{ext}").read_bytes(), ext
    egs = list(SequentialTableReader(f"ark:{tmp_path}/port.ark",
                                     holder="xeg"))
    assert len(egs) == 3 * (4 + 5)
    assert egs[0][1].feats.shape == (1, 32, 10)


@pytest.mark.parametrize("tool,opts", [
    ("nnet3-xvector-compute", []),
    ("nnet3-xvector-compute-batched", ["--chunk-size=40", "--batch-size=3"])])
def test_xvector_compute_tools_match_original(tmp_path, tool, opts):
    """On a model file the JAX package wrote: the port's embeddings equal
    the original's, and the port's tool equals its library (whole
    utterances, or the mean over --chunk-size windows)."""
    from kaldi_tpu.am import xvector as jxv
    from kaldi_tpu_torch.am import xvector as txv
    _speaker_feats(tmp_path)
    cfg = jxv.XvectorConfig(feat_dim=10, num_speakers=3, hidden_dim=24,
                            embed_dim=8, contexts=((-1, 0, 1), (0,)))
    v = jax.tree_util.tree_map(np.asarray, jxv.XvectorNet(cfg).init(
        jax.random.PRNGKey(2), np.zeros((2, 16, 10), np.float32)))
    jxv.save_xvector_model(f"{tmp_path}/x.mdl", v, cfg, ["s0", "s1", "s2"])
    args = [f"{tmp_path}/x.mdl", f"ark:{tmp_path}/feats.ark"]
    _run(TOOLS, tool, opts + ["--device=cpu"] + args
         + [f"ark:{tmp_path}/port.ark"])
    _run(JTOOLS, tool, opts + args + [f"ark:{tmp_path}/jax.ark"])
    got = dict(SequentialTableReader(f"ark:{tmp_path}/port.ark",
                                     holder="vec"))
    want = dict(SequentialTableReader(f"ark:{tmp_path}/jax.ark",
                                      holder="vec"))
    assert sorted(got) == sorted(want) and len(got) == 6
    model, _ = txv.load_xvector_model(f"{tmp_path}/x.mdl", device="cpu")
    feats = dict(SequentialTableReader(f"ark:{tmp_path}/feats.ark",
                                       holder="mat"))
    for k in got:
        scale = float(np.abs(want[k]).max())
        np.testing.assert_allclose(got[k], want[k], atol=1e-5 * scale)
        f = feats[k]
        if tool == "nnet3-xvector-compute":
            lib = txv.extract_xvector(model, f)
        else:
            lib = np.mean([txv.extract_xvector(model, f[lo:lo + 40])
                           for lo in range(0, len(f) - 39, 40)], axis=0)
        np.testing.assert_allclose(got[k], lib, atol=1e-5 * scale)
