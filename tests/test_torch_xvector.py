"""The port's x-vector system (kaldi_tpu_torch/am/xvector.py) against
the JAX package's (kaldi_tpu/am/xvector.py), mirroring
tests/test_xvector.py's three tests, then one Adam step against optax's
and the model files both ways.

The port's trainer starts from flax's initial variables (its
``init_xvector`` hands them over); both sides draw the same batches and
chunk offsets from numpy.  Tolerances: statistics pooling 1e-6; one
Adam step as tests/test_torch_rnnlm.py bounds it (1e-3·lr, plus the
step's sensitivity lr·eps·δg/(|g| + eps)² to a gradient error δg of
1e-5 of the tensor's largest gradient); batch statistics 1e-5 of their
largest; embeddings from the same weights 1e-5 of their largest.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kaldi_tpu.am import xvector as jxv
from kaldi_tpu_torch.am import ivector as tiv
from kaldi_tpu_torch.am import xvector as txv
from kaldi_tpu_torch.am.tdnn import state_dict_from_flax, state_dict_to_flax

torch.set_num_threads(1)

CFG = dict(feat_dim=10, hidden_dim=32, embed_dim=16,
           contexts=((-1, 0, 1), (0,)))
LR = 1e-3
ADAM_EPS = 1e-8


def _speaker_corpus(rng, n_spk=6, utts_per_spk=8, D=10, T=60):
    """Speaker identity lives in the per-speaker channel offset; frames
    add shared 'content' noise (tests/test_xvector.py's corpus)."""
    spk_off = 3.0 * rng.standard_normal((n_spk, D))
    feats, utt2spk = {}, {}
    for s in range(n_spk):
        for j in range(utts_per_spk):
            u = f"s{s}u{j}"
            feats[u] = (spk_off[s]
                        + rng.standard_normal((T, D))).astype(np.float32)
            utt2spk[u] = f"s{s}"
    return feats, utt2spk


def _hand_over(monkeypatch, n_spk, chunk, seed=0):
    """flax's initial variables of train_xvector (the same init call),
    handed to the port's trainer.  → the variables."""
    cfg = jxv.XvectorConfig(num_speakers=n_spk, **CFG)
    v = jax.tree_util.tree_map(np.asarray, jxv.XvectorNet(cfg).init(
        jax.random.PRNGKey(seed),
        np.zeros((2, chunk, cfg.feat_dim), np.float32), train=True))

    def init(c, s, device):
        m = txv.XvectorNet(c)
        m.load_state_dict(state_dict_from_flax(v))
        return m.to(device)

    monkeypatch.setattr(txv, "init_xvector", init)
    return v


def test_statistics_pooling_masked():
    x = np.zeros((1, 4, 2), np.float32)
    x[0, :, 0] = [1, 3, 100, 100]
    x[0, :, 1] = [2, 2, 100, 100]
    mask = np.array([[1, 1, 0, 0]], np.float32)
    out = txv.StatisticsPooling()(torch.from_numpy(x),
                                  torch.from_numpy(mask))[0].numpy()
    np.testing.assert_allclose(out[:2], [2.0, 2.0], atol=1e-5)
    assert abs(out[2] - 1.0) < 1e-4
    assert out[3] < 0.02
    want = np.asarray(jxv.StatisticsPooling().apply(
        {}, jnp.asarray(x), jnp.asarray(mask)))[0]
    np.testing.assert_allclose(out, want, atol=1e-6)


def test_xvector_separates_speakers(monkeypatch, rng):
    """Trained from flax's init on 6 utterances a speaker, the held-out
    embeddings rank same-speaker pairs above different-speaker pairs
    (the original's bars)."""
    feats, utt2spk = _speaker_corpus(rng)
    train_u = {u for u in feats if int(u.split("u")[1]) < 6}
    _hand_over(monkeypatch, 6, 32)
    model, spks = txv.train_xvector(
        {u: feats[u] for u in train_u}, {u: utt2spk[u] for u in train_u},
        txv.XvectorConfig(**CFG), num_epochs=25, batch_size=16, chunk=32,
        device="cpu")
    assert spks == [f"s{k}" for k in range(6)]
    embs = {u: txv.extract_xvector(model, feats[u])
            for u in feats if u not in train_u}

    def cos(a, b):
        return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))

    same, diff = [], []
    keys = sorted(embs)
    for i, a in enumerate(keys):
        for b in keys[i + 1:]:
            (same if utt2spk[a] == utt2spk[b] else diff).append(
                cos(embs[a], embs[b]))
    assert np.mean(same) > np.mean(diff) + 0.15
    auc = float((np.asarray(same)[:, None]
                 > np.asarray(diff)[None, :]).mean())
    assert auc > 0.85, auc


def test_xvector_plda_diarization(monkeypatch, rng):
    """X-vectors feed the port's PLDA + AHC backend (am/ivector.py's
    copies): two held-out speakers' segments cluster apart."""
    feats, utt2spk = _speaker_corpus(rng, n_spk=8, utts_per_spk=6)
    _hand_over(monkeypatch, 8, 32)
    model, _ = txv.train_xvector(feats, utt2spk, txv.XvectorConfig(**CFG),
                                 num_epochs=25, chunk=32, device="cpu")
    embs = {u: txv.extract_xvector(model, feats[u]) for u in feats}
    train_spk = {f"s{k}" for k in range(6)}
    spk2emb = {}
    for u, e in embs.items():
        if utt2spk[u] in train_spk:
            spk2emb.setdefault(utt2spk[u], []).append(e)
    plda = tiv.Plda.train({s: np.stack(v) for s, v in spk2emb.items()})
    segs, truth = [], []
    for k, s in enumerate(("s6", "s7")):
        for u in sorted(embs):
            if utt2spk[u] == s:
                segs.append(embs[u])
                truth.append(k)
    labels = tiv.diarize(plda, np.stack(segs), max_clusters=2)
    truth = np.asarray(truth)
    agree = max(float((labels == truth).mean()),
                float((labels == 1 - truth).mean()))
    assert agree > 0.9, (labels.tolist(), truth.tolist())


def test_one_adam_step_matches_optax(monkeypatch, rng):
    """One epoch of one batch from flax's init on both sides: every
    parameter within the first Adam step's bar, batch statistics within
    1e-5, and some weights moved."""
    feats, utt2spk = _speaker_corpus(rng, n_spk=4, utts_per_spk=4)
    v0 = _hand_over(monkeypatch, 4, 32)
    grads = {}
    real_step = torch.optim.Adam.step

    def spy(self, *a, **kw):
        for group in self.param_groups:
            for p in group["params"]:
                grads[id(p)] = p.grad.detach().clone()
        return real_step(self, *a, **kw)

    monkeypatch.setattr(torch.optim.Adam, "step", spy)
    model, _ = txv.train_xvector(feats, utt2spk, txv.XvectorConfig(**CFG),
                                 num_epochs=1, batch_size=16, chunk=32,
                                 learning_rate=LR, device="cpu")
    jv, _, _ = jxv.train_xvector(feats, utt2spk, jxv.XvectorConfig(**CFG),
                                 num_epochs=1, batch_size=16, chunk=32,
                                 learning_rate=LR)
    want = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jv))
    init = state_dict_from_flax(v0)
    moved = 0
    for k, p in model.named_parameters():
        g = grads[id(p)].double().abs()
        tol = 1e-3 * LR + LR * ADAM_EPS * (1e-5 * float(g.max())) / \
            (g + ADAM_EPS) ** 2
        assert bool(((p.detach().double() - want[k].double()).abs()
                     <= tol).all()), k
        moved += int((p.detach() != init[k]).sum())
    assert moved > 0
    for k, b in model.named_buffers():
        w = want[k]
        assert float((b - w).abs().max()) <= 1e-5 * float(w.abs().max()), k


def test_model_files_cross_both_ways(tmp_path, rng):
    """An <XvectorModel> file written by either package reads in the
    other, and the port writes the JAX package's bytes for the same
    weights; embeddings from a crossed file equal the writer's."""
    cfg = jxv.XvectorConfig(num_speakers=3, **CFG)
    v = jax.tree_util.tree_map(np.asarray, jxv.XvectorNet(cfg).init(
        jax.random.PRNGKey(1), np.zeros((2, 16, 10), np.float32)))
    spks = ["a", "b", "c"]
    jxv.save_xvector_model(str(tmp_path / "j.mdl"), v, cfg, spks)
    model, got_spks = txv.load_xvector_model(str(tmp_path / "j.mdl"),
                                             device="cpu")
    assert got_spks == spks and model.config.contexts == CFG["contexts"]
    txv.save_xvector_model(str(tmp_path / "t.mdl"), model, spks)
    assert (tmp_path / "t.mdl").read_bytes() == \
        (tmp_path / "j.mdl").read_bytes()
    x = rng.standard_normal((40, 10)).astype(np.float32)
    jv2, jmodel, jspks = jxv.load_xvector_model(str(tmp_path / "t.mdl"))
    assert jspks == spks
    want = jxv.extract_xvector(jv2, jmodel, x)
    got = txv.extract_xvector(model, x)
    np.testing.assert_allclose(got, want,
                               atol=1e-5 * float(np.abs(want).max()))
    back = state_dict_to_flax(model.state_dict())
    for coll in ("params", "batch_stats"):
        for path, leaf in jax.tree_util.tree_leaves_with_path(v[coll]):
            b = back[coll]
            for p in path:
                b = b[p.key]
            np.testing.assert_array_equal(b, leaf)


def test_train_xvector_defaults_to_the_card(monkeypatch):
    from kaldi_tpu_torch.core.logging import KaldiError
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(KaldiError, match="no CUDA card"):
        txv.train_xvector({"u": np.zeros((4, 10), np.float32)}, {"u": "s"},
                          txv.XvectorConfig(**CFG))
