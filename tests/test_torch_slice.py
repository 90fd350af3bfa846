"""The port's serving slice end to end on the CPU, against the JAX
package: seeded waveforms → Fbank → TdnnChain (weights converted from
one shared numpy set) → batched lattice decode on a small task.

Best-path words must be equal and costs within 1e-2: the ~1e-4 per-bin
feature difference (DFT by products vs an FFT) is summed over every
frame of the path.  Each side decodes on a task built by its own
package; the port runs on the CPU (``device="cpu"``).  A subprocess runs
both of the port's paths from the port alone and checks that neither
JAX nor the JAX package was ever imported.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from kaldi_tpu.am import tdnn as jtdnn
from kaldi_tpu.decoder import beam as jbeam
from kaldi_tpu.features import compute as jcompute
from kaldi_tpu.features import mel as jmel
from kaldi_tpu.pipelines import largevocab as jlv
from kaldi_tpu_torch.am import tdnn as ttdnn
from kaldi_tpu_torch.decoder import beam as tbeam
from kaldi_tpu_torch.features import compute as tcompute
from kaldi_tpu_torch.features import mel as tmel
from kaldi_tpu_torch.pipelines import decode as tdecode
from kaldi_tpu_torch.pipelines import largevocab as tlv

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _waves(n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        T = int(rng.uniform(0.8, 1.2) * 16000)
        t = np.arange(T) / 16000.0
        x = 300.0 * rng.standard_normal(T)
        for seg in np.array_split(np.arange(T), 3):
            f0 = rng.uniform(90.0, 250.0)
            for h in range(1, 5):
                x[seg] += 2000.0 / h * np.sin(2 * np.pi * h * f0 * t[seg])
        out.append(x.astype(np.float32))
    return out


@pytest.fixture(scope="module")
def slice_setup():
    kw = dict(vocab_size=300, order=3, seed=7, closure=False,
              corpus_sentences=600)
    task = tlv.make_largevocab_task(**kw)
    jtask = jlv.make_largevocab_task(**kw)
    cfg = dict(feat_dim=40, num_pdfs=task.num_pdfs, hidden_dim=64,
               bottleneck_dim=16, num_layers=4, frame_subsampling_factor=3)
    model = jtdnn.TdnnChain(jtdnn.TdnnConfig(**cfg))
    init = model.init(jax.random.PRNGKey(0), np.zeros((1, 9, 40), np.float32),
                      train=False)
    rng = np.random.default_rng(17)

    def draw(path, leaf):
        name = getattr(path[-1], "key", "")
        shape = np.shape(leaf)
        if name == "var":
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        scale = 1.0 / np.sqrt(shape[0]) if name == "kernel" else 0.1
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    variables = jax.tree_util.tree_map_with_path(
        draw, jax.tree_util.tree_map(np.asarray, dict(init)))
    # spread the outputs over a few units so the lattices are not one path
    variables["params"]["output_affine"]["kernel"] *= np.float32(0.05)
    return task, jtask, cfg, model, variables


def test_slice_matches_jax(slice_setup):
    task, jtask, cfg, jmodel, variables = slice_setup
    waves = _waves(2, seed=3)
    dkw = dict(beam=13.0, max_active=7000, acoustic_scale=1.0,
               lattice_beam=7.0, arc_budget=1024, token_capacity=256,
               arc_block=8, escalate_budget=4096, escalate_deficit=4.0,
               lattice_arcs_per_frame=512, record_capacity=16384)
    args = (task.graph.csr, task.tm.tid_to_pdf_array)

    # JAX package: compute-fbank-feats → nnet forward → batch decode
    jf = jcompute.Fbank(jcompute.FbankOptions(
        mel_opts=jmel.MelBanksOptions(num_bins=40)))
    jll = [np.asarray(jmodel.apply(variables, jf.compute(w)[None],
                                   train=False))[0] for w in waves]
    lens = np.array([len(x) for x in jll])
    X = np.zeros((2, int(np.ceil(lens.max() / 64) * 64), task.num_pdfs),
                 np.float32)
    for b, x in enumerate(jll):
        X[b, :len(x)] = x
    want = jbeam.BeamDecoder(jtask.graph.csr, jtask.tm.tid_to_pdf_array,
                             jbeam.BeamDecoderConfig(**dkw)) \
        .decode_compact_batch(X, lens)

    # the port
    tf = tcompute.Fbank(tcompute.FbankOptions(
        mel_opts=tmel.MelBanksOptions(num_bins=40)), device="cpu")
    tmodel = ttdnn.TdnnChain(ttdnn.TdnnConfig(**cfg))
    tmodel.load_state_dict(ttdnn.params_from_flax(variables))
    tmodel.eval()
    tll = tdecode.acoustic_scores(waves, tf, tmodel)
    for a, b in zip(tll, jll):
        assert a.shape == b.shape
        assert float(np.std(b)) > 0.5
        np.testing.assert_allclose(a.numpy(), b, atol=1e-3, rtol=0)
    got = tdecode.decode_waveforms(
        waves, tf, tmodel,
        tbeam.BeamDecoder(*args, tbeam.BeamDecoderConfig(**dkw),
                          device="cpu"),
        batch_size=2)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        gw, _, gc = g.best_path()
        ww, _, wc = w.best_path()
        assert gw == ww
        assert np.isfinite(gc) and abs(gc - wc) < 1e-2


_HYGIENE = r"""
import sys
import numpy as np
import torch
torch.manual_seed(0)
from kaldi_tpu_torch.am.tdnn import TdnnChain, TdnnConfig
from kaldi_tpu_torch.decoder.beam import BeamDecoder, BeamDecoderConfig
from kaldi_tpu_torch.features import Fbank, FbankOptions, MelBanksOptions
from kaldi_tpu_torch.pipelines.decode import decode_waveforms
from kaldi_tpu_torch.pipelines.largevocab import make_largevocab_task
from kaldi_tpu_torch.pipelines.score import compute_wer
import kaldi_tpu_torch.ops.build
task = make_largevocab_task(vocab_size=60, order=2, seed=7, closure=False,
                            corpus_sentences=100)
model = TdnnChain(TdnnConfig(feat_dim=40, num_pdfs=task.num_pdfs,
                             hidden_dim=32, bottleneck_dim=8, num_layers=4))
dec = BeamDecoder(task.graph.csr, task.tm.tid_to_pdf_array,
                  BeamDecoderConfig(beam=10.0, max_active=200,
                                    acoustic_scale=1.0, lattice_beam=5.0,
                                    lattice_arcs_per_frame=256), device="cpu")
wave = np.random.default_rng(0).standard_normal(8000).astype(np.float32)
lats = decode_waveforms([wave * 1000], Fbank(FbankOptions(
    mel_opts=MelBanksOptions(num_bins=40)), device="cpu"), model.eval(),
    dec, 1)
assert np.isfinite(lats[0].best_path()[2])
# the GMM decode path: MFCC → CMVN → Δ+ΔΔ → GMM → both latgen branches,
# on a graph the port's own fst modules build
from kaldi_tpu_torch.fst.csr import csr_to_vector_fst
from kaldi_tpu_torch.am.gmm import AmDiagGmm
from kaldi_tpu_torch.am.serialize import read_mdl, write_mdl
from kaldi_tpu_torch.am.transforms import apply_transform
from kaldi_tpu_torch.cli.latgen import _LatgenDecoder, gmm_latgen_faster
from kaldi_tpu_torch.core.table import SequentialTableReader, TableWriter
from kaldi_tpu_torch.decoder.dense import DenseDecoder
from kaldi_tpu_torch.features import (Mfcc, MfccOptions, add_deltas,
                                      apply_cmvn, compute_cmvn_stats,
                                      splice_frames)
from kaldi_tpu_torch.ops.gmm import CudaGmm
from kaldi_tpu_torch.pipelines.decode import decode_gmm, decode_gmm_lattice
from kaldi_tpu_torch.tools.synth import aligned_gmm, synth_speech
raw = Mfcc(MfccOptions(), device="cpu").compute(wave * 1000)
feats = add_deltas(apply_cmvn(raw, compute_cmvn_stats(raw)))
spliced = apply_transform(splice_frames(raw, 1, 1), np.eye(39, 40))
assert spliced.shape == feats.shape
rng = np.random.default_rng(1)
P = task.num_pdfs
am = AmDiagGmm(np.full((P, 2), 0.5), rng.standard_normal((P, 2, 39)),
               np.ones((P, 2, 39)), device="cpu")
write_mdl("hygiene.mdl", task.tm, am)
tm, am = read_mdl("hygiene.mdl", device="cpu")
fst = csr_to_vector_fst(task.graph.csr)
clats = {}
for limit in (20000, 0):
    clats[str(limit)] = _LatgenDecoder(
        fst, tm.tid_to_pdf_array, 13.0, 6.0, 0.1, dense_limit=limit,
        device="cpu").decode_to_clat(am.loglikes(feats))
    assert np.isfinite(clats[str(limit)].best_path()[2])
# a clat table through the port's core.table (its lazy lattice.io import)
with TableWriter("ark:hygiene.ark", holder="clat") as w:
    for key, clat in clats.items():
        w[key] = clat
back = dict(SequentialTableReader("ark:hygiene.ark", holder="clat"))
for key, clat in clats.items():
    got, want = back[key].best_path(), clat.best_path()
    assert got[:2] == want[:2] and abs(got[2] - want[2]) < 1e-3
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "flax", "kaldi_tpu"))
assert not bad, bad
print("no-jax-ok")
"""


def test_port_never_imports_jax(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", _HYGIENE], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "no-jax-ok" in res.stdout
