"""The port's multi-process layer (kaldi_tpu_torch/parallel/) over two gloo
ranks on the CPU, against the JAX package's parallel/ and the port's
single-process runs.

One module fixture launches two pairs of processes, each pair joined by a
``file://`` store (no port to race for under xdist): the port's own
worker (``python -m kaldi_tpu_torch.parallel.distributed ... --device=cpu
--backend=gloo``, the original's four checks) and
tests/torch_parallel_worker.py (meshes, both sharded decoders, and
``ChainTrainer(mesh=)`` from weights the JAX trainer drew).  While they
run, the fixture computes the references: the JAX package's sharded
decoders and trainer on the conftest's 8 virtual devices, and the port's
single-process decodes and trainer.  Every process gets
``communicate(timeout=120)`` and a 60 s rendezvous and collective
timeout, and every process is killed if any fails, so nothing can wait
past its limit.
"""

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from kaldi_tpu_torch.core.logging import KaldiError

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NPROC = 2
WORKER_TIMEOUT = 120
# the 600-word task of the original's worker; one utterance much noisier
# than the rest, so that it alone escalates at arc budget 512
TASK = dict(vocab_size=600, corpus_sentences=600, seed=3)
BEAM_CFG = dict(beam=14.0, max_active=512, acoustic_scale=1.0,
                lattice_beam=6.0, lattice_arcs_per_frame=1024,
                record_capacity=16384, arc_budget=512,
                escalate_budget=8192, escalate_deficit=2.0)
BEAM_NOISE = (0.3, 0.3, 0.3, 0.3, 2.0)     # B = 5: odd
BEAM_T = 96
LOCAL_ROWS = ((0, 3), (3, 5))              # each rank's own rows
# test_parallel.py's chain step, at two batches of 8
CHAIN_PHONES = [1, 2]
CHAIN_SEQS = [[1, 2], [2, 1]]
CHAIN_B, CHAIN_T, CHAIN_N = 8, 12, 16
CHAIN_SEED = 7
# a large l2 term, so that its normalization shows in the second step
CHAIN_L2 = 0.5


def _launch(cmds, env):
    """Start every command (``_wait`` collects them)."""
    procs = [subprocess.Popen(c, env=env, cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE) for c in cmds]
    return procs


def _wait(procs):
    """Wait for each process within WORKER_TIMEOUT; kill them all if one
    fails or times out."""
    try:
        for p in procs:
            _out, err = p.communicate(timeout=WORKER_TIMEOUT)
            assert p.returncode == 0, err.decode()[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def _dense_inputs(num_pdfs):
    rng = np.random.default_rng(0)
    B, T = 11, 30                       # deliberately not a multiple of 2
    lls = rng.standard_normal((B, T, num_pdfs)).astype(np.float32)
    lens = rng.integers(10, T + 1, B).astype(np.int64)
    return lls, lens


def _beam_inputs():
    from kaldi_tpu_torch.pipelines.largevocab import (make_largevocab_task,
                                                      sample_eval_set,
                                                      synth_loglikes)
    task = make_largevocab_task(**TASK)
    ev = sample_eval_set(task, len(BEAM_NOISE), max_words=4, seed=5)
    urng = np.random.default_rng(17)
    lls = [synth_loglikes(task, s, urng, noise=n)
           for (_, s), n in zip(sorted(ev.items()), BEAM_NOISE)]
    X = np.zeros((len(lls), BEAM_T, task.num_pdfs), np.float32)
    lens = np.zeros(len(lls), np.int64)
    for i, ll in enumerate(lls):
        X[i, :min(len(ll), BEAM_T)] = ll[:BEAM_T]
        lens[i] = min(len(ll), BEAM_T)
    return task, X, lens


def _chain_setup():
    """The JAX side's den graph, config and egs, and the JAX trainer on a
    (4, 2) mesh with its initial weights as the port's state dict."""
    from kaldi_tpu.am.chain import ChainTrainingOptions, \
        make_denominator_graph
    from kaldi_tpu.am.tdnn import TdnnConfig
    from kaldi_tpu.am.topology import HmmTopology
    from kaldi_tpu.am.tree import MonophoneContextDependency
    from kaldi_tpu.parallel import make_mesh
    from kaldi_tpu.pipelines.chain import ChainTrainConfig, ChainTrainer
    from kaldi_tpu_torch.am.tdnn import params_from_flax
    topo = HmmTopology.chain(CHAIN_PHONES)
    tree = MonophoneContextDependency(CHAIN_PHONES, topo)
    den = make_denominator_graph(CHAIN_SEQS, tree, topo)
    model = dict(feat_dim=6, num_pdfs=tree.num_pdfs, hidden_dim=8,
                 bottleneck_dim=4, num_layers=2, frame_subsampling_factor=3)
    train = dict(num_epochs=1, batch_size=CHAIN_B, optimizer="ngsgd")
    rng = np.random.default_rng(0)
    egs = dict(
        feats=rng.standard_normal((CHAIN_N, CHAIN_T, 6)).astype(np.float32),
        pdf_ali=rng.integers(0, tree.num_pdfs,
                             (CHAIN_N, CHAIN_T // 3)).astype(np.int32),
        mask=np.ones((CHAIN_N, CHAIN_T // 3), bool))
    mesh = make_mesh(data=4, model=2)
    jt = ChainTrainer(TdnnConfig(**model), den, ChainTrainConfig(
        opts=ChainTrainingOptions(l2_regularize=CHAIN_L2), **train),
        mesh=mesh, seed=CHAIN_SEED)
    init = {k: v.numpy() for k, v in params_from_flax({
        "params": jax_tree_to_numpy(jt.params),
        "batch_stats": jax_tree_to_numpy(jt.batch_stats)}).items()}
    return dict(phones=CHAIN_PHONES, seqs=CHAIN_SEQS, model=model,
                train=train, l2=CHAIN_L2, egs=egs, init=init), jt, mesh


def jax_tree_to_numpy(tree):
    import jax
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_references(dense_lls, dense_lens, X, lens, jt, jmesh, egs):
    from kaldi_tpu.am import HmmTopology, MonophoneContextDependency, \
        TransitionModel
    from kaldi_tpu.decoder.beam import BeamDecoder, BeamDecoderConfig
    from kaldi_tpu.decoder.dense import DenseDecoder, DenseDecoderConfig
    from kaldi_tpu.fst import (ArpaModel, Lang, Lexicon, arpa_to_fst,
                               make_unigram_arpa, mkgraph)
    from kaldi_tpu.parallel import make_mesh
    from kaldi_tpu.parallel.decode import ShardedBeamDecoder, ShardedDecoder
    from kaldi_tpu.pipelines.chain import ChainEgs
    from kaldi_tpu.pipelines.largevocab import make_largevocab_task
    lang = Lang(Lexicon(entries=[("YES", ["Y", "EH", "S"]),
                                 ("NO", ["N", "OW"])]))
    phones = lang.phone_list()
    topo = HmmTopology.three_state(phones)
    tm = TransitionModel(topo, MonophoneContextDependency(phones, topo))
    HCLG = mkgraph(lang, tm, arpa_to_fst(
        ArpaModel.parse(make_unigram_arpa({"YES": 1.0, "NO": 1.0})),
        lang.words))
    dec = DenseDecoder(HCLG, tm.tid_to_pdf_array,
                       DenseDecoderConfig(beam=1e9, acoustic_scale=0.1))
    dense = ShardedDecoder(dec, make_mesh(data=8, model=1)).decode_batch(
        dense_lls, dense_lens.astype(np.int32))
    task = make_largevocab_task(**TASK)
    bdec = BeamDecoder(task.graph.csr, task.tm.tid_to_pdf_array,
                       BeamDecoderConfig(**BEAM_CFG))
    stats = {}
    lats = ShardedBeamDecoder(bdec, make_mesh(data=2, model=1)) \
        .decode_compact_batch(X, lens.astype(np.int32), stats=stats)
    with jmesh:
        last = jt.train(ChainEgs(**egs), log_every=100)
    return dict(dense=dense, stats=stats,
                beam=[(lat.best_path(), dict(lat.paths())) for lat in lats],
                chain_last=last)


def _port_references(dense_lls, dense_lens, X, lens, chain):
    from kaldi_tpu_torch.am import chain as tchain
    from kaldi_tpu_torch.am.tdnn import TdnnConfig
    from kaldi_tpu_torch.am.topology import HmmTopology
    from kaldi_tpu_torch.am.transitions import TransitionModel
    from kaldi_tpu_torch.am.tree import MonophoneContextDependency
    from kaldi_tpu_torch.decoder.beam import BeamDecoder, BeamDecoderConfig
    from kaldi_tpu_torch.decoder.dense import DenseDecoder, DenseDecoderConfig
    from kaldi_tpu_torch.fst import (ArpaModel, Lang, Lexicon, arpa_to_fst,
                                     make_unigram_arpa, mkgraph)
    from kaldi_tpu_torch.pipelines.chain import (ChainEgs, ChainTrainConfig,
                                                 ChainTrainer)
    from kaldi_tpu_torch.pipelines.largevocab import make_largevocab_task
    lang = Lang(Lexicon(entries=[("YES", ["Y", "EH", "S"]),
                                 ("NO", ["N", "OW"])]))
    phones = lang.phone_list()
    topo = HmmTopology.three_state(phones)
    tm = TransitionModel(topo, MonophoneContextDependency(phones, topo))
    HCLG = mkgraph(lang, tm, arpa_to_fst(
        ArpaModel.parse(make_unigram_arpa({"YES": 1.0, "NO": 1.0})),
        lang.words))
    dec = DenseDecoder(HCLG, tm.tid_to_pdf_array,
                       DenseDecoderConfig(beam=1e9, acoustic_scale=0.1),
                       device="cpu")
    dense = dec.decode_batch(dense_lls, dense_lens)
    task = make_largevocab_task(**TASK)
    bdec = BeamDecoder(task.graph.csr, task.tm.tid_to_pdf_array,
                       BeamDecoderConfig(**BEAM_CFG), device="cpu")
    stats = {}
    lats = bdec.decode_compact_batch(X, lens, stats=stats)
    ctopo = HmmTopology.chain(chain["phones"])
    tree = MonophoneContextDependency(chain["phones"], ctopo)
    den = tchain.make_denominator_graph(chain["seqs"], tree, ctopo)
    tr = ChainTrainer(TdnnConfig(**chain["model"]), den, ChainTrainConfig(
        opts=tchain.ChainTrainingOptions(l2_regularize=CHAIN_L2),
        **chain["train"]), device="cpu")
    tr.model.load_state_dict({k: torch.tensor(v)
                              for k, v in chain["init"].items()})
    last = tr.train(ChainEgs(**chain["egs"]), log_every=100)
    return dict(dense=dense, stats=stats,
                beam=[(lat.best_path(), dict(lat.paths())) for lat in lats],
                chain_last=last,
                chain_state={k: v.numpy()
                             for k, v in tr.model.state_dict().items()})


def _worker_main_single_step():
    """The port's unsharded form of worker_main's chain step (check 4):
    the same seeded graph, model (seed 0) and batch."""
    from kaldi_tpu_torch.am.chain import make_denominator_graph
    from kaldi_tpu_torch.am.tdnn import TdnnConfig
    from kaldi_tpu_torch.am.topology import HmmTopology
    from kaldi_tpu_torch.am.tree import MonophoneContextDependency
    from kaldi_tpu_torch.pipelines.chain import (ChainEgs, ChainTrainConfig,
                                                 ChainTrainer)
    phones = list(range(1, 9))
    topo = HmmTopology.chain(phones)
    tree = MonophoneContextDependency(phones, topo)
    crng = np.random.default_rng(0)
    seqs = [list(crng.integers(1, 9, 8)) for _ in range(30)]
    den = make_denominator_graph(seqs, tree, topo, order=2)
    Bc, Tc = NPROC * 2, 24
    tr = ChainTrainer(TdnnConfig(feat_dim=8, num_pdfs=tree.num_pdfs,
                                 hidden_dim=16, bottleneck_dim=8,
                                 num_layers=3, frame_subsampling_factor=3),
                      den, ChainTrainConfig(batch_size=Bc, total_steps=0),
                      device="cpu")
    egs = ChainEgs(
        feats=crng.standard_normal((Bc, Tc, 8)).astype(np.float32),
        pdf_ali=crng.integers(0, tree.num_pdfs, (Bc, Tc // 3)).astype(
            np.int32),
        mask=np.ones((Bc, Tc // 3), bool))
    loss, _ = tr._step(*tr.batches(egs, np.arange(Bc)))
    sd = tr.model.state_dict()
    return float(loss), torch.cat([v.reshape(-1).float()
                                   for v in sd.values()]).numpy()


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    from kaldi_tpu_torch.am.topology import HmmTopology
    from kaldi_tpu_torch.am.transitions import TransitionModel
    from kaldi_tpu_torch.am.tree import MonophoneContextDependency
    from kaldi_tpu_torch.fst import Lang, Lexicon
    d = tmp_path_factory.mktemp("parallel")
    lang = Lang(Lexicon(entries=[("YES", ["Y", "EH", "S"]),
                                 ("NO", ["N", "OW"])]))
    phones = lang.phone_list()
    topo = HmmTopology.three_state(phones)
    num_pdfs = TransitionModel(
        topo, MonophoneContextDependency(phones, topo)).num_pdfs
    dense_lls, dense_lens = _dense_inputs(num_pdfs)
    _task, X, lens = _beam_inputs()
    chain, jt, jmesh = _chain_setup()
    inp = dict(dense_lls=dense_lls, dense_lens=dense_lens, task=TASK,
               beam_cfg=BEAM_CFG, beam_X=X, beam_lens=lens,
               local_rows=LOCAL_ROWS, chain=chain)
    with open(d / "inputs.pkl", "wb") as f:
        pickle.dump(inp, f)
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    cmds = [[sys.executable, os.path.join(REPO, "tests",
                                          "torch_parallel_worker.py"),
             f"file://{d}/store_w", str(NPROC), str(pid),
             str(d / "inputs.pkl"), str(d / "w")] for pid in range(NPROC)]
    cmds += [[sys.executable, "-m", "kaldi_tpu_torch.parallel.distributed",
              f"file://{d}/store_m", str(NPROC), str(pid), str(d / "m"),
              "--device=cpu", "--backend=gloo"] for pid in range(NPROC)]
    procs = _launch(cmds, env)
    try:
        jax_ref = _jax_references(dense_lls, dense_lens, X, lens, jt, jmesh,
                                  chain["egs"])
        port_ref = _port_references(dense_lls, dense_lens, X, lens, chain)
        single_step = _worker_main_single_step()
    finally:
        _wait(procs)
    w = []
    for pid in range(NPROC):
        with open(d / f"w.{pid}.pkl", "rb") as f:
            w.append(pickle.load(f))
    m = [dict(np.load(d / f"m.{pid}.npz")) for pid in range(NPROC)]
    return dict(w=w, m=m, jax=jax_ref, port=port_ref,
                single_step=single_step, inputs=inp)


# -- in process: no process group --------------------------------------------

def test_make_mesh_alone_is_one_by_one(monkeypatch):
    from kaldi_tpu_torch.parallel import make_mesh
    mesh = make_mesh(device="cpu")
    assert mesh.shape == {"data": 1, "model": 1}
    assert (mesh.rank, mesh.data_index, mesh.model_index) == (0, 0, 0)
    for kw in (dict(model=2), dict(data=2), dict(model=0)):
        with pytest.raises(ValueError):
            make_mesh(device="cpu", **kw)
    # the default device is the card: without one it raises
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(KaldiError, match="no CUDA card"):
        make_mesh()


def test_model_sharding_rules():
    """The original's rules on flax names, and the same split on the
    port's state-dict names in torch's (out, in) layout."""
    from kaldi_tpu_torch.parallel import model_sharding_rules as rules
    assert rules(["tdnnf1", "linear", "kernel"]) == (None, "model")
    assert rules(["tdnnf1", "affine", "kernel"]) == ("model", None)
    assert rules(["input_affine", "kernel"]) == (None, "model")
    assert rules(["tdnnf1", "affine", "bias"]) == ()
    assert rules("tdnnf.0.linear.weight".split(".")) == ("model", None)
    assert rules("tdnnf.0.affine.weight".split(".")) == (None, "model")
    assert rules("tdnnf.0.batchnorm.mean".split(".")) == ()
    # the JAX package's rules on the flax names, transposed for torch
    from kaldi_tpu.parallel.mesh import model_sharding_rules as jrules
    for path in (["tdnnf1", "linear", "kernel"],
                 ["tdnnf1", "affine", "kernel"], ["prefinal", "kernel"],
                 ["prefinal", "bias"]):
        assert tuple(jrules(path)) == rules(path)


def test_shard_params_and_uneven_batches_raise():
    """Tensor parallelism of a model class other than TdnnChain raises
    naming its ROADMAP item (a TdnnChain keeps each rank's slices); a
    batch that does not divide over the data axis raises before any
    collective."""
    from kaldi_tpu_torch.am.chain import make_denominator_graph
    from kaldi_tpu_torch.am.tdnn import TdnnChain, TdnnConfig
    from kaldi_tpu_torch.am.topology import HmmTopology
    from kaldi_tpu_torch.am.tree import MonophoneContextDependency
    from kaldi_tpu_torch.parallel.mesh import Mesh, batch_sharding, \
        shard_params
    from kaldi_tpu_torch.pipelines.chain import ChainEgs, ChainTrainer
    cfg = TdnnConfig(feat_dim=6, num_pdfs=4, hidden_dim=8,
                     bottleneck_dim=4, num_layers=2)
    from kaldi_tpu_torch.am.lstm import LstmChain, LstmConfig
    with pytest.raises(KaldiError, match="ROADMAP Queue 1 item 6"):
        shard_params(LstmChain(LstmConfig(feat_dim=6, num_pdfs=4,
                                          hidden_dim=8, proj_dim=4,
                                          num_layers=1)),
                     Mesh(1, 2, 0, torch.device("cpu")))
    sharded = shard_params(TdnnChain(cfg), Mesh(1, 2, 1, torch.device("cpu")))
    assert sharded.tdnnf[0].linear.weight.shape == (2, 16)
    assert sharded.tdnnf[0].affine.weight.shape == (8, 4)
    mesh = Mesh(2, 1, 1, torch.device("cpu"))
    assert batch_sharding(mesh, 6) == slice(3, 6)
    with pytest.raises(KaldiError, match="does not divide"):
        batch_sharding(mesh, 5)
    topo = HmmTopology.chain([1, 2])
    tree = MonophoneContextDependency([1, 2], topo)
    tr = ChainTrainer(cfg, make_denominator_graph([[1, 2]], tree, topo),
                      device="cpu")
    tr.mesh = mesh
    egs = ChainEgs(feats=np.zeros((5, 12, 6), np.float32),
                   pdf_ali=np.zeros((5, 4), np.int32),
                   mask=np.ones((5, 4), bool))
    with pytest.raises(KaldiError, match="does not divide"):
        tr.batches(egs, np.arange(5))
    assert tr.batches(egs, np.arange(4))[0].shape[0] == 2


def test_initialize_refuses_what_it_cannot_run(monkeypatch):
    from kaldi_tpu_torch.parallel import distributed as D
    assert D._init_method("127.0.0.1:1234") == "tcp://127.0.0.1:1234"
    assert D._init_method("file:///tmp/x") == "file:///tmp/x"
    with pytest.raises(KaldiError, match="expected"):
        D._init_method("udp://h:1")
    with pytest.raises(KaldiError, match="CUDA devices only"):
        D.initialize("file:///nonexistent/s", 2, 0, backend="nccl",
                     device="cpu")
    # two ranks on one card: nccl refused, no quiet switch to gloo
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(KaldiError, match="a card per rank"):
        D.initialize("file:///nonexistent/s", 2, 1, device="cuda")
    assert not torch.distributed.is_initialized()


# -- the port's worker: the original's four checks --------------------------

def test_psum_stats_equals_the_numpy_sum(pairs):
    want = sum(np.random.default_rng(100 + pid).standard_normal(
        (4, 3)).astype(np.float32) for pid in range(NPROC))
    for r in pairs["m"]:
        assert int(r["ndev"]) == NPROC
        assert str(r["backend"]) == "gloo" and str(r["device"]) == "cpu"
        np.testing.assert_allclose(r["total"], want, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(pairs["m"][0]["total"],
                                  pairs["m"][1]["total"])


def test_data_parallel_gradient_equals_the_full_batch(pairs):
    D = 8
    gb = np.random.default_rng(7).standard_normal(
        (NPROC * 4, D)).astype(np.float32)
    gy = gb @ (np.arange(D) * 0.1)
    W = np.linspace(-1, 1, D).astype(np.float32)
    want = 2 * gb.T @ (gb @ W - gy) / len(gy)
    for r in pairs["m"]:
        np.testing.assert_allclose(r["grad"], want, rtol=1e-5, atol=1e-6)


def test_worker_sharded_lattice_decode(pairs):
    for r in pairs["m"]:
        assert int(r["decode_ok"]) == 1
        assert int(r["n_lats"]) == 2


def test_worker_chain_step_equal_across_ranks_and_to_one_process(pairs):
    r0, r1 = pairs["m"]
    assert float(r0["chain_loss"]) == float(r1["chain_loss"])
    assert float(r0["chain_p0"]) == float(r1["chain_p0"])
    np.testing.assert_array_equal(r0["chain_params"], r1["chain_params"])
    loss, params = pairs["single_step"]
    assert np.isfinite(loss)
    assert float(r0["chain_loss"]) == pytest.approx(loss, rel=1e-5)
    np.testing.assert_allclose(r0["chain_params"], params,
                               atol=1e-5 * np.abs(params).max())
    assert int(r0["den_launches"]) == 0          # the CPU: no kernel


# -- meshes, sharded decoders and the trainer over the pair ------------------

def test_mesh_shapes_over_the_pair(pairs):
    for pid, r in enumerate(pairs["w"]):
        assert r["mesh"] == {"data": 2, "model": 1}
        assert r["mesh_21"] == {"data": 2, "model": 1}
        assert r["mesh_12"] == ({"data": 1, "model": 2}, 0, pid)
        assert r["raises"] == [True, True, True]
        assert r["rows"] == (3 * pid, 3 * pid + 3)


def test_sharded_dense_decode(pairs):
    """ShardedDecoder on the yes/no graph, B = 11 over 2 ranks: every
    rank returns all 11, equal to the port's single decode and to the
    JAX ShardedDecoder on 8 devices."""
    port, jax = pairs["port"]["dense"], pairs["jax"]["dense"]
    assert len(port) == len(jax) == 11
    for r in pairs["w"]:
        assert len(r["dense"]) == 11
        for (gt, go, gc), (pt, po, pc), (jt, jo, jc) in zip(r["dense"], port,
                                                            jax):
            assert gt == pt == list(jt) and go == po == list(jo)
            assert gc == pytest.approx(pc, abs=1e-6)
            assert gc == pytest.approx(jc, abs=1e-3)


def _same_lattices(got, want, tol):
    assert len(got) == len(want)
    for (gb, gp), (wb, wp) in zip(got, want):
        assert list(gb[0]) == list(wb[0])
        assert gb[2] == pytest.approx(wb[2], abs=tol)
        assert gp == pytest.approx(wp, abs=tol)


def test_sharded_beam_decode_compact_batch(pairs):
    """B = 5 (padded to 6) on the 600-word task, one utterance escalated:
    every rank returns all 5 lattices, equal to the port's single decode
    (words exact, costs 1e-6) and the JAX ShardedBeamDecoder on a data=2
    mesh (costs 1e-3)."""
    port, jax = pairs["port"], pairs["jax"]
    assert port["stats"]["n_escalated"] == jax["stats"]["n_escalated"] == 1
    for r in pairs["w"]:
        _same_lattices(r["batch"], port["beam"], 1e-6)
        _same_lattices(r["batch"], jax["beam"], 1e-3)
        assert r["batch_stats"]["n_escalated"] == 1
        assert r["batch_stats"]["min_eff_beam"] == pytest.approx(
            port["stats"]["min_eff_beam"], abs=1e-6)


def test_sharded_beam_decode_compact_local(pairs):
    """Each rank passes its own rows (3 and 2) and gets back exactly
    those, decoded and escalated on that rank."""
    port, jax = pairs["port"]["beam"], pairs["jax"]["beam"]
    n_esc = 0
    for r, (lo, hi) in zip(pairs["w"], LOCAL_ROWS):
        _same_lattices(r["local"], port[lo:hi], 1e-6)
        _same_lattices(r["local"], jax[lo:hi], 1e-3)
        n_esc += r["local_stats"]["n_escalated"]
    assert n_esc == 1


def test_chain_trainer_mesh(pairs):
    """Two NG-SGD steps of ChainTrainer(mesh=) over 2 ranks (4 rows each
    of a batch of 8, from the JAX trainer's initial weights): the ranks'
    parameters and batch-norm statistics equal to the bit, each equal to
    the port's unsharded trainer within 1e-5 of each tensor's largest,
    the loss equal to the JAX ChainTrainer's on a (4, 2) mesh within
    1e-3."""
    w0, w1 = pairs["w"]
    port, jax = pairs["port"], pairs["jax"]
    assert w0["chain_last"] == w1["chain_last"]
    assert sorted(w0["chain_state"]) == sorted(port["chain_state"])
    moved = 0.0
    for k, want in port["chain_state"].items():
        np.testing.assert_array_equal(w0["chain_state"][k],
                                      w1["chain_state"][k])
        scale = max(float(np.abs(want).max()), 1e-12)
        assert float(np.abs(w0["chain_state"][k] - want).max()) \
            <= 1e-5 * scale, k
        moved = max(moved, float(np.abs(
            want - pairs["inputs"]["chain"]["init"][k]).max()))
    assert moved > 0
    assert w0["chain_last"]["loss"] == pytest.approx(
        port["chain_last"]["loss"], rel=1e-5)
    assert abs(w0["chain_last"]["loss"] - jax["chain_last"]["loss"]) < 1e-3
