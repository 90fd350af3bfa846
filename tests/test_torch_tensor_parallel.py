"""Tensor parallelism in the port: ``ChainTrainer(mesh=make_mesh(data,
model))`` on a ``TdnnChain`` over gloo ranks on the CPU, against the
port's unsharded trainer and the JAX package's.

One module fixture launches tests/torch_parallel_worker.py's
``--tensor-parallel`` mode on a pair of ranks (meshes (1, 2)) and on
four (meshes (2, 2) and (1, 4)), each group joined by a ``file://``
store, with tests/test_torch_parallel.py's launcher.  Every run starts
from the JAX trainer's initial weights (``params_from_flax``) and takes
three NG-SGD (or AdamW) steps over the same batches as the unsharded
runs, which the fixture computes while the ranks run: the port's trainer
in process and the JAX ``ChainTrainer`` (tests/test_parallel.py's
widths: hidden 8, bottleneck 4).  The second width, bottleneck 8,
splits over 2 and 4 ranks; 3 phones give 6 pdfs, which split unevenly
over 4.  The (2, 2) run writes a checkpoint the fixture restores at
(1, 1), and a (2, 2) run restores the unsharded trainer's; the AdamW
(1, 2) run writes one the unsharded AdamW trainer takes a step from.
"""

import os
import pickle
import sys

import numpy as np
import pytest
import torch

from kaldi_tpu_torch.core.logging import KaldiError
from test_torch_parallel import REPO, _launch, _wait

torch.set_num_threads(1)

PHONES = [1, 2, 3]
SEQS = [[1, 2, 3], [2, 1], [3, 3, 1, 2]]
SEED = 7
B, T = 8, 12
N = 3 * B                                  # three batches: three steps
WIDTH_A = dict(feat_dim=6, hidden_dim=8, bottleneck_dim=4, num_layers=2,
               frame_subsampling_factor=3)
WIDTH_B = dict(feat_dim=6, hidden_dim=16, bottleneck_dim=8, num_layers=2,
               frame_subsampling_factor=3)
NGSGD = dict(num_epochs=1, batch_size=B, optimizer="ngsgd", total_steps=0)
ADAMW = dict(NGSGD, optimizer="adamw")
# max-change low enough to bind (AdamW's updates are ~lr an entry,
# NG-SGD's ~lr·|g|): the clamp reads the whole update's norm
CLIP = dict(max_change=2e-3)
NG_CLIP = dict(max_change=1e-6)
STEPS = [0, 1, 2]


def _jax_setup():
    """The JAX package's den graph, egs and unsharded trainers (seed 7)
    of both widths; their initial weights as port state dicts."""
    from kaldi_tpu.am.chain import make_denominator_graph
    from kaldi_tpu.am.tdnn import TdnnConfig
    from kaldi_tpu.am.topology import HmmTopology
    from kaldi_tpu.am.tree import MonophoneContextDependency
    from kaldi_tpu.pipelines.chain import ChainTrainConfig, ChainTrainer
    from kaldi_tpu_torch.am.tdnn import params_from_flax
    from test_torch_parallel import jax_tree_to_numpy
    topo = HmmTopology.chain(PHONES)
    tree = MonophoneContextDependency(PHONES, topo)
    den = make_denominator_graph(SEQS, tree, topo)
    P = tree.num_pdfs
    rng = np.random.default_rng(0)
    egs = dict(feats=rng.standard_normal((N, T, 6)).astype(np.float32),
               pdf_ali=rng.integers(0, P, (N, T // 3)).astype(np.int32),
               mask=np.ones((N, T // 3), bool))
    inits, trainers = {}, {}
    for name, width in (("a", WIDTH_A), ("b", WIDTH_B)):
        jt = ChainTrainer(TdnnConfig(num_pdfs=P, **width), den,
                          ChainTrainConfig(**NGSGD), seed=SEED)
        inits[name] = {k: v.numpy() for k, v in params_from_flax({
            "params": jax_tree_to_numpy(jt.params),
            "batch_stats": jax_tree_to_numpy(jt.batch_stats)}).items()}
        trainers[name] = jt
    return P, egs, inits, trainers


def _port_trainer(width, train, P, mesh=None):
    from kaldi_tpu_torch.am.chain import make_denominator_graph
    from kaldi_tpu_torch.am.tdnn import TdnnConfig
    from kaldi_tpu_torch.am.topology import HmmTopology
    from kaldi_tpu_torch.am.tree import MonophoneContextDependency
    from kaldi_tpu_torch.pipelines.chain import ChainTrainConfig, ChainTrainer
    topo = HmmTopology.chain(PHONES)
    tree = MonophoneContextDependency(PHONES, topo)
    den = make_denominator_graph(SEQS, tree, topo)
    return ChainTrainer(TdnnConfig(num_pdfs=P, **width), den,
                        ChainTrainConfig(**train), device="cpu", mesh=mesh)


def _single(width, train, P, egs, init, save=None):
    """The port's unsharded trainer over STEPS → (losses, step 1's state,
    the final state, and after ``save``, the state one more step on)."""
    from kaldi_tpu_torch.pipelines.chain import ChainEgs
    from torch_parallel_worker import _numpy, tp_train
    tr = _port_trainer(width, train, P)
    tr.load_state_dict({k: torch.tensor(v) for k, v in init.items()})
    e = ChainEgs(**egs)
    losses, step1 = tp_train(tr, e, STEPS, B)
    out = dict(losses=losses, step1=step1, final=_numpy(tr.state_dict()))
    if save is not None:
        tr.save(save, len(STEPS))
        out["after"] = tp_train(tr, e, [0], B)[0]
        out["after_state"] = _numpy(tr.state_dict())
    return out


def _runs(inits, d):
    run = lambda name, mesh, width, train, **kw: dict(
        name=name, mesh=mesh, model=dict(num_pdfs=inits["P"], **width),
        train=train, init=inits[name[-1]], batches=STEPS, **kw)
    pair = [run("ng12a", (1, 2), WIDTH_A, NGSGD),
            run("adam12a", (1, 2), WIDTH_A, ADAMW, save=str(d / "ck12adam")),
            run("ng12b", (1, 2), WIDTH_B, NGSGD),
            run("ngclip12a", (1, 2), WIDTH_A, dict(NGSGD, **NG_CLIP)),
            run("adamclip12a", (1, 2), WIDTH_A, dict(ADAMW, **CLIP))]
    quad = [run("ng22a", (2, 2), WIDTH_A, NGSGD, save=str(d / "ck22")),
            run("ng14b", (1, 4), WIDTH_B, NGSGD),
            dict(run("re22a", (2, 2), WIDTH_A, NGSGD,
                     restore=str(d / "ck11")), batches=[0])]
    return pair, quad


@pytest.fixture(scope="module")
def tp(tmp_path_factory):
    d = tmp_path_factory.mktemp("tensor_parallel")
    P, egs, inits, jtrainers = _jax_setup()
    inits["P"] = P
    # the unsharded runs first: one writes the checkpoint a (2, 2) run
    # restores
    single = {"a": _single(WIDTH_A, NGSGD, P, egs, inits["a"],
                           save=str(d / "ck11")),
              "adama": _single(WIDTH_A, ADAMW, P, egs, inits["a"],
                               save=str(d / "ck11adam")),
              "b": _single(WIDTH_B, NGSGD, P, egs, inits["b"]),
              "clip_nga": _single(WIDTH_A, dict(NGSGD, **NG_CLIP), P, egs,
                                  inits["a"]),
              "clip_adama": _single(WIDTH_A, dict(ADAMW, **CLIP), P, egs,
                                    inits["a"])}
    pair, quad = _runs(inits, d)
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    cmds = []
    for tag, runs, n in (("p", pair, 2), ("q", quad, 4)):
        with open(d / f"in_{tag}.pkl", "wb") as f:
            pickle.dump({"tp": dict(phones=PHONES, seqs=SEQS, egs=egs,
                                    runs=runs)}, f)
        cmds += [[sys.executable,
                  os.path.join(REPO, "tests", "torch_parallel_worker.py"),
                  "--tensor-parallel", f"file://{d}/store_{tag}", str(n),
                  str(pid), str(d / f"in_{tag}.pkl"), str(d / tag)]
                 for pid in range(n)]
    procs = _launch(cmds, env)
    try:
        from kaldi_tpu.pipelines.chain import ChainEgs as JEgs
        jax_last = jtrainers["a"].train(JEgs(**egs), log_every=100)
    finally:
        _wait(procs)
    ranks = {}
    for tag, n in (("p", 2), ("q", 4)):
        for pid in range(n):
            with open(d / f"{tag}.{pid}.pkl", "rb") as f:
                for name, r in pickle.load(f).items():
                    ranks.setdefault(name, []).append(r)
    return dict(single=single, ranks=ranks, jax_last=jax_last, P=P,
                egs=egs, dir=d, inits=inits)


REF = {"ng12a": "a", "adam12a": "adama", "ng12b": "b", "ng22a": "a",
       "ng14b": "b", "ngclip12a": "clip_nga", "adamclip12a": "clip_adama"}


def _close(got, want, tol):
    """Each tensor within ``tol`` of the largest of its wanted value."""
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        scale = max(float(np.abs(w).max()), 1e-12)
        assert float(np.abs(got[k] - w).max()) <= tol * scale, k


@pytest.mark.parametrize("name", sorted(REF))
def test_step_one_equals_the_unsharded_step(tp, name):
    """Step 1's whole tensors (gathered) within 1e-5 of the unsharded
    port's, on every rank, and the three steps' losses within 1e-4."""
    want = tp["single"][REF[name]]
    for r in tp["ranks"][name]:
        _close(r["step1"], want["step1"], 1e-5)
        _close(r["final"], want["final"], 1e-4)
        assert r["losses"] == pytest.approx(want["losses"], rel=1e-4)
    moved = max(float(np.abs(want["final"][k] - v).max())
                for k, v in tp["inits"][REF[name][-1]].items())
    assert moved > 0


def test_loss_equals_the_jax_trainer(tp):
    """The sharded runs' third loss within 1e-3 of the unsharded JAX
    ChainTrainer's (tests/test_parallel.py's bar), from its weights."""
    for name in ("ng12a", "ng22a"):
        for r in tp["ranks"][name]:
            assert abs(r["losses"][-1] - tp["jax_last"]["loss"]) < 1e-3


@pytest.mark.parametrize("name", sorted(REF))
def test_replicated_tensors_equal_on_every_rank(tp, name):
    """Every () tensor (biases, batch-norm statistics) equal to the bit
    on every rank after three steps, and every sharded matrix 1/m of the
    whole on each rank."""
    rs = tp["ranks"][name]
    m = len({r["mesh"][1] for r in rs})
    for r in rs[1:]:
        assert sorted(r["replicated"]) == sorted(rs[0]["replicated"])
        for k, v in rs[0]["replicated"].items():
            np.testing.assert_array_equal(r["replicated"][k], v)
    whole = tp["single"][REF[name]]["final"]
    for r in rs:
        assert r["shapes"] and set(r["shapes"]) | set(r["replicated"]) \
            == set(whole)
        for k, shape in r["shapes"].items():
            full = whole[k].shape
            dim = [i for i in range(2) if shape[i] != full[i]]
            assert len(dim) == 1
            assert shape[dim[0]] in (full[dim[0]] // m,
                                     -(-full[dim[0]] // m)), k
        # gathered, each rank holds the whole model
        np.testing.assert_array_equal(sorted(r["final"]), sorted(whole))


def test_checkpoints_cross_layouts(tp):
    """A (2, 2) checkpoint restores at (1, 1) to the gathered weights,
    and the unsharded trainer's restores at (2, 2): its next step equals
    the unsharded trainer's next step."""
    from torch_parallel_worker import _numpy
    tr = _port_trainer(WIDTH_A, NGSGD, tp["P"])
    assert tr.restore(str(tp["dir"] / "ck22")) == len(STEPS)
    got = _numpy(tr.state_dict())
    for r in tp["ranks"]["ng22a"]:
        for k, v in r["final"].items():
            np.testing.assert_array_equal(got[k], v)
    single = tp["single"]["a"]
    for r in tp["ranks"]["re22a"]:
        assert r["restored_step"] == len(STEPS)
        _close(r["step1"], single["after_state"], 1e-5)
        assert r["losses"] == pytest.approx(single["after"], rel=1e-5)


@pytest.mark.parametrize("name", sorted(REF))
def test_optimizer_state_is_sharded(tp, name):
    """A sharded matrix's optimizer state (NG-SGD's momentum trace,
    AdamW's two moments) is its slice's shape on every rank."""
    want = {"ng": ["trace"], "ad": ["mu", "nu"]}[name[:2]]
    for r in tp["ranks"][name]:
        assert sorted(r["opt_shapes"]) == sorted(r["shapes"])
        for k, shape in r["shapes"].items():
            for sk in want:
                assert r["opt_shapes"][k][sk] == shape, (k, sk)


def test_adamw_checkpoint_restores_unsharded(tp):
    """The AdamW (1, 2) run's checkpoint (moments gathered whole, the
    step count) restores in the unsharded trainer, whose next step
    equals the unsharded run's own next step after its checkpoint."""
    from torch_parallel_worker import _numpy, tp_train
    from kaldi_tpu_torch.pipelines.chain import ChainEgs
    tr = _port_trainer(WIDTH_A, ADAMW, tp["P"])
    assert tr.restore(str(tp["dir"] / "ck12adam")) == len(STEPS)
    assert tr.opt.count == len(STEPS)
    losses, _ = tp_train(tr, ChainEgs(**tp["egs"]), [0], B)
    single = tp["single"]["adama"]
    _close(_numpy(tr.state_dict()), single["after_state"], 1e-5)
    assert losses == pytest.approx(single["after"], rel=1e-5)


def test_strided_affine_shard():
    """The row-parallel affine's shard is block j of each splice copy:
    the ranks' partial outputs sum to the whole layer's, and the
    contiguous shard P("model", None) suggests does not."""
    from kaldi_tpu_torch.am.tdnn import splice
    from kaldi_tpu_torch.parallel.tensor import Shard, shard_bounds
    g = torch.Generator().manual_seed(0)
    Bn, H, m, s = 8, 12, 2, 3
    h = torch.randn(2, 10, Bn, generator=g)
    W = torch.randn(H, 2 * Bn, generator=g)
    want = splice(h, (0, s)) @ W.T
    strided = Shard.strided(1, Bn, 2, m)
    contiguous = Shard.contiguous(1, 2 * Bn, m)
    parts = {"strided": 0.0, "contiguous": 0.0}
    for j in range(m):
        lo, hi = shard_bounds(Bn, m, j)
        local = splice(h[..., lo:hi], (0, s))
        parts["strided"] = parts["strided"] + local @ strided.take(W, j).T
        parts["contiguous"] = (parts["contiguous"]
                               + local @ contiguous.take(W, j).T)
    torch.testing.assert_close(parts["strided"], want)
    assert float((parts["contiguous"] - want).abs().max()) > 0.1
    assert strided.index[0].tolist() == [0, 1, 2, 3, 8, 9, 10, 11]


def test_other_model_classes_raise_on_a_model_axis():
    """shard_params refuses a model axis above 1 for any class but
    TdnnChain, naming the ROADMAP item that brings it; on a model axis
    of 1 it shards nothing."""
    from kaldi_tpu_torch.am.lstm import LstmChain, LstmConfig
    from kaldi_tpu_torch.am.tdnn import TdnnChain, TdnnConfig
    from kaldi_tpu_torch.am.xconfig import chain_model_from_xconfig
    from kaldi_tpu_torch.parallel.mesh import Mesh, shard_params
    mesh = Mesh(1, 2, 0, torch.device("cpu"))
    xc = chain_model_from_xconfig(
        "input name=input dim=6\n"
        "relu-batchnorm-layer name=tdnn1 input=Append(-1,0,1) dim=8\n"
        "tdnnf-layer name=tdnnf2 dim=8 bottleneck-dim=4 time-stride=1\n"
        "output-layer name=output dim=4 include-log-softmax=false\n")
    for model in (LstmChain(LstmConfig(feat_dim=6, num_pdfs=4,
                                       hidden_dim=8, proj_dim=4,
                                       num_layers=1)), xc):
        with pytest.raises(KaldiError, match="ROADMAP Queue 1 item 6b"):
            shard_params(model, mesh)
    tdnn = TdnnChain(TdnnConfig(num_pdfs=4, **WIDTH_A))
    assert not hasattr(shard_params(tdnn, Mesh(2, 1, 0,
                                               torch.device("cpu"))),
                       "tp_shards")
