"""One rank of tests/test_torch_parallel.py's gloo pair, on the CPU.

    python tests/torch_parallel_worker.py <file-store> <nproc> <pid> \\
        <inputs.pkl> <out_prefix>
    python tests/torch_parallel_worker.py --tensor-parallel <file-store> \\
        <nproc> <pid> <inputs.pkl> <out_prefix>

Joins the process group through ``kaldi_tpu_torch.parallel.distributed``
(gloo, a ``file://`` store, a 60 s timeout), runs the port's mesh,
sharded decoders and data-parallel ChainTrainer on the inputs the test
wrote, and pickles what it got to ``<out_prefix>.<pid>.pkl``.  With
``--tensor-parallel`` it runs tests/test_torch_tensor_parallel.py's
``ChainTrainer(mesh=make_mesh(data, model))`` runs instead.  It imports
only the port: the tests hold the results against the JAX package and
the port's single-process runs.
"""

import pickle
import sys

import torch


def mesh_checks(out):
    from kaldi_tpu_torch.parallel.mesh import batch_sharding, make_mesh
    m = make_mesh()
    out["mesh"] = m.shape
    out["mesh_21"] = make_mesh(2, 1).shape
    m12 = make_mesh(1, 2)
    out["mesh_12"] = (m12.shape, m12.data_index, m12.model_index)
    raises = []
    for kw in (dict(data=3), dict(model=3), dict(data=1, model=1)):
        try:
            make_mesh(**kw)
            raises.append(False)
        except ValueError:
            raises.append(True)
    out["raises"] = raises
    rows = batch_sharding(m, 6)
    out["rows"] = (rows.start, rows.stop)
    return m


def dense_decode(inp, mesh, out):
    from kaldi_tpu_torch.am.topology import HmmTopology
    from kaldi_tpu_torch.am.transitions import TransitionModel
    from kaldi_tpu_torch.am.tree import MonophoneContextDependency
    from kaldi_tpu_torch.decoder.dense import DenseDecoder, DenseDecoderConfig
    from kaldi_tpu_torch.fst import (ArpaModel, Lang, Lexicon, arpa_to_fst,
                                     make_unigram_arpa, mkgraph)
    from kaldi_tpu_torch.parallel.decode import ShardedDecoder
    lex = Lexicon(entries=[("YES", ["Y", "EH", "S"]), ("NO", ["N", "OW"])])
    lang = Lang(lex)
    phones = lang.phone_list()
    topo = HmmTopology.three_state(phones)
    tm = TransitionModel(topo, MonophoneContextDependency(phones, topo))
    HCLG = mkgraph(lang, tm, arpa_to_fst(
        ArpaModel.parse(make_unigram_arpa({"YES": 1.0, "NO": 1.0})),
        lang.words))
    dec = DenseDecoder(HCLG, tm.tid_to_pdf_array,
                       DenseDecoderConfig(beam=1e9, acoustic_scale=0.1),
                       device="cpu")
    out["dense"] = ShardedDecoder(dec, mesh).decode_batch(
        inp["dense_lls"], inp["dense_lens"])


def beam_decode(inp, mesh, pid, out):
    from kaldi_tpu_torch.decoder.beam import BeamDecoder, BeamDecoderConfig
    from kaldi_tpu_torch.parallel.decode import ShardedBeamDecoder
    from kaldi_tpu_torch.pipelines.largevocab import make_largevocab_task
    task = make_largevocab_task(**inp["task"])
    dec = BeamDecoder(task.graph.csr, task.tm.tid_to_pdf_array,
                      BeamDecoderConfig(**inp["beam_cfg"]), device="cpu")
    sharded = ShardedBeamDecoder(dec, mesh)
    X, lens = inp["beam_X"], inp["beam_lens"]
    stats = {}
    lats = sharded.decode_compact_batch(X, lens, stats=stats)
    out["batch"] = [(lat.best_path(), dict(lat.paths())) for lat in lats]
    out["batch_stats"] = stats
    lo, hi = inp["local_rows"][pid]
    local_stats = {}
    lats = sharded.decode_compact_local(X[lo:hi], lens[lo:hi],
                                        stats=local_stats)
    out["local"] = [(lat.best_path(), dict(lat.paths())) for lat in lats]
    out["local_stats"] = local_stats


def chain_training(inp, mesh, out):
    from kaldi_tpu_torch.am.chain import (ChainTrainingOptions,
                                          make_denominator_graph)
    from kaldi_tpu_torch.am.tdnn import TdnnConfig
    from kaldi_tpu_torch.am.topology import HmmTopology
    from kaldi_tpu_torch.am.tree import MonophoneContextDependency
    from kaldi_tpu_torch.pipelines.chain import (ChainEgs, ChainTrainConfig,
                                                 ChainTrainer)
    c = inp["chain"]
    topo = HmmTopology.chain(c["phones"])
    tree = MonophoneContextDependency(c["phones"], topo)
    den = make_denominator_graph(c["seqs"], tree, topo)
    tr = ChainTrainer(TdnnConfig(**c["model"]), den, ChainTrainConfig(
        opts=ChainTrainingOptions(l2_regularize=c["l2"]), **c["train"]),
        mesh=mesh)
    tr.model.load_state_dict({k: torch.tensor(v)
                              for k, v in c["init"].items()})
    out["chain_last"] = tr.train(ChainEgs(**c["egs"]), log_every=100)
    out["chain_state"] = {k: v.detach().cpu().numpy()
                          for k, v in tr.model.state_dict().items()}


def _numpy(sd):
    return {k: v.detach().cpu().numpy().copy() for k, v in sd.items()}


def tp_train(tr, egs, batches, B):
    """``tr._step`` on the rows ``order[b·B:(b+1)·B]`` of each b in
    ``batches`` (order: the trainers' epoch permutation) → (losses, the
    whole state after the first step)."""
    import numpy as np
    order = np.random.default_rng(0).permutation(egs.feats.shape[0])
    losses, step1 = [], None
    for b in batches:
        loss, _ = tr._step(*tr.batches(egs, order[b * B:(b + 1) * B]))
        losses.append(float(loss))
        if step1 is None:
            step1 = _numpy(tr.state_dict())
    return losses, step1


def tensor_parallel(inp, out):
    from kaldi_tpu_torch.am.chain import make_denominator_graph
    from kaldi_tpu_torch.am.tdnn import TdnnConfig
    from kaldi_tpu_torch.am.topology import HmmTopology
    from kaldi_tpu_torch.am.tree import MonophoneContextDependency
    from kaldi_tpu_torch.parallel.mesh import make_mesh
    from kaldi_tpu_torch.pipelines.chain import (ChainEgs, ChainTrainConfig,
                                                 ChainTrainer)
    c = inp["tp"]
    topo = HmmTopology.chain(c["phones"])
    tree = MonophoneContextDependency(c["phones"], topo)
    den = make_denominator_graph(c["seqs"], tree, topo)
    egs = ChainEgs(**c["egs"])
    for run in c["runs"]:
        mesh = make_mesh(*run["mesh"])
        tr = ChainTrainer(TdnnConfig(**run["model"]), den,
                          ChainTrainConfig(**run["train"]), mesh=mesh)
        r = {"mesh": (mesh.data_index, mesh.model_index)}
        if run.get("restore"):
            r["restored_step"] = tr.restore(run["restore"])
        else:
            tr.load_state_dict({k: torch.tensor(v)
                                for k, v in run["init"].items()})
        r["losses"], r["step1"] = tp_train(tr, egs, run["batches"],
                                           run["train"]["batch_size"])
        r["final"] = _numpy(tr.state_dict())
        local = tr.model.state_dict()
        shards = getattr(tr.model, "tp_shards", {})
        r["replicated"] = _numpy({k: v for k, v in local.items()
                                  if k not in shards})
        r["shapes"] = {k: tuple(local[k].shape) for k in shards}
        named = dict(tr.model.named_parameters())
        r["opt_shapes"] = {k: {sk: tuple(v.shape) for sk, v in
                               tr.opt.state[named[k]].items()
                               if torch.is_tensor(v)} for k in shards}
        if run.get("save"):
            tr.save(run["save"], len(run["batches"]))
        out[run["name"]] = r


def main(argv):
    mode = "all"
    if argv[0] == "--tensor-parallel":
        mode, argv = "tp", argv[1:]
    store, nproc, pid, in_path, out_prefix = (argv[0], int(argv[1]),
                                              int(argv[2]), argv[3], argv[4])
    torch.set_num_threads(1)
    from kaldi_tpu_torch.parallel import distributed
    distributed.initialize(store, nproc, pid, backend="gloo", device="cpu",
                           timeout_s=60.0)
    with open(in_path, "rb") as f:
        inp = pickle.load(f)
    out = {}
    try:
        if mode == "tp":
            tensor_parallel(inp, out)
            return _write(out, out_prefix, pid)
        mesh = mesh_checks(out)
        dense_decode(inp, mesh, out)
        beam_decode(inp, mesh, pid, out)
        chain_training(inp, mesh, out)
    finally:
        distributed.shutdown()
    return _write(out, out_prefix, pid)


def _write(out, out_prefix, pid):
    with open(f"{out_prefix}.{pid}.pkl", "wb") as f:
        pickle.dump(out, f)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
