"""One rank of tests/test_torch_parallel.py's gloo pair, on the CPU.

    python tests/torch_parallel_worker.py <file-store> <nproc> <pid> \\
        <inputs.pkl> <out_prefix>

Joins the process group through ``kaldi_tpu_torch.parallel.distributed``
(gloo, a ``file://`` store, a 60 s timeout), runs the port's mesh,
sharded decoders and data-parallel ChainTrainer on the inputs the test
wrote, and pickles what it got to ``<out_prefix>.<pid>.pkl``.  It
imports only the port: the test holds the results against the JAX
package and the port's single-process runs.
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


def main(argv):
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
        mesh = mesh_checks(out)
        dense_decode(inp, mesh, out)
        beam_decode(inp, mesh, pid, out)
        chain_training(inp, mesh, out)
    finally:
        distributed.shutdown()
    with open(f"{out_prefix}.{pid}.pkl", "wb") as f:
        pickle.dump(out, f)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
