"""Multi-process distributed runtime over ``torch.distributed``.

Port of kaldi_tpu/parallel/distributed.py.  The original joins one JAX
process per host to a coordinator (``jax.distributed.initialize``) and
federates the devices into one global mesh.  Here each process is one
rank with one device, joined by ``torch.distributed.init_process_group``:
PyTorch's idiom for the same SPMD program, and the form that reaches N
hosts.  Sums over ranks are ``all_reduce`` calls — the gmm-sum-accs /
nnet3-average role — in place of ``psum`` under ``shard_map``.

Backends: ``nccl`` when every rank has a card of its own (the default for
``device="cuda"``); where ranks share a card the caller passes
``backend="gloo"``, since NCCL refuses two ranks on one device, and
``"nccl"`` on a shared card raises.  Gloo's ``all_reduce`` and
``broadcast`` take CUDA tensors and stage them through host memory; the
compute stays on the card.  ``gloo`` on ``device="cpu"`` is what the
tests run.

``worker_main`` is the per-process entry (the run.pl "job"):

    python -m kaldi_tpu_torch.parallel.distributed <coord> <nproc> <pid> \\
        <out_prefix> [--device=cpu|cuda] [--backend=gloo|nccl]

``<coord>`` is ``host:port`` as the JAX coordinator takes it (or
``tcp://host:port``), or a ``file://`` store shared by the ranks (the
tests use one: no port to race for).  Runs across hosts (``tcp://``) are
untested beyond one host.
"""

from __future__ import annotations

import datetime
import os
import sys
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from kaldi_tpu_torch.core.logging import KaldiError, get_logger
from kaldi_tpu_torch.device import resolve_device

log = get_logger(__name__)

# the device initialize() gave this process's rank
_RANK_DEVICE: Optional[torch.device] = None


def _init_method(coordinator_address: str) -> str:
    if coordinator_address.startswith(("tcp://", "file://")):
        return coordinator_address
    if "://" in coordinator_address:
        raise KaldiError(f"coordinator {coordinator_address!r}: expected "
                         "host:port, tcp://host:port or file://path")
    return f"tcp://{coordinator_address}"


def initialize(coordinator_address: str, num_processes: int,
               process_id: int, backend: Optional[str] = None,
               device: torch.device | str = "cuda",
               timeout_s: float = 120.0) -> torch.device:
    """Join the process group as rank ``process_id`` of ``num_processes``
    (idempotent per process).  The rank computes on
    ``cuda:(local_rank % device_count)`` (``LOCAL_RANK`` when set, else
    ``process_id``), or on the CPU when ``device="cpu"``.  Every
    collective and the rendezvous itself give up after ``timeout_s``.
    → the rank's device."""
    global _RANK_DEVICE
    if dist.is_initialized():
        return _RANK_DEVICE
    dev = resolve_device(device)
    local_rank = int(os.environ.get("LOCAL_RANK", process_id))
    if dev.type == "cuda":
        n_cards = torch.cuda.device_count()
        dev = torch.device("cuda", local_rank % n_cards)
        backend = backend or "nccl"
        # ranks on this host: LOCAL_WORLD_SIZE when a launcher sets it,
        # else all of them (one host)
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE",
                                         num_processes))
        if backend == "nccl" and local_world > n_cards:
            raise KaldiError(
                f"nccl needs a card per rank: {local_world} ranks on "
                f"{n_cards} card(s); pass backend='gloo' to share a card")
        torch.cuda.set_device(dev)
    else:
        backend = backend or "gloo"
        if backend == "nccl":
            raise KaldiError("nccl runs on CUDA devices only: pass "
                             "backend='gloo' for device='cpu'")
    dist.init_process_group(
        backend=backend, init_method=_init_method(coordinator_address),
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=timeout_s))
    _RANK_DEVICE = dev
    log.info("distributed: rank %d/%d up on %s (%s)", process_id,
             num_processes, dev, backend)
    return dev


def rank_device() -> Optional[torch.device]:
    """The device ``initialize`` gave this rank (None before it)."""
    return _RANK_DEVICE if dist.is_initialized() else None


def shutdown() -> None:
    """Leave the process group (every rank)."""
    global _RANK_DEVICE
    if dist.is_initialized():
        dist.destroy_process_group()
    _RANK_DEVICE = None


def global_mesh():
    """Every rank on the data axis (model = 1)."""
    from kaldi_tpu_torch.parallel.mesh import make_mesh
    return make_mesh(model=1)


def psum_stats(local_stats: np.ndarray, mesh=None) -> np.ndarray:
    """Sum per-rank statistics over the mesh's data axis (the
    gmm-sum-accs reduction as one ``all_reduce`` on the rank's device).
    ``local_stats``: this rank's contribution; every rank must call."""
    mesh = mesh or global_mesh()
    t = torch.from_numpy(np.ascontiguousarray(local_stats)).to(mesh.device)
    return mesh.all_reduce_data(t).cpu().numpy()


def worker_main(argv=None) -> int:
    """Entry of the distributed smoke worker (module docstring).  Each
    rank runs the original's four checks and writes the reduced results
    to ``<out_prefix>.<pid>.npz`` for the launcher to compare:

    1. stat reduction: per-rank seeded stats summed by ``psum_stats``;
    2. a data-parallel gradient: each rank's rows of one global batch of
       a least-squares loss, the loss normalized by the global row count
       and the gradients all-reduced, equal to the full-batch gradient;
    3. the sharded lattice decode: each rank decodes its own rows of a
       global batch on the 600-word task with ``decode_compact_local``
       and checks every lattice's best path against the single decode of
       the same utterance in process (``decode_ok``);
    4. one data-parallel chain training step (``ChainTrainer(mesh=)``),
       whose loss and parameters must equal across ranks
       (``chain_loss``, ``chain_p0``, ``chain_params``).

    The den kernels' launches in 4 are ``den_launches``."""
    from kaldi_tpu_torch.core.options import ParseOptions
    po = ParseOptions("python -m kaldi_tpu_torch.parallel.distributed "
                      "<coord> <nproc> <pid> <out_prefix>")
    po.register("device", str, "cuda", "the rank's device type")
    po.register("backend", str, "", "gloo or nccl (default: nccl on "
                "cuda, gloo on cpu)")
    args = po.read(list(sys.argv[1:] if argv is None else argv))
    if len(args) != 4:
        po.print_usage()
        return 1
    coord, nproc, pid, out_prefix = (args[0], int(args[1]), int(args[2]),
                                     args[3])
    dev = initialize(coord, nproc, pid, backend=po["backend"] or None,
                     device=po["device"])
    try:
        out = _worker_checks(pid, nproc, dev)
        np.savez(f"{out_prefix}.{pid}.npz", **out)
        log.info("worker %d done: ranks=%d decode_ok=%d chain_loss=%.5f",
                 pid, nproc, int(out["decode_ok"]), float(out["chain_loss"]))
        dist.barrier()
    finally:
        shutdown()
    return 0


def _worker_checks(pid: int, nproc: int, dev: torch.device) -> dict:
    from kaldi_tpu_torch.parallel.mesh import make_mesh
    mesh = global_mesh()
    # 1. stat reduction (gmm-sum-accs role)
    rng = np.random.default_rng(100 + pid)
    local = rng.standard_normal((4, 3)).astype(np.float32)
    total = psum_stats(local, mesh)

    # 2. data-parallel gradient step (nnet3-average role, done as
    #    synchronous all-reduce SGD): the global batch split over ranks
    D, per_rank = 8, 4
    grng = np.random.default_rng(7)        # the same on every rank
    gb = grng.standard_normal((nproc * per_rank, D)).astype(np.float32)
    gy = (gb @ (np.arange(D) * 0.1)).astype(np.float32)
    lo = pid * per_rank
    X = torch.from_numpy(gb[lo:lo + per_rank]).to(dev)
    Y = torch.from_numpy(gy[lo:lo + per_rank]).to(dev)
    W = torch.from_numpy(np.linspace(-1, 1, D).astype(np.float32)).to(dev)
    W.requires_grad_(True)
    loss = ((X @ W - Y) ** 2).sum() / len(gy)
    loss.backward()
    g = mesh.all_reduce_data(W.grad).cpu().numpy()

    # 3. the sharded lattice decode: each rank feeds and fetches only its
    #    own rows and checks each lattice against a single decode of the
    #    same utterance in process
    from kaldi_tpu_torch.decoder.beam import BeamDecoder, BeamDecoderConfig
    from kaldi_tpu_torch.parallel.decode import ShardedBeamDecoder
    from kaldi_tpu_torch.pipelines.largevocab import (make_largevocab_task,
                                                      sample_eval_set,
                                                      synth_loglikes)
    task = make_largevocab_task(vocab_size=600, corpus_sentences=600,
                                seed=3)
    dec = BeamDecoder(task.graph.csr, task.tm.tid_to_pdf_array,
                      BeamDecoderConfig(beam=14.0, max_active=512,
                                        acoustic_scale=1.0,
                                        lattice_beam=6.0,
                                        lattice_arcs_per_frame=1024,
                                        record_capacity=16384),
                      device=dev)
    sharded = ShardedBeamDecoder(dec, mesh)
    Bl = 2                                 # rows for THIS rank
    eval_set = sample_eval_set(task, Bl * nproc, max_words=4, seed=5)
    urng = np.random.default_rng(17)       # the same on every rank
    all_lls = [synth_loglikes(task, s, urng, noise=0.3)
               for _, s in sorted(eval_set.items())]
    T_pad = 64
    Xd = np.zeros((Bl * nproc, T_pad, task.num_pdfs), np.float32)
    lensd = np.zeros(Bl * nproc, np.int64)
    for i, ll in enumerate(all_lls):
        Xd[i, :len(ll)] = ll[:T_pad]
        lensd[i] = min(len(ll), T_pad)
    lo = pid * Bl
    lats = sharded.decode_compact_local(Xd[lo:lo + Bl], lensd[lo:lo + Bl])
    decode_ok = 1
    for b, lat in enumerate(lats):
        ref = dec.decode_compact(Xd[lo + b][:lensd[lo + b]], bucket=64)
        gw, _gt, gc = lat.best_path()
        rw, _rt, rc = ref.best_path()
        if gw != rw or abs(gc - rc) > 1e-3:
            decode_ok = 0
            log.info("worker %d: decode mismatch at row %d", pid, b)

    # 4. one data-parallel chain training step: every rank must hold the
    #    same loss and parameters after it
    from kaldi_tpu_torch.am.chain import make_denominator_graph
    from kaldi_tpu_torch.am.tdnn import TdnnConfig
    from kaldi_tpu_torch.am.topology import HmmTopology
    from kaldi_tpu_torch.am.tree import MonophoneContextDependency
    from kaldi_tpu_torch.ops.chain_den import CudaChainDen
    from kaldi_tpu_torch.pipelines.chain import (ChainEgs, ChainTrainConfig,
                                                 ChainTrainer)
    phones = list(range(1, 9))
    topo = HmmTopology.chain(phones)
    tree = MonophoneContextDependency(phones, topo)
    crng = np.random.default_rng(0)
    seqs = [list(crng.integers(1, 9, 8)) for _ in range(30)]
    den = make_denominator_graph(seqs, tree, topo, order=2)
    ccfg = TdnnConfig(feat_dim=8, num_pdfs=tree.num_pdfs, hidden_dim=16,
                      bottleneck_dim=8, num_layers=3,
                      frame_subsampling_factor=3)
    Bc, Tc = nproc * 2, 24
    trainer = ChainTrainer(ccfg, den, ChainTrainConfig(
        batch_size=Bc, total_steps=0), mesh=make_mesh(model=1))
    egs = ChainEgs(
        feats=crng.standard_normal((Bc, Tc, 8)).astype(np.float32),
        pdf_ali=crng.integers(0, tree.num_pdfs, (Bc, Tc // 3)).astype(
            np.int32),
        mask=np.ones((Bc, Tc // 3), bool))
    CudaChainDen.total_launches = 0
    loss, _diag = trainer._step(*trainer.batches(egs, np.arange(Bc)))
    sd = trainer.model.state_dict()
    return dict(
        total=total, grad=g, ndev=np.asarray(nproc),
        decode_ok=np.asarray(decode_ok), n_lats=np.asarray(len(lats)),
        chain_loss=np.asarray(float(loss)),
        chain_p0=np.asarray(float(sd["output_affine.bias"].sum())),
        chain_params=torch.cat([v.reshape(-1).float() for v in sd.values()])
        .cpu().numpy(),
        den_launches=np.asarray(CudaChainDen.total_launches),
        device=np.asarray(str(dev)), backend=np.asarray(dist.get_backend()))


if __name__ == "__main__":
    # run the package's module, whose state make_mesh reads, not this
    # __main__ copy of it
    from kaldi_tpu_torch.parallel.distributed import worker_main as _main
    sys.exit(_main())
