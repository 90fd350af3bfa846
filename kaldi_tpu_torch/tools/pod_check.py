"""chip_smoke phase 16 alone, on every card of the host.

    python3 kaldi_tpu_torch/tools/pod_check.py

Imports ``chip_smoke`` from this checkout, builds the kernels, then
runs what phase 16 takes its inputs from: phase 4's batch (32 seeded
utterances on the 20k-word task's graph, decoded in this process: the
best paths and audio-s/s the ranks are held to) and phase 8b's egs (48
seeded waveforms through the fbank kernel on the bench's den graph).
Then ``pod_phase``: max(2, cards) ranks, NCCL with a card each where
there are enough cards, else gloo on cuda:0 (16a the distributed worker,
16b the sharded decode, 16c ``ChainTrainer(mesh=)``, 16d its tensor-
parallel layouts).  On a host of four cards joined by NVLink it runs the
NCCL path the one-card chip_smoke does not, and 16d at 16c's batch
(B = 128, 10 steps) on the layouts (4, 1), (2, 2) and (1, 4): each
one's aggregate Mframes/s, the collectives of one step (count, MiB, ms),
the parameter and optimizer-state bytes a rank holds, and its step 1
against one process's.  Card only.
"""

import os
import sys
import time


def main() -> int:
    sys.path.insert(0, os.path.abspath(os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "..", "..")))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("pod_check: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    import kaldi_tpu_torch.features  # noqa: F401  (before ops.fbank)
    from kaldi_tpu_torch.decoder.beam import BeamDecoder, BeamDecoderConfig
    from kaldi_tpu_torch.ops import build
    from kaldi_tpu_torch.pipelines.largevocab import (make_largevocab_task,
                                                      sample_eval_set,
                                                      synth_loglikes)
    from kaldi_tpu_torch.tools.timing import card_info
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tag = f"[{card_info()}]"
    print(f"pod_check: {torch.cuda.device_count()} card(s) "
          f"{torch.cuda.get_device_name(0)}, torch {torch.__version__} "
          f"{tag}", flush=True)
    build.load_all()
    # phase 4's batch, decoded in this process
    task = make_largevocab_task(vocab_size=20000, order=3, seed=7,
                                closure=False)
    cfg = BeamDecoderConfig(beam=13.0, max_active=7000, acoustic_scale=1.0,
                            lattice_beam=7.0, arc_budget=4096,
                            token_capacity=2048, arc_block=8,
                            escalate_budget=16384, escalate_deficit=4.0,
                            lattice_arcs_per_frame=4096,
                            record_capacity=16384)
    dec = BeamDecoder(task.graph.csr, task.tm.tid_to_pdf_array, cfg,
                      device=dev)
    eval_set = sample_eval_set(task, 32, max_words=6, seed=99)
    lrng = np.random.default_rng(1234)
    lls = [synth_loglikes(task, eval_set[u], lrng, noise=0.5)
           for u in sorted(eval_set)]
    lens = np.array([len(x) for x in lls], np.int64)
    T_pad = int(np.ceil(lens.max() / 32) * 32)
    X = np.zeros((len(lls), T_pad, task.num_pdfs), np.float32)
    for b, ll in enumerate(lls):
        X[b, :len(ll)] = ll
    dec.decode_compact_batch(X, lens)                        # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    best = [lat.best_path() for lat in dec.decode_compact_batch(X, lens)]
    rate = float(lens.sum()) * 0.03 / (time.perf_counter() - t0)
    print(f"pod_check: phase 4's batch in one process: {rate:.1f} "
          f"audio-s/s {tag}", flush=True)
    del dec
    # phase 8b's egs
    topo, tree, _, den = cs.bench_den_graph()
    egs = cs.chain_egs(dev, topo, tree, den, 48)[0]
    t0 = time.perf_counter()
    n = cs.pod_layout()[0]
    tp = (dict(tp_layouts=[(n, 1), (2, n // 2), (1, n)], tp_B=cs.POD_B,
               tp_steps=cs.POD_STEPS) if n == 4 else {})
    launches = cs.pod_phase(dev, task.graph.csr, task.tm.tid_to_pdf_array,
                            cfg, X, lens, best, rate, den, egs,
                            tree.num_pdfs, None, tag, **tp)
    print(f"pod_check: phase 16 took {time.perf_counter() - t0:.1f} s; den "
          f"kernel launches {launches} {tag}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
