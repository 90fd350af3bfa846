"""Profile of the port's slice on one CUDA card.

    python -m kaldi_tpu_torch.tools.profile_slice

Every line ends with the card's name and power limit (nvidia-smi).

1. The fbank kernel against its plain PyTorch version at the paths'
   per-utterance frame counts (300, 598) and at batched ones (4096 to
   131,072), 40 bins: the kernel's time on the card alone (calls queued
   behind a spin, CUDA events), its time per call issued back to back
   (the host's issue time where that is longer; the kernels' earlier
   timings were taken so), the plain version's time on the card, the
   bound (tools/timing.py fbank_bound) and the kernel's share of it.
   Kernel and plain are timed in the order plain, kernel, kernel, plain;
   the best of each is kept.
2. The GMM kernel the same way at the mini_librispeech tri3b width
   (2500 pdfs, 15,000 Gaussians, D = 40) from 300 to 32,768 frames.
3. One ``_decode_batch`` of the chip_smoke decode setup (20k-word task,
   32 utterances, beam 13, max-active 7000, lattice-beam 7) under
   torch.profiler, with the device β-prune on and off: kernels launched
   per frame, device kernel time against the profiled wall (the busy
   share), and the top entries by device time.
4. The streaming decoder on the same decoder (chip_smoke phase 7): one
   utterance's advances in chunks of 6 frames, its finalize, and 10
   steps of 8 lanes of MultiStreamBeamDecoder, each under torch.profiler:
   kernels launched per frame and the busy share.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch


def _best(fn_plain, fn_kernel, timer, iters):
    """(kernel ms, plain ms): plain, kernel, kernel, plain; best of each."""
    t = {"plain": [], "kernel": []}
    for which in ("plain", "kernel", "kernel", "plain"):
        t[which].append(timer(fn_plain if which == "plain" else fn_kernel,
                              iters))
    return min(t["kernel"]), min(t["plain"])


def _profiled(fn):
    """Run ``fn`` (which ends in a device synchronisation) under
    torch.profiler → (wall ms, CUDA kernels launched, their device ms,
    the profile)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type.name == "CUDA"]
    return wall, len(kernels), sum(e.device_time for e in kernels) / 1e3, prof


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_slice: no CUDA device", file=sys.stderr)
        return 1
    from kaldi_tpu_torch.decoder.beam import BeamDecoder, BeamDecoderConfig
    from kaldi_tpu_torch.features.compute import Fbank, FbankOptions
    from kaldi_tpu_torch.features.mel import MelBanksOptions
    from kaldi_tpu_torch.features.window import preprocess_frames
    from kaldi_tpu_torch.pipelines.largevocab import (make_largevocab_task,
                                                      sample_eval_set,
                                                      synth_loglikes)
    from kaldi_tpu_torch.tools.synth import tri3b_gmm
    from kaldi_tpu_torch.tools.timing import (card_info, cuda_ms, device_ms,
                                              fbank_bound, gmm_bound)

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    tag = f"[{card_info()}]"
    print(f"card: {tag}")

    fb = Fbank(FbankOptions(mel_opts=MelBanksOptions(num_bins=40)),
               device=dev)
    k = fb.kernel
    rng = np.random.default_rng(1)
    for n in (300, 598, 4096, 32768, 131072):
        raw = torch.from_numpy((1000 * rng.standard_normal((n, 400)))
                               .astype(np.float32)).to(dev)
        x, _ = preprocess_frames(raw, fb.frame_opts)
        x = x.contiguous()
        iters = 30 if n < 32768 else 10
        err = float((k(x) - k.reference(x)).abs().max())
        ms, plain = _best(lambda: k.reference(x), lambda: k(x), device_ms,
                          iters)
        call = cuda_ms(lambda: k(x), iters)
        bnd, by = fbank_bound(k, n)
        print(f"fbank {n} frames: kernel {ms:.4f} ms on the card, "
              f"{call:.4f} ms per call; "
              f"plain {plain:.4f} ms; bound {bnd:.4f} ms by {by}, "
              f"{100 * bnd / ms:.1f}% of it; max |diff| {err:.2e} {tag}")

    gk = tri3b_gmm(np.random.default_rng(2), device=dev).device_params()
    for n in (300, 1000, 4096, 16384, 32768):
        x = torch.from_numpy(rng.standard_normal((n, 40)).astype(
            np.float32)).to(dev)
        want = gk.reference(x)
        d = (gk(x) - want).abs()
        ok = bool((d <= 1e-4 + 1e-4 * want.abs()).all())
        del want
        iters = 20 if n <= 4096 else 5
        ms, plain = _best(lambda: gk.reference(x), lambda: gk(x), device_ms,
                          iters)
        call = cuda_ms(lambda: gk(x), iters)
        bnd, by = gmm_bound(gk, n)
        padded = 4.0 * n * gk.num_pdfs * gk.max_mix * gk.dim
        print(f"gmm {n} frames: kernel {ms:.4f} ms on the card, "
              f"{call:.4f} ms per call; plain "
              f"{plain:.4f} ms; bound {bnd:.4f} ms by {by}, "
              f"{100 * bnd / ms:.1f}% of it; float32 work over all slots "
              f"{padded / ms / 1e9:.1f} TFLOP/s, {3 * padded / ms / 1e9:.1f} "
              f"of TF32 products; max |diff| "
              f"{float(d.max()):.2e} within 1e-4 + 1e-4·|plain|: {ok} {tag}")

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
    ev = sample_eval_set(task, 32, max_words=6, seed=99)
    lrng = np.random.default_rng(1234)
    lls = [synth_loglikes(task, ev[u], lrng, noise=0.5) for u in sorted(ev)]
    lens = np.array([len(x) for x in lls], np.int64)
    T_pad = int(np.ceil(lens.max() / 32) * 32)
    X = np.zeros((len(lls), T_pad, task.num_pdfs), np.float32)
    for b, ll in enumerate(lls):
        X[b, :len(ll)] = ll
    Xd = torch.from_numpy(X).to(dev)
    nd = torch.from_numpy(lens).to(dev)
    for name, d in (("beta on", dec),
                    ("beta off", dec.with_overrides(device_beta_prune=False))):
        d._decode_batch(Xd, nd)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        d._decode_batch(Xd, nd)
        torch.cuda.synchronize()
        plain_wall = time.perf_counter() - t0
        def run():
            d._decode_batch(Xd, nd)
            torch.cuda.synchronize()

        wall, n_k, busy, prof = _profiled(run)
        print(f"decode {name}: T_pad {T_pad}; unprofiled wall "
              f"{plain_wall * 1e3:.1f} ms; profiled wall {wall:.1f} "
              f"ms, device kernel time {busy:.1f} ms "
              f"({100 * busy / wall:.1f}% busy), {n_k} "
              f"kernels = {n_k / T_pad:.1f} per frame {tag}")
        print(prof.key_averages().table(sort_by="device_time_total",
                                        row_limit=12,
                                        max_name_column_width=50))

    from kaldi_tpu_torch.decoder.online_beam import (MultiStreamBeamDecoder,
                                                     OnlineBeamDecoder)
    ob = OnlineBeamDecoder(dec, chunk_frames=6, max_frames=1024)
    ll = Xd[0, :int(lens[0])]

    def stream():
        ob.reset()
        for a in range(0, ll.shape[0], 6):
            ob.advance(ll[a:a + 6])
        torch.cuda.synchronize()

    stream()
    ob.finalize()                                               # warm
    for what, fn, frames in (("advances", stream, ll.shape[0]),
                             ("finalize", ob.finalize, ll.shape[0])):
        wall, n_k, busy, _ = _profiled(fn)
        print(f"stream {what} of one utterance ({frames} frames, chunks "
              f"of 6): profiled wall {wall:.1f} ms, device kernel time "
              f"{busy:.1f} ms ({100 * busy / wall:.1f}% busy), {n_k} "
              f"kernels = {n_k / frames:.1f} per frame {tag}")
    ms = MultiStreamBeamDecoder(dec, n_channels=8, chunk_frames=6,
                                max_frames=512)
    llm = [Xd[i, :60] for i in range(8)]

    def steps():
        for a in range(0, 60, 6):
            ms.advance([x[a:a + 6] for x in llm])
        torch.cuda.synchronize()

    ms.advance([x[:6] for x in llm])                             # warm
    for c in range(8):
        ms.reset_channel(c)
    wall, n_k, busy, _ = _profiled(steps)
    print(f"multistream 10 steps of 8 lanes × 6 frames: profiled wall "
          f"{wall:.1f} ms, device kernel time {busy:.1f} ms "
          f"({100 * busy / wall:.1f}% busy), {n_k} kernels = "
          f"{n_k / 60:.1f} per frame step {tag}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
