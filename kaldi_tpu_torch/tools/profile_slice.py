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
5. Chain training (chip_smoke phase 8's den graph and TDNN-F, NG-SGD)
   at B = 32 float32 and B = 128 bfloat16 on egs of 150 seeded random
   frames: one step split by synchronizes into its parts (forward,
   numerator, denominator kernels, the whole loss, backward, optimizer)
   on a step that advances the NG-SGD estimates and on one that does
   not, then 4 steps under torch.profiler (kernels a step, busy share,
   the den kernels' device time) and the den kernels alone
   (``den_kernels``): at B = 32, 64 and 128 with the score prefetch the
   wrapper picks, forward and backward apart and together; then at B =
   128, T = 50 with and without the prefetch, each held against the
   plain version.  ``--den`` runs only these den lines.
6. The feature frontend (``features``): the batched frontend on 32
   seeded waveforms of 10 s (MFCC + CMN + Δ+ΔΔ, one fbank launch a
   batch): its time on the card a batch, and under torch.profiler its
   kernels a batch and the card's busy share; Plp on one 5 s utterance,
   split into the fbank kernel, Durbin + the cepstrum recursion and the
   rest (times on the card, and the launches of each part); the
   identity-filter fbank (the spectrogram's) at 4096 frames beside one
   ``torch.fft.rfft`` of the same windowed frames, as information for an
   FFT-form fbank (the rfft is not the kernel's function: no power, no
   log).  ``--features`` runs only this section.
7. GMM training at the tri3b width (``gmm_training``; chip_smoke phase
   10c's steps): ``accumulate_stats`` over 32,768 frames drawn from a
   seeded tri3b model (2500 pdfs, 15,000 Gaussians, D = 40), on the card
   alone and per call, and under torch.profiler (kernels, busy share);
   then the forced aligner over 32 sentences of the 300-word task: a
   batch's time per call, and under torch.profiler its kernels a frame
   and the card's busy share, for the frame loop with the backtrace.
   ``--gmm-train`` runs only this section.
8. The den's plain recursion (``am/chain.py`` ``denominator_reference``,
   forward and autograd backward: thousands of launches a call) at
   chip_smoke 8a's bench graph, B = 128, T = 50, timed three ways
   (``den_plain_methods``): CUDA events around 10 calls queued behind a
   spin kernel without ``device_ms``'s check (its former reading, which
   times the host's gaps once the launch queue is full), ``graph_ms``
   (one call captured into a CUDA graph, launched once) and ``kernel_ms``
   (CUPTI's kernel durations, summed, over 10 calls); then the den
   kernels (two launches a call) by ``device_ms``, ``graph_ms`` and
   ``kernel_ms``, where all three should agree.  ``--den-plain`` runs
   only this section.
9. The GMM kernel's precision (``gmm_precision``) at the tri3b width
   (2500 pdfs, 15,000 Gaussians, D = 40) on 4096 seeded frames, once of
   unit scale and once scaled ×4 and shifted by 2 (larger terms, as
   fMLLR features give): the kernel's and the plain float32 version's
   max |diff| from float64 of the same function on the same float32
   tables, and the kernel's time on the card.  ``--gmm`` runs only this
   section; run as a file with another checkout first on PYTHONPATH
   (``PYTHONPATH=build/prev python kaldi_tpu_torch/tools/profile_slice.py
   --gmm``), it measures that checkout's kernel.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from kaldi_tpu_torch.tools.timing import profiled


def _best(fn_plain, fn_kernel, timer, iters):
    """(kernel ms, plain ms): plain, kernel, kernel, plain; best of each."""
    t = {"plain": [], "kernel": []}
    for which in ("plain", "kernel", "kernel", "plain"):
        t[which].append(timer(fn_plain if which == "plain" else fn_kernel,
                              iters))
    return min(t["kernel"]), min(t["plain"])


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
    if "--den" in sys.argv[1:]:
        _, tree, den, _ = _bench_den()
        den_kernels(dev, tag, den, tree.num_pdfs)
        return 0
    if "--features" in sys.argv[1:]:
        features(dev, tag)
        return 0
    if "--gmm-train" in sys.argv[1:]:
        gmm_training(dev, tag)
        return 0
    if "--den-plain" in sys.argv[1:]:
        _, tree, den, _ = _bench_den()
        den_plain_methods(dev, tag, den, tree.num_pdfs)
        return 0
    if "--gmm" in sys.argv[1:]:
        gmm_precision(dev, tag)
        return 0

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

        wall, n_k, busy, prof = profiled(run)
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
        wall, n_k, busy, _ = profiled(fn)
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
    wall, n_k, busy, _ = profiled(steps)
    print(f"multistream 10 steps of 8 lanes × 6 frames: profiled wall "
          f"{wall:.1f} ms, device kernel time {busy:.1f} ms "
          f"({100 * busy / wall:.1f}% busy), {n_k} kernels = "
          f"{n_k / 60:.1f} per frame step {tag}")
    chain_training(dev, tag)
    features(dev, tag)
    return 0


def _waves(rng, n: int, seconds: float) -> np.ndarray:
    """(n, seconds · 16 kHz) float32: harmonic segments over noise, at
    int16 amplitude."""
    L = int(seconds * 16000)
    t = np.arange(L) / 16000.0
    out = 300.0 * rng.standard_normal((n, L))
    for b in range(n):
        for seg in np.array_split(np.arange(L), int(rng.integers(4, 9))):
            f0, amp = rng.uniform(90.0, 250.0), rng.uniform(500.0, 4000.0)
            for h in range(1, 6):
                out[b, seg] += amp / h * np.sin(2 * np.pi * h * f0 * t[seg])
    return out.astype(np.float32)


def features(dev, tag: str) -> None:
    """Section 6 (see the module's docstring)."""
    from kaldi_tpu_torch.features import (BatchedFrontend,
                                          DeltaFeaturesOptions,
                                          FrameExtractionOptions, MfccOptions,
                                          Plp, Spectrogram)
    from kaldi_tpu_torch.features.compute import _durbin, _lpc_to_cepstrum
    from kaldi_tpu_torch.features.window import preprocess_frames
    from kaldi_tpu_torch.tools.timing import cuda_ms, device_ms

    rng = np.random.default_rng(6)
    W = torch.from_numpy(_waves(rng, 32, 10.0)).to(dev)
    fe = BatchedFrontend(MfccOptions(frame_opts=FrameExtractionOptions(
        dither=0.0)), "mfcc", DeltaFeaturesOptions(), cmn=True, device=dev)
    fe(W)
    torch.cuda.synchronize()
    frames = 32 * fe.num_frames(W.shape[1])
    ms = device_ms(lambda: fe(W), 5)

    def batch():
        fe(W)
        torch.cuda.synchronize()

    wall, n_k, busy, _ = profiled(batch)
    print(f"features batched frontend, 32 × 10 s ({frames} frames), MFCC + "
          f"CMN + Δ+ΔΔ: {ms:.4f} ms a batch on the card "
          f"({frames / ms * 1e3:.0f} frames/s); profiled wall {wall:.2f} ms, "
          f"device kernel time {busy:.2f} ms ({100 * busy / wall:.1f}% "
          f"busy), {n_k} kernels a batch {tag}")

    plp = Plp(device=dev)
    wave = _waves(rng, 1, 5.0)[0]
    fr = torch.from_numpy(plp.frames(wave)).to(dev)
    x, le = preprocess_frames(fr, plp.frame_opts)
    x = x.contiguous()
    mel_e = plp.kernel(x)
    o = plp.opts
    dup = (mel_e * plp.equal_loudness[None, :]) ** o.compress_factor
    ac = torch.cat([dup[:, :1], dup, dup[:, -1:]], dim=1) @ plp.idft

    def recursion():
        lpc, _ = _durbin(ac, o.lpc_order)
        return _lpc_to_cepstrum(lpc, o.lpc_order, o.num_ceps)

    parts = {"whole compute_frames": lambda: plp.compute_frames(fr),
             "fbank kernel": lambda: plp.kernel(x),
             "Durbin + cepstrum": recursion}
    line, on_card = [], {}
    for name, fn in parts.items():
        fn()
        torch.cuda.synchronize()
        # 2 calls: up to ~500 launches queue behind the spin; more would
        # fill the launch queue and time the host's issue instead
        on_card[name], hms = device_ms(fn, 2), cuda_ms(fn, 10)
        _, n_k, k_ms, _ = profiled(lambda: (fn(), torch.cuda.synchronize()))
        line.append(f"{name} {on_card[name]:.4f} ms on the card, {hms:.4f} "
                    f"ms per call, {n_k} kernels profiled ({k_ms:.4f} ms of "
                    f"kernel time)")
    rest = on_card["whole compute_frames"] - on_card["fbank kernel"] \
        - on_card["Durbin + cepstrum"]
    print(f"features Plp, one 5 s utterance ({x.shape[0]} frames): "
          f"{'; '.join(line)}; the rest (pre-processing, loudness, IDFT, "
          f"lifter) {rest:.4f} ms on the card {tag}")

    spec = Spectrogram(device=dev)
    k = spec.kernel
    raw = torch.from_numpy((1000.0 * rng.standard_normal(
        (4096, k.win_size))).astype(np.float32)).to(dev)
    x = preprocess_frames(raw, spec.frame_opts)[0].contiguous()
    pad = spec.frame_opts.padded_window_size - k.win_size
    xw = torch.nn.functional.pad(x * k.window, (0, pad))
    kms, fft_ms = _best(lambda: torch.fft.rfft(xw), lambda: k(x), device_ms,
                        50)
    print(f"features identity-filter fbank (257 outputs), 4096 frames: "
          f"kernel {kms:.4f} ms on the card; torch.fft.rfft of the same "
          f"windowed frames (no power, no log) {fft_ms:.4f} ms {tag}")


def gmm_training(dev, tag: str) -> None:
    """Section 7 (see the module's docstring)."""
    from kaldi_tpu_torch.am.gmm import accumulate_stats_device
    from kaldi_tpu_torch.decoder.align import DenseAligner
    from kaldi_tpu_torch.pipelines.largevocab import make_largevocab_task
    from kaldi_tpu_torch.tools.synth import (align_workload, model_frames,
                                             tri3b_gmm)
    from kaldi_tpu_torch.tools.timing import cuda_ms, device_ms

    rng = np.random.default_rng(10)
    am = tri3b_gmm(rng, 2500, 15000, device=dev)
    T = 32768
    feats, pdfs = model_frames(am, rng, T)
    x = torch.from_numpy(feats).to(dev)
    p = torch.from_numpy(pdfs).to(dev)
    am.device_params()

    def acc():
        accumulate_stats_device(am, x, p)
        torch.cuda.synchronize()

    ms = device_ms(lambda: accumulate_stats_device(am, x, p), 5)
    call = cuda_ms(lambda: accumulate_stats_device(am, x, p), 5)
    wall, n_k, busy, _ = profiled(acc)
    print(f"gmm-train accumulate_stats, tri3b width ({am.num_pdfs} pdfs, "
          f"{am.num_gauss()} Gaussians, D={am.dim}), {T} frames: "
          f"{ms:.4f} ms on the card, {call:.4f} ms per call "
          f"({T / ms * 1e3:.0f} frames/s on the card); profiled wall "
          f"{wall:.2f} ms, {n_k} kernels, device time {busy:.3f} ms "
          f"({100 * busy / wall:.1f}% busy) {tag}")

    task = make_largevocab_task(vocab_size=300, order=3, seed=7,
                                closure=False, corpus_sentences=600)
    graphs, lls, tm = align_workload(task, 32, 11)
    al = DenseAligner(tm.tid_to_pdf_array, device=dev)
    batch = al.prepare(graphs, lls)
    T_max = batch["loglikes"].shape[1]
    frames = sum(len(ll) for ll in lls)

    def align():
        al.align_device(batch)
        torch.cuda.synchronize()

    align()
    call = cuda_ms(lambda: al.align_device(batch), 3)
    wall, n_k, busy, prof = profiled(align)
    print(f"gmm-train DenseAligner, 32 utterances ({frames} frames, T_max "
          f"{T_max}, {batch['e_src'].shape[1]} padded states, ε depth "
          f"{batch['eps_depth']}): {call:.1f} ms a batch per call "
          f"({frames / call * 1e3:.0f} frames/s); profiled wall "
          f"{wall:.1f} ms, {n_k} kernels = {n_k / T_max:.1f} a frame, "
          f"device time {busy:.2f} ms ({100 * busy / wall:.1f}% busy) {tag}")
    top = prof.key_averages().table(sort_by="device_time_total", row_limit=6)
    print("gmm-train aligner top kernels:\n" + top)


def chain_training(dev, tag: str) -> None:
    """Section 5 (see the module's docstring)."""
    from kaldi_tpu_torch.am.chain import (ChainTrainingOptions, den_kernel,
                                          denominator_logprob,
                                          numerator_flexible_logprob)
    from kaldi_tpu_torch.am.tdnn import TdnnConfig
    from kaldi_tpu_torch.pipelines.chain import (ChainTrainConfig,
                                                 ChainTrainer, make_chain_egs)
    topo, tree, den, rng = _bench_den()
    feats, runs = {}, {}
    for u in range(48):
        n = int(rng.integers(300, 600))
        feats[f"u{u}"] = rng.standard_normal((n, 40)).astype(np.float32)
        runs[f"u{u}"] = [(int(p), 5) for p in rng.integers(1, 42, n // 5 + 1)]
        runs[f"u{u}"] = [r for i, r in enumerate(runs[f"u{u}"])
                         if i == 0 or r[0] != runs[f"u{u}"][i - 1][0]]
    egs = make_chain_egs(feats, runs, tree, topo, chunk_size=150,
                         subsample=3, den=den)
    opts = ChainTrainingOptions()

    def sync():
        torch.cuda.synchronize()
        return time.perf_counter()

    for B, dtype in ((32, "float32"), (128, "bfloat16")):
        cfg = TdnnConfig(feat_dim=40, num_pdfs=tree.num_pdfs,
                         hidden_dim=1024, bottleneck_dim=128, num_layers=13,
                         compute_dtype=dtype)
        tr = ChainTrainer(cfg, den, ChainTrainConfig(
            batch_size=B, optimizer="ngsgd", total_steps=0), device=dev)
        batch = tr.batches(egs, np.arange(B) % egs.feats.shape[0])
        for _ in range(3):
            tr._step(*batch)
        for advance in (True, False):
            while (tr.opt.count < 10
                   or tr.opt.count % tr.opt.update_period == 0) != advance:
                tr._step(*batch)
            f, a, m, ng, _ = batch
            f, m = tr._as_tensor(f, torch.float32), tr._as_tensor(m,
                                                                 torch.bool)
            ng = tuple(tr._as_tensor(x) for x in ng)
            a = tr._as_tensor(a, torch.int64)
            tr.model.train()
            t0 = sync()
            scores = tr.model(f)
            t1 = sync()
            numerator_flexible_logprob(scores, *ng[:3], m, *ng[3:])
            t2 = sync()
            denominator_logprob(den, scores, m, opts.leaky_hmm_coefficient)
            t3 = sync()
            loss, _ = tr._loss_fn(f, a, m, ng)
            t4 = sync()
            tr.opt.zero_grad(set_to_none=True)
            loss.backward()
            t5 = sync()
            tr.opt.step()
            t6 = sync()
            print(f"train B={B} {dtype}, a step that "
                  f"{'advances' if advance else 'does not advance'} the "
                  f"NG-SGD estimates: forward {1e3 * (t1 - t0):.1f} ms, "
                  f"numerator {1e3 * (t2 - t1):.1f}, den kernel "
                  f"{1e3 * (t3 - t2):.1f}, whole loss {1e3 * (t4 - t3):.1f}, "
                  f"backward {1e3 * (t5 - t4):.1f}, optimizer "
                  f"{1e3 * (t6 - t5):.1f} (host clock around synchronizes) "
                  f"{tag}")
        k = den_kernel(den, dev)

        def steps():
            for _ in range(4):
                tr._step(*batch)
            torch.cuda.synchronize()

        n0 = k.launches
        wall, n_k, busy, prof = profiled(steps)
        den_dev = sum(e.device_time for e in prof.events()
                      if e.device_type.name == "CUDA"
                      and ("den_forward" in e.name
                           or "den_backward" in e.name)) / 1e3
        print(f"train B={B} {dtype}: 4 steps profiled: wall {wall:.1f} ms, "
              f"device kernel time {busy:.1f} ms ({100 * busy / wall:.1f}% "
              f"busy), {n_k} kernels = {n_k / 4:.0f} a step; den kernels "
              f"{k.launches - n0} launches, {den_dev:.1f} ms of device time "
              f"{tag}")
        print(prof.key_averages().table(sort_by="device_time_total",
                                        row_limit=10,
                                        max_name_column_width=50))
        del tr
    den_kernels(dev, tag, den, tree.num_pdfs)


def _bench_den():
    """chip_smoke's den graph: 41 phones, monophone tree, trigram phone
    LM from 200 seeded 20-phone sequences → (topo, tree, den, the
    generator that drew them)."""
    from kaldi_tpu_torch.am.chain import make_denominator_graph
    from kaldi_tpu_torch.am.topology import HmmTopology
    from kaldi_tpu_torch.am.tree import MonophoneContextDependency
    phones = list(range(1, 42))
    topo = HmmTopology.chain(phones)
    tree = MonophoneContextDependency(phones, topo)
    rng = np.random.default_rng(0)
    seqs = [[int(p) for p in rng.integers(1, 42, 20)] for _ in range(200)]
    return topo, tree, make_denominator_graph(seqs, tree, topo,
                                              order=3), rng


def den_kernels(dev, tag: str, den, P: int, T: int = 50) -> None:
    """The den kernels alone (see the module's docstring)."""
    from kaldi_tpu_torch.am.chain import den_kernel, denominator_reference
    from kaldi_tpu_torch.ops.chain_den import ChainDenFn, DenPlan
    from kaldi_tpu_torch.tools.timing import device_ms
    k = den_kernel(den, dev)
    rng = np.random.default_rng(2)
    leak = 0.1

    def inputs(B):
        s = torch.from_numpy((2.0 * rng.standard_normal((B, T, P)))
                             .astype(np.float32)).to(dev)
        m = torch.ones((B, T), dtype=torch.uint8, device=dev)
        return s, m

    def times(s, m, plan):
        logz, saved = k._forward(s, m, leak, plan)
        gout = torch.ones_like(logz)
        fwd = device_ms(lambda: k._forward(s, m, leak, plan), 10)
        bwd = device_ms(lambda: k._backward(s, m, saved, gout, leak, plan),
                        10)

        def both():
            x = s.detach().requires_grad_(True)
            ChainDenFn.apply(x, m, k, leak, plan).sum().backward()
        return fwd, bwd, device_ms(both, 10)

    for B in (32, 64, 128):
        s, m = inputs(B)
        plan = k.plan(P)
        fwd, bwd, both = times(s, m, plan)
        print(f"den kernels at B={B}, T={T}: {plan}: forward {fwd:.4f} ms, "
              f"backward {bwd:.4f} ms, forward + backward {both:.4f} ms on "
              f"the card {tag}")
    B = 128
    s, m = inputs(B)
    x = s.detach().requires_grad_(True)
    zr = denominator_reference(den, x, m.bool(), leak)
    zr.sum().backward()
    gr = x.grad
    for pref in (True, False):
        if k.plan(P) != DenPlan(True, True) and pref:
            continue
        plan = DenPlan(pref, pref)
        x = s.detach().requires_grad_(True)
        z = ChainDenFn.apply(x, m, k, leak, plan)
        z.sum().backward()
        dz = float((z.detach() - zr.detach()).abs().max())
        dg = float((x.grad - gr).abs().max())
        fwd, bwd, both = times(s, m, plan)
        print(f"den prefetch={pref} at B={B}, T={T}: forward {fwd:.4f} ms, "
              f"backward {bwd:.4f} ms, both {both:.4f} ms; vs plain max "
              f"|d log Z| {dz:.2e}, max |d grad| {dg:.2e} {tag}")


def _spin_events_ms(fn, iters: int) -> float:
    """``device_ms`` without its check: events around ``iters`` calls
    queued behind a spin sized to the host's issue time, whether or not
    the host could queue them all before the spin ended."""
    from kaldi_tpu_torch.tools.timing import _SLEEP_HZ
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    issue = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(2.0 * issue * iters + 1e-3, 2.0) * _SLEEP_HZ))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def den_plain_methods(dev, tag: str, den, P: int, T: int = 50,
                      B: int = 128) -> None:
    """Section 8 (see the module's docstring)."""
    from kaldi_tpu_torch.am.chain import (den_kernel, denominator_logprob,
                                          denominator_reference)
    from kaldi_tpu_torch.tools.timing import (LaunchQueueOverflow,
                                              device_ms, graph_ms, kernel_ms)
    rng = np.random.default_rng(3)
    scores = torch.from_numpy((2.0 * rng.standard_normal((B, T, P)))
                              .astype(np.float32)).to(dev)
    mask = torch.ones((B, T), dtype=torch.bool, device=dev)
    den_kernel(den, dev)

    def run(fn):
        s = scores.detach().clone().requires_grad_(True)
        fn(den, s, mask, 0.1).sum().backward()

    for name, fn in (("plain recursion", denominator_reference),
                     ("kernels", denominator_logprob)):
        call = (lambda fn=fn: run(fn))
        _, n_k, _, _ = profiled(lambda: (call(), torch.cuda.synchronize()))
        got = {"events behind a spin": _spin_events_ms(call, 10),
               "graph_ms": min(graph_ms(call) for _ in range(3)),
               "kernel_ms": kernel_ms(call, 10)}
        try:
            got["device_ms"] = device_ms(call, 10)
        except LaunchQueueOverflow:
            got["device_ms"] = "raises LaunchQueueOverflow"
        print(f"den {name} at B={B}, T={T}, forward + backward "
              f"({n_k} kernels a call): "
              + ", ".join(f"{k} {v:.4f} ms" if isinstance(v, float)
                          else f"{k} {v}" for k, v in got.items())
              + f" {tag}")



def gmm_precision(dev, tag: str, T: int = 4096) -> None:
    """Section 9: the GMM kernel's and the plain version's error from
    float64 at the tri3b width, and the kernel's time."""
    import kaldi_tpu_torch
    from kaldi_tpu_torch.ops.gmm import gmm_loglikes_reference
    from kaldi_tpu_torch.tools.synth import tri3b_gmm
    from kaldi_tpu_torch.tools.timing import device_ms
    gk = tri3b_gmm(np.random.default_rng(2), device=dev).device_params()
    d64 = {n: getattr(gk, n).double() for n in ("gconst", "mean_invvar",
                                                "inv_var")}
    rng = np.random.default_rng(5)
    base = rng.standard_normal((T, 40)).astype(np.float32)
    for name, x in (("unit", base), ("x4+2", 4.0 * base + 2.0)):
        x = torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(dev)
        exact = gmm_loglikes_reference(x.double(), **d64)
        err = float((gk(x).double() - exact).abs().max())
        plain = float((gk.reference(x).double() - exact).abs().max())
        ms = min(device_ms(lambda: gk(x), 20) for _ in range(2))
        print(f"gmm precision ({kaldi_tpu_torch.__file__}): {T} frames, "
              f"features {name} (|ll| up to {float(exact.abs().max()):.1f})"
              f": max |diff| from float64: kernel {err:.3e}, plain float32 "
              f"{plain:.3e} (kernel / plain {err / max(plain, 1e-30):.2f}); "
              f"kernel {ms:.4f} ms on the card (best of 2 × 20) {tag}")


if __name__ == "__main__":
    sys.exit(main())
