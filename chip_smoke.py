"""Smoke run of the PyTorch port's serving path on one CUDA card.

    python3 chip_smoke.py

Phases (each prints lines; any failure raises and exits non-zero):
  1. device: card name and power limit; TF32 off for matmuls and cuDNN;
  2. build: nvcc build of the fbank kernel (kaldi_tpu_torch/csrc/fbank.cu);
  3. kernel vs its plain PyTorch version on the card, 4096 frames;
  4. batched lattice decode of synthetic log-likelihoods on the 20k-word
     task at the headline operating point, checked against the port's
     own CPU decode, with the frame loop run under
     torch.cuda.set_sync_debug_mode("error");
  5. wav → fbank kernel → TDNN-F → lattice decode on 8 seeded waveforms,
     then the kernel against its plain version on each waveform's frames
     and the TDNN-F on the card against its CPU forward.
The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.  There is no CPU fallback: without a
CUDA device the script exits non-zero before printing any result.
"""

import json
import math
import os
import sys
import time

import numpy as np
import torch

SEED = 20261016
SAMP_FREQ = 16000
OUT_SCALE = 0.04


def random_tdnn_state(model, rng: np.random.Generator):
    """Seeded weights: N(0, 1/fan_in) dense kernels, small biases,
    batch-norm statistics near (0, 1), so activations keep their scale
    through the 13 layers; the output layer is scaled by OUT_SCALE so
    that the chain outputs spread over a few units per frame (unscaled,
    one pdf wins every frame by ~100 and every lattice is one path)."""
    sd = {}
    for name, t in model.state_dict().items():
        shape = tuple(t.shape)
        if name.endswith(".weight"):
            a = rng.standard_normal(shape) / math.sqrt(shape[1])
            if name.startswith("output_affine"):
                a *= OUT_SCALE
        elif name.endswith(".bias"):
            a = 0.1 * rng.standard_normal(shape)
        elif name.endswith(".mean"):
            a = 0.1 * rng.standard_normal(shape)
        elif name.endswith(".var"):
            a = rng.uniform(0.5, 1.5, shape)
        else:
            raise ValueError(name)
        sd[name] = torch.from_numpy(a.astype(np.float32))
    return sd


def synth_waveforms(rng: np.random.Generator, n: int):
    """n waveforms of 3–6 s at 16 kHz: a few voiced-like harmonic
    segments over noise, at int16 amplitude."""
    waves = []
    for _ in range(n):
        T = int(rng.uniform(3.0, 6.0) * SAMP_FREQ)
        t = np.arange(T) / SAMP_FREQ
        x = 300.0 * rng.standard_normal(T)
        for seg in np.array_split(np.arange(T), int(rng.integers(4, 9))):
            f0 = rng.uniform(90.0, 250.0)
            amp = rng.uniform(500.0, 4000.0)
            for h in range(1, 6):
                x[seg] += amp / h * np.sin(2 * np.pi * h * f0 * t[seg])
        waves.append(np.clip(x, -32768, 32767).astype(np.float32))
    return waves


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from kaldi_tpu_torch.am.tdnn import TdnnChain, TdnnConfig
    from kaldi_tpu_torch.decoder.beam import (BeamDecoder, BeamDecoderConfig,
                                              host_lattice_backend)
    from kaldi_tpu_torch.features.compute import Fbank, FbankOptions
    from kaldi_tpu_torch.features.mel import MelBanksOptions
    from kaldi_tpu_torch.features.window import preprocess_frames
    from kaldi_tpu_torch.ops import build
    from kaldi_tpu_torch.ops.fbank import fbank_reference
    from kaldi_tpu_torch.pipelines.decode import (decode_scores,
                                                  decode_waveforms)
    from kaldi_tpu_torch.pipelines.largevocab import (make_largevocab_task,
                                                      sample_eval_set,
                                                      synth_loglikes)
    from kaldi_tpu_torch.pipelines.score import compute_wer
    from kaldi_tpu_torch.tools.timing import card_info, cuda_ms

    # 1. device
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    card = card_info()
    tag = f"[{card}]"
    print(f"device: {kind} | nvidia-smi: {card} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 2. build the fbank kernel
    t0 = time.perf_counter()
    build.load_library("kt_fbank", ["fbank.cu"])
    print(f"build: fbank.cu with nvcc in {time.perf_counter() - t0:.2f} s")
    for line in build.BUILD_LOG.get("kt_fbank", "").splitlines():
        if "registers" in line or "spill" in line:
            print(f"build: ptxas {line.strip()}")

    # 3. fbank kernel vs its plain version, 4096 frames
    fopts = FbankOptions(mel_opts=MelBanksOptions(num_bins=40))
    fbank = Fbank(fopts, device=dev)
    kern = fbank.kernel
    rng = np.random.default_rng(SEED)
    raw = torch.from_numpy((1000.0 * rng.standard_normal(
        (4096, fopts.frame_opts.window_size))).astype(np.float32)).to(dev)
    x, _ = preprocess_frames(raw, fopts.frame_opts)
    x = x.contiguous()

    def plain():
        return fbank_reference(x, kern.window, kern.cos, kern.sin, kern.mel)

    got = kern(x)
    want = plain()
    torch.cuda.synchronize()
    fb_err = float((got - want).abs().max())
    print(f"fbank: kernel vs plain on 4096 frames: max |diff| "
          f"{fb_err:.3e} log-mel (limit 2e-3)")
    if not fb_err <= 2e-3:
        raise AssertionError(f"fbank kernel disagrees: {fb_err}")
    times = {"plain": [], "kernel": []}
    for which in ("plain", "kernel", "kernel", "plain"):
        times[which].append(cuda_ms(plain if which == "plain"
                                    else lambda: kern(x), 50))
    fb_ms, fb_plain_ms = min(times["kernel"]), min(times["plain"])
    print(f"fbank: 4096 frames kernel {fb_ms:.4f} ms, plain "
          f"{fb_plain_ms:.4f} ms (best of 2 × 50 launches) {tag}")

    # 4. decode synthetic log-likelihoods on the 20k task
    t0 = time.perf_counter()
    task = make_largevocab_task(vocab_size=20000, order=3, seed=7,
                                closure=False)
    csr = task.graph.csr
    print(f"decode: 20k task {csr.num_states} states, "
          f"{csr.num_emitting_arcs}+{csr.num_eps_arcs} arcs, "
          f"{task.num_pdfs} pdfs (built in "
          f"{time.perf_counter() - t0:.1f} s)")
    print(f"decode: host lattice library: {host_lattice_backend()}")
    cfg = BeamDecoderConfig(beam=13.0, max_active=7000, acoustic_scale=1.0,
                            lattice_beam=7.0, arc_budget=4096,
                            token_capacity=2048, arc_block=8,
                            escalate_budget=16384, escalate_deficit=4.0,
                            lattice_arcs_per_frame=4096,
                            record_capacity=16384)
    t0 = time.perf_counter()
    dec = BeamDecoder(csr, task.tm.tid_to_pdf_array, cfg, device=dev)
    print(f"decode: graph packed and uploaded in "
          f"{time.perf_counter() - t0:.1f} s (K={dec.K}, M={dec.M}, "
          f"L={dec.L})")
    eval_set = sample_eval_set(task, 32, max_words=6, seed=99)
    utts = sorted(eval_set)
    lrng = np.random.default_rng(1234)
    lls = [synth_loglikes(task, eval_set[u], lrng, noise=0.5) for u in utts]
    lens = np.array([len(x) for x in lls], np.int64)
    T_pad = int(np.ceil(lens.max() / 32) * 32)
    X = np.zeros((len(lls), T_pad, task.num_pdfs), np.float32)
    for b, ll in enumerate(lls):
        X[b, :len(ll)] = ll
    audio_s = float(lens.sum()) * 0.03      # ×3-subsampled 30 ms frames

    X_dev = torch.from_numpy(X).to(dev)
    nf_dev = torch.from_numpy(lens).to(dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    out = dec._decode_batch(X_dev, nf_dev)
    torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    print(f"decode: frame loops ran under sync debug mode 'error' "
          f"(T_pad={T_pad}, beta={'on' if out['rec_reversed'] else 'off'}): "
          f"no host sync")

    dec.decode_compact_batch(X, lens)                       # warm
    torch.cuda.synchronize()
    dev_ms = cuda_ms(lambda: dec._decode_batch(X_dev, nf_dev), 3)
    stats = {}
    t0 = time.perf_counter()
    lats = dec.decode_compact_batch(X, lens, stats=stats)
    wall = time.perf_counter() - t0
    best = [lat.best_path() for lat in lats]
    hyps = {u: [task.words.find(o) for o in bp[0]]
            for u, bp in zip(utts, best)}
    wer = compute_wer(eval_set, hyps)
    print(f"decode: {wer}")
    print(f"decode: n_escalated {stats['n_escalated']} dropped_arcs "
          f"{stats['dropped_arcs']} min_eff_beam "
          f"{stats['min_eff_beam']:.3f} arcs_peak {stats['arcs_peak']} "
          f"heads_peak {stats['heads_peak']}")
    print(f"decode: 32 utts, {audio_s:.2f} audio-s: wall {wall:.3f} s = "
          f"{audio_s / wall:.1f} audio-s/s; device frame loops "
          f"{dev_ms:.1f} ms = {audio_s / (dev_ms / 1e3):.1f} audio-s/s {tag}")
    cpu_dec = BeamDecoder(csr, task.tm.tid_to_pdf_array, cfg, device="cpu")
    cpu_best = [lat.best_path()
                for lat in cpu_dec.decode_compact_batch(X[:4], lens[:4])]
    for b in range(4):
        if best[b][0] != cpu_best[b][0] or \
                abs(best[b][2] - cpu_best[b][2]) > 1e-3:
            raise AssertionError(f"utt {b}: GPU {best[b][0]} "
                                 f"{best[b][2]} vs CPU {cpu_best[b][0]} "
                                 f"{cpu_best[b][2]}")
    print("decode: GPU best paths equal the port's CPU decode on 4 utts "
          "(words equal, costs within 1e-3)")

    # 5. wav → fbank kernel → TDNN-F → lattice
    tcfg = TdnnConfig(feat_dim=40, num_pdfs=task.num_pdfs, hidden_dim=1024,
                      bottleneck_dim=128, num_layers=13,
                      frame_subsampling_factor=3)
    model = TdnnChain(tcfg)
    model.load_state_dict(random_tdnn_state(model,
                                            np.random.default_rng(SEED)))
    model.eval()
    model_cpu = TdnnChain(tcfg)
    model_cpu.load_state_dict(model.state_dict())
    model_cpu.eval()
    model.to(dev)
    waves = synth_waveforms(np.random.default_rng(SEED + 1), 8)
    wav_s = sum(len(w) for w in waves) / SAMP_FREQ

    decode_waveforms(waves[:2], fbank, model, dec, batch_size=8)   # warm
    torch.cuda.synchronize()
    kern.launches = 0
    t0 = time.perf_counter()
    wlats = decode_waveforms(waves, fbank, model, dec, batch_size=8)
    torch.cuda.synchronize()
    w_wall = time.perf_counter() - t0
    fbank_launches = kern.launches
    if fbank_launches <= 0:
        raise AssertionError("wav path did not launch the fbank kernel")
    wbest = [lat.best_path() for lat in wlats]
    if len(wbest) != len(waves) or \
            not all(math.isfinite(bp[2]) for bp in wbest):
        raise AssertionError(f"non-finite best path: {[b[2] for b in wbest]}")
    print(f"wav: {len(waves)} waveforms, {wav_s:.2f} s audio -> "
          f"{len(wlats)} determinized lattices, best costs "
          f"{[round(b[2], 2) for b in wbest]}, words/utt "
          f"{[len(b[0]) for b in wbest]}; fbank launches {fbank_launches}")
    print(f"wav: end to end {w_wall:.3f} s = {wav_s / w_wall:.1f} "
          f"audio-s/s {tag}")

    # the kernel against its plain version at the main path's shapes:
    # every waveform's frames, most of them ending in a partial tile
    # (launches here are not counted)
    wav_err, wav_frames = 0.0, []
    for w in waves:
        x, _ = preprocess_frames(torch.from_numpy(fbank.frames(w)).to(dev),
                                 fopts.frame_opts)
        x = x.contiguous()
        d = (kern(x) - fbank_reference(x, kern.window, kern.cos, kern.sin,
                                       kern.mel)).abs().max()
        wav_err = max(wav_err, float(d))
        wav_frames.append(x.shape[0])
    print(f"fbank: kernel vs plain on each waveform's frames "
          f"({wav_frames}): max |diff| "
          f"{wav_err:.3e} log-mel (limit 2e-3)")
    if not wav_err <= 2e-3:
        raise AssertionError(f"fbank kernel disagrees on the wav path: "
                             f"{wav_err}")

    # stage breakdown (launches here are not counted)
    with torch.no_grad():
        t0 = time.perf_counter()
        feats = [fbank.compute(w) for w in waves]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        scores = [model(f[None])[0] for f in feats]
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    decode_scores(scores, dec, 8)
    t3 = time.perf_counter()
    print(f"wav: stages fbank {t1 - t0:.3f} s, tdnn {t2 - t1:.3f} s, "
          f"decode+lattice {t3 - t2:.3f} s {tag}")

    with torch.no_grad():
        ref = model_cpu(feats[0].cpu()[None])[0]
    rel = float((scores[0].cpu() - ref).abs().max() / ref.abs().max())
    print(f"wav: TDNN-F on the card vs CPU float32 forward: max |diff| / "
          f"max |cpu| = {rel:.3e} (limit 1e-3); output "
          f"{tuple(scores[0].shape)}, std {float(scores[0].std()):.3f}")
    if not rel <= 1e-3:
        raise AssertionError(f"TDNN output disagrees: {rel}")

    print(json.dumps({"kernels": [{
        "name": "fbank_logmel", "route": "cuda",
        "source": "kaldi_tpu_torch/csrc/fbank.cu",
        "replaces": "kaldi_tpu/ops/pallas_frontend.py:53",
        "launches": fbank_launches,
        "max_abs_err": max(fb_err, wav_err),
        "ms": fb_ms, "plain_ms": fb_plain_ms}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
