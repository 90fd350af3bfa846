"""Smoke run of the PyTorch port's serving and training paths on one
CUDA card.

    python3 chip_smoke.py

Phases (each prints lines; any failure raises and exits non-zero):
  1. device: card name and power limit; TF32 off for matmuls and cuDNN
     (the plain versions run in full float32);
  2. build: nvcc builds of every kernel (kaldi_tpu_torch/csrc/*.cu), all
     started together;
  3. the fbank kernel (3xTF32 on the tensor cores) vs its plain PyTorch
     version on the card, 4096 frames, at the TDNN-F's 40 bins and at
     the MFCC configurations (16 kHz with 23 bins, 8 kHz with 15 bins),
     with both times on the card alone and the kernel's bound; then at
     40 bins at each of Fbank's use_power x use_log_fbank settings; then
     the wide banks (16 kHz with 15 and 17 bins, whose top filters pass
     one group and are cut into pieces summed by kt_fbank_sum_pieces),
     timed, and Fbank (17 bins) and Mfcc (15 bins) on 4 seeded
     waveforms: the wide-bank path;
  4. batched lattice decode of synthetic log-likelihoods on the 20k-word
     task at the headline operating point, checked against the port's
     own CPU decode, with the frame loop run under
     torch.cuda.set_sync_debug_mode("error");
  5. wav → fbank kernel → TDNN-F → lattice decode on 8 seeded waveforms,
     then the kernel against its plain version on each waveform's frames
     and the TDNN-F on the card against its CPU forward;
  6. the GMM decode path (gmm-latgen-faster):
     a. the GMM kernel (3xTF32 on the tensor cores) vs its plain
        version at the mini_librispeech tri3b width (2500 pdfs, 15,000
        Gaussians, D = 40) at 300, 1000 and 4096 frames, with both times
        and the kernel's bound;
     b. wav → MFCC → CMVN → Δ+ΔΔ → GMM kernel → the latgen BeamDecoder
        branch on the 20k-word task (above the dense limit), 4
        waveforms, checked against the port's CPU decode on 2;
     c. wav → MFCC → CMVN → splice ±3 → LDA+MLLT → GMM kernel → the
        latgen DenseDecoder branch on a 300-word task: one-best batch
        of 8 (frame loop under sync debug mode "error") and lattices
        of 4, checked against the port's CPU decode.
     The waveforms of b and c are seeded sentences of each task
     rendered as speech-like audio, and the GMMs are drawn around the
     features of each pdf's frames (kaldi_tpu_torch/tools/synth.py), so
     the WER of the path is a check too;
  7. the streaming decode path (online2-wav-nnet3-latgen-faster):
     a. OnlineBeamDecoder on phase 4's task and decoder: 12 of its
        utterances in chunks of 6 frames (180 ms of audio), every
        advance under sync debug mode "error"; advance p50/p99 (host
        ms), first partial, finalize p50/p99 and the slowest finalize's
        parts; each final best path equals phase 4's offline lattice,
        and on 2 streams the card equals the port's CPU decoder;
     b. MultiStreamBeamDecoder: lane throughput of 8 lanes × 480
        frames, then 8 utterances through 4 lanes with staggered starts
        and resets, each final lattice equal to the offline one;
     c. phase 5's waveforms in 0.18 s chunks through
        OnlineFeaturePipeline (the 40-bin fbank kernel, dither 0) →
        OnlineNnetScorer (36 frames of context: the model's receptive
        field is ±34) → OnlineBeamDecoder: streamed scores equal the
        offline forward on the same features (relative 1e-4), words
        equal the offline path's with the same computer, and the kernel
        holds against its plain version on the chunks' frames;
     d. `python -m kaldi_tpu_torch.cli.online2 --device=cuda` on 2 of
        phase 6c's waveforms, with the 300-word task's .mdl and HCLG.fst
        and a 13-layer raw nnet3 TDNN-F (13 MFCC inputs, seeded), all
        written by the port: the dense SingleUtteranceDecoder branch;
        its words equal the library path's on the same files;
  8. the chain training path (nnet3-chain-train), on the JAX bench's den
     graph (41 phones, trigram phone LM from 200 seeded 20-phone
     sequences: 1553 states) and TDNN-F (40 fbank inputs, 1024 wide,
     bottleneck 128, 13 layers, ×3; seeded weights):
     a. the den forward-backward kernels against their plain version at
        B = 128 sequences of 50 frames (150 input frames ×3
        subsampled), leak 0.1, a ragged mask: log Z, d log Z / d scores,
        posteriors summing to 1; both times on the card (the kernels
        queued behind a spin, ``device_ms``; the plain recursion, whose
        thousands of launches a call overflow the launch queue, as one
        CUDA graph launch, ``graph_ms``) and the bound;
        the kernels' launches under sync debug mode "error"; every other
        layout that fits (sequences a block G = 1/2/4/8, with and
        without the score prefetch); then
        the same on the left-biphone den graph (1722 states, 41 of
        them utterance-initial, 3444 pdfs), the largest P the kernels
        take here;
     b. 48 seeded waveforms → the fbank kernel → seeded phone
        alignments → egs of 150 frames with the den's normalization
        weights → ChainTrainer with NG-SGD at B = 32 in float32 and
        B = 32 / 64 / 128 in bfloat16: Mframes/s per point under the JAX
        bench's keys (f32_B32_Mframes_s, ...), then one float32 step at
        B = 4 on the card equal to the port's CPU step;
     c. `python -m kaldi_tpu_torch.cli.chain` nnet3-chain-compute-prob,
        nnet3-chain-train (4 epochs) and compute-prob again on the card,
        on files the port writes: the objective is finite and better
        after training;
  9. the rest of the feature frontend:
     a. Spectrogram (the fbank kernel with 257 one-bin filters) and Plp
        (the kernel's linear mel energies → Levinson-Durbin → cepstra)
        on phase 5's waveforms: each kernel path against its plain
        version on the card and the whole computers against the port's
        CPU ones; the identity-filter kernel at 4096 frames, timed, with
        its bound;
     b. BatchedFrontend on 32 seeded waveforms of 10 s (31,936 frames),
        MFCC + CMN + Δ+ΔΔ and 40-bin fbank, under sync debug mode
        "error": one fbank launch a call; each utterance equal to the
        per-utterance computers on the card plus the same CMN and
        deltas; device ms a batch, frames/s, and the kernel alone at the
        batch's frames against its plain version;
     c. GmmDecodableProvider on b's batch at the mini_librispeech tri1
        width (2000 pdfs, 10,000 Gaussians, D = 39): one GMM launch a
        call, equal to the plain GMM on the card; the kernel timed there;
     d. `python -m kaldi_tpu_torch.cli` on 4 waveforms' wav ark:
        compute-mfcc-feats | compute-cmvn-stats | apply-cmvn |
        add-deltas, compute-plp-feats, compute-spectrogram-feats and
        compute-and-process-kaldi-pitch-feats, each output equal to the
        library call in the same run;
 10. GMM training and the GMM recipes:
     a. the yesno recipe (pipelines/yesno.py ``run`` at its defaults: 30
        train / 10 test utterances, 12 iterations, 120 Gaussians, beam
        16) on the card: MFCC through the fbank kernel, flat start,
        realignments (one GMM launch over all frames, the batched
        aligner), accumulation, MLE updates and mix-up, then the dense
        decode of the test and the train set, both WER 0.00; the loglike
        per frame of each iteration; the same recipe on the port's CPU:
        final loglike per frame within 0.05%, the same WER, at least 99%
        of frames with equal alignments at each realignment;
     b. the mini_librispeech ladder (pipelines/mini.py ``run``: mono 14
        iterations; tri1, tri2b LDA+MLLT, tri3b SAT with the two-pass
        fMLLR decode) on the card, on the hard corpus of the GMM stages
        of pipelines/ladder.py (100 / 30 utterances, 30 leaves / 600
        Gaussians): each stage's WER and wall; it fails unless mono's
        WER is above 0 and tri3b's at most mono's;
     c. at the tri3b width (2500 pdfs, 15,000 Gaussians, D = 40):
        accumulate_stats over 32,768 seeded frames, the card against the
        port's CPU at rtol 1e-4, timed, then twice under sync debug mode
        "error", the two equal to the bit; mle_update and mixup to 18,000
        Gaussians; DenseAligner over 32 sentences of phase 6c's 300-word
        task, under sync debug mode "error", its tids equal to the CPU
        aligner's on the same log-likelihoods, timed, with its kernels a
        frame;
     d. ``python -m kaldi_tpu_torch.cli`` gmm-init-mono,
        compile-train-graphs, align-equal-compiled, gmm-acc-stats-ali,
        gmm-est --mix-up and gmm-align-compiled on a's train set (run in
        the background beside b and c), each output equal to the library
        call in the same run;
 11. the flagship LVCSR system, the hard corpus and the lattice tools:
     a. pipelines/flagship.py ``run`` on the card at HARDBENCH_r05's
        operating point (5000 words, 30,000 LM sentences, 400 train / 160
        test utterances, noise 0.10, warp 0.12; the TDNN of run, 10 chain
        epochs): MFCC through the fbank kernel, mono → tri → tri2b
        (LDA+MLLT) → tri3b (SAT) on the GMM kernel, the mono-GMM rung and
        the two-pass fMLLR tri3b rung on large-vocabulary graphs, the
        left-biphone chain tree, den graph and training on the den
        kernels, the chain rung, the chain + online i-vector rung (a
        64-Gaussian diag UBM, 3 EM iterations of a 16-dimensional
        extractor and online i-vectors, float64 on the card, then a second
        chain training on the i-vector-appended features and its decode),
        4-gram rescoring, the RNNLM rung (a GRU LM of E 96, H 192 over
        the 5k vocabulary trained on the card on 8000 LM sentences, 12
        epochs of B = 64 with a 512-candidate sampled softmax, then its
        scorer's GRU steps on the card inside the pruned lattice
        rescoring: steps, final nll, histories scored, ms a history,
        rescore audio-s/s beside HARDBENCH_r05's TPU v5e row) and MBR;
        every rung printed beside r5's WER,
        each WER at most 30 and each oracle WER at most its WER, each
        decode's time on the card at most its wall time; the graphs'
        state counts equal to host rebuilds;
        the three kernels against their plain versions at the run's
        shapes (the den's at B = 32, T = 17 on the run's den graph,
        timed); the chain model in float32 on the card against the CPU on
        16 test utterances (1e-4 + 1e-4·|cpu|) and their decodes' best
        paths (equal on at least 15), the card's decode profiled;
     c. ``python -m kaldi_tpu_torch.cli`` lattice-scale |
        lattice-add-penalty | lattice-lmrescore-pruned, lattice-best-path
        and lattice-oracle on a's chain lattices: 1-best and oracle equal
        to the same steps in process;
     d. the i-vector stages of a on the card against the CPU (float64
        both) on 40 training utterances' base features: the UBM, the
        extractor's EM and the online i-vectors of 8 test utterances
        within 1e-8 of the largest magnitude; online_ivectors against the
        streaming estimator fed period by period;
     e. (first) the device-time check: two small kernels with a 50 ms
        host sleep between them read at least 50 ms by CUDA events
        around the queued region, under 5 ms by tools/timing.py
        ``graph_ms`` (the region captured into a CUDA graph and launched
        once, as decode_eval's ``device_s`` times every batch) and
        ``device_ms`` (the work queued behind a spin kernel, as the
        kernels are timed);
     b. pipelines/hard.py ``run_point`` on the 20,000-word hard corpus
        (80 utterances, noise 1.0, peak 4.0, up to 16 words) at arc
        budgets 4096 and 12288 with escalation to 16384: WER, oracle,
        density, rates, dropped arcs, escalations; each oracle WER at most
        its WER, 4096 within 0.1 oracle WER of 12288, and each point's
        device_s at most its wall_s;
 12. i-vectors as the Kaldi recipes run them, on the card:
     a. ``python -m kaldi_tpu_torch.cli`` gmm-global-init-from-feats →
        gmm-global-acc-stats → gmm-global-est → ivector-extractor-init →
        two ivector-extractor-acc-stats jobs → ivector-extractor-sum-accs
        → ivector-extractor-est → ivector-extract-online2 on online2's
        MFCC of phase 5's waveforms (run in the background beside 11a),
        each output equal to the library in this process from the chain's
        previous output;
     b. phase 5's waveforms through ``python -m
        kaldi_tpu_torch.cli.online2 --ivector-extractor`` (a's
        extractor; 7d's 300-word task, a raw TDNN-F of the flagship's
        widths on 13 + 16 inputs) on the card, and the first 2 on the
        CPU (at the end of a's shell): the same words; the streamed
        i-vector-appended features equal the offline assembly.
     11c's and 13c's tools go in the background after 11a's rung, b's card
     run after 12a's check; 14c's with 11c's and 13c's.
 13. the flagship's RNNLM rung on the card (11a's run):
     a. at the rung's widths on seeded weights, the card against the
        port's CPU: the forward on one batch of 64 LM sentences, one
        full-softmax and one sampled-softmax Adam step (the same
        candidates) from the same weights (losses, gradients, weights
        after the step), and the scorer's log-probs on 40 sentences'
        prefixes;
     b. the training step's time, kernels and busy card time a step,
        and the scorer's time a new history (11a's trained model);
     c. (in the background from 11a's rung on) ``python -m
        kaldi_tpu_torch.cli`` rnnlm-get-sampling-lm → rnnlm-train (one
        epoch of 2000 LM sentences at the rung's widths) →
        rnnlm-compute-prob → lattice-lmrescore-kaldi-rnnlm-pruned on 8
        of 11a's chain lattices, equal to the library's rescoring with
        the tool's model on the card, and arpa-to-const-arpa →
        lattice-lmrescore-const-arpa on the 4-gram, equal to rescoring
        with the ARPA text.
 14. chain training on lattice and end-to-end supervision
     (am/chain_supervision.py) and the Kaldi chain recipes as tools:
     a. phase 8b's 48 utterances and phone alignments as alignment
        lattices of 3 paths (the alignment; every boundary moved by a
        seeded ±1–2 frames; one phone substituted), the bench den's
        normalization weights composed in, cut into chunks of 50
        subsampled frames: the FSA numerator (tolerance 1) at B = 128 on
        the card against the port's CPU (log-probs rtol 1e-5 / atol
        1e-5, d/d scores rtol 1e-4 / atol 1e-5), num ≤ den + 1e-3 on the
        whole-utterance FSAs on the card, the FSAs' arc and state counts,
        the forward + backward's time on the card (one call as a CUDA
        graph launch, graph_ms) and its launches a call;
     b. ChainTrainer with NG-SGD on a's egs at phase 8b's TDNN-F: 10 steps
        each at float32 B = 32 and bfloat16 B = 128, Mframes/s under
        lat_f32_B32_Mframes_s and lat_bf16_B128_Mframes_s beside 8b's, the
        kernels and busy card time a step (2 steps profiled), every
        objective finite, then one float32 step at B = 4 on the card
        equal to the port's CPU step (8b's rule);
     c. (in the background from 11a's rung until before 13a, with 11c
        and 13c; two threads a process) ``python -m
        kaldi_tpu_torch.pipelines.chain_cli_recipe`` at its defaults (40
        / 12 utterances, 8 mono iterations, 8 chain epochs, hidden 48;
        every stage a port tool, on the card where it computes): each
        stage's wall and the WER, exit 0 (WER < 20); on its work dir
        ali-to-phones → nnet3-chain-e2e-get-egs → nnet3-chain-compute-prob
        → nnet3-chain-train (free boundaries, 2 epochs) →
        compute-prob, finite and better after; chain-get-supervision's
        FSAs equal to supervision_from_phone_runs, the recipe's
        nnet3-chain-get-egs archive equal to make_chain_egs in process;
        beside them ``python -m kaldi_tpu_torch.pipelines.chain_recipe``
        at its defaults (50 utterances, 40 epochs, hidden 128), exit 0.
Before the last two lines, a line of its own is the card's name and
power limit as nvidia-smi reports them.  The line before the last is the
kernels' JSON record: launches on the paths (the den's include 14b's
training), the largest difference from
the plain versions, the times on the card (fbank and GMM at 4096
frames, the wide-bank fbank pair at 4096 frames of 17 bins, the den's
forward + backward at phase 8a's B = 128) and the
bound there: the larger of the bytes over 3.35 TB/s and the float32
operations over 165 TFLOP/s (the H100's 495 TFLOP/s of TF32 over the 3
products of 3xTF32, the least-time route that keeps float32 accuracy),
counted as
the function needs them (tools/timing.py): the fbank's as a real FFT
with frames and output moved once, which makes it bound by bytes, not
as the kernel's dense DFT product; the GMM's over its live Gaussians
only; the chain den's as its arc operations over the active frames, at
the 67 TFLOP/s of float32 outside the tensor cores (no matrix product
carries sparse arcs).  The last line is {"ok": true,
"device": {...}}.  The script imports nothing of JAX or of kaldi_tpu.
There is no CPU fallback: without a CUDA device the script exits
non-zero before printing any result.
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
# the GMM kernel's parity bar with its plain version (3xTF32 against
# float32, summed in different orders; log-likelihoods are O(100))
GMM_TOL = 1e-4
# the GMM path recognizes what its synthesized speech says (WER 0 in
# both branches, PERF.md); 10% leaves room for near-homophones of the
# 20k-word task, and a broken path is far above it
MAX_WER = 10.0
# phase 10d's gmm-est --mix-up target on the yesno train set
GMM_TOOLS_GAUSS = 60


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


def synth_waveforms(rng: np.random.Generator, n: int, seconds=(3.0, 6.0)):
    """n waveforms of ``seconds`` (a range; 3–6 s) at 16 kHz: a few
    voiced-like harmonic segments over noise, at int16 amplitude."""
    waves = []
    for _ in range(n):
        T = int(rng.uniform(*seconds) * SAMP_FREQ)
        t = np.arange(T) / SAMP_FREQ
        x = 300.0 * rng.standard_normal(T)
        for seg in np.array_split(np.arange(T), int(rng.integers(4, 9))):
            f0 = rng.uniform(90.0, 250.0)
            amp = rng.uniform(500.0, 4000.0)
            for h in range(1, 6):
                x[seg] += amp / h * np.sin(2 * np.pi * h * f0 * t[seg])
        waves.append(np.clip(x, -32768, 32767).astype(np.float32))
    return waves


def speech_set(task, n: int, seed: int):
    """n seeded sentences of ``task`` rendered as 16 kHz speech-like
    waveforms (tools/synth.py): (waveforms, frame-level pdf alignments,
    reference word lists)."""
    from kaldi_tpu_torch.pipelines.largevocab import (sample_eval_set,
                                                      synth_alignment)
    from kaldi_tpu_torch.tools.synth import pdf_signatures, synth_speech
    rng = np.random.default_rng(seed)
    freqs, amps = pdf_signatures(rng, task.num_pdfs,
                                 {task.fwd_pdf["SIL"], task.slf_pdf["SIL"]})
    sents = sample_eval_set(task, n, max_words=12, seed=seed)
    refs = [sents[u] for u in sorted(sents)]
    aligns = [synth_alignment(task, r, rng, frames_per_phone=(6, 13))
              for r in refs]
    return [synth_speech(a, freqs, amps, rng) for a in aligns], aligns, refs


def delta_feats(mfcc, wave):
    """The mono/tri1 features: MFCC → per-utterance CMVN → Δ+ΔΔ."""
    from kaldi_tpu_torch.features import (add_deltas, apply_cmvn,
                                          compute_cmvn_stats)
    raw = mfcc.compute(wave)
    return add_deltas(apply_cmvn(raw, compute_cmvn_stats(raw)))


def lda_feats(mfcc, wave, mat):
    """The tri2b/tri3b features: MFCC → per-utterance CMVN → splice ±3
    → the LDA+MLLT matrix."""
    from kaldi_tpu_torch.am.transforms import apply_transform
    from kaldi_tpu_torch.features import (apply_cmvn, compute_cmvn_stats,
                                          splice_frames)
    raw = mfcc.compute(wave)
    return apply_transform(
        splice_frames(apply_cmvn(raw, compute_cmvn_stats(raw)), 3, 3), mat)


def same_best(got, want, what: str) -> None:
    """(words, tids, cost) or (tids, words, cost) pairs: the same label
    sequences, costs within 1e-3."""
    for b, (g, w) in enumerate(zip(got, want)):
        if g[0] != w[0] or g[1] != w[1] or abs(g[2] - w[2]) > 1e-3:
            raise AssertionError(f"{what} utt {b}: GPU {g[0]} {g[2]} vs "
                                 f"CPU {w[0]} {w[2]}")


def gmm_kernel_check(dev, tag: str, num_pdfs: int = 2500,
                     num_gauss: int = 15000, sizes=(300, 1000, 4096)):
    """6a: the GMM kernel against its plain version at the tri3b width
    (steps/train_sat.sh 2500 15000 on 40 LDA+MLLT dims).  Returns
    (max |diff|, kernel ms, plain ms, (bound ms, bound by) at the last
    size)."""
    from kaldi_tpu_torch.tools.synth import tri3b_gmm
    from kaldi_tpu_torch.tools.timing import device_ms, gmm_bound
    rng = np.random.default_rng(SEED + 6)
    am = tri3b_gmm(rng, num_pdfs, num_gauss, device=dev)
    if am.num_gauss() != num_gauss:
        raise AssertionError(f"tri3b model has {am.num_gauss()} Gaussians")
    k = am.device_params()
    print(f"gmm: tri3b width: {am.num_pdfs} pdfs, {am.num_gauss()} "
          f"Gaussians in {am.max_mix} slots per pdf, D={am.dim}")
    err = 0.0
    for T in sizes:
        x = torch.from_numpy(rng.standard_normal((T, 40)).astype(
            np.float32)).to(dev)
        got, want = k(x), k.reference(x)
        torch.cuda.synchronize()
        diff = (got - want).abs()
        share = float((diff / (GMM_TOL + GMM_TOL * want.abs())).max())
        ok = share <= 1.0
        err = max(err, float(diff.max()))
        times = {"plain": [], "kernel": []}
        for which in ("plain", "kernel", "kernel", "plain"):
            times[which].append(device_ms(
                (lambda: k.reference(x)) if which == "plain"
                else (lambda: k(x)), 20))
        ms, plain_ms = min(times["kernel"]), min(times["plain"])
        bnd = gmm_bound(k, T)
        print(f"gmm: {T} frames: kernel vs plain max |diff| "
              f"{float(diff.max()):.3e}, at most {share:.3f} of the limit "
              f"{GMM_TOL:g} + {GMM_TOL:g}·|plain| (values in "
              f"[{float(want.min()):.1f}, "
              f"{float(want.max()):.1f}]); on the card kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms (best of 2 × 20), bound "
              f"{bnd[0]:.4f} ms by {bnd[1]} ({100 * bnd[0] / ms:.1f}% of "
              f"it) {tag}")
        if not ok:
            raise AssertionError(f"GMM kernel disagrees at T={T}")
    return err, ms, plain_ms, bnd


def check_path_loglikes(am, feats, lls, what: str) -> float:
    """The GMM kernel's output on the path against its plain version on
    the same features (these plain runs launch nothing)."""
    k = am.device_params()
    err = share = 0.0
    for f, ll in zip(feats, lls):
        want = k.reference(f)
        diff = (ll - want).abs()
        share = max(share, float((diff / (GMM_TOL + GMM_TOL * want.abs()))
                                 .max()))
        err = max(err, float(diff.max()))
    print(f"{what}: GMM kernel vs plain on each utterance's features: max "
          f"|diff| {err:.3e}, at most {share:.3f} of the limit "
          f"{GMM_TOL:g} + {GMM_TOL:g}·|plain|")
    if not share <= 1.0:
        raise AssertionError(f"{what}: GMM kernel disagrees on the path")
    return err


def check_path_fbank(mfcc, waves, what: str) -> float:
    """The fbank kernel at the MFCC's configuration against its plain
    version on each waveform's frames (launches here are not counted)."""
    from kaldi_tpu_torch.features.window import preprocess_frames
    from kaldi_tpu_torch.ops.fbank import fbank_reference
    k, n = mfcc.kernel, mfcc.kernel.launches
    err = 0.0
    for w in waves:
        x = preprocess_frames(torch.from_numpy(mfcc.frames(w)).to(k.device),
                              mfcc.frame_opts)[0].contiguous()
        err = max(err, float((k(x) - fbank_reference(
            x, k.window, k.cos, k.sin, k.mel)).abs().max()))
    k.launches = n
    print(f"{what}: fbank kernel ({k.n_mel} bins) vs plain on each "
          f"waveform's frames: max |diff| {err:.3e} log-mel (limit 2e-3)")
    if not err <= 2e-3:
        raise AssertionError(f"{what}: fbank kernel disagrees: {err}")
    return err


def words_of(task, wids):
    return [task.words.find(w) for w in wids]


# 6b's waveforms, and those decoded again on the CPU (8 and 4 before
# phase 13 came; cut to keep the whole run near its time budget)
GMM_BEAM_UTTS = 4
GMM_BEAM_CPU_UTTS = 2


def gmm_beam_branch(dev, task, mfcc, tag: str):
    """6b: the latgen BeamDecoder branch (the 20k-word graph is above
    dense_limit; the CSR goes to the decoder as it is, with no VectorFst
    round trip).  Returns (GMM launches, fbank launches, max |diff| of
    the GMM and the fbank kernel on the path)."""
    from kaldi_tpu_torch.cli.latgen import _LatgenDecoder
    from kaldi_tpu_torch.pipelines.score import compute_wer
    from kaldi_tpu_torch.tools.synth import aligned_gmm, mix_counts
    csr, tm = task.graph.csr, task.tm
    waves, aligns, refs = speech_set(task, GMM_BEAM_UTTS, SEED + 7)
    rng = np.random.default_rng(SEED + 7)
    feats = [delta_feats(mfcc, w) for w in waves]
    am = aligned_gmm(rng, [f.cpu().numpy() for f in feats], aligns,
                     mix_counts(rng, task.num_pdfs, 1000, 12, 13), device=dev)
    t0 = time.perf_counter()
    dec = _LatgenDecoder(csr, tm.tid_to_pdf_array, 13.0, 6.0, 0.1,
                         max_active=7000, device=dev)
    print(f"gmm-beam: {csr.num_states} states > dense_limit → "
          f"BeamDecoder={dec._compact} (built in "
          f"{time.perf_counter() - t0:.1f} s); GMM {am.num_pdfs} pdfs, "
          f"{am.num_gauss()} Gaussians, {am.max_mix} slots, D={am.dim}")
    dec.decode_to_clat(am.loglikes(feats[0][:100]))            # warm
    torch.cuda.synchronize()
    k = am.device_params()
    mfcc.kernel.launches = k.launches = 0
    t0 = time.perf_counter()
    feats = [delta_feats(mfcc, w) for w in waves]
    lls = [am.loglikes(f) for f in feats]
    best = [dec.decode_to_clat(ll).best_path() for ll in lls]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = (k.launches, mfcc.kernel.launches)
    audio_s = sum(len(w) for w in waves) / SAMP_FREQ
    if [len(f) for f in feats] != [len(a) for a in aligns] or \
            not all(math.isfinite(b[2]) for b in best):
        raise AssertionError(f"bad output: {[b[2] for b in best]}")
    wer = compute_wer(dict(enumerate(refs)),
                      {b: words_of(task, bp[0]) for b, bp in enumerate(best)})
    if not wer.wer <= MAX_WER:
        raise AssertionError(f"gmm-beam: {wer}")
    print(f"gmm-beam: {len(waves)} waveforms, {audio_s:.2f} s audio, "
          f"{sum(len(f) for f in feats)} frames of {feats[0].shape[1]} "
          f"dims; {wer}; GMM launches {launches[0]}, fbank launches "
          f"{launches[1]}")
    print(f"gmm-beam: end to end {wall:.3f} s = {audio_s / wall:.1f} "
          f"audio-s/s {tag}")
    err = check_path_loglikes(am, feats, lls, "gmm-beam")
    fb_err = check_path_fbank(mfcc, waves, "gmm-beam")
    t0 = time.perf_counter()
    cpu = _LatgenDecoder(csr, tm.tid_to_pdf_array, 13.0, 6.0, 0.1,
                         max_active=7000, device="cpu")
    n = GMM_BEAM_CPU_UTTS
    same_best(best[:n], [cpu.decode_to_clat(ll.cpu()).best_path()
                         for ll in lls[:n]], "gmm-beam")
    print(f"gmm-beam: GPU best paths equal the port's CPU decode on {n} utts "
          f"(words equal, costs within 1e-3; CPU side "
          f"{time.perf_counter() - t0:.1f} s)")
    return launches + (err, fb_err)


# 6c's utterances decoded again on the CPU, whose dense lattice decode
# is the slowest step of phases 1-10: 2, not 4, keeps the whole run
# within half its time limit
DENSE_CPU_UTTS = 2


def gmm_dense_branch(dev, task, mfcc, tag: str):
    """6c: the latgen DenseDecoder branch on a graph under dense_limit.
    Returns (GMM launches, fbank launches, max |diff| of the GMM kernel
    on the path)."""
    from kaldi_tpu_torch.cli.latgen import _LatgenDecoder
    from kaldi_tpu_torch.pipelines.score import compute_wer
    from kaldi_tpu_torch.tools.synth import aligned_gmm, mix_counts
    csr, tm, P = task.graph.csr, task.tm, task.num_pdfs
    waves, aligns, refs = speech_set(task, 8, SEED + 8)
    rng = np.random.default_rng(SEED + 8)
    mat = (rng.standard_normal((40, 92)) / math.sqrt(91)).astype(np.float32)
    feats = [lda_feats(mfcc, w, mat) for w in waves]
    am = aligned_gmm(rng, [f.cpu().numpy() for f in feats], aligns,
                     mix_counts(rng, P, 5 * P, 4, 6), device=dev)
    t0 = time.perf_counter()
    ldec = _LatgenDecoder(csr, tm.tid_to_pdf_array, 13.0, 6.0, 0.1,
                          device=dev)
    dense = ldec._dec
    g = dense.graph
    print(f"gmm-dense: {csr.num_states} states ≤ dense_limit → "
          f"DenseDecoder={not ldec._compact} (built in "
          f"{time.perf_counter() - t0:.1f} s; in-degree emit "
          f"{g.e_src.shape[1]}, ε {g.n_src.shape[1]}, ε-depth "
          f"{g.eps_depth}); GMM {am.num_pdfs} pdfs, {am.num_gauss()} "
          f"Gaussians, {am.max_mix} slots, D={am.dim}")
    k = am.device_params()
    mfcc.kernel.launches = k.launches = 0
    t0 = time.perf_counter()
    feats = [lda_feats(mfcc, w, mat) for w in waves]
    lls = [am.loglikes(f) for f in feats]
    lens = np.array([len(ll) for ll in lls], np.int64)
    X = torch.zeros((len(lls), int(lens.max()), P), device=dev)
    for b, ll in enumerate(lls):
        X[b, :len(ll)] = ll
    nf = torch.from_numpy(lens).to(dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    dense._decode_device(X, nf)
    torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    one_best = dense.decode_batch(X, lens)
    t2 = time.perf_counter()
    raws = [dense.decode_lattice(ll) for ll in lls[:4]]
    best = [ldec.determinize(lat).best_path() for lat, _ in raws]
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    launches = (k.launches, mfcc.kernel.launches)
    if not all(math.isfinite(b[2]) for b in one_best + best):
        raise AssertionError("non-finite best path")
    audio_s = sum(len(w) for w in waves) / SAMP_FREQ
    wer = compute_wer(dict(enumerate(refs)),
                      {b: words_of(task, bp[1])
                       for b, bp in enumerate(one_best)})
    if not wer.wer <= MAX_WER:
        raise AssertionError(f"gmm-dense: {wer}")
    print(f"gmm-dense: frame loop of {len(lls)} utts (T_pad "
          f"{int(lens.max())}) ran under sync debug mode 'error': no host "
          f"sync; one-best {wer}; GMM launches {launches[0]}, fbank "
          f"launches {launches[1]}")
    print(f"gmm-dense: {audio_s:.2f} s audio: features + GMM + sync-checked "
          f"loop {t1 - t0:.3f} s, one-best batch of {len(lls)} "
          f"{t2 - t1:.3f} s, 4 lattices {t3 - t2:.3f} s; lattice states "
          f"{[lat.num_states for lat, _ in raws]} {tag}")
    err = check_path_loglikes(am, feats, lls, "gmm-dense")
    t0 = time.perf_counter()
    cpu = _LatgenDecoder(csr, tm.tid_to_pdf_array, 13.0, 6.0, 0.1,
                         device="cpu")
    n = DENSE_CPU_UTTS
    same_best(one_best[:n], cpu._dec.decode_batch(X[:n].cpu(), lens[:n]),
              "gmm-dense one-best")
    cbest = []
    for b, ll in enumerate(lls[:n]):
        lat, cost = cpu._dec.decode_lattice(ll.cpu())
        glat, gcost = raws[b]
        shape = (lat.num_states, sum(len(a) for a in lat.arcs))
        gshape = (glat.num_states, sum(len(a) for a in glat.arcs))
        if shape != gshape or abs(cost - gcost) > 1e-3:
            raise AssertionError(f"gmm-dense lattice utt {b}: GPU {gshape} "
                                 f"{gcost} vs CPU {shape} {cost}")
        cbest.append(cpu.determinize(lat).best_path())
    same_best(best[:n], cbest, "gmm-dense lattice")
    print(f"gmm-dense: GPU equals the port's CPU decode: one-best on {n} "
          f"utts, and {n} lattices (same states and arcs, best paths' words "
          f"equal, costs within 1e-3; CPU side "
          f"{time.perf_counter() - t0:.1f} s)")
    return launches + (err,)


STREAM_CHUNK = 6            # decoder frames per advance: 180 ms of audio
WAV_CHUNK = 2880            # samples per accept_waveform: 0.18 s at 16 kHz


def pctl(xs, q) -> float:
    return float(np.percentile(np.asarray(xs), q))


def stream_beam(dec, cpu_dec, lls, best, tag: str) -> None:
    """7a: OnlineBeamDecoder on phase 4's decoder, 12 utterances in
    chunks of STREAM_CHUNK frames."""
    from kaldi_tpu_torch.decoder.online_beam import OnlineBeamDecoder
    n = 12
    ob = OnlineBeamDecoder(dec, chunk_frames=STREAM_CHUNK, max_frames=1024)
    lls_dev = [torch.from_numpy(ll).to(dec.device) for ll in lls[:n]]
    adv_ms, first_ms, fin_ms, parts, got = [], [], [], [], []
    n_esc = 0
    torch.cuda.synchronize()
    for ll in lls_dev:
        ob.reset()
        for a in range(0, ll.shape[0], STREAM_CHUNK):
            torch.cuda.set_sync_debug_mode("error")
            t0 = time.perf_counter()
            ob.advance(ll[a:a + STREAM_CHUNK])
            dt = (time.perf_counter() - t0) * 1e3
            torch.cuda.set_sync_debug_mode(0)
            if a == 0:
                t0 = time.perf_counter()
                ob.partial()
                first_ms.append(dt + (time.perf_counter() - t0) * 1e3)
            else:
                adv_ms.append(dt)
        t0 = time.perf_counter()
        clat = ob.finalize()
        fin_ms.append((time.perf_counter() - t0) * 1e3)
        parts.append(dict(ob.last_finalize_breakdown))
        n_esc += int(dec.deficit_fires(float(ob._deficit)))
        got.append(clat.best_path())
    same_best(got, best[:n], "stream")
    frames = sum(ll.shape[0] for ll in lls_dev)
    print(f"stream: {n} utts, {frames} frames in chunks of {STREAM_CHUNK} "
          f"({STREAM_CHUNK * 30} ms of audio); every advance ran under sync "
          f"debug mode 'error': no host sync; final best paths equal phase "
          f"4's offline lattices (words and tids equal, costs within 1e-3); "
          f"n_escalated {n_esc}")
    worst = parts[int(np.argmax(fin_ms))]
    print(f"stream: advance p50 {pctl(adv_ms, 50):.3f} ms, p99 "
          f"{pctl(adv_ms, 99):.3f} ms (host, {len(adv_ms)} advances); first "
          f"partial {np.median(first_ms):.3f} ms (median of {n}: first "
          f"advance + partial); finalize p50 {pctl(fin_ms, 50):.3f} ms, p99 "
          f"{pctl(fin_ms, 99):.3f} ms; slowest finalize "
          f"{ {k: round(v, 3) for k, v in worst.items()} } {tag}")
    t0 = time.perf_counter()
    cpu_ob = OnlineBeamDecoder(cpu_dec, chunk_frames=STREAM_CHUNK,
                               max_frames=1024)
    cpu = []
    for ll in lls[:2]:
        cpu_ob.reset()
        for a in range(0, ll.shape[0], STREAM_CHUNK):
            cpu_ob.advance(ll[a:a + STREAM_CHUNK])
        cpu.append(cpu_ob.finalize().best_path())
    same_best(got[:2], cpu, "stream GPU vs CPU")
    print(f"stream: GPU equals the port's CPU OnlineBeamDecoder on 2 streams "
          f"(CPU side {time.perf_counter() - t0:.1f} s)")


def round_robin(ms, lls, chunk: int):
    """Utterances through ``ms``'s lanes: lane c takes its first one at
    step c and the next one as soon as it frees.  → {utt: final
    lattice}."""
    queue, active, done, step = list(range(len(lls))), {}, {}, 0
    while queue or active:
        for c in range(ms.N):
            if c not in active and queue and step >= c:
                active[c] = (queue.pop(0), 0)
        chunks = [None] * ms.N
        for c, (u, pos) in active.items():
            chunks[c] = lls[u][pos:pos + chunk]
        ms.advance(chunks)
        for c in list(active):
            u, pos = active[c]
            pos += chunks[c].shape[0]
            if pos >= lls[u].shape[0]:
                done[u] = ms.finalize_channel(c)
                ms.reset_channel(c)
                del active[c]
            else:
                active[c] = (u, pos)
        step += 1
    return done


def multistream(dec, lls, best, tag: str) -> None:
    """7b: MultiStreamBeamDecoder lane throughput, then staggered
    utterances through 4 lanes."""
    from kaldi_tpu_torch.decoder.online_beam import MultiStreamBeamDecoder
    N, Tms, c = 8, 480, STREAM_CHUNK
    ms = MultiStreamBeamDecoder(dec, n_channels=N, chunk_frames=c,
                                max_frames=512)
    llm = [torch.from_numpy(np.concatenate([lls[i % len(lls)]] * 8)[:Tms])
           .to(dec.device) for i in range(N)]
    for a in range(0, 2 * c, c):                                # warm
        ms.advance([x[a:a + c] for x in llm])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps = 0
    for a in range(2 * c, Tms, c):
        ms.advance([x[a:a + c] for x in llm])
        steps += 1
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    print(f"multistream: {N} lanes × {Tms} frames in chunks of {c}: "
          f"{steps} steps in {wall:.3f} s = "
          f"{N * steps * c * 0.03 / wall:.1f} audio-s/s {tag}")
    ms4 = MultiStreamBeamDecoder(dec, n_channels=4, chunk_frames=c,
                                 max_frames=512)
    done = round_robin(ms4, [torch.from_numpy(ll).to(dec.device)
                             for ll in lls[:8]], c)
    same_best([done[u].best_path() for u in range(8)], best[:8],
              "multistream")
    print("multistream: 8 utts through 4 lanes (staggered starts, resets): "
          "each final lattice's best path equals phase 4's offline one")


def feed(pipe, sc, online, wave):
    """The online2 tool's loop over one waveform (cli/online2.py):
    WAV_CHUNK pieces into the feature pipeline, ready frames into the
    scorer, ready scores into the decoder, then the end of input.  →
    (the score chunks, the host time just before the last piece)."""
    fed, outs = 0, []

    def pull(finish=False):
        nonlocal fed
        ready = pipe.num_frames_ready()
        if ready > fed:
            sc.accept_features(pipe.get_frames(fed, ready))
            fed = ready
        if finish:
            sc.input_finished()
        s = sc.read_new()
        if s.numel():
            outs.append(s)
            online.advance_decoding(s)

    for i in range(0, len(wave), WAV_CHUNK):
        t_last = time.perf_counter()
        pipe.accept_waveform(wave[i:i + WAV_CHUNK])
        pull()
    pipe.input_finished()
    pull(finish=True)
    return outs, t_last


def check_stream_fbank(fb, waves, chunk: int):
    """The fbank kernel against its plain version on the frames each
    streaming chunk completes, as OnlineFeaturePipeline computes them
    (launches here are not counted).  → (max |diff|, frame counts)."""
    from kaldi_tpu_torch.features.window import num_frames, preprocess_frames
    k, n0 = fb.kernel, fb.kernel.launches
    opts = fb.frame_opts
    err, sizes = 0.0, set()
    for w in waves:
        have = 0
        for end in list(range(chunk, len(w), chunk)) + [len(w)]:
            total = num_frames(end, opts)
            if total > have:
                fr = fb.frames(w[have * opts.window_shift:end])
                x = preprocess_frames(torch.from_numpy(fr).to(k.device),
                                      opts)[0].contiguous()
                err = max(err, float((k(x) - k.reference(x)).abs().max()))
                sizes.add(x.shape[0])
                have = total
    k.launches = n0
    return err, sorted(sizes)


def stream_wav(dev, waves, model, dec, tag: str):
    """7c: waveforms in WAV_CHUNK pieces → OnlineFeaturePipeline (fbank
    kernel) → OnlineNnetScorer → OnlineBeamDecoder.  → (fbank launches,
    max |diff| of the kernel on the chunks' frames)."""
    from kaldi_tpu_torch.decoder.online_beam import OnlineBeamDecoder
    from kaldi_tpu_torch.decoder.online_nnet import OnlineNnetScorer
    from kaldi_tpu_torch.features.compute import Fbank, FbankOptions
    from kaldi_tpu_torch.features.mel import MelBanksOptions
    from kaldi_tpu_torch.features.online import OnlineFeaturePipeline
    from kaldi_tpu_torch.features.window import FrameExtractionOptions
    from kaldi_tpu_torch.pipelines.decode import decode_waveforms
    # dither 0: the computer draws dither afresh on each call, so only
    # without it do streamed and offline features agree
    fb = Fbank(FbankOptions(frame_opts=FrameExtractionOptions(dither=0.0),
                            mel_opts=MelBanksOptions(num_bins=40)),
               device=dev)
    ref = [lat.best_path()
           for lat in decode_waveforms(waves, fb, model, dec, batch_size=8)]
    ob = OnlineBeamDecoder(dec, chunk_frames=STREAM_CHUNK, max_frames=1024)
    got, scores, feats, last_ms = [], [], [], []
    torch.cuda.synchronize()
    fb.kernel.launches = 0
    t0 = time.perf_counter()
    for w in waves:
        pipe = OnlineFeaturePipeline(fb)
        sc = OnlineNnetScorer(model, left_context=36, right_context=36,
                              device=dev)
        ob.reset()
        outs, t_last = feed(pipe, sc, ob, w)
        got.append(ob.finalize().best_path())
        last_ms.append((time.perf_counter() - t_last) * 1e3)
        scores.append(torch.cat(outs))
        feats.append(pipe.get_frames(0, pipe.num_frames_ready()))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fb.kernel.launches
    audio_s = sum(len(w) for w in waves) / SAMP_FREQ
    rel = 0.0
    with torch.no_grad():
        for s, f in zip(scores, feats):
            off = model(f[None])[0]
            if s.shape != off.shape:
                raise AssertionError(f"streamed {tuple(s.shape)} vs offline "
                                     f"{tuple(off.shape)}")
            rel = max(rel, float((s - off).abs().max() / off.abs().max()))
    if not rel <= 1e-4:
        raise AssertionError(f"streamed scores differ from offline: {rel}")
    if [g[0] for g in got] != [r[0] for r in ref]:
        raise AssertionError(f"streamed words {[g[0] for g in got]} vs "
                             f"offline {[r[0] for r in ref]}")
    if launches <= 0:
        raise AssertionError("the streaming path did not launch the fbank "
                             "kernel")
    dcost = max(abs(g[2] - r[2]) for g, r in zip(got, ref))
    print(f"wav-stream: {len(waves)} waveforms, {audio_s:.2f} s audio in "
          f"{WAV_CHUNK}-sample chunks; streamed scores vs offline forward on "
          f"the same features: max |diff| / max |offline| {rel:.3e} (limit "
          f"1e-4); words equal the offline path's (largest cost difference "
          f"{dcost:.2e}); fbank launches {launches}")
    print(f"wav-stream: wall {wall:.3f} s, RTF {wall / audio_s:.4f}; last "
          f"chunk → final lattice p50 {pctl(last_ms, 50):.2f} ms, max "
          f"{max(last_ms):.2f} ms {tag}")
    err, sizes = check_stream_fbank(fb, waves, WAV_CHUNK)
    print(f"wav-stream: fbank kernel vs plain on each chunk's frames "
          f"({sizes} frames per launch): max |diff| {err:.3e} log-mel "
          f"(limit 2e-3)")
    if not err <= 2e-3:
        raise AssertionError(f"fbank kernel disagrees on the chunks: {err}")
    return launches, err


def online2_cli(dev, task, tag: str) -> int:
    """7d: the online2 tool on the card, against the library path on the
    same files.  → the tool's fbank launches (its log's count)."""
    import re
    import subprocess
    from kaldi_tpu_torch.am.gmm import AmDiagGmm
    from kaldi_tpu_torch.am.nnet3_io import write_raw_model
    from kaldi_tpu_torch.am.serialize import write_mdl
    from kaldi_tpu_torch.am.tdnn import TdnnChain, TdnnConfig
    from kaldi_tpu_torch.cli.online2 import _load_tdnn
    from kaldi_tpu_torch.core.table import SequentialTableReader, TableWriter
    from kaldi_tpu_torch.decoder.dense import DenseDecoder, DenseDecoderConfig
    from kaldi_tpu_torch.decoder.online import SingleUtteranceDecoder
    from kaldi_tpu_torch.decoder.online_nnet import OnlineNnetScorer
    from kaldi_tpu_torch.features.compute import Mfcc, MfccOptions
    from kaldi_tpu_torch.features.online import OnlineFeaturePipeline
    from kaldi_tpu_torch.features.window import FrameExtractionOptions
    from kaldi_tpu_torch.fst.csr import csr_to_vector_fst
    from kaldi_tpu_torch.fst.openfst_io import write_fst_path
    repo = os.path.dirname(os.path.abspath(__file__))
    d = os.path.join(repo, "build", "chip_smoke_online2")
    os.makedirs(d, exist_ok=True)
    P = task.num_pdfs
    # the tool reads only the transition model of the .mdl
    write_mdl(os.path.join(d, "final.mdl"), task.tm,
              AmDiagGmm(np.ones((P, 1)), np.zeros((P, 1, 13)),
                        np.ones((P, 1, 13)), device=dev))
    HCLG = csr_to_vector_fst(task.graph.csr)
    write_fst_path(os.path.join(d, "HCLG.fst"), HCLG)
    cfg = TdnnConfig(feat_dim=13, num_pdfs=P, hidden_dim=1024,
                     bottleneck_dim=128, num_layers=13)
    sd = random_tdnn_state(TdnnChain(cfg), np.random.default_rng(SEED + 9))
    # outputs 5× phase 5's spread: at that spread the dense decoder's
    # best path holds no word on these waveforms
    sd["output_affine.weight"] *= 5.0
    write_raw_model(os.path.join(d, "final.raw"), sd, cfg)
    waves = [np.clip(w, -32768, 32767).astype(np.int16)
             for w in speech_set(task, 8, SEED + 8)[0][:2]]
    with TableWriter(f"ark:{os.path.join(d, 'wav.ark')}", holder="wav") as w:
        for i, x in enumerate(waves):
            w[f"utt{i}"] = (x, SAMP_FREQ)
    files = [os.path.join(d, f) for f in ("final.mdl", "final.raw",
                                          "HCLG.fst")]
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "kaldi_tpu_torch.cli.online2", "--device=cuda",
         *files, f"ark:{os.path.join(d, 'wav.ark')}",
         f"ark,t:{os.path.join(d, 'words.txt')}"],
        cwd=repo, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    if res.returncode != 0:
        raise AssertionError(f"online2 failed ({res.returncode}):\n"
                             f"{res.stderr[-3000:]}")
    m = re.search(r"fbank kernel launches (\d+)", res.stderr)
    launches = int(m.group(1)) if m else 0
    cli = dict(SequentialTableReader(f"ark,t:{os.path.join(d, 'words.txt')}",
                                     holder="text"))
    # the library path on the same files, with the tool's settings
    mfcc = Mfcc(MfccOptions(frame_opts=FrameExtractionOptions(dither=0.0),
                            num_ceps=13), device=dev)
    _, net = _load_tdnn(files[1], 3, dev)
    dense = DenseDecoder(HCLG, task.tm.tid_to_pdf_array,
                         DenseDecoderConfig(beam=15.0, acoustic_scale=1.0),
                         device=dev)
    lib = {}
    for i, x in enumerate(waves):
        online = SingleUtteranceDecoder(dense)
        feed(OnlineFeaturePipeline(mfcc), OnlineNnetScorer(net, device=dev),
             online, x.astype(np.float32))
        lib[f"utt{i}"] = [str(o) for o in
                          online.get_best_path(use_final_probs=True)[1]]
    if cli != lib or launches <= 0:
        raise AssertionError(f"online2 words {cli} vs library {lib}; fbank "
                             f"launches {launches}")
    print(f"online2: python -m kaldi_tpu_torch.cli.online2 --device=cuda on "
          f"2 waveforms ({sum(len(x) for x in waves) / SAMP_FREQ:.2f} s) of "
          f"the 300-word task ({task.graph.csr.num_states} states: "
          f"SingleUtteranceDecoder), 13-layer raw nnet3 TDNN-F: words "
          f"{[len(v) for v in cli.values()]} per utt equal the library "
          f"path's; wall {wall:.2f} s (process start, graph and model "
          f"load); fbank launches {launches} {tag}")
    return launches


CHAIN_T = 150              # frames per eg: the get_egs.sh chunk (bench.py)
CHAIN_LEAK = 0.1           # ChainTrainingOptions' leaky-HMM coefficient
# the den kernel's parity bar with its plain version: log Z summed over
# 50 frames in float32 (the plain version) against double (the kernel),
# so 1e-5 of |log Z| + 1e-4; posteriors are in [0, 1]: 1e-4
DEN_LOGZ_REL, DEN_LOGZ_ABS, DEN_GRAD_TOL = 1e-5, 1e-4, 1e-4
# 8c's training: compute-prob runs the model in eval mode, on running
# batch-norm statistics that move 1% a step, so the run keeps the
# weights near the statistics they were calibrated on; the tool's
# default lr (1e-3) moves a 13-layer model far past them in a few steps
CLI_EPOCHS, CLI_LR = 4, 1e-4
# the JAX bench's training points: (batch, compute dtype)
CHAIN_POINTS = ((32, "float32"), (32, "bfloat16"), (64, "bfloat16"),
                (128, "bfloat16"))


def bench_den_graph():
    """The JAX bench's den graph (bench.py): 41 phones, chain topology,
    monophone tree, trigram phone LM from 200 seeded 20-phone
    sequences.  → (topo, tree, sequences, den)."""
    from kaldi_tpu_torch.am.chain import make_denominator_graph
    from kaldi_tpu_torch.am.topology import HmmTopology
    from kaldi_tpu_torch.am.tree import MonophoneContextDependency
    phones = list(range(1, 42))
    topo = HmmTopology.chain(phones)
    tree = MonophoneContextDependency(phones, topo)
    rng = np.random.default_rng(0)
    seqs = [[int(p) for p in rng.integers(1, 42, 20)] for _ in range(200)]
    return topo, tree, seqs, make_denominator_graph(seqs, tree, topo,
                                                    order=3)


def biphone_den_graph():
    """The bench's phone LM over a full left-biphone tree (the e2e
    flat-start recipes' tree): 1722 states (41 utterance-initial),
    72,324 arcs, 3444 pdfs, the largest P the den kernels take here.  →
    (den, P)."""
    from kaldi_tpu_torch.am.chain import make_denominator_graph
    from kaldi_tpu_torch.am.topology import HmmTopology
    from kaldi_tpu_torch.am.tree import full_biphone_tree
    phones = list(range(1, 42))
    topo = HmmTopology.chain(phones)
    tree = full_biphone_tree(phones, topo)
    rng = np.random.default_rng(0)
    seqs = [[int(p) for p in rng.integers(1, 42, 20)] for _ in range(200)]
    return make_denominator_graph(seqs, tree, topo, order=3), tree.num_pdfs


def den_kernel_check(dev, den, P: int, tag: str, B: int = 128,
                     T: int = 50):
    """8a: the den forward-backward kernels against the plain version on
    the card, at B sequences of T output frames (the bench's B = 128
    chunks of 150 frames, ×3 subsampled), leak 0.1, a ragged mask.  The
    kernels' launches run under sync debug mode "error".  Then the
    kernels without the score prefetch, and the kernels on 4 sequences
    with one NaN score against their plain twin on the CPU.  → (max
    |diff| of the gradient, kernel ms, plain ms, (bound ms, bound by))."""
    from kaldi_tpu_torch.am.chain import (den_kernel, denominator_logprob,
                                          denominator_reference)
    from kaldi_tpu_torch.ops.chain_den import ChainDenFn, DenPlan
    from kaldi_tpu_torch.tools.timing import (chain_den_bound, device_ms,
                                              graph_ms)
    rng = np.random.default_rng(SEED + 10)
    lens = rng.integers(T // 2, T + 1, B)
    lens[0] = T
    mask_np = np.arange(T)[None, :] < lens[:, None]
    scores = torch.from_numpy((2.0 * rng.standard_normal((B, T, P)))
                              .astype(np.float32)).to(dev)
    mask = torch.from_numpy(mask_np).to(dev)
    k = den_kernel(den, dev)

    def run(fn):
        s = scores.detach().clone().requires_grad_(True)
        z = fn(den, s, mask, CHAIN_LEAK)
        z.sum().backward()
        return z.detach(), s.grad

    def run_on(kern, x, m):
        s = x.clone().requires_grad_(True)
        z = kern(s, m, CHAIN_LEAK)
        z.sum().backward()
        return z.detach(), s.grad

    torch.cuda.synchronize()
    n0 = k.launches
    torch.cuda.set_sync_debug_mode("error")
    z, g = run(denominator_logprob)
    torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    if k.launches - n0 != 2:
        raise AssertionError(f"den kernels launched {k.launches - n0} "
                             f"times for one forward-backward")
    zr, gr = run(denominator_reference)
    torch.cuda.synchronize()
    dz = float(((z - zr).abs() / (DEN_LOGZ_ABS + DEN_LOGZ_REL * zr.abs()))
               .max())
    dg = float((g - gr).abs().max())
    want = torch.from_numpy(mask_np | (np.arange(T) == 0)[None, :]).to(dev)
    dsum = float((g.sum(dim=2) - want.float()).abs().max())
    print(f"den: kernels vs plain at B={B}, T={T}, S={den.num_states}, "
          f"A={len(den.src)}, P={P}, {k.plan(P)}, leak "
          f"{CHAIN_LEAK}, frames per sequence "
          f"{int(lens.min())}-{T}: log Z (range [{float(zr.min()):.1f}, "
          f"{float(zr.max()):.1f}]) at most {dz:.3f} of the limit "
          f"{DEN_LOGZ_ABS:g} + {DEN_LOGZ_REL:g}·|log Z|; d log Z / d scores "
          f"max |diff| {dg:.3e} (limit {DEN_GRAD_TOL:g}); posteriors sum to "
          f"1 per active frame within {dsum:.2e}; the kernels' launches ran "
          f"under sync debug mode 'error'")
    if not (dz <= 1.0 and dg <= DEN_GRAD_TOL and dsum <= 1e-4):
        raise AssertionError("den kernels disagree with the plain version")
    # the kernels without the score prefetch (a graph too large for it)
    s = scores.detach().clone().requires_grad_(True)
    zl = ChainDenFn.apply(s, mask.to(torch.uint8), k, CHAIN_LEAK,
                          DenPlan(False, False))
    zl.sum().backward()
    dzl = float(((zl.detach() - zr).abs()
                 / (DEN_LOGZ_ABS + DEN_LOGZ_REL * zr.abs())).max())
    dgl = float((s.grad - gr).abs().max())
    if not (dzl <= 1.0 and dgl <= DEN_GRAD_TOL):
        raise AssertionError(f"den kernels without the prefetch disagree: "
                             f"{dzl}, {dgl}")
    dg = max(dg, dgl)
    # a NaN score in sequence 1, on a pdf the graph reads (the wrapper
    # sets the pdfs it never reads to -inf): its log Z and the gradient
    # rows of its active frames are NaN, as in the plain twin; the others
    # agree
    sn = scores[:4].detach().clone()
    sn[1, T // 3, int(np.asarray(den.pdf)[0])] = float("nan")
    zk, gk = run_on(k, sn, mask[:4])
    zc, gc = run_on(den_kernel(den, "cpu"), sn.cpu(), mask[:4].cpu())
    rows_k, rows_c = gk.isnan().any(dim=2).cpu(), gc.isnan().any(dim=2)
    ok = (torch.equal(zk.isnan().cpu(), zc.isnan())
          and torch.equal(rows_k, rows_c)
          and int(rows_c[1, 1:].sum()) == int(mask_np[1, 1:].sum())
          and not bool(rows_c[[0, 2, 3]].any()))
    dgn = float((gk[[0, 2, 3]].cpu() - gc[[0, 2, 3]]).abs().max())
    print(f"den: without the score prefetch: log Z at most {dzl:.3f} of its "
          f"limit, gradient max |diff| {dgl:.3e}; a NaN score: NaN log Z "
          f"and gradient rows as the plain twin's ({int(rows_k.sum())} "
          f"rows), the other sequences' gradient max |diff| {dgn:.3e}")
    if not (ok and dgn <= DEN_GRAD_TOL):
        raise AssertionError("den kernels do not carry a NaN score as the "
                             "plain version does")
    # the plain recursion's thousands of launches a call overflow the
    # launch queue that device_ms queues behind its spin: one call is
    # captured into a CUDA graph and launched once (graph_ms)
    times = {"plain": [], "kernel": []}
    for which in ("plain", "kernel", "kernel", "plain"):
        if which == "plain":
            times[which].append(graph_ms(lambda: run(denominator_reference)))
        else:
            times[which].append(device_ms(lambda: run(denominator_logprob),
                                          10))
    ms, plain_ms = min(times["kernel"]), min(times["plain"])
    active = int(mask_np[:, 1:].sum()) + B
    bnd = chain_den_bound(k, active, B, T, P)
    print(f"den: forward + backward on the card: kernels {ms:.4f} ms (best "
          f"of 2 × 10, device_ms), plain {plain_ms:.4f} ms (best of 2 "
          f"graph launches, graph_ms), bound {bnd[0]:.4f} ms by {bnd[1]} "
          f"({100 * bnd[0] / ms:.1f}% of it); {active} active frames {tag}")
    return dg, ms, plain_ms, bnd


def phone_runs(rng, n_frames: int, phones):
    """Seeded (phone, frames) runs covering n_frames: 3-15 frames each,
    no phone twice in a row."""
    runs, total, prev = [], 0, 0
    while total < n_frames:
        ph = prev
        while ph == prev:
            ph = int(rng.choice(phones))
        d = int(rng.integers(3, 16))
        runs.append((ph, d))
        total += d
        prev = ph
    return runs


def chain_egs(dev, topo, tree, den, n_waves: int):
    """Seeded waveforms → Fbank (the fbank kernel, 40 bins) → egs of
    CHAIN_T frames with seeded phone alignments and the den's
    normalization weights.  → (egs, fbank computer, seconds of audio,
    features, phone runs)."""
    from kaldi_tpu_torch.features.compute import Fbank, FbankOptions
    from kaldi_tpu_torch.features.mel import MelBanksOptions
    from kaldi_tpu_torch.pipelines.chain import make_chain_egs
    fb = Fbank(FbankOptions(mel_opts=MelBanksOptions(num_bins=40)),
               device=dev)
    waves = synth_waveforms(np.random.default_rng(SEED + 11), n_waves)
    feats = {f"utt{i:03d}": fb.compute(w) for i, w in enumerate(waves)}
    rng = np.random.default_rng(SEED + 12)
    feats = {u: f.cpu().numpy() for u, f in feats.items()}
    runs = {u: phone_runs(rng, len(f), topo.phones)
            for u, f in feats.items()}
    egs = make_chain_egs(feats, runs, tree, topo, chunk_size=CHAIN_T,
                         subsample=3, den=den)
    return egs, fb, sum(len(w) for w in waves) / SAMP_FREQ, feats, runs


def tdnn_config(P: int, dtype: str = "float32", hidden: int = 1024,
                layers: int = 13):
    """The bench's TDNN-F: 40 fbank inputs, 1024 wide, bottleneck 128,
    13 layers, ×3 subsampling."""
    from kaldi_tpu_torch.am.tdnn import TdnnConfig
    return TdnnConfig(feat_dim=40, num_pdfs=P, hidden_dim=hidden,
                      bottleneck_dim=128, num_layers=layers,
                      frame_subsampling_factor=3, compute_dtype=dtype)


def chain_train_points(dev, den, egs, P: int, tag: str,
                       points=CHAIN_POINTS, steps: int = 30,
                       key_prefix: str = "", profile_steps: int = 0,
                       **width):
    """8b (14b): NG-SGD training steps of ChainTrainer at each (B, dtype),
    after 3 warm steps; Mframes/s of input frames over ``steps`` steps
    between two synchronizes; with ``profile_steps``, that many more
    steps under torch.profiler for the kernels and busy card time a
    step.  → {key: Mframes/s}."""
    from kaldi_tpu_torch.tools.timing import profiled
    from kaldi_tpu_torch.pipelines.chain import ChainTrainConfig, ChainTrainer
    N = egs.feats.shape[0]
    out = {}
    for B, dtype in points:
        if N < B:
            raise AssertionError(f"{N} egs for a batch of {B}")
        tr = ChainTrainer(tdnn_config(P, dtype, **width), den,
                          ChainTrainConfig(batch_size=B, optimizer="ngsgd",
                                           total_steps=0),
                          seed=SEED, device=dev)
        batches = [tr.batches(egs, (np.arange(B) + i * B) % N)
                   for i in range(4)]
        for i in range(3):
            tr._step(*batches[i % 4])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        objf = []
        for i in range(steps):
            loss, diag = tr._step(*batches[i % 4])
            objf.append(diag["objf"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        key = (f"{key_prefix}{'f32' if dtype == 'float32' else 'bf16'}"
               f"_B{B}_Mframes_s")
        out[key] = B * egs.feats.shape[1] * steps / wall / 1e6
        params = sum(p.numel() for p in tr.model.parameters())
        if not (math.isfinite(float(loss))
                and bool(torch.stack(objf).isfinite().all())):
            raise AssertionError(f"{key}: loss {float(loss)}, objf "
                                 f"{torch.stack(objf).tolist()}")
        print(f"train: B={B} {dtype}: {steps} NG-SGD steps in {wall:.3f} s "
              f"= {1e3 * wall / steps:.2f} ms a step, {out[key]:.4f} "
              f"Mframes/s ({params / 1e6:.2f}M params, den "
              f"{den.num_states} states); loss {float(loss):.4f}, objf "
              f"{float(diag['objf']):.4f} {tag}")
        if profile_steps:
            def run_steps():
                for i in range(profile_steps):
                    tr._step(*batches[i % 4])
                torch.cuda.synchronize()
            pwall, n_k, busy, _ = profiled(run_steps)
            print(f"train: B={B} {dtype}: {profile_steps} steps profiled: "
                  f"{n_k / profile_steps:.0f} kernels and "
                  f"{busy / profile_steps:.2f} ms of busy card a step, "
                  f"{pwall / profile_steps:.2f} ms "
                  f"wall a step ({100 * busy / pwall:.1f}% busy) {tag}")
    return out


def card_step_equals_cpu(dev, den, egs, P: int, B: int = 4, **width):
    """8b: one f32 NG-SGD step at B on the card against the port's CPU
    step on the same egs and seed (TF32 off): loss and every parameter
    within 1e-4 of its largest value."""
    from kaldi_tpu_torch.pipelines.chain import ChainTrainConfig, ChainTrainer
    res = []
    for d in (dev, "cpu"):
        tr = ChainTrainer(tdnn_config(P, **width), den,
                          ChainTrainConfig(batch_size=B, optimizer="ngsgd",
                                           total_steps=0),
                          seed=SEED, device=d)
        before = {k: v.detach().cpu().clone()
                  for k, v in tr.model.state_dict().items()}
        loss, _ = tr._step(*tr.batches(egs, np.arange(B)))
        res.append((float(loss), before,
                    {k: v.detach().cpu() for k, v in
                     tr.model.state_dict().items()}))
    (lg, bg, pg), (lc, bc, pc) = res
    rel = max(float((pg[k] - pc[k]).abs().max()
                    / max(float(pc[k].abs().max()), 1e-12)) for k in pc)
    moved = max(float((pc[k] - bc[k]).abs().max()) for k in pc)
    lrel = abs(lg - lc) / max(abs(lc), 1e-12)
    print(f"train: one step at B={B} on the card vs the port's CPU step: "
          f"loss {lg:.6f} vs {lc:.6f} (relative {lrel:.2e}), parameters "
          f"within {rel:.2e} of each tensor's largest (limit 1e-4; the step "
          f"moved them by up to {moved:.3e})")
    if not (lrel <= 1e-4 and rel <= 1e-4 and moved > 0):
        raise AssertionError("the card's training step differs from the CPU's")


def calibrate_batch_norm(model, feats: torch.Tensor) -> None:
    """Running statistics = the statistics of one training-mode forward
    over ``feats`` (momentum 0), so that eval mode sees what training
    sees."""
    from kaldi_tpu_torch.am.tdnn import BatchNorm
    bns = [m for m in model.modules() if isinstance(m, BatchNorm)]
    for m in bns:
        m.momentum = 0.0
    model.train()
    with torch.no_grad():
        model(feats)
    for m in bns:
        m.momentum = 0.99
    model.eval()


def chain_cli(dev, topo, tree, seqs, egs, tag: str, n_egs: int = 64,
              **width):
    """8c: nnet3-chain-compute-prob, nnet3-chain-train (CLI_EPOCHS
    epochs) and compute-prob again on the card, on files the port
    writes: a .mdl, a seeded 13-layer raw TDNN-F (batch norm calibrated
    on the egs), the bench's phone sequences and n_egs egs.  → (objf
    before, after)."""
    import subprocess
    from kaldi_tpu_torch.am.gmm import AmDiagGmm
    from kaldi_tpu_torch.am.nnet3_io import write_raw_model
    from kaldi_tpu_torch.am.serialize import write_mdl
    from kaldi_tpu_torch.am.tdnn import TdnnChain
    from kaldi_tpu_torch.am.transitions import TransitionModel
    from kaldi_tpu_torch.core.table import TableWriter
    from kaldi_tpu_torch.pipelines.chain import ChainEgs
    from kaldi_tpu_torch.pipelines.egs_io import write_egs_ark
    repo = os.path.dirname(os.path.abspath(__file__))
    d = os.path.join(repo, "build", "chip_smoke_chain")
    os.makedirs(d, exist_ok=True)
    P = tree.num_pdfs
    write_mdl(os.path.join(d, "final.mdl"), TransitionModel(topo, tree),
              AmDiagGmm(np.ones((P, 1)), np.zeros((P, 1, 40)),
                        np.ones((P, 1, 40)), device=dev))
    sub = ChainEgs(**{f: getattr(egs, f)[:n_egs] for f in (
        "feats", "pdf_ali", "mask", "entry_pdf", "self_pdf", "num_segs",
        "entry_w", "self_w", "init_w", "final_w")})
    write_egs_ark(f"ark:{os.path.join(d, 'egs.ark')}", sub)
    with TableWriter(f"ark:{os.path.join(d, 'ph.ark')}", holder="ivec") as w:
        for i, s in enumerate(seqs):
            w[f"seq{i:03d}"] = np.asarray(s, np.int32)
    cfg = tdnn_config(P, **width)
    net = TdnnChain(cfg)
    net.load_state_dict(random_tdnn_state(net, np.random.default_rng(
        SEED + 13)))
    calibrate_batch_norm(net.to(dev), torch.from_numpy(sub.feats[:32]).to(dev))
    write_raw_model(os.path.join(d, "0.raw"), net.state_dict(), cfg)
    common = [os.path.join(d, "final.mdl")]
    tail = [f"ark:{os.path.join(d, 'ph.ark')}",
            f"ark:{os.path.join(d, 'egs.ark')}"]
    device = f"--device={dev.type}"

    def tool(*args):
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-m", "kaldi_tpu_torch.cli.chain", *args],
            cwd=repo, capture_output=True, text=True, timeout=600)
        if res.returncode != 0:
            raise AssertionError(f"{args[0]} failed ({res.returncode}):\n"
                                 f"{res.stderr[-3000:]}")
        return res.stdout, time.perf_counter() - t0

    def objf(raw):
        out, wall = tool("nnet3-chain-compute-prob", device, *common,
                         os.path.join(d, raw), *tail)
        return float(out.strip().splitlines()[-1]), wall

    before, w0 = objf("0.raw")
    _, w1 = tool("nnet3-chain-train", device, f"--num-epochs={CLI_EPOCHS}",
                 f"--learning-rate={CLI_LR}", *common,
                 os.path.join(d, "0.raw"), *tail, os.path.join(d, "1.raw"))
    after, w2 = objf("1.raw")
    print(f"chain-cli: python -m kaldi_tpu_torch.cli.chain {device}: "
          f"nnet3-chain-compute-prob of the seeded model {before:.4f} "
          f"({w0:.1f} s), nnet3-chain-train {CLI_EPOCHS} epochs at lr "
          f"{CLI_LR:g} over {n_egs} egs of "
          f"{CHAIN_T} frames ({w1:.1f} s), compute-prob after {after:.4f} "
          f"({w2:.1f} s) {tag}")
    if not (math.isfinite(before) and math.isfinite(after)
            and after > before):
        raise AssertionError(f"chain CLI objf {before} → {after}")
    return before, after


# phase 9's bars.  A spectrogram bin has no filter to average it: the
# DFT's error is absolute, of the order of float32 rounding of the
# frame's norm, so a bin's log power is held at 2e-3 (the log-mel bar)
# where its power is at least 1e-5 of the frame's largest bin, and every
# bin's power within 1e-5 of that bin.  PLP carries the mel energies
# through Levinson-Durbin: 1e-3 + 1e-3·|plain|.  The batched features
# are held as the CPU tests hold them against the JAX package: 2e-3 on
# log-mel, 4e-3·lifter_k on MFCC + CMN + deltas.
SPEC_SHARE, SPEC_LOG_TOL, SPEC_LIN_TOL = 1e-5, 2e-3, 1e-5
PLP_TOL = 1e-3
BATCH_B, BATCH_SECONDS = 32, 10.0
# the mini_librispeech tri1 width (steps/train_deltas.sh 2000 10000 on
# MFCC + Δ + ΔΔ)
TRI1_PDFS, TRI1_GAUSS = 2000, 10000


def spectra_diff(got, want):
    """Two log power spectra (F, n_bins) → (max |Δ log power| on bins of
    at least SPEC_SHARE of the frame's largest bin, max |Δ power| over
    the frame's largest bin); raises past SPEC_LOG_TOL / SPEC_LIN_TOL."""
    g, w = got.double().cpu(), want.double().cpu()
    pw = w.exp()
    top = pw.max(dim=1, keepdim=True).values
    big = pw >= SPEC_SHARE * top
    log_err = float((g - w).abs()[big].max())
    lin_err = float(((g.exp() - pw).abs() / top).max())
    if not (log_err <= SPEC_LOG_TOL and lin_err <= SPEC_LIN_TOL):
        raise AssertionError(f"spectra disagree: log {log_err}, linear "
                             f"{lin_err}")
    return log_err, lin_err


def plp_diff(got, want) -> float:
    """max |Δ| / (1 + |want|) of two PLP matrices; raises past PLP_TOL."""
    share = float(((got.cpu() - want.cpu()).abs()
                   / (1.0 + want.cpu().abs())).max())
    if not share <= PLP_TOL:
        raise AssertionError(f"PLP disagrees: {share}")
    return share


def spectrogram_plp(dev, waves, tag: str):
    """9a: Spectrogram and Plp on the card on phase 5's waveforms, each
    kernel path against its plain version on the card and the whole
    computer against the port's CPU one; the identity-filter kernel at
    4096 frames.  → fbank launches on the path."""
    from kaldi_tpu_torch.features.compute import Plp, Spectrogram
    from kaldi_tpu_torch.features.window import preprocess_frames
    from kaldi_tpu_torch.tools.timing import device_ms, fbank_bound
    spec, plp = Spectrogram(device=dev), Plp(device=dev)
    spec_cpu, plp_cpu = Spectrogram(device="cpu"), Plp(device="cpu")
    spec.compute(waves[0][:8000])                          # warm
    plp.compute(waves[0][:8000])
    torch.cuda.synchronize()
    spec.kernel.launches = plp.kernel.launches = 0
    t0 = time.perf_counter()
    specs = [spec.compute(w) for w in waves]
    plps = [plp.compute(w) for w in waves]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = (spec.kernel.launches, plp.kernel.launches)
    if launches != (len(waves), len(waves)):
        raise AssertionError(f"spectrogram / PLP fbank launches {launches}")
    frames = sum(s.shape[0] for s in specs)
    if not all(bool(torch.isfinite(x).all()) for x in specs + plps):
        raise AssertionError("non-finite spectrogram or PLP")
    # each kernel path against its plain version on the card (launches
    # here are not counted)
    s_log = s_lin = p_mel = p_plp = 0.0
    for w in waves:
        x, le = preprocess_frames(torch.from_numpy(spec.frames(w)).to(dev),
                                  spec.frame_opts)
        x = x.contiguous()
        d = spectra_diff(spec.kernel(x), spec.kernel.reference(x))
        s_log, s_lin = max(s_log, d[0]), max(s_lin, d[1])
        got, want = plp.kernel(x), plp.kernel.reference(x)
        p_mel = max(p_mel, float(((got - want).abs() / want).max()))
        p_plp = max(p_plp, plp_diff(plp.from_mel(got, le),
                                    plp.from_mel(want, le)))
    spec.kernel.launches = plp.kernel.launches = 0
    print(f"features: Spectrogram (257 one-bin filters) and Plp (23 bins, "
          f"LPC order 12, 13 cepstra) on the card: {len(waves)} waveforms, "
          f"{frames} frames, {wall:.3f} s for both computers; fbank launches "
          f"{launches[0]} + {launches[1]}")
    print(f"features: kernel vs plain on the card: spectrogram max |Δ log "
          f"power| {s_log:.3e} on bins ≥ {SPEC_SHARE:g} of the frame's "
          f"largest (limit {SPEC_LOG_TOL:g}), max |Δ power| / largest "
          f"{s_lin:.3e} (limit {SPEC_LIN_TOL:g}); PLP mel energies max "
          f"relative {p_mel:.3e}, PLP max |Δ| / (1 + |plain|) {p_plp:.3e} "
          f"(limit {PLP_TOL:g})")
    # the whole computers against the port's CPU ones
    c_log = c_lin = c_plp = c_e = 0.0
    for w, s, p in zip(waves, specs, plps):
        want = spec_cpu.compute(w)
        d = spectra_diff(s[:, 1:], want[:, 1:])
        c_log, c_lin = max(c_log, d[0]), max(c_lin, d[1])
        c_e = max(c_e, float((s[:, 0].cpu() - want[:, 0]).abs().max()))
        c_plp = max(c_plp, plp_diff(p, plp_cpu.compute(w)))
    if not c_e <= 1e-4:
        raise AssertionError(f"spectrogram energy column: {c_e}")
    print(f"features: card vs the port's CPU computers: spectrogram max "
          f"|Δ log power| {c_log:.3e}, |Δ power| / largest {c_lin:.3e}, "
          f"energy column {c_e:.3e} (limit 1e-4); PLP max |Δ| / (1 + "
          f"|cpu|) {c_plp:.3e}")
    # the identity-filter kernel at 4096 frames
    k = spec.kernel
    raw = torch.from_numpy((1000.0 * np.random.default_rng(SEED + 11)
                            .standard_normal((4096, k.win_size)))
                           .astype(np.float32)).to(dev)
    x = preprocess_frames(raw, spec.frame_opts)[0].contiguous()
    err = spectra_diff(k(x), k.reference(x))
    times = {"plain": [], "kernel": []}
    for which in ("plain", "kernel", "kernel", "plain"):
        times[which].append(device_ms(
            (lambda: k.reference(x)) if which == "plain" else
            (lambda: k(x)), 50))
    ms, plain_ms = min(times["kernel"]), min(times["plain"])
    bnd = fbank_bound(k, x.shape[0])
    k.launches = 0
    print(f"features: identity-filter fbank, 4096 frames: kernel vs plain "
          f"max |Δ log power| {err[0]:.3e}, |Δ power| / largest "
          f"{err[1]:.3e}; on the card kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms (best of 2 × 50), bound {bnd[0]:.4f} ms by "
          f"{bnd[1]} ({100 * bnd[0] / ms:.1f}% of it); {len(k.groups)} "
          f"groups {tag}")
    return sum(launches)


def batched_frontend(dev, tag: str):
    """9b: BatchedFrontend on BATCH_B seeded waveforms of BATCH_SECONDS,
    MFCC + CMN + Δ+ΔΔ and 40-bin fbank, under sync debug mode "error",
    one fbank launch a call; each utterance equal to the per-utterance
    computers on the card.  → (the waves on the card, the MFCC
    frontend, its features, fbank launches, max |Δ log-mel| of the
    kernel at the batch's frames)."""
    from kaldi_tpu_torch.features import (BatchedFrontend,
                                          DeltaFeaturesOptions, Fbank,
                                          FbankOptions, FrameExtractionOptions,
                                          MelBanksOptions, Mfcc, MfccOptions,
                                          add_deltas)
    from kaldi_tpu_torch.features.compute import compute_lifter_coeffs
    from kaldi_tpu_torch.features.window import preprocess_frames
    from kaldi_tpu_torch.tools.timing import device_ms, fbank_bound
    fo = FrameExtractionOptions(dither=0.0)
    mo = MfccOptions(frame_opts=fo)
    bo = MfccOptions(frame_opts=fo, mel_opts=MelBanksOptions(num_bins=40))
    fe_m = BatchedFrontend(mo, "mfcc", DeltaFeaturesOptions(), cmn=True,
                           device=dev)
    fe_f = BatchedFrontend(bo, "fbank", device=dev)
    waves = synth_waveforms(np.random.default_rng(SEED + 10), BATCH_B,
                            (BATCH_SECONDS, BATCH_SECONDS))
    W = torch.from_numpy(np.stack(waves)).to(dev)
    fe_m(W[:2])                                            # warm
    fe_f(W[:2])
    torch.cuda.synchronize()
    fe_m.kernel.launches = fe_f.kernel.launches = 0
    torch.cuda.set_sync_debug_mode("error")
    fm = fe_m(W)
    ff = fe_f(W)
    torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    launches = (fe_m.kernel.launches, fe_f.kernel.launches)
    B, T = BATCH_B, fe_m.num_frames(W.shape[1])
    if launches != (1, 1):
        raise AssertionError(f"batched frontend fbank launches {launches}")
    if fm.shape != (B, T, 39) or ff.shape != (B, T, 40) or \
            not bool(torch.isfinite(fm).all() and torch.isfinite(ff).all()):
        raise AssertionError(f"batched features {tuple(fm.shape)}, "
                             f"{tuple(ff.shape)}")
    print(f"features: BatchedFrontend, {B} waveforms of {BATCH_SECONDS:g} s "
          f"({B} × {T} = {B * T} frames): MFCC + CMN + Δ+ΔΔ {tuple(fm.shape)}"
          f" and 40-bin fbank {tuple(ff.shape)} under sync debug mode "
          f"'error': no host sync; fbank launches {launches[0]} and "
          f"{launches[1]}, one a call")
    # each utterance against the per-utterance computers on the card
    # (launches here are not counted)
    tol = torch.from_numpy(np.tile(4e-3 * compute_lifter_coeffs(22.0, 13),
                                   3)).to(dev)
    mfcc = Mfcc(mo, device=dev)
    fbank = Fbank(FbankOptions(frame_opts=fo, mel_opts=bo.mel_opts),
                  device=dev)
    m_share = f_err = 0.0
    for b, w in enumerate(waves):
        raw = mfcc.compute(w)
        want = add_deltas(raw - raw.mean(dim=0, keepdim=True))
        m_share = max(m_share, float(((fm[b] - want).abs() / tol).max()))
        f_err = max(f_err, float((ff[b] - fbank.compute(w)).abs().max()))
    if not (m_share <= 1.0 and f_err <= 2e-3):
        raise AssertionError(f"batched vs per-utterance: MFCC {m_share} of "
                             f"the bar, fbank {f_err}")
    print(f"features: each utterance equals the per-utterance computers on "
          f"the card: MFCC + CMN + Δ+ΔΔ at most {m_share:.3f} of 4e-3·lifter"
          f"_k, fbank max |Δ log-mel| {f_err:.3e} (limit 2e-3)")
    ms_m = device_ms(lambda: fe_m(W), 5)
    ms_f = device_ms(lambda: fe_f(W), 5)
    # the kernel alone at the batch's frames, against its plain version
    k = fe_f.kernel
    x = preprocess_frames(W.unfold(1, fo.window_size, fo.window_shift)
                          .reshape(-1, fo.window_size), fo)[0].contiguous()
    err = float((k(x) - k.reference(x)).abs().max())
    if not err <= 2e-3:
        raise AssertionError(f"fbank kernel disagrees at {x.shape[0]} "
                             f"frames: {err}")
    times = {"plain": [], "kernel": []}
    for which in ("plain", "kernel", "kernel", "plain"):
        times[which].append(device_ms(
            (lambda: k.reference(x)) if which == "plain" else
            (lambda: k(x)), 10))
    ms, plain_ms = min(times["kernel"]), min(times["plain"])
    bnd = fbank_bound(k, x.shape[0])
    fe_m.kernel.launches = fe_f.kernel.launches = 0
    print(f"features: a batch on the card: MFCC + CMN + Δ+ΔΔ {ms_m:.4f} ms "
          f"({B * T / ms_m * 1e3:.0f} frames/s), 40-bin fbank {ms_f:.4f} ms "
          f"({B * T / ms_f * 1e3:.0f} frames/s) {tag}")
    print(f"features: fbank kernel (40 bins) at {x.shape[0]} frames: vs "
          f"plain max |diff| {err:.3e}; kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms (best of 2 × 10), bound {bnd[0]:.4f} ms by "
          f"{bnd[1]} ({100 * bnd[0] / ms:.1f}% of it) {tag}")
    return W, fe_m, fm, sum(launches), err


def gmm_provider(dev, W, fe, feats, tag: str):
    """9c: GmmDecodableProvider at the tri1 width on 9b's batch: one
    fbank and one GMM launch a call, under sync debug mode "error"; equal
    to the plain GMM on the card.  → (GMM launches, fbank launches, max
    |diff|)."""
    from kaldi_tpu_torch.features import GmmDecodableProvider
    from kaldi_tpu_torch.tools.synth import mix_counts, seeded_gmm
    from kaldi_tpu_torch.tools.timing import device_ms, gmm_bound
    x = feats.reshape(-1, feats.shape[2]).contiguous()
    xs = x.double().cpu().numpy()
    rng = np.random.default_rng(SEED + 12)
    am = seeded_gmm(rng, mix_counts(rng, TRI1_PDFS, TRI1_GAUSS, 2, 10),
                    xs.mean(axis=0), xs.var(axis=0), spread=1.0, device=dev)
    prov = GmmDecodableProvider(fe, am)
    k = am.device_params()
    prov(W[:2])                                             # warm
    torch.cuda.synchronize()
    k.launches = fe.kernel.launches = 0
    torch.cuda.set_sync_debug_mode("error")
    ll = prov(W)
    torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    launches = (k.launches, fe.kernel.launches)
    if launches != (1, 1):
        raise AssertionError(f"provider launches (GMM, fbank) {launches}")
    B, T = feats.shape[:2]
    if ll.shape != (B, T, TRI1_PDFS) or not bool(torch.isfinite(ll).all()):
        raise AssertionError(f"provider output {tuple(ll.shape)}")
    want = k.reference(x)
    diff = (ll.reshape(-1, TRI1_PDFS) - want).abs()
    share = float((diff / (GMM_TOL + GMM_TOL * want.abs())).max())
    err = float(diff.max())
    if not share <= 1.0:
        raise AssertionError(f"provider vs plain GMM: {share} of the bar")
    times = {"plain": [], "kernel": []}
    for which in ("plain", "kernel", "kernel", "plain"):
        times[which].append(device_ms(
            (lambda: k.reference(x)) if which == "plain" else
            (lambda: k(x)), 5))
    ms, plain_ms = min(times["kernel"]), min(times["plain"])
    bnd = gmm_bound(k, x.shape[0])
    k.launches = fe.kernel.launches = 0
    print(f"features: GmmDecodableProvider at the tri1 width ({am.num_pdfs} "
          f"pdfs, {am.num_gauss()} Gaussians in {am.max_mix} slots, D="
          f"{am.dim}) on the batch: {tuple(ll.shape)} under sync debug mode "
          f"'error'; GMM launches {launches[0]}, fbank launches "
          f"{launches[1]}; vs plain max |diff| {err:.3e}, at most "
          f"{share:.3f} of the limit {GMM_TOL:g} + {GMM_TOL:g}·|plain|")
    print(f"features: GMM kernel (tri1) at {x.shape[0]} frames: kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms (best of 2 × 5), bound "
          f"{bnd[0]:.4f} ms by {bnd[1]} ({100 * bnd[0] / ms:.1f}% of it) "
          f"{tag}")
    return launches + (err,)


def feature_cli(dev, waves, tag: str) -> int:
    """9d: ``python -m kaldi_tpu_torch.cli`` on 4 waveforms' wav ark:
    compute-mfcc-feats | compute-cmvn-stats | apply-cmvn | add-deltas,
    and compute-plp-feats, compute-spectrogram-feats and
    compute-and-process-kaldi-pitch-feats beside it, each output against
    the library call in this run.  → the tools' fbank launches (their
    logs' counts)."""
    import re
    import subprocess
    from kaldi_tpu_torch.core.table import SequentialTableReader, TableWriter
    from kaldi_tpu_torch.features import (Mfcc, Plp, Spectrogram, add_deltas,
                                          apply_cmvn, compute_cmvn_stats)
    from kaldi_tpu_torch.features.pitch import (compute_kaldi_pitch,
                                                process_pitch)
    repo = os.path.dirname(os.path.abspath(__file__))
    d = os.path.join(repo, "build", "chip_smoke_features")
    os.makedirs(d, exist_ok=True)
    waves = [np.clip(w, -32768, 32767).astype(np.int16) for w in waves[:4]]
    with TableWriter(f"ark:{d}/wav.ark", holder="wav") as w:
        for i, x in enumerate(waves):
            w[f"utt{i}"] = (x, SAMP_FREQ)
    cli = f"{sys.executable} -m kaldi_tpu_torch.cli"
    cmds = {
        "mfcc": f"{cli} compute-mfcc-feats --device=cuda ark:{d}/wav.ark "
                f"ark:{d}/mfcc.ark && {cli} compute-cmvn-stats --device=cuda "
                f"ark:{d}/mfcc.ark ark:{d}/cmvn.ark && {cli} apply-cmvn "
                f"--device=cuda ark:{d}/cmvn.ark ark:{d}/mfcc.ark ark:- | "
                f"{cli} add-deltas --device=cuda ark:- ark:{d}/deltas.ark",
        "plp": f"{cli} compute-plp-feats --device=cuda ark:{d}/wav.ark "
               f"ark:{d}/plp.ark",
        "spectrogram": f"{cli} compute-spectrogram-feats --device=cuda "
                       f"ark:{d}/wav.ark ark:{d}/spec.ark",
        "pitch": f"{cli} compute-and-process-kaldi-pitch-feats "
                 f"ark:{d}/wav.ark ark:{d}/pitch.ark"}
    t0 = time.perf_counter()
    procs = {n: subprocess.Popen(["bash", "-o", "pipefail", "-c", c],
                                 cwd=repo, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)
             for n, c in cmds.items()}
    logs = {}
    for n, p in procs.items():
        out, err = p.communicate(timeout=600)
        if p.returncode != 0:
            raise AssertionError(f"{n} tools failed ({p.returncode}):\n"
                                 f"{err[-3000:]}")
        logs[n] = err
    wall = time.perf_counter() - t0
    launches = sum(int(m) for err in logs.values()
                   for m in re.findall(r"fbank kernel launches (\d+)", err))
    if launches != 3 * len(waves):
        raise AssertionError(f"feature tools' fbank launches {launches}")

    def read(name):
        return dict(SequentialTableReader(f"ark:{d}/{name}.ark"))

    # the library calls on the same waveforms (launches not counted)
    mfcc, plp, spec = Mfcc(device=dev), Plp(device=dev), Spectrogram(
        device=dev)
    got = {n: read(n) for n in ("deltas", "plp", "spec", "pitch")}
    err = {"deltas": 0.0, "plp": 0.0, "spec": 0.0, "pitch": 0.0}
    for i, x in enumerate(waves):
        key, xf = f"utt{i}", x.astype(np.float32)
        raw = mfcc.compute(xf)
        lib = {"deltas": add_deltas(apply_cmvn(raw, compute_cmvn_stats(raw))),
               "plp": plp.compute(xf), "spec": spec.compute(xf),
               "pitch": process_pitch(compute_kaldi_pitch(xf))}
        for n, want in lib.items():
            want = np.asarray(want.cpu() if torch.is_tensor(want) else want)
            if got[n][key].shape != want.shape:
                raise AssertionError(f"{n} {key}: {got[n][key].shape} vs "
                                     f"{want.shape}")
            err[n] = max(err[n], float(np.abs(got[n][key] - want).max()))
    # binary archives carry float32 exactly, and the tools run the same
    # kernel on the same frames as the library: 1e-5; pitch is host
    # numpy: equal
    if not (max(err["deltas"], err["plp"], err["spec"]) <= 1e-5
            and err["pitch"] == 0.0):
        raise AssertionError(f"feature tools vs library: {err}")
    print(f"features: python -m kaldi_tpu_torch.cli on {len(waves)} "
          f"waveforms: compute-mfcc-feats | compute-cmvn-stats | apply-cmvn "
          f"| add-deltas, compute-plp-feats, compute-spectrogram-feats "
          f"(--device=cuda) and compute-and-process-kaldi-pitch-feats, in "
          f"{wall:.2f} s (7 processes, 4 at a time); each output vs the "
          f"library call max |diff|: "
          + ", ".join(f"{n} {e:.3e}" for n, e in err.items())
          + f" (limit 1e-5; pitch 0); fbank launches {launches} {tag}")
    return launches


def wide_banks(dev, x, tag: str):
    """3, wide banks: at 16 kHz a bank of 15 or 17 bins has filters wider
    than a group holds; the kernel on their pieces plus the pieces' sum
    against the plain version on phase 3's 4096 frames (launches here
    are not counted), both timed; then the wide-bank path: Fbank (17
    bins) and Mfcc (15 bins) on 4 seeded waveforms, its count at 0 just
    before.  → (max |diff|, 17-bin ms, plain ms, bound, launches of the
    pair on the path)."""
    from kaldi_tpu_torch.features.compute import (Fbank, FbankOptions, Mfcc,
                                                  MfccOptions)
    from kaldi_tpu_torch.features.mel import MelBanksOptions
    from kaldi_tpu_torch.features.window import FrameExtractionOptions
    from kaldi_tpu_torch.ops.fbank import CudaFbank, fbank_reference
    from kaldi_tpu_torch.tools.timing import device_ms, fbank_bound
    err = 0.0
    for nb in (15, 17):
        k = CudaFbank(FrameExtractionOptions(), MelBanksOptions(num_bins=nb),
                      dev)

        def plain():
            return fbank_reference(x, k.window, k.cos, k.sin, k.mel)

        d = float((k(x) - plain()).abs().max())
        torch.cuda.synchronize()
        times = {"plain": [], "kernel": []}
        for which in ("plain", "kernel", "kernel", "plain"):
            times[which].append(device_ms(plain if which == "plain"
                                          else lambda: k(x), 50))
        ms, plain_ms = min(times["kernel"]), min(times["plain"])
        bnd = fbank_bound(k, x.shape[0])
        print(f"fbank: 16 kHz, {nb} bins (widest filter "
              f"{int((k.mel != 0).sum(0).max())} DFT bins, cut into "
              f"{k.n_cols} pieces): kernel + piece sum vs plain on 4096 "
              f"frames: max |diff| {d:.3e} (limit 2e-3); on the card "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms (best of 2 × 50), "
              f"bound {bnd[0]:.4f} ms by {bnd[1]} "
              f"({100 * bnd[0] / ms:.1f}% of it) {tag}")
        if not d <= 2e-3:
            raise AssertionError(f"wide-bank fbank disagrees: {d}")
        err = max(err, d)
    waves = synth_waveforms(np.random.default_rng(SEED + 3), 4)
    fbank = Fbank(FbankOptions(mel_opts=MelBanksOptions(num_bins=17)),
                  device=dev)
    mfcc = Mfcc(MfccOptions(mel_opts=MelBanksOptions(num_bins=15),
                            num_ceps=13, use_energy=False), device=dev)
    CudaFbank.total_sum_launches = 0
    for w in waves:
        fbank.compute(w)
        mfcc.compute(w)
    torch.cuda.synchronize()
    launches = CudaFbank.total_sum_launches
    if launches != 2 * len(waves):
        raise AssertionError(f"wide-bank path launches {launches}")
    err = max(err, check_path_fbank(mfcc, waves, "fbank 16 kHz 15 bins"),
              check_path_fbank(fbank, waves, "fbank 16 kHz 17 bins"))
    return err, ms, plain_ms, bnd, launches


# ---------------------------------------------------------------------------
# 10. GMM training and the GMM recipes
# ---------------------------------------------------------------------------

def zero_totals() -> None:
    """Every instance's launch counts to 0 (a recipe makes its own fbank
    computers, den graph and GMM tables, the last after every update)."""
    from kaldi_tpu_torch.ops.chain_den import CudaChainDen
    from kaldi_tpu_torch.ops.fbank import CudaFbank
    from kaldi_tpu_torch.ops.gmm import CudaGmm
    CudaFbank.total_launches = CudaFbank.total_sum_launches = 0
    CudaGmm.total_launches = CudaChainDen.total_launches = 0


def totals():
    """(fbank launches, GMM launches) of every instance."""
    from kaldi_tpu_torch.ops.fbank import CudaFbank
    from kaldi_tpu_torch.ops.gmm import CudaGmm
    return CudaFbank.total_launches, CudaGmm.total_launches


def training_recorder(noise: float = 0.0, seed: int = 0):
    """A train_mono/train_tri report that keeps each iteration's loglike
    per frame and alignments; with ``noise``, it then scales each entry
    of the accumulators the update reads by 1 + noise·N(0, 1), drawn
    from ``seed``."""
    rec = {"ll": [], "ali": []}
    rng = np.random.default_rng(seed)

    def report(it, ali, accs):
        rec["ll"].append(accs.tot_like / accs.tot_frames)
        rec["ali"].append({u: list(t) for u, t in ali.items()})
        for a in (accs.occ, accs.mean_acc, accs.var_acc):
            if noise:
                a *= 1.0 + noise * rng.standard_normal(a.shape)

    return rec, report


def equal_share(x, y) -> float:
    """The share of frames two alignments (utt → tids) give equal tids."""
    same = sum(int(p == q) for u in x for p, q in zip(x[u], y[u]))
    return same / sum(len(x[u]) for u in x)


def drift(a, b, iters):
    """(relative difference of the last loglike per frame, per iteration
    in ``iters`` the share of frames with equal alignments) between two
    training records."""
    return (abs(a["ll"][-1] - b["ll"][-1]) / abs(b["ll"][-1]),
            [equal_share(a["ali"][it], b["ali"][it]) for it in iters])


# 10a's bar for the card's training run against the CPU's: the larger of
# 0.05% (final loglike per frame) and YESNO_SLACK times the largest drift
# that the CPU run shows against itself in YESNO_DRAWS runs whose float32
# accumulators are scaled by 1 + 1e-6·N(0, 1) (the size of a
# summation-order difference, which mix-up's and the alignments'
# discrete choices amplify over the iterations), and the smaller of 99%
# and 1 - YESNO_SLACK times those runs' largest unequal share of frames,
# at each realignment
YESNO_SLACK = 2.0
YESNO_DRAWS = 3


def yesno_recipe(dev, tag: str):
    """10a: the yesno recipe at its own settings on the card, then the
    same on the port's CPU, unperturbed and with its accumulators
    perturbed at the scale of float32 rounding.  → (fbank launches, GMM
    launches, the system the card built)."""
    from kaldi_tpu_torch.am.gmm import AmDiagGmm
    from kaldi_tpu_torch.decoder.align import (DenseAligner,
                                               pack_training_graphs)
    from kaldi_tpu_torch.decoder.training_graph import TrainingGraphCompiler
    from kaldi_tpu_torch.pipelines import yesno
    from kaldi_tpu_torch.pipelines.decode import decode_gmm
    from kaldi_tpu_torch.pipelines.mono import MonoTrainConfig, realign
    rec, report = training_recorder()
    zero_totals()
    t0 = time.perf_counter()
    res, sysm = yesno.run(device=dev, report=report, return_system=True)
    m = sysm["model"]
    tr = decode_gmm(sysm["train_feats"], m.am, m.tm, sysm["HCLG"],
                    sysm["lang"], sysm["dcfg"], refs=sysm["train"].text,
                    device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fb, gm = totals()
    print(f"yesno: {len(sysm['train'].utts)} train / "
          f"{len(sysm['test'].utts)} test utterances, 12 iterations, "
          f"{m.am.num_gauss()} Gaussians: test {res.wer}; train {tr.wer}; "
          f"{wall:.1f} s on the card (features, training, graph, both "
          f"decodes); fbank launches {fb}, GMM launches {gm} {tag}")
    print("yesno: loglike per frame by iteration (card): "
          + " ".join(f"{v:.4f}" for v in rec["ll"]))
    if not (res.wer.wer == 0.0 and tr.wer.wer == 0.0):
        raise AssertionError(f"yesno WER test {res.wer} train {tr.wer}")
    if min(fb, gm) <= 0:
        raise AssertionError(f"yesno launches: fbank {fb}, GMM {gm}")

    # one step, the same model: the card's realignment of the train set
    # (the GMM kernel, the aligner on the card) against the CPU's
    feats, utts = sysm["train_feats"], sysm["train"].utts
    compiler = TrainingGraphCompiler(sysm["lang"], m.tm)
    dense = dict(zip(utts, pack_training_graphs(
        [compiler.compile_text(sysm["train"].text[u]) for u in utts])))
    got = realign(m.am, DenseAligner(m.tm.tid_to_pdf_array, device=dev),
                  dense, utts, feats)
    cpu_am = AmDiagGmm(m.am.weights, m.am.means, m.am.vars, device="cpu")
    want = realign(cpu_am, DenseAligner(m.tm.tid_to_pdf_array,
                                        device="cpu"), dense, utts, feats)
    one = equal_share(got, want)

    realigns = MonoTrainConfig(realign_iters=tuple(range(1, 12, 2))) \
        .realign_iters
    crec, creport = training_recorder()
    t0 = time.perf_counter()
    cres = yesno.run(device="cpu", report=creport)
    cwall = time.perf_counter() - t0
    rel, shares = drift(rec, crec, realigns)
    p_rel, p_shares = 0.0, [1.0] * len(realigns)
    for k in range(YESNO_DRAWS):
        prec, preport = training_recorder(noise=1e-6, seed=SEED + 12 + k)
        yesno.run(device="cpu", report=preport)
        d, sh = drift(prec, crec, realigns)
        p_rel, p_shares = max(p_rel, d), [min(a, b) for a, b in
                                          zip(p_shares, sh)]
    ll_bar = max(5e-4, YESNO_SLACK * p_rel)
    ali_bars = [min(0.99, 1.0 - YESNO_SLACK * (1.0 - x)) for x in p_shares]
    print(f"yesno: the port's CPU run ({cwall:.1f} s): test {cres.wer}; "
          f"final loglike per frame {crec['ll'][-1]:.5f} vs card "
          f"{rec['ll'][-1]:.5f}: {rel:.2e} relative (bar {ll_bar:.2e}); "
          f"frames with equal alignments at realignments {list(realigns)}: "
          + " ".join(f"{100 * x:.2f}%" for x in shares) + " (bars "
          + " ".join(f"{100 * x:.2f}%" for x in ali_bars) + ")")
    print(f"yesno: the CPU run against itself with its accumulators scaled "
          f"by 1 + 1e-6·N(0, 1), worst of {YESNO_DRAWS} draws: final "
          f"loglike per frame {p_rel:.2e} relative; equal alignments "
          + " ".join(f"{100 * x:.2f}%" for x in p_shares)
          + f"; one realignment of the train set by the trained model, "
          f"card vs CPU: {100 * one:.3f}% of frames equal (limit 99.9%)")
    if not (cres.wer.wer == res.wer.wer and rel <= ll_bar and one >= 0.999
            and all(x >= b for x, b in zip(shares, ali_bars))):
        raise AssertionError("yesno: card and CPU runs disagree")
    return fb, gm, sysm


# 10b's corpus: the GMM stages of kaldi_tpu/pipelines/ladder.py ``run``
# at its defaults (100 / 30 utterances, the confusable lexicon, noise and
# speaker warp 0.12, held-out test speakers, coarticulation 0.35, 30
# leaves / 600 Gaussians, 5 / 3 speakers).  At mini.run's own defaults
# mono already scores 0.00 and the original fails its exit rule (ROADMAP
# Queue 3).
MINI_LADDER = dict(num_utts=100, num_test=30, seed=1, noise=0.12,
                   speaker_warp=0.12, heldout_speakers=True,
                   coarticulation=0.35, tri_leaves=30, tri_gauss=600,
                   num_speakers=5, num_test_speakers=3)


def mini_recipe(dev, tag: str):
    """10b: the mini_librispeech ladder (mini.run) on the ladder's hard
    corpus on the card.  → (fbank launches, GMM launches)."""
    from kaldi_tpu_torch.pipelines import mini
    from kaldi_tpu_torch.pipelines.data import (confusable_formants,
                                                confusable_lexicon)
    stamps = {}

    def report(stage, it, ali, accs):
        stamps.setdefault(stage, []).append(
            (time.perf_counter(), accs.tot_like / accs.tot_frames))

    zero_totals()
    t0 = time.perf_counter()
    wers = mini.run(lexicon=confusable_lexicon(),
                    formants=confusable_formants(), device=dev,
                    report=report, **MINI_LADDER)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fb, gm = totals()
    prev = t0
    for stage, marks in stamps.items():
        print(f"mini: {stage}: {len(marks)} iterations, final loglike per "
              f"frame {marks[-1][1]:.4f}; {marks[-1][0] - prev:.1f} s from "
              f"the previous stage's last iteration (its decode, this "
              f"stage's set-up and training)")
        prev = marks[-1][0]
    print(f"mini: " + "; ".join(f"{k} {v}" for k, v in wers.items()))
    print(f"mini: {wall:.1f} s on the card for the four stages and their "
          f"decodes; fbank launches {fb}, GMM launches {gm} {tag}")
    # the ladder's rule: a task mono does not solve, and tri3b no worse
    if not (0 < wers["mono"].wer and wers["tri3b"].wer <= wers["mono"].wer):
        raise AssertionError(f"mini: mono {wers['mono']}, tri3b "
                             f"{wers['tri3b']}")
    if min(fb, gm) <= 0:
        raise AssertionError(f"mini launches: fbank {fb}, GMM {gm}")
    return fb, gm


def tri3b_training(dev, task, tag: str):
    """10c: accumulation, the MLE update and mix-up at the tri3b width,
    then the forced aligner over 32 utterances of ``task``.  → (ms of
    accumulate_stats on the card, ms of the align batch, launches per
    aligner frame)."""
    from kaldi_tpu_torch.am.gmm import (AmDiagGmm, GmmAccs, accumulate_stats,
                                        accumulate_stats_device, mixup,
                                        mle_update)
    from kaldi_tpu_torch.decoder.align import DenseAligner
    from kaldi_tpu_torch.tools.synth import (align_workload, model_frames,
                                             tri3b_gmm)
    from kaldi_tpu_torch.tools.timing import cuda_ms, device_ms, profiled
    rng = np.random.default_rng(SEED + 10)
    am = tri3b_gmm(rng, 2500, 15000, device=dev)
    T = 32768
    feats, pdfs = model_frames(am, rng, T)
    cpu = AmDiagGmm(am.weights, am.means, am.vars, device="cpu")
    got, want = (GmmAccs.zeros(am.num_pdfs, am.max_mix, am.dim)
                 for _ in range(2))
    accumulate_stats(am, feats, pdfs, got)
    accumulate_stats(cpu, feats, pdfs, want)
    worst = 0.0
    for name in ("occ", "mean_acc", "var_acc"):
        g, w = getattr(got, name), getattr(want, name)
        worst = max(worst, float((np.abs(g - w) / (1e-4 * np.abs(w) + 1e-4
                                 * np.abs(w).max())).max()))
    like = abs(got.tot_like - want.tot_like) / abs(want.tot_like)
    x = torch.from_numpy(feats).to(dev)
    p = torch.from_numpy(pdfs).to(dev)
    acc_ms = device_ms(lambda: accumulate_stats_device(am, x, p), 5)
    # the sums by pdf need no host sync, and two calls sum in one order
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    runs = [accumulate_stats_device(am, x, p) for _ in range(2)]
    torch.cuda.set_sync_debug_mode(0)
    if not all(torch.equal(a, b) for a, b in zip(*runs)):
        raise AssertionError("accumulate_stats_device: two calls differ")
    print("train: accumulate_stats_device ran twice under sync debug mode "
          "'error': no host sync, the two calls equal to the bit")
    print(f"train: accumulate_stats at the tri3b width ({am.num_pdfs} pdfs, "
          f"{am.num_gauss()} Gaussians, D={am.dim}) over {T} frames: card vs "
          f"the port's CPU accumulators at most {worst:.3f} of the limit "
          f"1e-4·|cpu| + 1e-4·max|cpu|, tot_like {like:.2e} relative "
          f"(limit 1e-4); {acc_ms:.4f} ms on the card "
          f"({T / acc_ms * 1e3:.0f} frames/s) {tag}")
    if not (worst <= 1.0 and like <= 1e-4):
        raise AssertionError("accumulate_stats: card and CPU disagree")
    t0 = time.perf_counter()
    mle_update(am, got)
    t1 = time.perf_counter()
    n_live = am.num_gauss()
    am = mixup(am, 18000)
    t2 = time.perf_counter()
    # the model's tables follow the update and the mix-up: its kernel
    # output equals that of a model built afresh from its parameters
    ll = am.loglikes(x[:4096])
    fresh = AmDiagGmm(am.weights, am.means, am.vars,
                      device=dev).loglikes(x[:4096])
    same = bool(torch.equal(ll, fresh))
    # mle_update zeroes the weight of a Gaussian that took no frames
    # (about e^-2.2 of them at 2.2 frames a Gaussian); mixup, as the
    # original's, then fills slots by the count of live ones, and a
    # split can land on a live slot above such a hole (ROADMAP Queue 3)
    print(f"train: mle_update {1e3 * (t1 - t0):.1f} ms ({n_live} Gaussians "
          f"kept), mixup toward 18000: {am.num_gauss()} Gaussians "
          f"({am.max_mix} slots) {1e3 * (t2 - t1):.1f} ms on the host; the "
          f"GMM kernel on the mixed-up model's tables "
          f"{'equals' if same else 'DIFFERS from'} a fresh model's")
    if not (n_live < am.num_gauss() <= 18000 and same):
        raise AssertionError("mixup at the tri3b width")

    graphs, lls, tm = align_workload(task, 32, SEED + 11)
    want = DenseAligner(tm.tid_to_pdf_array, device="cpu").align_batch(
        graphs, lls)
    al = DenseAligner(tm.tid_to_pdf_array, device=dev)
    batch = al.prepare(graphs, lls)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    tids, _ = al.align_device(batch)
    torch.cuda.set_sync_debug_mode(0)
    got = al.align_batch(graphs, lls)
    tids = tids.cpu().numpy()
    for b, ((gt, gc), (wt, wc)) in enumerate(zip(got, want)):
        if gt != wt or tids[b][:len(wt)].tolist() != wt \
                or abs(gc - wc) > 1e-4 * abs(wc):
            raise AssertionError(f"aligner utt {b}: card and CPU differ")
    T_max = batch["loglikes"].shape[1]
    frames = sum(len(w[0]) for w in want)
    align_ms = cuda_ms(lambda: al.align_device(batch), 3)
    wall, n_k, busy, _ = profiled(
        lambda: (al.align_device(batch), torch.cuda.synchronize()))
    print(f"train: DenseAligner, 32 sentences of phase 6c's 300-word task "
          f"({frames} frames, T_max {T_max}, "
          f"{batch['e_src'].shape[1]} padded states, ε depth "
          f"{batch['eps_depth']}): tids equal the port's CPU aligner's on "
          f"the same log-likelihoods, costs within 1e-4; the frame loop "
          f"and backtrace ran under sync debug mode 'error'; "
          f"{align_ms:.1f} ms a batch ({frames / align_ms * 1e3:.0f} "
          f"frames/s); {n_k} kernels, {n_k / T_max:.1f} a frame, "
          f"{100 * busy / wall:.1f}% busy under the profiler {tag}")
    return acc_ms, align_ms, n_k / T_max


def gmm_tools_start(dev, sysm):
    """10d, started: the yesno train set's features, transcripts,
    lexicon and topology written by the port, then ``python -m
    kaldi_tpu_torch.cli`` gmm-init-mono | compile-train-graphs |
    align-equal-compiled | gmm-acc-stats-ali | gmm-est --mix-up |
    gmm-align-compiled in one background shell.  → (process, dir)."""
    import subprocess
    from kaldi_tpu_torch.am.serialize import write_topology
    from kaldi_tpu_torch.am.topology import HmmTopology
    from kaldi_tpu_torch.core import io as kio
    from kaldi_tpu_torch.core.table import TableWriter
    repo = os.path.dirname(os.path.abspath(__file__))
    d = os.path.join(repo, "build", "chip_smoke_gmm_tools")
    os.makedirs(d, exist_ok=True)
    train, feats = sysm["train"], sysm["train_feats"]
    with TableWriter(f"ark:{d}/feats.ark", holder="mat") as w:
        for u in train.utts:
            w[u] = feats[u]
    with TableWriter(f"ark:{d}/text.ark", holder="text") as w:
        for u in train.utts:
            w[u] = train.text[u]
    with open(f"{d}/lexicon.txt", "w") as f:
        for word, pron in sysm["lang"].lexicon.entries:
            f.write(f"{word} {' '.join(pron)}\n")
    with open(f"{d}/topo", "wb") as f:
        kio.init_kaldi_output_stream(f)
        write_topology(f, HmmTopology.three_state(sysm["lang"].phone_list()))
    dim = feats[train.utts[0]].shape[1]
    cli = f"{sys.executable} -m kaldi_tpu_torch.cli"
    steps = [
        f"gmm-init-mono --train-feats=ark:{d}/feats.ark "
        f"--perturb-factor=0.01 {d}/topo {dim} {d}/0.mdl {d}/tree",
        f"compile-train-graphs {d}/lexicon.txt {d}/0.mdl ark:{d}/text.ark "
        f"ark:{d}/graphs.ark",
        f"align-equal-compiled ark:{d}/graphs.ark ark:{d}/feats.ark "
        f"ark:{d}/ali0.ark",
        f"gmm-acc-stats-ali --device=cuda {d}/0.mdl ark:{d}/feats.ark "
        f"ark:{d}/ali0.ark {d}/0.acc",
        f"gmm-est --mix-up={GMM_TOOLS_GAUSS} {d}/0.mdl {d}/0.acc {d}/1.mdl",
        f"gmm-align-compiled --device=cuda {d}/1.mdl ark:{d}/graphs.ark "
        f"ark:{d}/feats.ark ark:{d}/ali1.ark"]
    proc = subprocess.Popen(
        ["bash", "-e", "-c", "\n".join(f"{cli} {s}" for s in steps)],
        cwd=repo, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return proc, d, time.perf_counter()


def gmm_tools_finish(dev, sysm, started, tag: str) -> int:
    """10d, checked: each tool's output against the library call on the
    same inputs in this run.  → the tools' GMM launches (their log)."""
    import re
    from kaldi_tpu_torch.am.gmm import (AmDiagGmm, GmmAccs, accumulate_stats,
                                        global_stats, mixup, mle_update)
    from kaldi_tpu_torch.am.serialize import read_mdl, write_mdl
    from kaldi_tpu_torch.cli.tools_extra import read_gmm_accs
    from kaldi_tpu_torch.core.table import SequentialTableReader
    from kaldi_tpu_torch.decoder.align import (DenseAligner,
                                               pack_training_graphs)
    from kaldi_tpu_torch.decoder.training_graph import (TrainingGraphCompiler,
                                                        equal_align)
    from kaldi_tpu_torch.pipelines.mono import realign
    proc, d, t0 = started
    _, err = proc.communicate(timeout=900)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"GMM tools failed ({proc.returncode}):\n"
                             f"{err[-3000:]}")
    launches = sum(int(n) for n in
                   re.findall(r"GMM kernel launches (\d+)", err))
    train, feats, lang = sysm["train"], sysm["train_feats"], sysm["lang"]
    utts = train.utts

    def ark(name, holder):
        return dict(SequentialTableReader(f"ark:{d}/{name}.ark",
                                          holder=holder))

    def same_model(tool, lib, tm):
        # the library's model through the same .mdl file format
        write_mdl(f"{d}/lib.mdl", tm, lib)
        _, lib = read_mdl(f"{d}/lib.mdl", device="cpu")
        return all(np.array_equal(getattr(tool, n), getattr(lib, n))
                   for n in ("weights", "means", "vars"))

    tm0, am0 = read_mdl(f"{d}/0.mdl", device=dev)
    gmean, gvar = global_stats(feats[u] for u in utts)
    ok = {"gmm-init-mono": same_model(am0, AmDiagGmm.flat_start(
        am0.num_pdfs, gmean, gvar, perturb=0.01, device="cpu"), tm0)}
    compiler = TrainingGraphCompiler(lang, tm0)
    graphs = {u: compiler.compile_text(train.text[u]) for u in utts}
    got = ark("graphs", "fst")
    def arcs(fst):
        # an archive carries float32 weights
        return [[(a.ilabel, a.olabel, np.float32(a.weight), a.nextstate)
                 for a in arcs] for arcs in fst.arcs]

    ok["compile-train-graphs"] = all(arcs(got[u]) == arcs(graphs[u])
                                     for u in utts)
    ali0 = ark("ali0", "ivec")
    ok["align-equal-compiled"] = all(
        list(ali0[u]) == equal_align(graphs[u], feats[u].shape[0])
        for u in utts)
    accs = GmmAccs.zeros(am0.num_pdfs, am0.max_mix, am0.dim)
    for u in utts:
        accumulate_stats(am0, feats[u], tm0.tid_to_pdf_array[
            np.asarray(ali0[u])], accs)
    tool_accs = read_gmm_accs(f"{d}/0.acc")
    ok["gmm-acc-stats-ali"] = all(
        np.allclose(getattr(tool_accs, n), getattr(accs, n), rtol=1e-5,
                    atol=1e-5 * np.abs(getattr(accs, n)).max())
        for n in ("occ", "mean_acc", "var_acc"))
    mle_update(am0, tool_accs)
    am1 = mixup(am0, GMM_TOOLS_GAUSS)
    tm1, tool_am1 = read_mdl(f"{d}/1.mdl", device=dev)
    ok["gmm-est --mix-up"] = same_model(tool_am1, am1, tm1) \
        and tool_am1.num_gauss() == GMM_TOOLS_GAUSS
    dense = dict(zip(utts, pack_training_graphs([graphs[u] for u in utts])))
    lib = realign(tool_am1, DenseAligner(tm1.tid_to_pdf_array, device=dev),
                  dense, utts, feats)
    ali1 = ark("ali1", "ivec")
    ok["gmm-align-compiled"] = all(list(ali1[u]) == lib[u] for u in utts)
    print(f"gmm tools: python -m kaldi_tpu_torch.cli on the yesno train set "
          f"({len(utts)} utterances), 6 processes in {wall:.1f} s (run "
          f"beside 10b and 10c): "
          + ", ".join(f"{n} {'equals' if v else 'DIFFERS from'} the library"
                      for n, v in ok.items())
          + f"; GMM launches {launches} {tag}")
    if not all(ok.values()) or launches <= 0:
        raise AssertionError(f"GMM tools vs library: {ok}, launches "
                             f"{launches}")
    return launches


# ---------------------------------------------------------------------------
# 11. the flagship LVCSR system, the hard corpus and the lattice tools
# ---------------------------------------------------------------------------

# r5's WERs were 0.84-3.95; a broken rung is far above this
FLAGSHIP_MAX_WER = 30.0
# the chain model on the card against the CPU: test utterances compared,
# the float32 bar of tests/test_torch_chain.py, and the best paths that
# must agree
CHAIN_CHECK_UTTS = 16
CHAIN_CHECK_TOL = 1e-4
CHAIN_CHECK_SAME = 15
# 11b: the hard corpus at HARDBENCH_r05's noise-1.0 point (20,000 words,
# noise 1.0, peak 4.0, up to 16 words) on 80 utterances (r5 ran 1200;
# cut so that the whole script, with its i-vector, RNNLM and lattice-
# supervision phases and every decode's card time, stays near its time
# budget), at the default
# and the loosest arc budget, both with escalation to 16384
HARD_TASK = dict(vocab=20000)
HARD_EVAL = dict(n_utts=80, noise=1.0, peak=4.0, max_words=16)
HARD_BUDGETS = (4096, 12288)
HARD_ESCALATE = 16384
# the module's own acceptance (pipelines/hard.py): the default budget
# loses less than this much oracle WER, absolute, against the loosest
HARD_ORACLE_LOSS = 0.1
# 11c: the tool chain's settings
TOOL_ACWT, TOOL_PENALTY, TOOL_BEAM = 0.8, 0.5, 8.0


# 11a's GMM bar.  The trained tri3b model on fMLLR features sums terms
# (gconst, x·μ/σ², ½x²/σ²) far larger than their result: float32 itself
# then holds the result only to about u·S, where S is the sum of the
# terms' magnitudes and u = 2^-24, and two float32 sums in other orders
# (the plain version, the kernel) differ by that much (PERF.md §7).  On
# the flagship's path both are held to the float64 value of the same
# function on the same float32 tables: within GMM_TOL + GMM_TOL·|f64| +
# 2^-18·S, S taken at the component that dominates the logsumexp; 2^-18
# = 64u covers 3xTF32's products (each about 3·2^-22 relative: the lo·lo
# product and the lo parts' own TF32 rounding are dropped) and the
# float32 sum of the 2D + 1 terms
GMM_TERMS_TOL = 2.0 ** -18


def check_path_loglikes_f64(am, xs, what: str) -> float:
    """11a: the GMM kernel and its plain version against the float64
    value of the same function on the model's float32 tables, on each
    utterance's features, at GMM_TERMS_TOL (launches here are not
    counted).  → the kernel's max |diff| from float64."""
    from kaldi_tpu_torch.ops.gmm import gmm_loglikes_reference
    k = am.device_params()
    d = {n: getattr(k, n).double() for n in ("gconst", "mean_invvar",
                                             "inv_var")}
    P, M, D = d["mean_invvar"].shape
    err, share, plain_share, plain_err = 0.0, 0.0, 0.0, 0.0
    for x in xs:
        x = torch.as_tensor(x, dtype=torch.float32).to(k.device)
        x64 = x.double()
        exact = gmm_loglikes_reference(x64, **d)
        comp = (x64 @ d["mean_invvar"].reshape(P * M, D).T
                - 0.5 * (x64 * x64) @ d["inv_var"].reshape(P * M, D).T
                ).reshape(-1, P, M) + d["gconst"][None]
        terms = ((x64.abs() @ d["mean_invvar"].abs().reshape(P * M, D).T
                  + 0.5 * (x64 * x64) @ d["inv_var"].abs().reshape(
                      P * M, D).T).reshape(-1, P, M)
                 + d["gconst"].abs()[None])
        S = torch.gather(terms, 2, comp.argmax(dim=2, keepdim=True))[..., 0]
        bar = GMM_TOL + GMM_TOL * exact.abs() + GMM_TERMS_TOL * S
        got, plain = k(x).double(), k.reference(x).double()
        err = max(err, float((got - exact).abs().max()))
        plain_err = max(plain_err, float((plain - exact).abs().max()))
        share = max(share, float(((got - exact).abs() / bar).max()))
        plain_share = max(plain_share,
                          float(((plain - exact).abs() / bar).max()))
    print(f"{what}: GMM kernel vs float64 on each utterance's features: max "
          f"|diff| {err:.3e}, at most {share:.3f} of the limit {GMM_TOL:g} + "
          f"{GMM_TOL:g}·|f64| + 2^-18·S (S the terms' magnitudes, up to "
          f"{float(S.max()):.3e}); the plain float32 version at most "
          f"{plain_share:.3f} of it; max |diff| from float64: kernel "
          f"{err:.3e}, plain float32 {plain_err:.3e} (kernel / plain "
          f"{err / max(plain_err, 1e-30):.2f})")
    if not share <= 1.0:
        raise AssertionError(f"{what}: GMM kernel disagrees on the path")
    return err


def den_unread_check(dev, den, P: int, B: int = 32, T: int = 17) -> float:
    """11a: the den kernels with the pdfs the graph never reads (those
    below P it skips, and one past P) scored 200 above every read pdf:
    log Z and the gradient on the read pdfs equal the plain version's
    (log space, which reads only the graph's pdfs) within 8a's bars, the
    unread pdfs' gradient 0.  → the gradient's max |diff|."""
    from kaldi_tpu_torch.am.chain import den_kernel, denominator_reference
    rng = np.random.default_rng(SEED + 11)
    k = den_kernel(den, dev)
    unread = k.unused_pdfs.tolist() + [P]
    scores = torch.from_numpy((2.0 * rng.standard_normal((B, T, P + 1)))
                              .astype(np.float32)).to(dev)
    scores[:, :, unread] = float(scores.max()) + 200.0
    mask = torch.ones((B, T), dtype=torch.bool, device=dev)
    s = scores.clone().requires_grad_(True)
    z = k(s, mask, CHAIN_LEAK)
    z.sum().backward()
    read = [p for p in range(P + 1) if p not in unread]
    sr = scores[:, :, read].clone().requires_grad_(True)
    zr = denominator_reference(den, _scatter(sr, read, P + 1), mask,
                               CHAIN_LEAK)
    zr.sum().backward()
    z, zr = z.detach(), zr.detach()
    dz = float(((z - zr).abs() / (DEN_LOGZ_ABS + DEN_LOGZ_REL * zr.abs()))
               .max())
    dg = float((s.grad[:, :, read] - sr.grad).abs().max())
    g_unread = float(s.grad[:, :, unread].abs().max())
    print(f"den: pdfs the graph never reads ({unread}) scored 200 above the "
          f"rest: log Z finite and at most {dz:.3f} of the limit, gradient "
          f"max |diff| {dg:.3e} on the read pdfs, {g_unread:g} on the "
          f"unread")
    if not (dz <= 1.0 and dg <= DEN_GRAD_TOL and g_unread == 0.0):
        raise AssertionError("den kernels: an unread pdf's score changes "
                             "log Z")
    return dg


def _scatter(x, cols, width):
    """(B, T, len(cols)) → (B, T, width) with x at ``cols``, 0 elsewhere
    (differentiable)."""
    out = x.new_zeros(x.shape[:2] + (width,))
    return out.index_copy(2, torch.tensor(cols, device=x.device), x)


def r05_flagship():
    """HARDBENCH_r05's flagship rows (a TPU run of the JAX package at
    11a's operating point): system → (WER, oracle WER, graph states)."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "HARDBENCH_r05.json")
    with open(path) as f:
        rows = json.load(f)["flagship"]
    return {r["system"]: (r["wer"], r.get("oracle_wer"),
                          r.get("graph_states")) for r in rows}


def flagship_system(dev, tag: str):
    """11a: pipelines/flagship.py ``run`` on the card at its R05_POINT
    (HARDBENCH_r05's operating point at run's widths: 5000 words, 30,000
    LM sentences, 400 train / 160 test utterances, the TDNN of run: hidden
    256, bottleneck 64, 7 layers, subsampling 3; 10 chain epochs): every
    rung's record beside r5's WER; the rungs' WERs within
    FLAGSHIP_MAX_WER and their oracle WERs at most their WERs.  → (fbank,
    GMM and den launches of the run, its records, its systems, wall s)."""
    from kaldi_tpu_torch.ops.chain_den import CudaChainDen
    from kaldi_tpu_torch.pipelines import flagship
    zero_totals()
    t0 = time.perf_counter()
    results, sysm = flagship.run(device=dev, return_systems=True,
                                 **flagship.R05_POINT)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fb, gm = totals()
    den = CudaChainDen.total_launches
    r05 = r05_flagship()
    for r in results:
        want = r05.get(r["system"])
        rest = " ".join(f"{k}={v}" for k, v in r.items()
                        if k not in ("metric", "system", "wer"))
        print(f"flagship: {r['system']}: WER {r['wer']:.2f} (HARDBENCH_r05 "
              f"WER {want[0] if want else '—'}); {rest} {tag}")
    print(f"flagship: run took {wall:.1f} s on the card; fbank launches "
          f"{fb}, GMM launches {gm}, den kernel launches {den} {tag}")
    for r in results:
        for prefix in ("", "pass1_"):
            if prefix + "wall_s" in r:
                decode_times_ok(f"flagship: {r['system']}"
                                + (" first pass" if prefix else ""), r,
                                prefix)
    for r in results:
        if not r["wer"] <= FLAGSHIP_MAX_WER:
            raise AssertionError(f"flagship {r['system']}: WER {r['wer']}")
        if "oracle_wer" in r and not r["oracle_wer"] <= r["wer"]:
            raise AssertionError(f"flagship {r['system']}: oracle WER "
                                 f"{r['oracle_wer']} above WER {r['wer']}")
    if min(fb, gm, den) <= 0:
        raise AssertionError(f"flagship launches: fbank {fb}, GMM {gm}, den "
                             f"{den}")
    return fb, gm, den, results, sysm, wall


def flagship_graphs(results, sysm) -> None:
    """11a: each rung's graph rebuilt on the host from the run's lexicon,
    trigram and transition models has the state count the run reports
    (r5's counts beside them)."""
    from kaldi_tpu_torch.am.topology import HmmTopology
    from kaldi_tpu_torch.am.transitions import TransitionModel
    from kaldi_tpu_torch.am.tree import MonophoneContextDependency
    from kaldi_tpu_torch.fst.biglang import build_big_graph
    lang = sysm["lang"]
    phones = lang.phone_list()
    topo = HmmTopology.three_state(phones)
    tms = {"mono-gmm": (TransitionModel(
               topo, MonophoneContextDependency(phones, topo)), 0.1),
           "tri3b-sat": (sysm["sat_model"].tm, 0.1),
           "chain-tdnn": (sysm["tm_chain"], 1.0)}
    r05 = r05_flagship()
    for name, (tm, slf) in tms.items():
        g = build_big_graph(sysm["entries"], sysm["arpa3"], tm, lang.words,
                            lang.phones, self_loop_scale=slf)
        got = sysm["graph_states"][name]
        print(f"flagship: {name} graph: {got} states in the run, "
              f"{g.csr.num_states} rebuilt on the host (HARDBENCH_r05: "
              f"{r05[name][2]})")
        if got != g.csr.num_states:
            raise AssertionError(f"flagship {name} graph: {got} states, "
                                 f"{g.csr.num_states} rebuilt")


def flagship_kernels(dev, sysm, tag: str):
    """11a: the kernels against their plain versions at the flagship's
    shapes (launches here are not counted): the fbank kernel at the
    8 kHz MFCC's 15 bins on 4 test waveforms, the GMM kernel with the
    mono (10 cepstra + Δ + ΔΔ, D = 30) and tri3b (LDA+MLLT+fMLLR,
    D = 30) models on 4 test utterances' features (against float64:
    GMM_TERMS_TOL), the den kernels on the run's left-biphone den
    graph at the trainer's B = 32 chunks of 17 output frames (51 input
    frames, ×3), timed, and with the pdfs the graph never reads scored
    far above the rest.  → (fbank err, GMM err, den err)."""
    from kaldi_tpu_torch.features import FrameExtractionOptions, \
        MelBanksOptions, Mfcc, MfccOptions
    test = sysm["test"]
    utts = test.utts[:4]
    mfcc = Mfcc(MfccOptions(
        frame_opts=FrameExtractionOptions(samp_freq=8000.0, dither=0.0),
        mel_opts=MelBanksOptions(num_bins=15), num_ceps=10), device=dev)
    fb_err = check_path_fbank(mfcc, [test.wavs[u][0] * 32768.0
                                     for u in utts], "flagship")
    gm_err = 0.0
    for name, am, feats in (("mono", sysm["mono"].am, sysm["delta_te"]),
                            ("tri3b", sysm["sat_model"].am,
                             sysm["sat_te"])):
        gm_err = max(gm_err, check_path_loglikes_f64(
            am, [feats[u] for u in utts], f"flagship {name} (D={am.dim}, "
            f"{am.num_pdfs} pdfs, {am.num_gauss()} Gaussians)"))
    den = sysm["den"]
    P = sysm["trainer"].model.config.num_pdfs
    print(f"flagship: the run's den graph: {den.num_states} states, "
          f"{len(den.src)} arcs, {P} pdfs")
    den_err = den_kernel_check(dev, den, P, tag, B=32, T=17)[0]
    return fb_err, gm_err, max(den_err, den_unread_check(dev, den, P))


def flagship_card_vs_cpu(dev, sysm, tag: str) -> None:
    """11a: the trained chain model in float32 on the card and on the
    CPU on CHAIN_CHECK_UTTS test utterances: outputs within
    CHAIN_CHECK_TOL + CHAIN_CHECK_TOL·|cpu|, and the card's decode and
    the CPU's (the run's chain graph and knobs) the same best path on at
    least CHAIN_CHECK_SAME; the card's decode profiled for its busy
    share."""
    import dataclasses as dc
    from kaldi_tpu_torch.am.tdnn import TdnnChain
    from kaldi_tpu_torch.pipelines.hard import decode_eval
    from kaldi_tpu_torch.tools.timing import profiled
    trained = sysm["trainer"].model
    cfg = dc.replace(trained.config, compute_dtype="float32")
    state = {k: v.detach().cpu() for k, v in trained.state_dict().items()}
    utts = sorted(sysm["base_te"])[:CHAIN_CHECK_UTTS]
    outs, share, bf16 = [], 0.0, 0.0
    for where in (dev, torch.device("cpu")):
        m = TdnnChain(cfg)
        m.load_state_dict(state)
        m.to(where).eval()
        with torch.no_grad():
            outs.append({u: m(torch.from_numpy(
                sysm["base_te"][u][None]).to(where))[0].cpu()
                for u in utts})
    on_card, on_cpu = outs
    with torch.no_grad():
        trained.eval()
        for u in utts:
            c = on_cpu[u]
            share = max(share, float(((on_card[u] - c).abs()
                                      / (CHAIN_CHECK_TOL
                                         + CHAIN_CHECK_TOL * c.abs())).max()))
            b = trained(torch.from_numpy(sysm["base_te"][u][None]).to(
                dev))[0].float().cpu()
            bf16 = max(bf16, float((b - c).abs().max()
                                   / max(float(c.abs().max()), 1e-6)))
    print(f"flagship: chain model (float32) on the card vs the CPU on "
          f"{len(utts)} test utterances: at most {share:.3f} of the limit "
          f"{CHAIN_CHECK_TOL:g} + {CHAIN_CHECK_TOL:g}·|cpu|; the trained "
          f"{trained.config.compute_dtype} forward on the card within "
          f"{bf16:.2e} of the largest |cpu| value")
    if not share <= 1.0:
        raise AssertionError("flagship: the chain model's outputs on the "
                             "card and the CPU disagree")
    knobs = dict(sysm["chain_knobs"], batch=CHAIN_CHECK_UTTS)
    sys_ch = sysm["sys_ch"]
    card_in = {u: x.numpy() for u, x in on_card.items()}
    lat_card, stats = decode_eval(sys_ch, card_in, device=dev, **knobs)
    decode_times_ok("flagship: the 16 utterances' decode", stats)
    lat_cpu, _ = decode_eval(sys_ch, {u: x.numpy() for u, x in
                                      on_cpu.items()},
                             device="cpu", **knobs)
    same = sum(lat_card[u].best_path()[0] == lat_cpu[u].best_path()[0]
               for u in utts)

    def decode():
        decode_eval(sys_ch, card_in, device=dev, **knobs)
        torch.cuda.synchronize()

    wall, n_k, busy, _ = profiled(decode)
    frames = sum(x.shape[0] for x in card_in.values())
    print(f"flagship: decodes of the {len(utts)} utterances: the card's and "
          f"the CPU's best paths equal on {same} (at least "
          f"{CHAIN_CHECK_SAME}); the card's decode under torch.profiler: "
          f"{wall:.1f} ms wall, {n_k} kernels ({n_k / frames:.1f} a frame), "
          f"{busy:.1f} ms on the card ({100 * busy / wall:.1f}% busy) {tag}")
    if same < CHAIN_CHECK_SAME:
        raise AssertionError(f"flagship: card and CPU decodes agree on "
                             f"{same} of {len(utts)}")


def hard_corpus(dev, tag: str):
    """11b: pipelines/hard.py ``run_point`` on the card on the hard
    corpus at each of HARD_BUDGETS with escalation to HARD_ESCALATE:
    every point's oracle WER at most its WER, and the default budget
    within HARD_ORACLE_LOSS oracle WER of the loosest.  → the points."""
    from kaldi_tpu_torch.pipelines import hard
    t0 = time.perf_counter()
    task = hard.make_hard_task(**HARD_TASK)
    ev, lls = hard.synth_eval(task, **HARD_EVAL)
    audio_s = sum(len(x) for x in lls.values()) * 0.03
    print(f"hard: {HARD_TASK['vocab']}-word task, graph "
          f"{task.graph.csr.num_states} states, {HARD_EVAL['n_utts']} "
          f"utterances / {audio_s:.1f} audio-s (built in "
          f"{time.perf_counter() - t0:.1f} s on the host)")
    recs = []
    for ab in HARD_BUDGETS:
        r = hard.run_point(task, ev, lls, device=dev, arc_budget=ab,
                           escalate_budget=HARD_ESCALATE)
        recs.append(r)
        print(f"hard: arc_budget {ab}: WER {r['wer']:.2f}, oracle "
              f"{r['oracle_wer']:.2f}, density {r['density']:.2f}, "
              f"{r['audio_s_per_s']} audio-s/s wall, "
              f"{r.get('device_audio_s_per_s')} on the card, dropped arcs "
              f"{r['dropped_arcs']}, escalated {r['n_escalated']}, min "
              f"effective beam {r['min_eff_beam']}; wall {r['wall_s']} s "
              f"(fetch {r['fetch_s']}, lattice builds {r['build_s']} over "
              f"the threads) {tag}")
        print(json.dumps(r))
        decode_times_ok(f"hard: arc_budget {ab}", r)
    for r in recs:
        if not r["oracle_wer"] <= r["wer"]:
            raise AssertionError(f"hard {r['arc_budget']}: oracle WER "
                                 f"{r['oracle_wer']} above WER {r['wer']}")
    loss = recs[0]["oracle_wer"] - recs[-1]["oracle_wer"]
    print(f"hard: budget {HARD_BUDGETS[0]} loses {loss:.2f} oracle WER "
          f"against {HARD_BUDGETS[-1]} (limit {HARD_ORACLE_LOSS})")
    if not loss < HARD_ORACLE_LOSS:
        raise AssertionError(f"hard: oracle WER loss {loss}")
    return recs


def lattice_tools_start(sysm):
    """11c, started: 11a's chain lattices, reference texts, words and LMs
    written to files, then lattice-scale | lattice-add-penalty |
    lattice-lmrescore-pruned | lattice-best-path, and lattice-oracle on
    the rescored lattices, as processes of ``python -m
    kaldi_tpu_torch.cli`` in one background shell.  → (process, dir,
    start time)."""
    import subprocess
    from kaldi_tpu_torch.core.table import TableWriter
    from kaldi_tpu_torch.fst.arpa import write_arpa
    repo = os.path.dirname(os.path.abspath(__file__))
    d = os.path.join(repo, "build", "chip_smoke_lattice")
    os.makedirs(d, exist_ok=True)
    lang, test = sysm["lang"], sysm["test"]
    with TableWriter(f"ark:{d}/lat.ark", holder="clat") as w:
        for u, lat in sorted(sysm["lats_ch"].items()):
            w[u] = lat
    with TableWriter(f"ark,t:{d}/ref.txt", holder="text") as w:
        for u in sorted(sysm["lats_ch"]):
            w[u] = test.text[u]
    lang.words.write(f"{d}/words.txt")
    write_arpa(sysm["arpa3"], f"{d}/lm3.arpa")
    write_arpa(sysm["arpa4"], f"{d}/lm4.arpa")
    cli = f"{sys.executable} -m kaldi_tpu_torch.cli"
    cmd = (f"{cli} lattice-scale --acoustic-scale={TOOL_ACWT} "
           f"ark:{d}/lat.ark ark:- | {cli} lattice-add-penalty "
           f"--word-ins-penalty={TOOL_PENALTY} ark:- ark:- | {cli} "
           f"lattice-lmrescore-pruned --lattice-compose-beam={TOOL_BEAM} "
           f"{d}/lm3.arpa {d}/lm4.arpa {d}/words.txt ark:- "
           f"ark:{d}/rescored.ark && {cli} lattice-best-path "
           f"--word-symbol-table={d}/words.txt ark:{d}/rescored.ark "
           f"ark,t:{d}/best.txt && {cli} lattice-oracle "
           f"--word-symbol-table={d}/words.txt ark:{d}/rescored.ark "
           f"ark,t:{d}/ref.txt")
    proc = subprocess.Popen(["bash", "-o", "pipefail", "-c", cmd],
                            cwd=repo, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    return proc, d, time.perf_counter()


def lattice_tools_finish(sysm, started) -> None:
    """11c, checked: the tools' 1-best and oracle equal the same steps in
    process on the lattices and LMs read back."""
    import io
    from kaldi_tpu_torch.core.table import SequentialTableReader
    from kaldi_tpu_torch.fst.arpa import ArpaModel
    from kaldi_tpu_torch.lattice.functions import (oracle_errors,
                                                   scale_lattice)
    from kaldi_tpu_torch.lattice.io import (read_compact_lattice,
                                            write_compact_lattice)
    from kaldi_tpu_torch.lattice.rescore import lmrescore_diff_pruned
    proc, d, t0 = started
    stdout, stderr = proc.communicate(timeout=900)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"lattice tools failed ({proc.returncode}):\n"
                             f"{stderr[-3000:]}")
    lang, test = sysm["lang"], sysm["test"]
    tool_best = dict(SequentialTableReader(f"ark,t:{d}/best.txt",
                                           holder="text"))
    # the same steps in process, on the lattices and LMs read back, each
    # step's lattice stored as the tools store it (float32 weights)
    def stored(lat):
        buf = io.BytesIO()
        write_compact_lattice(buf, lat)
        buf.seek(0)
        return read_compact_lattice(buf)

    old = ArpaModel.parse(f"{d}/lm3.arpa")
    new = ArpaModel.parse(f"{d}/lm4.arpa")
    err = words = same = 0
    for u, lat in SequentialTableReader(f"ark:{d}/lat.ark", holder="clat"):
        lat = stored(scale_lattice(lat, acoustic_scale=TOOL_ACWT))
        for s in range(lat.num_states):
            for a in lat.arcs[s]:
                if a.word:
                    a.graph_cost += TOOL_PENALTY
        r = stored(lmrescore_diff_pruned(stored(lat), old, new, lang.words,
                                         beam=TOOL_BEAM, max_arcs=200_000))
        best = [lang.words.find(w) for w in r.best_path()[0]]
        same += int(best == list(tool_best.get(u, [None])))
        ref = [lang.words[w] for w in test.text[u]]
        err += oracle_errors(r, ref)
        words += len(ref)
    want = f"%WER {100.0 * err / max(words, 1):.2f} [ {err} / {words} ]"
    got = stdout.strip().splitlines()[-1]
    print(f"tools: lattice-scale | lattice-add-penalty | "
          f"lattice-lmrescore-pruned, lattice-best-path, lattice-oracle on "
          f"{len(tool_best)} chain lattices in {wall:.1f} s (in the "
          f"background from 11a's rung on): 1-best equal to "
          f"the library's on {same}, oracle '{got}' (library '{want}')")
    if same != len(sysm["lats_ch"]) or got != want:
        raise AssertionError("lattice tools disagree with the library")


# ---------------------------------------------------------------------------
# 11d, 11e, 12: i-vectors on the card, the device-time check
# ---------------------------------------------------------------------------

# 11d: the i-vector functions on the card against the CPU, both float64
# (only the order of the sums differs): within IVEC_TOL of the largest
# magnitude, on the flagship's base features of IVEC_CHECK_UTTS training
# utterances (the UBM and the extractor) and 8 test utterances (online
# i-vectors)
IVEC_TOL = 1e-8
IVEC_CHECK_UTTS = 40
# 12: the i-vector tool chain (steps/online/nnet2's train_diag_ubm.sh →
# train_ivector_extractor.sh → extract_ivectors_online.sh) on online2's
# MFCC of phase 5's waveforms, at the flagship rung's i-vector dim and
# period; its UBM is smaller (16 Gaussians: 8 waveforms, ~3,900 frames)
IVEC_DIM, IVEC_PERIOD = 16, 10
IVEC_TOOL_GAUSS, IVEC_TOOL_ITERS = 16, 6
# 12b: the streamed features against the offline assembly (the MFCC of
# the fbank kernel over other batches of frames, and the i-vectors that
# follow from them): within this share of each part's largest magnitude
STREAM_IVEC_TOL = 1e-4
# 12b: waveforms the CPU run decodes (its dense decoder takes ~30 s a
# waveform on the host)
STREAM_CPU_WAVES = 2


def rel_err(got, want) -> float:
    """max |got − want| over max |want| (tensors or arrays)."""
    got = torch.as_tensor(np.asarray(got) if not torch.is_tensor(got)
                          else got).detach().cpu().double()
    want = torch.as_tensor(np.asarray(want) if not torch.is_tensor(want)
                           else want).detach().cpu().double()
    if got.shape != want.shape:
        raise AssertionError(f"shapes {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    return float((got - want).abs().max()) / max(float(want.abs().max()),
                                                 1e-300)


def device_time_check(dev, tag: str) -> None:
    """11e: a region of two small kernels with a 50 ms host sleep between
    them.  CUDA events around it, recorded as the work is queued, read
    the host's gap (at least 50 ms); ``tools/timing.py`` ``graph_ms``
    (the region captured into a CUDA graph and launched once, as
    decode_eval's ``device_s`` times each batch) and ``device_ms`` (the
    region queued behind a spin kernel, as the kernels are timed) read
    the card's work alone (above 0, under 5 ms)."""
    from kaldi_tpu_torch.tools.timing import device_ms, graph_ms
    x = torch.ones(1 << 16, device=dev)

    def region():
        x.mul_(1.0001)
        time.sleep(0.05)
        x.add_(1.0)

    region()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    region()
    end.record()
    torch.cuda.synchronize()
    events_ms = start.elapsed_time(end)
    spin_ms = device_ms(region, 1)
    g_ms = graph_ms(region)
    print(f"device time: two kernels with a 50 ms host sleep between them: "
          f"events around the queued region {events_ms:.3f} ms (at least "
          f"50), graph_ms {g_ms:.4f} ms and device_ms {spin_ms:.4f} ms "
          f"(above 0, under 5) {tag}")
    if not (events_ms >= 50.0 and 0.0 < spin_ms < 5.0 and 0.0 < g_ms < 5.0):
        raise AssertionError(f"device time check: events {events_ms} ms, "
                             f"graph_ms {g_ms} ms, device_ms {spin_ms} ms")


def decode_times_ok(what: str, rec: dict, prefix: str = "") -> None:
    """A decode's device_s is at most its wall_s (and the seconds its
    measurement took, off the wall clock)."""
    wall, dev_s = rec[prefix + "wall_s"], rec[prefix + "device_s"]
    print(f"{what}: decode wall {wall} s, on the card {dev_s} s "
          f"(device_s ≤ wall_s); measuring it took "
          f"{rec[prefix + 'timing_s']} s off the wall clock")
    if not dev_s <= wall:
        raise AssertionError(f"{what}: device_s {dev_s} above wall_s {wall}")


def ivector_card_vs_cpu(dev, sysm, tag: str) -> None:
    """11d: the flagship rung's i-vector stages on the card and on the
    CPU (train_diag_ubm with 64 Gaussians, the 3-iteration extractor EM,
    online_ivectors) equal within IVEC_TOL; and on the card
    online_ivectors equals OnlineIvectorEstimator fed period by period
    (its estimate before each block)."""
    from kaldi_tpu_torch.am.ivector import (IvectorExtractor,
                                            OnlineIvectorEstimator,
                                            online_ivectors, train_diag_ubm)
    feats = [sysm["base_tr"][u] for u in sorted(sysm["base_tr"])[
        :IVEC_CHECK_UTTS]]
    test = [sysm["base_te"][u] for u in sorted(sysm["base_te"])[:8]]
    out, walls = [], []
    for where in (dev, torch.device("cpu")):
        t0 = time.perf_counter()
        m, v, w = train_diag_ubm(feats, num_gauss=64, seed=1, device=where)
        ex = IvectorExtractor(m, v, w, ivector_dim=IVEC_DIM, seed=1,
                              device=where)
        ex.train([ex.acc_stats(f) for f in feats], num_iters=3)
        on = [online_ivectors(ex, f, period=IVEC_PERIOD) for f in test]
        if where.type == "cuda":
            torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        out.append((ex, [m, v, w, ex.T] + on))
    (ex, card), (_, cpu) = out
    err = max(rel_err(g, c) for g, c in zip(card, cpu))
    est_err = 0.0
    for f, got in zip(test, card[4:]):
        est = OnlineIvectorEstimator(ex, max_count=100.0)
        rows = []
        for t0 in range(0, len(f), IVEC_PERIOD):
            rows.append(est.ivector())
            est.accept_frames(f[t0:t0 + IVEC_PERIOD])
        want = torch.stack(rows).repeat_interleave(IVEC_PERIOD, 0)[:len(f)]
        est_err = max(est_err, rel_err(got, want))
    frames = sum(len(f) for f in feats)
    print(f"ivectors: UBM (64 Gaussians), 3 EM iterations (dim {IVEC_DIM}) "
          f"on {len(feats)} utterances ({frames} frames) and online "
          f"i-vectors of 8 test utterances, float64: the card against the "
          f"CPU within {err:.2e} of the largest magnitude (limit "
          f"{IVEC_TOL:g}); online_ivectors against the estimator fed "
          f"period by period {est_err:.2e}; wall {walls[0]:.2f} s on "
          f"the card, {walls[1]:.2f} s on the CPU {tag}")
    if not (err <= IVEC_TOL and est_err <= IVEC_TOL):
        raise AssertionError(f"i-vectors card vs CPU {err}, batched vs "
                             f"streaming {est_err}")


def ivector_tools_start(dev, task, waves):
    """12a, started: online2's MFCC (16 kHz, 13 cepstra, dither 0) of
    phase 5's waveforms on the card, written as an ark (and as two job
    arks) with a spk2utt of two speakers, then ``python -m
    kaldi_tpu_torch.cli`` gmm-global-init-from-feats →
    gmm-global-acc-stats → gmm-global-est → ivector-extractor-init → two
    ivector-extractor-acc-stats jobs (at once) →
    ivector-extractor-sum-accs → ivector-extractor-est →
    ivector-extract-online2, on the card, in one background shell; then,
    for 12b, ``python -m kaldi_tpu_torch.cli.online2 --device=cpu
    --ivector-extractor`` with the extractor it made on the first
    STREAM_CPU_WAVES waveforms (on 2 threads: the shell runs beside 11a),
    with 7d's 300-word .mdl and HCLG.fst and a raw nnet3 TDNN-F of the
    flagship rung's widths (13 + 16 inputs, seeded), written here.  →
    (process, dir, features, start time)."""
    import subprocess
    from kaldi_tpu_torch.am.nnet3_io import write_raw_model
    from kaldi_tpu_torch.am.tdnn import TdnnChain, TdnnConfig
    from kaldi_tpu_torch.core.table import TableWriter
    from kaldi_tpu_torch.features.compute import Mfcc, MfccOptions
    from kaldi_tpu_torch.features.window import FrameExtractionOptions
    repo = os.path.dirname(os.path.abspath(__file__))
    d = os.path.join(repo, "build", "chip_smoke_ivector")
    os.makedirs(d, exist_ok=True)
    mfcc = Mfcc(MfccOptions(frame_opts=FrameExtractionOptions(dither=0.0),
                            num_ceps=13), device=dev)
    feats = {f"utt{i}": mfcc.compute(w).cpu().numpy()
             for i, w in enumerate(waves)}
    utts = sorted(feats)
    half = len(utts) // 2
    for name, keys in (("feats", utts), ("feats1", utts[:half]),
                       ("feats2", utts[half:])):
        with TableWriter(f"ark:{d}/{name}.ark", holder="mat") as w:
            for u in keys:
                w[u] = feats[u]
    with TableWriter(f"ark,t:{d}/spk2utt", holder="text") as w:
        w["spkA"] = utts[:half]
        w["spkB"] = utts[half:]
    # 12b's model and waveforms
    cfg = TdnnConfig(feat_dim=13 + IVEC_DIM, num_pdfs=task.num_pdfs,
                     hidden_dim=256, bottleneck_dim=64, num_layers=7)
    sd = random_tdnn_state(TdnnChain(cfg), np.random.default_rng(SEED + 12))
    # as 7d's model: outputs 5× phase 5's spread, so that the best paths
    # hold words
    sd["output_affine.weight"] *= 5.0
    write_raw_model(f"{d}/ivec.raw", sd, cfg)
    for name, n in (("wav", len(waves)), ("wav_cpu", STREAM_CPU_WAVES)):
        with TableWriter(f"ark:{d}/{name}.ark", holder="wav") as w:
            for i, x in enumerate(waves[:n]):
                w[f"utt{i}"] = (np.clip(x, -32768, 32767).astype(np.int16),
                                SAMP_FREQ)
    cli = f"{sys.executable} -m kaldi_tpu_torch.cli"
    o2 = os.path.join(repo, "build", "chip_smoke_online2")
    script = "\n".join([
        f"{cli} gmm-global-init-from-feats --device=cuda "
        f"--num-gauss={IVEC_TOOL_GAUSS} --num-iters={IVEC_TOOL_ITERS} "
        f"ark:{d}/feats.ark {d}/ubm0",
        f"{cli} gmm-global-acc-stats --device=cuda {d}/ubm0 "
        f"ark:{d}/feats.ark {d}/ubm.acc",
        f"{cli} gmm-global-est {d}/ubm0 {d}/ubm.acc {d}/ubm",
        f"{cli} ivector-extractor-init --device=cuda "
        f"--ivector-dim={IVEC_DIM} --seed=1 {d}/ubm {d}/0.ie",
        f"{cli} ivector-extractor-acc-stats --device=cuda {d}/0.ie "
        f"ark:{d}/feats1.ark {d}/acc.1 & p1=$!",
        f"{cli} ivector-extractor-acc-stats --device=cuda {d}/0.ie "
        f"ark:{d}/feats2.ark {d}/acc.2 & p2=$!",
        "wait $p1",
        "wait $p2",
        f"{cli} ivector-extractor-sum-accs {d}/acc {d}/acc.1 {d}/acc.2",
        f"{cli} ivector-extractor-est --device=cuda {d}/0.ie {d}/acc "
        f"{d}/1.ie",
        f"{cli} ivector-extract-online2 --device=cuda "
        f"--ivector-period={IVEC_PERIOD} ark:{d}/spk2utt {d}/1.ie "
        f"ark:{d}/feats.ark ark:{d}/ivectors.ark",
        "echo TOOLS_DONE $SECONDS >&2",
        f"OMP_NUM_THREADS=2 {sys.executable} -m kaldi_tpu_torch.cli.online2 "
        f"--device=cpu --ivector-extractor={d}/1.ie "
        f"--ivector-period={IVEC_PERIOD} {o2}/final.mdl {d}/ivec.raw "
        f"{o2}/HCLG.fst ark:{d}/wav_cpu.ark ark,t:{d}/words_cpu.txt",
        "echo CPU_ONLINE2_DONE $SECONDS >&2"])
    proc = subprocess.Popen(["bash", "-e", "-c", script], cwd=repo,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    return proc, d, feats, time.perf_counter()


def ivector_tools_finish(dev, started, tag: str) -> int:
    """12a, checked: each tool's output against the library in this
    process on the card, from the tool chain's previous output (so each
    step is held on its own): the UBM's EM within 1e-6 of the largest
    magnitude, its accumulators within 1e-5, the host update and the
    extractor's initialisation equal, the i-vector stats within 1e-6
    (float64 work stored as float32), the estimated extractor and the
    online i-vectors within 1e-6 (read back and stored as float32).  The
    GMM kernel at the tools' shape (one pdf, IVEC_TOOL_GAUSS Gaussians,
    13 dims: a partial pdf tile) on the tool's UBM and the chain's MFCC,
    held with its plain version to the float64 value at 11a's bar.  → the tools' GMM kernel launches (their
    log: gmm-global-init-from-feats's like/frame line is the one launch;
    the tools' EM, stats and posteriors are tensor ops)."""
    import re
    from kaldi_tpu_torch.am.gmm import (AmDiagGmm, GmmAccs, accumulate_stats,
                                        global_stats, mixup, mle_update)
    from kaldi_tpu_torch.am.ivector import (IvectorExtractor,
                                            OnlineIvectorEstimator,
                                            read_ivector_extractor,
                                            write_ivector_extractor)
    from kaldi_tpu_torch.cli.tools_bank5 import (_read_global_gmm,
                                                 _write_global_gmm)
    from kaldi_tpu_torch.cli.tools_extra import read_gmm_accs
    from kaldi_tpu_torch.cli.tools_ivector import _read_iv_stats
    from kaldi_tpu_torch.core.table import SequentialTableReader
    proc, d, feats, t0 = started
    _, err = proc.communicate(timeout=900)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"i-vector tools failed ({proc.returncode}):\n"
                             f"{err[-3000:]}")
    launches = sum(int(n) for n in
                   re.findall(r"GMM kernel launches (\d+)", err))
    done = dict(re.findall(r"(TOOLS_DONE|CPU_ONLINE2_DONE) (\d+)", err))
    utts = sorted(feats)
    half = len(utts) // 2
    errs = {}
    # gmm-global-init-from-feats: six EM iterations with mix-ups, each
    # run as users run it (a one-pdf model's sums over frames take one
    # order every run: am/gmm.py accumulate_stats_device)
    x = np.concatenate([feats[u] for u in utts])
    gmean, gvar = global_stats([x])
    am = AmDiagGmm.flat_start(1, gmean, gvar, device=dev)
    for it in range(IVEC_TOOL_ITERS):
        want = min(IVEC_TOOL_GAUSS, 1 + (IVEC_TOOL_GAUSS * (it + 1) * 2)
                   // IVEC_TOOL_ITERS)
        if am.num_gauss() < want:
            am = mixup(am, want)
        accs = GmmAccs.zeros(am.num_pdfs, am.max_mix, am.dim)
        accumulate_stats(am, x, np.zeros(len(x), np.int32), accs)
        mle_update(am, accs)
    _write_global_gmm(f"{d}/lib_ubm0", am)
    tool, lib = (_read_global_gmm(f"{d}/{n}", dev)
                 for n in ("ubm0", "lib_ubm0"))
    errs["gmm-global-init-from-feats"] = (
        max(rel_err(getattr(tool, n), getattr(lib, n))
            for n in ("weights", "means", "vars"))
        if tool.num_gauss() == lib.num_gauss() == IVEC_TOOL_GAUSS else 1.0,
        1e-6)
    # the GMM kernel at the tools' shape, on the tool's UBM, held as on
    # 11a's path: on MFCCs without dither the UBM's terms run to ~1e5, and
    # float32 itself holds the result only to ~u·S (the plain version was
    # 3.7 of the GMM_TOL bar off float64 on this UBM on the CPU)
    ubm0 = _read_global_gmm(f"{d}/ubm0", dev)
    gmm_err = check_path_loglikes_f64(
        ubm0, [x],
        f"ivector tools: the UBM ({ubm0.num_pdfs} pdf, {ubm0.num_gauss()} "
        f"Gaussians, D={ubm0.dim}) on the chain's {len(x)} MFCC frames")
    # gmm-global-acc-stats, from the tool's UBM
    accs = GmmAccs.zeros(ubm0.num_pdfs, ubm0.max_mix, ubm0.dim)
    for u in utts:
        accumulate_stats(ubm0, feats[u], np.zeros(len(feats[u]), np.int32),
                         accs)
    tool_accs = read_gmm_accs(f"{d}/ubm.acc")
    errs["gmm-global-acc-stats"] = (max(
        rel_err(getattr(tool_accs, n), getattr(accs, n))
        for n in ("occ", "mean_acc", "var_acc")), 1e-5)
    # gmm-global-est, from the tool's UBM and accumulators (host numpy)
    ubm0 = _read_global_gmm(f"{d}/ubm0", "cpu")
    mle_update(ubm0, tool_accs)
    _write_global_gmm(f"{d}/lib_ubm", ubm0)
    with open(f"{d}/ubm", "rb") as f, open(f"{d}/lib_ubm", "rb") as g:
        errs["gmm-global-est"] = (0.0 if f.read() == g.read() else 1.0, 0.0)
    # ivector-extractor-init, from the tool's UBM
    ex = IvectorExtractor.from_am(_read_global_gmm(f"{d}/ubm", "cpu"),
                                  IVEC_DIM, device=dev)
    ex.T = 0.1 * np.random.default_rng(1).standard_normal(tuple(ex.T.shape))
    write_ivector_extractor(f"{d}/lib_0.ie", ex)
    with open(f"{d}/0.ie", "rb") as f, open(f"{d}/lib_0.ie", "rb") as g:
        errs["ivector-extractor-init"] = (0.0 if f.read() == g.read()
                                          else 1.0, 0.0)
    # the two acc-stats jobs and their sum, from the tool's extractor
    ex0 = read_ivector_extractor(f"{d}/0.ie", dev)
    jobs = [ex0.em_stats([ex0.acc_stats(feats[u]) for u in keys])
            for keys in (utts[:half], utts[half:])]
    tool_stats = _read_iv_stats(f"{d}/acc")
    errs["ivector-extractor-acc-stats + sum-accs"] = (max(
        rel_err(tool_stats[k], jobs[0][i] + jobs[1][i])
        for i, k in enumerate(("A", "B", "gamma"))), 1e-6)
    # ivector-extractor-est, from the tool's extractor and summed stats
    ex0.em_update(tool_stats["A"], tool_stats["B"], tool_stats["gamma"])
    write_ivector_extractor(f"{d}/lib_1.ie", ex0)
    tool1 = read_ivector_extractor(f"{d}/1.ie", dev)
    errs["ivector-extractor-est"] = (rel_err(
        tool1.T, read_ivector_extractor(f"{d}/lib_1.ie", dev).T), 1e-6)
    # ivector-extract-online2, from the tool's extractor: one estimator a
    # speaker, its estimate after each period
    got = dict(SequentialTableReader(f"ark:{d}/ivectors.ark", holder="mat"))
    worst = 0.0
    for keys in (utts[:half], utts[half:]):
        est = OnlineIvectorEstimator(tool1)
        for u in keys:
            rows = []
            for s in range(0, len(feats[u]), IVEC_PERIOD):
                est.accept_frames(feats[u][s:s + IVEC_PERIOD])
                rows.append(est.ivector())
            worst = max(worst, rel_err(got[u], torch.stack(rows)))
    errs["ivector-extract-online2"] = (worst, 1e-6)
    frames = sum(len(f) for f in feats.values())
    print(f"ivector tools: python -m kaldi_tpu_torch.cli on online2's MFCC of "
          f"{len(utts)} waveforms ({frames} frames, 2 speakers): 9 processes "
          f"in {done.get('TOOLS_DONE')} s, then 12b's online2 on the CPU "
          f"until {done.get('CPU_ONLINE2_DONE')} s (beside 11a; {wall:.1f} "
          f"s until checked here): "
          + ", ".join(f"{n} {e:.2e} (limit {lim:g})"
                      for n, (e, lim) in errs.items())
          + f"; GMM launches {launches} {tag}")
    bad = {n: e for n, (e, lim) in errs.items() if not e <= lim}
    if bad or launches <= 0:
        raise AssertionError(f"i-vector tools vs library: {bad}, GMM "
                             f"launches {launches}")
    return launches, gmm_err


def stream_ivectors_start(d: str):
    """12b, started: ``python -m kaldi_tpu_torch.cli.online2 --device=cuda
    --ivector-extractor`` on phase 5's waveforms with 12a's extractor,
    model and files, in the background.  → (process, start time)."""
    import subprocess
    repo = os.path.dirname(os.path.abspath(__file__))
    o2 = os.path.join(repo, "build", "chip_smoke_online2")
    proc = subprocess.Popen(
        [sys.executable, "-m", "kaldi_tpu_torch.cli.online2", "--device=cuda",
         f"--ivector-extractor={d}/1.ie", f"--ivector-period={IVEC_PERIOD}",
         f"{o2}/final.mdl", f"{d}/ivec.raw", f"{o2}/HCLG.fst",
         f"ark:{d}/wav.ark", f"ark,t:{d}/words_cuda.txt"],
        cwd=repo, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return proc, time.perf_counter()


def stream_ivectors(dev, waves, d: str, started, tag: str) -> int:
    """12b: the card's online2 run (``stream_ivectors_start``): the words
    of the first STREAM_CPU_WAVES equal those of 12a's CPU run, and some
    are decoded.  Then, on the card, each waveform streamed in WAV_CHUNK
    pieces through OnlineFeaturePipeline with an OnlineIvectorEstimator
    equals the offline assembly (the whole waveform's MFCC beside the
    estimator's estimate after each period, fed period by period),
    within STREAM_IVEC_TOL.  → the card tool's fbank launches (its
    log)."""
    import re
    from kaldi_tpu_torch.am.ivector import (OnlineIvectorEstimator,
                                            read_ivector_extractor)
    from kaldi_tpu_torch.core.table import SequentialTableReader
    from kaldi_tpu_torch.features.compute import Mfcc, MfccOptions
    from kaldi_tpu_torch.features.online import OnlineFeaturePipeline
    from kaldi_tpu_torch.features.window import FrameExtractionOptions
    # the streamed features against the offline assembly, on the card,
    # while the tool runs
    ex = read_ivector_extractor(f"{d}/1.ie", dev)
    mfcc = Mfcc(MfccOptions(frame_opts=FrameExtractionOptions(dither=0.0),
                            num_ceps=13), device=dev)
    feat_err = iv_err = 0.0
    for x in waves:
        pipe = OnlineFeaturePipeline(
            mfcc, ivector_estimator=OnlineIvectorEstimator(ex),
            ivector_period=IVEC_PERIOD)
        for i in range(0, len(x), WAV_CHUNK):
            pipe.accept_waveform(x[i:i + WAV_CHUNK])
        pipe.input_finished()
        got = pipe.get_frames(0, pipe.num_frames_ready())
        base = mfcc.compute(x)
        est = OnlineIvectorEstimator(ex)
        rows = []
        for s in range(0, base.shape[0], IVEC_PERIOD):
            est.accept_frames(base[s:s + IVEC_PERIOD])
            rows.append(est.ivector())
        ivec = torch.stack(rows).repeat_interleave(IVEC_PERIOD, 0)[
            :base.shape[0]]
        feat_err = max(feat_err, rel_err(got[:, :13], base))
        iv_err = max(iv_err, rel_err(got[:, 13:], ivec))
    proc, t0 = started
    _, err = proc.communicate(timeout=900)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"online2 --ivector-extractor failed "
                             f"({proc.returncode}):\n{err[-3000:]}")
    words = {where: dict(SequentialTableReader(
        f"ark,t:{d}/words_{where}.txt", holder="text"))
        for where in ("cuda", "cpu")}
    m = re.search(r"fbank kernel launches (\d+)", err)
    launches = int(m.group(1)) if m else 0
    n_words = [len(v) for v in words["cuda"].values()]
    same = all(words["cuda"].get(u) == v for u, v in words["cpu"].items())
    print(f"online2 --ivector-extractor: {len(waves)} waveforms "
          f"({sum(len(x) for x in waves) / SAMP_FREQ:.2f} s) on the card, "
          f"TDNN-F 256 / 64 / 7 layers on 13 + {IVEC_DIM} inputs, 7d's "
          f"300-word graph: words {n_words} per utt; the first "
          f"{len(words['cpu'])} equal the CPU run's: {same}; wall "
          f"{wall:.1f} s (process start, graph and model load; beside 11c "
          f"and the check below); fbank "
          f"launches {launches}; streamed features against the offline "
          f"assembly: MFCC {feat_err:.2e}, i-vectors {iv_err:.2e} of their "
          f"largest magnitude (limit {STREAM_IVEC_TOL:g}) {tag}")
    if not same or len(words["cpu"]) != STREAM_CPU_WAVES \
            or not sum(n_words) or launches <= 0:
        raise AssertionError(f"online2 --ivector-extractor: card "
                             f"{words['cuda']} vs CPU {words['cpu']}; fbank "
                             f"launches {launches}")
    if not (feat_err <= STREAM_IVEC_TOL and iv_err <= STREAM_IVEC_TOL):
        raise AssertionError(f"streamed i-vector features: MFCC {feat_err}, "
                             f"i-vectors {iv_err}")
    return launches


# ---------------------------------------------------------------------------
# 13. the flagship's RNNLM rung on the card: card against CPU, timing, tools
# ---------------------------------------------------------------------------

# 13a: the card against the CPU at the rung's widths (E 96, H 192, the
# rung's vocabulary) on seeded weights, one batch of the rung's B = 64
# LM sentences: forward, losses and gradients within RNN_TOL of the
# largest magnitude (float32 products summed in other orders over the
# 9 recurrent steps); the weights after one Adam step at the rung's lr
# within 1e-3·lr plus the step's sensitivity to a gradient error of
# RNN_TOL (a first step moves a weight by lr·g/(|g| + eps): near
# |g| = eps, rounding of g moves it by up to a step); the scorer's
# log-probs within RNN_SCORER_ATOL nats
RNN_TOL = 1e-4
RNN_SCORER_ATOL = 1e-4
RNN_LR = 4e-3
RNN_B = 64
# 13a / 13b: sentences whose prefixes are the scorer's histories
RNN_SCORER_SENTS = 40
# 13b: training steps timed, steps profiled
RNN_TIME_STEPS = 50
RNN_PROFILE_STEPS = 5
# 13c: the tools' training text, held-out text and lattices
RNN_TOOL_SENTS = 2000
RNN_TOOL_HELD = 200
RNN_TOOL_LATS = 8


def rnnlm_rung(results, sysm, tag: str) -> None:
    """11a: the RNNLM rung's record beside HARDBENCH_r05's (TPU v5e), its
    training steps and final nll per word, histories scored, ms a
    history (the rescore's wall over its histories) and rescore
    audio-s/s."""
    rec = next(r for r in results if r["system"] == "chain+rnnlm-rescore")
    info = sysm["rnnlm"]
    cfg = info["config"]
    r05 = json.load(open(os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "HARDBENCH_r05.json")))["flagship"]
    tpu = next(r for r in r05 if r["system"] == "chain+rnnlm-rescore")
    chain = next(r for r in results if r["system"] == "chain-tdnn")
    print(f"rnnlm: rung: WER {rec['wer']:.2f} (chain-tdnn {chain['wer']:.2f}"
          f", delta {rec['wer_delta_vs_trigram']:+.2f}), oracle "
          f"{rec['oracle_wer']:.2f}, lm_scale {rec['lm_scale']}, "
          f"rnnlm_train_s {rec['rnnlm_train_s']} ({info['steps']} steps of "
          f"B = 64 at V = {cfg.vocab_size}, E = {cfg.embed_dim}, H = "
          f"{cfg.hidden_dim}, K = {info['sample_k']}; final nll "
          f"per word {info['nll']:.4f}), {info['histories']} histories "
          f"scored in {info['rescore_s']:.2f} s = "
          f"{1e3 * info['rescore_s'] / max(info['histories'], 1):.4f} ms a "
          f"history, rescore {rec['rescore_audio_s_per_s']} audio-s/s "
          f"{tag}")
    print(f"rnnlm: HARDBENCH_r05 (TPU v5e, scorer on the host CPU, 3 "
          f"epochs): WER {tpu['wer']}, oracle {tpu['oracle_wer']}, delta "
          f"{tpu['wer_delta_vs_trigram']:+.2f}, rnnlm_train_s "
          f"{tpu['rnnlm_train_s']}, rescore {tpu['rescore_audio_s_per_s']} "
          f"audio-s/s")
    if info["steps"] <= 0 or info["histories"] <= 0:
        raise AssertionError(f"rnnlm rung: {info['steps']} steps, "
                             f"{info['histories']} histories")
    if not math.isfinite(info["nll"]):
        raise AssertionError(f"rnnlm rung: final nll {info['nll']}")


def _rnnlm_batch(sysm, n: int, start: int = 0):
    """The rung's first sentences from ``start`` as word ids, and the
    rung's <s> / </s> ids."""
    lang, info = sysm["lang"], sysm["rnnlm"]
    sents = [[lang.words[w] for w in s]
             for s in sysm["lm_texts"][start:start + n]]
    return sents, info["bos"], info["eos"]


def _adam_step_ok(got, want, grad, lr: float, tol: float) -> float:
    """max over weights of |got − want| / (1e-3·lr + lr·eps·δg/(|g| +
    eps)²), δg = tol·max|g|: ≤ 1 when the two steps agree."""
    eps = 1e-8
    g = grad.double().abs()
    bar = 1e-3 * lr + lr * eps * (tol * float(g.max())) / (g + eps) ** 2
    return float(((got.double() - want.double()).abs() / bar).max())


def rnnlm_card_vs_cpu(dev, sysm, tag: str) -> None:
    """13a: at the rung's widths on seeded weights (init_rnnlm, SEED),
    the card against the CPU: the forward on one batch of B = 64 LM
    sentences, one full-softmax and one sampled Adam step (the same
    candidates, drawn once) from the same weights, and the scorer's
    log-probs on the prefixes of RNN_SCORER_SENTS sentences."""
    from kaldi_tpu_torch.lm.rnnlm import (RnnLm, RnnLmScorer,
                                          draw_candidates, frame_sentences,
                                          init_rnnlm, train_step,
                                          unigram_proposal)
    cfg = sysm["rnnlm"]["config"]
    sents, bos, eos = _rnnlm_batch(sysm, RNN_B)
    batch_cpu = tuple(torch.from_numpy(a)
                      for a in frame_sentences(sents, bos, eos))
    batch_dev = tuple(a.to(dev) for a in batch_cpu)
    cpu = init_rnnlm(RnnLm(cfg), seed=SEED)
    state = {k: v.clone() for k, v in cpu.state_dict().items()}

    def pair():
        a, b = RnnLm(cfg), RnnLm(cfg)
        a.load_state_dict(state)
        b.load_state_dict(state)
        return a, b.to(dev)

    def rel(x, y):
        return float((x.cpu().double() - y.double()).abs().max()
                     / y.double().abs().max())

    a, b = pair()
    with torch.no_grad():
        la, ca = a(batch_cpu[0])
        lb, cb = b(batch_dev[0])
    fwd = max(rel(lb, la), rel(cb, ca))
    log_q = torch.from_numpy(np.log(unigram_proposal(
        _rnnlm_batch(sysm, 8000)[0], cfg.vocab_size, eos=eos)))
    cand = draw_candidates(log_q, sysm["rnnlm"]["sample_k"],
                           torch.Generator().manual_seed(SEED))
    worst = {"loss": 0.0, "grad": 0.0, "step": 0.0}
    for name, k in (("full", None), ("sampled", cand)):
        a, b = pair()
        oa = torch.optim.Adam(a.parameters(), lr=RNN_LR)
        ob = torch.optim.Adam(b.parameters(), lr=RNN_LR)
        loss_a = train_step(a, oa, *batch_cpu, log_q, k)
        loss_b = train_step(b, ob, *batch_dev, log_q.to(dev),
                            None if k is None else k.to(dev))
        worst["loss"] = max(worst["loss"], abs(float(loss_b) - float(loss_a))
                            / abs(float(loss_a)))
        # the step leaves each weight's gradient in .grad
        pb = dict(b.named_parameters())
        for n, w in a.named_parameters():
            worst["grad"] = max(worst["grad"], rel(pb[n].grad, w.grad))
            worst["step"] = max(worst["step"], _adam_step_ok(
                pb[n].detach().cpu(), w.detach(), w.grad, RNN_LR, RNN_TOL))
        print(f"rnnlm: card vs CPU, one {name}-softmax Adam step (B = "
              f"{RNN_B}, T = {batch_cpu[0].shape[1]}): loss "
              f"{float(loss_b):.6f} / {float(loss_a):.6f}")
    a, _ = pair()
    sc_cpu = RnnLmScorer(a, sysm["lang"].words, device="cpu")
    sc_dev = RnnLmScorer(a, sysm["lang"].words, device=dev)
    words = sysm["lang"].words
    score_err, n = 0.0, 0
    for s in _rnnlm_batch(sysm, RNN_SCORER_SENTS, start=RNN_B)[0]:
        ws = [words.find(w) for w in s]
        for i in range(len(ws) + 1):
            nxt = ws[i] if i < len(ws) else "</s>"
            score_err = max(score_err, abs(sc_dev.score(tuple(ws[:i]), nxt)
                                           - sc_cpu.score(tuple(ws[:i]),
                                                          nxt)))
            n += 1
    print(f"rnnlm: card vs CPU at V = {cfg.vocab_size}, E = "
          f"{cfg.embed_dim}, H = {cfg.hidden_dim} (seeded weights): forward "
          f"logits and carry max |diff| / max |cpu| {fwd:.3e} (limit "
          f"{RNN_TOL:g}); losses {worst['loss']:.3e} relative, gradients "
          f"{worst['grad']:.3e} of each tensor's largest (limit {RNN_TOL:g}); "
          f"weights after the step at most {worst['step']:.3f} of their bar; "
          f"the scorer's log-probs on {n} (history, word) pairs "
          f"({sc_dev.steps} histories on the card) max |diff| "
          f"{score_err:.3e} (limit {RNN_SCORER_ATOL:g}) {tag}")
    if not (fwd <= RNN_TOL and worst["loss"] <= RNN_TOL
            and worst["grad"] <= RNN_TOL and worst["step"] <= 1.0
            and score_err <= RNN_SCORER_ATOL):
        raise AssertionError(f"rnnlm: the card disagrees with the CPU: "
                             f"forward {fwd}, {worst}, scorer {score_err}")


def rnnlm_timing(dev, sysm, tag: str) -> None:
    """13b: the rung's training step on the card (sampled softmax, B = 64,
    the rung's widths, lr): ms a step over RNN_TIME_STEPS steps, and
    kernels and busy card ms a step from a profile of RNN_PROFILE_STEPS;
    then the scorer's step on the rung's trained model: ms a new history
    (one GRU step and its row of log-probs to the host) over the
    prefixes of RNN_SCORER_SENTS sentences."""
    from kaldi_tpu_torch.lm.rnnlm import (RnnLm, RnnLmScorer,
                                          draw_candidates, frame_sentences,
                                          init_rnnlm, train_step,
                                          unigram_proposal)
    from kaldi_tpu_torch.tools.timing import profiled
    cfg = sysm["rnnlm"]["config"]
    sents, bos, eos = _rnnlm_batch(sysm, RNN_B)
    batch = tuple(torch.from_numpy(a).to(dev)
                  for a in frame_sentences(sents, bos, eos))
    model = init_rnnlm(RnnLm(cfg), seed=SEED).to(dev)
    opt = torch.optim.Adam(model.parameters(), lr=RNN_LR)
    log_q = torch.from_numpy(np.log(unigram_proposal(
        _rnnlm_batch(sysm, 8000)[0], cfg.vocab_size, eos=eos))).to(dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    K = sysm["rnnlm"]["sample_k"]

    def step():
        train_step(model, opt, *batch, log_q, draw_candidates(log_q, K, gen))

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(RNN_TIME_STEPS):
        step()
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0) / RNN_TIME_STEPS

    def steps():
        for _ in range(RNN_PROFILE_STEPS):
            step()
        torch.cuda.synchronize()

    wall, n_k, k_ms, _ = profiled(steps)
    words = sysm["lang"].words
    scorer = RnnLmScorer(sysm["rnnlm"]["model"], words, device=dev)
    scorer.score((), "</s>")
    torch.cuda.synchronize()
    n0 = scorer.steps
    t0 = time.perf_counter()
    for s in _rnnlm_batch(sysm, RNN_SCORER_SENTS, start=RNN_B)[0]:
        ws = [words.find(w) for w in s]
        for i in range(len(ws) + 1):
            scorer.score(tuple(ws[:i]), "</s>")
    sc_ms = 1e3 * (time.perf_counter() - t0) / max(scorer.steps - n0, 1)
    print(f"rnnlm: training step on the card (sampled softmax, B = {RNN_B}, "
          f"T = {batch[0].shape[1]}, K = {K}): {step_ms:.3f} ms a step over "
          f"{RNN_TIME_STEPS} steps; profiled {RNN_PROFILE_STEPS} steps: "
          f"{n_k / RNN_PROFILE_STEPS:.1f} kernels and "
          f"{k_ms / RNN_PROFILE_STEPS:.3f} card ms a step "
          f"({100 * k_ms / wall:.1f}% busy) {tag}")
    print(f"rnnlm: scorer step on the card: {sc_ms:.4f} ms a new history "
          f"over {scorer.steps - n0} histories (the trained model) {tag}")


def rnnlm_tools_start(sysm, lat_dir: str):
    """13c, started: the rung's first RNN_TOOL_SENTS LM sentences (word
    ids) and RNN_TOOL_HELD held-out ones, RNN_TOOL_LATS of 11a's chain
    lattices, words.txt and both ARPA LMs written to files, then as
    processes of ``python -m kaldi_tpu_torch.cli`` in one background
    shell: rnnlm-get-sampling-lm → rnnlm-train (the rung's widths, one
    epoch, --sample-k) → rnnlm-compute-prob → lattice-lmrescore-kaldi-
    rnnlm-pruned, and arpa-to-const-arpa → lattice-lmrescore-const-arpa
    on the const file and on the ARPA text (words.txt and the LMs are
    11c's, in ``lat_dir``).  → (process, dir, start)."""
    import shutil
    import subprocess
    from kaldi_tpu_torch.core.table import TableWriter
    repo = os.path.dirname(os.path.abspath(__file__))
    d = os.path.join(repo, "build", "chip_smoke_rnnlm")
    os.makedirs(d, exist_ok=True)
    cfg = sysm["rnnlm"]["config"]
    train, _, _ = _rnnlm_batch(sysm, RNN_TOOL_SENTS)
    held, _, _ = _rnnlm_batch(sysm, RNN_TOOL_HELD, start=RNN_TOOL_SENTS)
    for name, ss in (("train", train), ("held", held)):
        with TableWriter(f"ark,t:{d}/{name}.txt", holder="text") as w:
            for i, s in enumerate(ss):
                w[f"s{i:05d}"] = [str(x) for x in s]
    with TableWriter(f"ark:{d}/lat.ark", holder="clat") as w:
        for u in sorted(sysm["lats_ch"])[:RNN_TOOL_LATS]:
            w[u] = sysm["lats_ch"][u]
    for name in ("words.txt", "lm3.arpa", "lm4.arpa"):
        shutil.copyfile(os.path.join(lat_dir, name), os.path.join(d, name))
    cli = f"{sys.executable} -m kaldi_tpu_torch.cli"
    cmd = (f"{cli} rnnlm-get-sampling-lm --vocab-size={cfg.vocab_size} "
           f"ark,t:{d}/train.txt {d}/sampling.lm && {cli} rnnlm-train "
           f"--device=cuda --vocab-size={cfg.vocab_size} "
           f"--embed-dim={cfg.embed_dim} --hidden-dim={cfg.hidden_dim} "
           f"--num-epochs=1 --learning-rate={RNN_LR} "
           f"--sample-k={sysm['rnnlm']['sample_k']} ark,t:{d}/train.txt "
           f"{d}/rnnlm.mdl && {cli} rnnlm-compute-prob --device=cuda "
           f"{d}/rnnlm.mdl ark,t:{d}/held.txt > {d}/ppl.txt && {cli} "
           f"lattice-lmrescore-kaldi-rnnlm-pruned --device=cuda "
           f"{d}/lm3.arpa {d}/rnnlm.mdl {d}/words.txt ark:{d}/lat.ark "
           f"ark:{d}/rnnlm.ark && {cli} arpa-to-const-arpa {d}/lm4.arpa "
           f"{d}/lm4.const && {cli} lattice-lmrescore-const-arpa "
           f"{d}/lm4.const {d}/words.txt ark:{d}/lat.ark ark:{d}/const.ark"
           f" && {cli} lattice-lmrescore-const-arpa {d}/lm4.arpa "
           f"{d}/words.txt ark:{d}/lat.ark ark:{d}/text.ark")
    proc = subprocess.Popen(["bash", "-o", "pipefail", "-c", cmd],
                            cwd=repo, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    return proc, d, time.perf_counter()


def _same_lattices(got, want, tol: float) -> float:
    """Equal structure (states, arcs' words, tids and next states,
    finals); → the largest weight difference (asserted ≤ tol)."""
    worst = 0.0
    if sorted(got) != sorted(want) or not got:
        raise AssertionError(f"lattice keys differ: {sorted(got)} "
                             f"{sorted(want)}")
    for u in want:
        a, b = got[u], want[u]
        if (a.start, a.num_states, sorted(a.finals)) != \
                (b.start, b.num_states, sorted(b.finals)):
            raise AssertionError(f"{u}: lattices differ in shape")
        for s in range(b.num_states):
            if [(x.word, tuple(x.tids), x.nextstate) for x in a.arcs[s]] != \
                    [(x.word, tuple(x.tids), x.nextstate)
                     for x in b.arcs[s]]:
                raise AssertionError(f"{u}: state {s}'s arcs differ")
            for x, y in zip(a.arcs[s], b.arcs[s]):
                worst = max(worst, abs(x.graph_cost - y.graph_cost),
                            abs(x.acoustic_cost - y.acoustic_cost))
        for s, f in b.finals.items():
            worst = max(worst, abs(a.finals[s][0] - f[0]),
                        abs(a.finals[s][1] - f[1]))
    if not worst <= tol:
        raise AssertionError(f"lattice weights differ by {worst}")
    return worst


def rnnlm_tools_finish(dev, sysm, started, tag: str) -> None:
    """13c, checked: the proposal is a distribution; the tool's model
    reads back and its perplexity on the held-out text equals the
    library's on the card; the tool's RNNLM-rescored lattices equal the
    library's pruned rescoring with that model on the card (the same
    steps in process, each lattice stored as the tools store it); the
    const-ARPA lattices equal the ARPA text's within the const file's
    float32 rounding, and its histories ran on the card."""
    import io
    from kaldi_tpu_torch.cli.tools_rnnlm import read_sampling_lm
    from kaldi_tpu_torch.core.table import SequentialTableReader
    from kaldi_tpu_torch.fst.arpa import ArpaModel
    from kaldi_tpu_torch.lattice.io import (read_compact_lattice,
                                            write_compact_lattice)
    from kaldi_tpu_torch.lattice.rescore import lmrescore_pruned
    from kaldi_tpu_torch.lm.rnnlm import (RnnLmScorer, load_rnnlm,
                                          perplexity)
    proc, d, t0 = started
    stdout, stderr = proc.communicate(timeout=900)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"rnnlm tools failed ({proc.returncode}):\n"
                             f"{stderr[-3000:]}")
    q = read_sampling_lm(f"{d}/sampling.lm")
    model = load_rnnlm(f"{d}/rnnlm.mdl", device=dev)
    held = [[int(x) for x in v] for _, v in
            SequentialTableReader(f"ark,t:{d}/held.txt", holder="text")]
    tool_ppl = float(open(f"{d}/ppl.txt").read().split()[-1])
    lib_ppl = perplexity(model, held)

    def stored(lat):
        buf = io.BytesIO()
        write_compact_lattice(buf, lat)
        buf.seek(0)
        return read_compact_lattice(buf)

    words = sysm["lang"].words
    scorer = RnnLmScorer(model, words, device=dev)
    old = ArpaModel.parse(f"{d}/lm3.arpa")
    lib = {u: stored(lmrescore_pruned(lat, old, scorer, words, beam=6.0,
                                      max_arcs=100_000))
           for u, lat in SequentialTableReader(f"ark:{d}/lat.ark",
                                               holder="clat")}
    tool = dict(SequentialTableReader(f"ark:{d}/rnnlm.ark", holder="clat"))
    rnn_err = _same_lattices(tool, lib, 1e-3)
    const_err = _same_lattices(
        dict(SequentialTableReader(f"ark:{d}/const.ark", holder="clat")),
        dict(SequentialTableReader(f"ark:{d}/text.ark", holder="clat")),
        1e-3)
    on_card = "histories scored on cuda" in stderr
    print(f"tools: rnnlm-get-sampling-lm (sum {q.sum():.6f}) → rnnlm-train "
          f"(one epoch of {RNN_TOOL_SENTS} sentences) → rnnlm-compute-prob "
          f"(ppl {tool_ppl:.4f}, library on the card {lib_ppl:.4f}) → "
          f"lattice-lmrescore-kaldi-rnnlm-pruned on {len(tool)} chain "
          f"lattices (equal to the library's, weights within {rnn_err:.2e}; "
          f"scorer on the card: {on_card}); arpa-to-const-arpa → "
          f"lattice-lmrescore-const-arpa equal to the ARPA text's within "
          f"{const_err:.2e}; {wall:.1f} s in the background {tag}")
    if not (abs(q.sum() - 1.0) < 1e-5 and q.min() > 0 and held
            and abs(tool_ppl - lib_ppl) <= 1e-5 * lib_ppl + 1e-6
            and math.isfinite(lib_ppl) and on_card):
        raise AssertionError(f"rnnlm tools: proposal sum {q.sum()}, ppl "
                             f"{tool_ppl} / {lib_ppl}, on the card "
                             f"{on_card}")


# phase 14: lattice and end-to-end supervision.  14a's bars are the
# flexible numerator's parity bars (tests/test_torch_chain.py): log-probs
# rtol 1e-5 / atol 1e-5, gradients rtol 1e-4 / atol 1e-5
LAT_T_SUB = CHAIN_T // 3    # chunks of 50 subsampled frames
LAT_B = 128
LAT_TOL = 1
LAT_VAL_RTOL, LAT_VAL_ATOL = 1e-5, 1e-5
LAT_GRAD_RTOL, LAT_GRAD_ATOL = 1e-4, 1e-5
# 14a's whole-utterance check, as tests/test_chain_supervision.py's: the
# normalization-weighted numerator is a weighted subset of the den's
# paths, so num <= den (no leak) up to float32 rounding
LAT_NUM_DEN_SLACK = 1e-3
LAT_POINTS = ((32, "float32"), (128, "bfloat16"))
LAT_STEPS, LAT_PROFILE_STEPS = 10, 2


def _moved_boundaries(rng, runs):
    """The same phones with every boundary moved by a seeded ±1–2 frames
    (each phone keeps at least one frame)."""
    total = sum(d for _, d in runs)
    b = np.cumsum([d for _, d in runs])[:-1]
    b = b + rng.choice([-2, -1, 1, 2], len(b))
    for i in range(len(b)):
        lo = (b[i - 1] if i else 0) + 1
        hi = total - (len(b) - i)
        b[i] = min(max(b[i], lo), hi)
    d = np.diff(np.concatenate([[0], b, [total]]))
    return [(ph, int(n)) for (ph, _), n in zip(runs, d)]


def _substituted(rng, runs, phones):
    """The same durations with one seeded phone replaced by another that
    neither neighbour has."""
    out = list(runs)
    i = int(rng.integers(len(runs)))
    near = {runs[j][0] for j in (i - 1, i, i + 1) if 0 <= j < len(runs)}
    ph = int(rng.choice([p for p in phones if p not in near]))
    out[i] = (ph, runs[i][1])
    return out


def alignment_lattices(topo, tree, runs, seed: int):
    """14a: each utterance's phone alignment → a CompactLattice of three
    word arcs (graph costs 0, 0.5, 1): the alignment, every boundary
    moved by a seeded ±1–2 frames, and one phone substituted
    (tests/test_chain_supervision.py's two_alt_lattice builds them).
    → (transition model, utt → lattice)."""
    from kaldi_tpu_torch.am.transitions import TransitionModel
    from kaldi_tpu_torch.lattice.lattice import CompactArc, CompactLattice
    tm = TransitionModel(topo, tree)
    fwd, slf = {}, {}
    for tid in range(1, tm.num_transition_ids + 1):
        (slf if tm.is_self_loop(tid) else fwd).setdefault(
            tm.transition_id_to_phone(tid), tid)
    rng = np.random.default_rng(seed)
    lats = {}
    for u, r in runs.items():
        clat = CompactLattice()
        s0, s1 = clat.add_state(), clat.add_state()
        clat.start = s0
        for cost, path in ((0.0, r), (0.5, _moved_boundaries(rng, r)),
                           (1.0, _substituted(rng, r, topo.phones))):
            tids = []
            for ph, d in path:
                tids.extend([fwd[ph]] + [slf[ph]] * (d - 1))
            clat.arcs[s0].append(CompactArc(1, cost, 0.0, tuple(tids), s1))
        clat.finals[s1] = (0.0, 0.0, ())
        lats[u] = clat
    return tm, lats


def _within(got, want, rtol, atol) -> float:
    """max |got − want| / (atol + rtol·|want|): at most 1 within the bar."""
    return float(((got - want).abs() / (atol + rtol * want.abs())).max())


def lattice_numerator(dev, topo, tree, den, feats, runs, tag: str):
    """14a: phase 8b's utterances and alignments as 3-path alignment
    lattices with the bench den's normalization weights, cut into chunks
    of LAT_T_SUB subsampled frames; the FSA numerator on the card
    against the port's CPU at B = LAT_B chunks, tolerance LAT_TOL (log-
    probs and d/d scores), num <= den on the whole-utterance FSAs on the
    card, and the forward + backward's time (one call as a CUDA graph
    launch, graph_ms) and launches a call.  → (chunk egs, stats)."""
    from kaldi_tpu_torch.am.chain import denominator_logprob
    from kaldi_tpu_torch.am.chain_supervision import (
        make_chain_egs_from_lattices, numerator_fsa_logprob, sup_to_device)
    from kaldi_tpu_torch.tools.timing import graph_ms, profiled
    t0 = time.perf_counter()
    tm, lats = alignment_lattices(topo, tree, runs, SEED + 14)
    whole = make_chain_egs_from_lattices(feats, lats, tm, tree, topo,
                                         subsample=3, den=den)
    egs = make_chain_egs_from_lattices(feats, lats, tm, tree, topo,
                                       subsample=3, den=den,
                                       chunk_size=LAT_T_SUB)
    build_s = time.perf_counter() - t0
    N, T_sub = egs.mask.shape
    if N < LAT_B or T_sub != LAT_T_SUB:
        raise AssertionError(f"{N} lattice egs of {T_sub} frames")
    ws, cs = whole.sup, egs.sup
    print(f"lattice: {len(lats)} utterances → 3-path alignment lattices → "
          f"whole-utterance FSAs with the den's normalization weights: "
          f"arcs {int(ws['n_arcs'].min())}-{int(ws['n_arcs'].max())} (mean "
          f"{float(ws['n_arcs'].mean()):.1f}), states "
          f"{int(ws['n_states'].min())}-{int(ws['n_states'].max())}, "
          f"{int(ws['num_frames'].min())}-{int(ws['num_frames'].max())} "
          f"subsampled frames; {N} chunks of {T_sub}: arcs "
          f"{int(cs['n_arcs'].min())}-{int(cs['n_arcs'].max())} (padded "
          f"to {cs['src'].shape[1]}), states up to {cs['bt'].shape[1]}, "
          f"{int(cs['mid_start'].sum())} start and {int(cs['mid_end'].sum())}"
          f" end mid-utterance (host build {build_s:.1f} s)")
    P = tree.num_pdfs
    rng = np.random.default_rng(SEED + 15)
    scores = torch.from_numpy((2.0 * rng.standard_normal((LAT_B, T_sub, P)))
                              .astype(np.float32))
    rows = np.arange(LAT_B)
    batch = {k: v[rows] for k, v in cs.items()}
    res = {}
    for d in (dev, torch.device("cpu")):
        sup = sup_to_device(batch, d)
        s = scores.to(d).clone().requires_grad_(True)
        v = numerator_fsa_logprob(s, sup, LAT_TOL)
        v.sum().backward()
        res[d.type] = (v.detach().cpu(), s.grad.cpu())
    (vg, gg), (vc, gc) = res[dev.type], res["cpu"]
    dv = _within(vg, vc, LAT_VAL_RTOL, LAT_VAL_ATOL)
    dg = _within(gg, gc, LAT_GRAD_RTOL, LAT_GRAD_ATOL)
    active = torch.from_numpy(egs.mask[rows])
    rows_sum = float((gc.sum(dim=2) - active.float()).abs().max())
    print(f"lattice: FSA numerator at B={LAT_B}, T={T_sub}, P={P}, "
          f"tolerance {LAT_TOL}: the card vs the port's CPU: log-prob "
          f"(range [{float(vc.min()):.1f}, {float(vc.max()):.1f}]) at most "
          f"{dv:.3f} of the bar rtol {LAT_VAL_RTOL:g} / atol "
          f"{LAT_VAL_ATOL:g}, d/d scores at most {dg:.3f} of rtol "
          f"{LAT_GRAD_RTOL:g} / atol {LAT_GRAD_ATOL:g} (max |diff| "
          f"{float((gg - gc).abs().max()):.3e}); gradient rows sum to 1 "
          f"on the active frames (0 past them) within {rows_sum:.2e}")
    if not (dv <= 1.0 and dg <= 1.0 and rows_sum <= 1e-3):
        raise AssertionError("the FSA numerator on the card differs from "
                             "the CPU")
    # num <= den on the whole utterances, on the card (no leak)
    B_w, T_w = whole.mask.shape
    sw = torch.from_numpy((2.0 * rng.standard_normal((B_w, T_w, P)))
                          .astype(np.float32)).to(dev)
    mask_w = torch.from_numpy(whole.mask).to(dev)
    with torch.no_grad():
        num = numerator_fsa_logprob(sw, sup_to_device(ws, dev),
                                    LAT_TOL).cpu()
        dl = denominator_logprob(den, sw, mask=mask_w).cpu()
    gap = float((num - dl).max())
    print(f"lattice: whole-utterance FSAs on the card: num − den at most "
          f"{gap:.4f} (limit {LAT_NUM_DEN_SLACK:g}) over {B_w} utterances "
          f"of up to {T_w} subsampled frames")
    if not gap <= LAT_NUM_DEN_SLACK:
        raise AssertionError(f"the FSA numerator exceeds the den: {gap}")
    # forward + backward on the card: its launches a call (torch.profiler
    # on one call) and its time as one CUDA graph launch
    sup = sup_to_device(batch, dev)
    x = scores.to(dev)

    def fwd_bwd():
        s = x.clone().requires_grad_(True)
        numerator_fsa_logprob(s, sup, LAT_TOL).sum().backward()
        return s.grad

    fwd_bwd()

    def one():
        fwd_bwd()
        torch.cuda.synchronize()

    _, n_k, busy, _ = profiled(one)
    ms = min(graph_ms(fwd_bwd) for _ in range(2))
    print(f"lattice: FSA numerator forward + backward at B={LAT_B}: "
          f"{ms:.4f} ms on the card (best of 2 graph launches, graph_ms), "
          f"{n_k} kernel launches a call ({busy:.4f} ms of kernels under "
          f"the profiler) {tag}")
    return egs, {"num_ms": ms, "num_launches": n_k, "num_err": dg}


# 14c's work dir and the mono loop's last alignment in the CLI recipe (8
# iterations, a realignment after every second)
RECIPES_DIR = os.path.join("build", "chip_smoke_chain_recipes")
RECIPE_ALI = "ali.8.ark"
RECIPE_E2E_EPOCHS = 2


def chain_recipes_start(dev):
    """14c (in the background after 11a's rung, beside 11a's checks and
    11c's and 13c's tools): the chain CLI recipe at its
    defaults, then on its work dir ali-to-phones →
    nnet3-chain-e2e-get-egs → nnet3-chain-compute-prob →
    nnet3-chain-train (free boundaries, RECIPE_E2E_EPOCHS epochs) →
    compute-prob, chain-get-supervision; in a second process beside
    them the chain recipe at its defaults; each step's wall in ms.  →
    (the tools' process, work dir, the chain recipe's process)."""
    import subprocess
    repo = os.path.dirname(os.path.abspath(__file__))
    w = os.path.join(repo, RECIPES_DIR)
    if os.path.isdir(w):
        import shutil
        shutil.rmtree(w)
    os.makedirs(w)
    c, e = os.path.join(w, "cli"), os.path.join(w, "e2e")
    py = sys.executable
    tool = f"{py} -m kaldi_tpu_torch.cli"
    dv = f"--device={dev.type}"
    ali = f"ark:{c}/exp/mono/{RECIPE_ALI}"
    prob = (f"{tool} nnet3-chain-compute-prob {dv} --lm-order=2 "
            f"--supervision-tolerance=$T {c}/exp/chain/0.mdl")
    tail = f"ark:{e}/phones.ark ark:{e}/egs.ark"
    timed = f"""set -e
t() {{ l=$1; shift; s=$(date +%s%N); "$@"; echo "$l $(( ($(date +%s%N) - s) / 1000000 ))" >> {w}/walls.txt; }}
"""
    script = timed + f"""t chain_cli_recipe {py} -m kaldi_tpu_torch.pipelines.chain_cli_recipe --work-dir={c} {dv} > {w}/cli.out 2> {w}/cli.err
mkdir -p {e}
t ali-to-phones {tool} ali-to-phones {c}/exp/mono/final.mdl {ali} ark:{e}/phones.ark 2>> {w}/tools.err
t nnet3-chain-e2e-get-egs {tool} nnet3-chain-e2e-get-egs {c}/exp/chain/0.mdl scp:{c}/mfcc/final_train.scp ark:{e}/phones.ark ark:{e}/egs.ark {e}/den.fst 2>> {w}/tools.err
T=$({py} -c "from kaldi_tpu_torch.pipelines.egs_io import read_egs_ark; print(read_egs_ark('ark:{e}/egs.ark').mask.shape[1])" 2>> {w}/tools.err)
echo $T > {e}/tolerance.txt
t nnet3-chain-compute-prob {prob} {c}/exp/chain/0.raw {tail} > {e}/before.txt 2>> {w}/tools.err
t nnet3-chain-train {tool} nnet3-chain-train {dv} --lm-order=2 --supervision-tolerance=$T --num-epochs={RECIPE_E2E_EPOCHS} --learning-rate=2e-3 {c}/exp/chain/0.mdl {c}/exp/chain/0.raw {tail} {e}/1.raw 2>> {w}/tools.err
t nnet3-chain-compute-prob {prob} {e}/1.raw {tail} > {e}/after.txt 2>> {w}/tools.err
t chain-get-supervision {tool} chain-get-supervision {c}/exp/mono/final.mdl {ali} ark:{e}/sup.ark 2>> {w}/tools.err
"""
    recipe = timed + (f"t chain_recipe {py} -m "
                      f"kaldi_tpu_torch.pipelines.chain_recipe {dv} > "
                      f"{w}/recipe.out 2> {w}/recipe.err\n")
    # two threads a process: the flagship's checks run beside them
    env = dict(os.environ, OMP_NUM_THREADS="2")
    procs = [subprocess.Popen(["bash", "-c", sh], cwd=repo, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for sh in (script, recipe)]
    return procs[0], w, procs[1]


def chain_recipes_finish(started, tag: str) -> None:
    """14c: both recipes exited 0 (the CLI recipe's WER under 20: its exit
    rule), the e2e tool chain trained to a finite, better objective, the
    re-run ali-to-phones equals the recipe's, chain-get-supervision's
    FSAs equal the library's supervision_from_phone_runs, and the
    recipe's nnet3-chain-get-egs archive equals make_chain_egs in this
    process."""
    from kaldi_tpu_torch.am.chain import make_denominator_graph
    from kaldi_tpu_torch.am.chain_supervision import \
        supervision_from_phone_runs
    from kaldi_tpu_torch.am.serialize import read_mdl
    from kaldi_tpu_torch.cli.tools_chain import (_pdfs_for_factory,
                                                 _subsample_runs)
    from kaldi_tpu_torch.core.table import SequentialTableReader
    from kaldi_tpu_torch.pipelines.chain import (make_chain_egs,
                                                 phone_alignment_runs)
    from kaldi_tpu_torch.pipelines.egs_io import read_egs_ark
    proc, w, rproc = started
    t0 = time.perf_counter()
    err = proc.communicate(timeout=900)[1]
    rerr = rproc.communicate(timeout=900)[1]
    waited = time.perf_counter() - t0

    def text(name):
        path = os.path.join(w, name)
        return open(path).read() if os.path.exists(path) else ""

    if proc.returncode != 0 or rproc.returncode != 0:
        raise AssertionError(
            f"14c failed ({proc.returncode}, {rproc.returncode}):\n"
            f"{err[-2000:]}\n{rerr[-2000:]}\n"
            f"{text('cli.err')[-2000:]}{text('tools.err')[-2000:]}"
            f"{text('recipe.err')[-2000:]}")
    for line in text("walls.txt").splitlines():
        what, ms = line.split()
        print(f"chain-recipes: {what}: {int(ms) / 1e3:.1f} s wall {tag}")
    cli = text("cli.out").strip().splitlines()
    print(f"chain-recipes: chain_cli_recipe (defaults: 40 / 12 utterances, 8 "
          f"mono iterations, 8 chain epochs, hidden 48): {cli[-2]}; "
          f"{cli[-1]} {tag}")
    print(f"chain-recipes: chain_recipe (defaults: 50 utterances, 40 epochs,"
          f" hidden 128): {text('recipe.out').strip().splitlines()[-1]} "
          f"{tag}")
    c, e = os.path.join(w, "cli"), os.path.join(w, "e2e")
    before = float(text("e2e/before.txt").strip().splitlines()[-1])
    after = float(text("e2e/after.txt").strip().splitlines()[-1])
    tol = int(text("e2e/tolerance.txt"))
    print(f"chain-recipes: e2e tools: nnet3-chain-compute-prob {before:.4f} "
          f"→ nnet3-chain-train {RECIPE_E2E_EPOCHS} epochs at tolerance "
          f"{tol} (the egs' largest subsampled length) → {after:.4f}")
    if not (math.isfinite(before) and math.isfinite(after)
            and after > before):
        raise AssertionError(f"e2e chain tools: objf {before} → {after}")
    with open(f"{e}/phones.ark", "rb") as a, \
            open(f"{c}/exp/chain/phones.ark", "rb") as b:
        if a.read() != b.read():
            raise AssertionError("ali-to-phones differs from the recipe's")
    mono, _ = read_mdl(f"{c}/exp/mono/final.mdl", device="cpu")
    chain, _ = read_mdl(f"{c}/exp/chain/0.mdl", device="cpu")
    alis = {k: v.tolist() for k, v in SequentialTableReader(
        f"ark:{c}/exp/mono/{RECIPE_ALI}", holder="ivec")}
    pf = _pdfs_for_factory(mono.tree, mono.topo)
    n = 0
    for key, eg in SequentialTableReader(f"ark:{e}/sup.ark", holder="ceg"):
        r = _subsample_runs(phone_alignment_runs(mono, alis[key]), 3)
        want = supervision_from_phone_runs(
            [r], [0.0], lambda q: pf(q, True), lambda q: pf(q, False),
            sum(d for _, d in r))
        for f in ("src", "dst", "entry_pdf", "self_pdf", "weight", "bt",
                  "final"):
            if not np.array_equal(getattr(eg.fsa, f), getattr(want, f)):
                raise AssertionError(f"chain-get-supervision {key}: {f}")
        n += 1
    feats = dict(SequentialTableReader(f"scp:{c}/mfcc/final_train.scp",
                                       holder="mat"))
    runs = {k: phone_alignment_runs(mono, alis[k]) for k in sorted(feats)}
    den = make_denominator_graph([[q for q, _ in runs[k]] for k in runs],
                                 chain.tree, chain.topo, order=3)
    want = make_chain_egs(feats, runs, chain.tree, chain.topo,
                          chunk_size=30, subsample=3, den=den)
    got = read_egs_ark(f"ark:{c}/exp/chain/egs.raw.ark")
    for f in ("feats", "pdf_ali", "mask", "entry_pdf", "self_pdf",
              "num_segs", "entry_w", "self_w", "init_w", "final_w"):
        g, wnt = getattr(got, f), getattr(want, f)
        if f in ("entry_pdf", "self_pdf", "entry_w", "self_w"):
            wnt = wnt[:, :g.shape[1]]
        if not np.array_equal(g, wnt):
            raise AssertionError(f"nnet3-chain-get-egs differs: {f}")
    print(f"chain-recipes: chain-get-supervision: {n} FSAs equal to "
          f"supervision_from_phone_runs; ali-to-phones equal to the recipe's;"
          f" nnet3-chain-get-egs's {got.feats.shape[0]} egs equal to "
          f"make_chain_egs in process (waited {waited:.1f} s for 14c)")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from kaldi_tpu_torch.am.chain import den_kernel
    from kaldi_tpu_torch.am.tdnn import TdnnChain, TdnnConfig
    from kaldi_tpu_torch.decoder.beam import (BeamDecoder, BeamDecoderConfig,
                                              host_lattice_backend)
    from kaldi_tpu_torch.features.compute import (Fbank, FbankOptions, Mfcc,
                                                  MfccOptions)
    from kaldi_tpu_torch.features.mel import MelBanksOptions
    from kaldi_tpu_torch.features.window import (FrameExtractionOptions,
                                                 preprocess_frames)
    from kaldi_tpu_torch.ops import build
    from kaldi_tpu_torch.ops.fbank import CudaFbank, fbank_reference
    from kaldi_tpu_torch.pipelines.decode import (decode_scores,
                                                  decode_waveforms)
    from kaldi_tpu_torch.pipelines.largevocab import (make_largevocab_task,
                                                      sample_eval_set,
                                                      synth_loglikes)
    from kaldi_tpu_torch.pipelines.score import compute_wer
    from kaldi_tpu_torch.tools.timing import (card_info, cuda_ms, device_ms,
                                              fbank_bound)

    # 1. device
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    card = card_info()
    tag = f"[{card}]"
    print(f"device: {kind} | nvidia-smi: {card} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 2. build every kernel, one nvcc per source, all started together
    t0 = time.perf_counter()
    build.load_all()
    print(f"build: {', '.join(s for v in build.KERNELS.values() for s in v)}"
          f" with nvcc in {time.perf_counter() - t0:.2f} s")
    for name in build.KERNELS:
        for line in build.BUILD_LOG.get(name, "").splitlines():
            if "registers" in line or "spill" in line:
                print(f"build: {name}: ptxas {line.strip()}")

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
        times[which].append(device_ms(plain if which == "plain"
                                      else lambda: kern(x), 50))
    fb_ms, fb_plain_ms = min(times["kernel"]), min(times["plain"])
    fb_bound = fbank_bound(kern, x.shape[0])
    print(f"fbank: 4096 frames on the card: kernel {fb_ms:.4f} ms, plain "
          f"{fb_plain_ms:.4f} ms (best of 2 × 50 launches), bound "
          f"{fb_bound[0]:.4f} ms by {fb_bound[1]} "
          f"({100 * fb_bound[0] / fb_ms:.1f}% of it); {len(kern.groups)} "
          f"mel filter groups {tag}")
    # the MFCC configurations of the GMM path (launches here are not
    # counted): 16 kHz with 23 bins, 8 kHz with 15 bins (window 200,
    # n_fft 256)
    mfcc16 = Mfcc(MfccOptions(mel_opts=MelBanksOptions(num_bins=23),
                              num_ceps=13, use_energy=False), device=dev)
    mfcc8 = Mfcc(MfccOptions(
        frame_opts=FrameExtractionOptions(samp_freq=8000.0),
        mel_opts=MelBanksOptions(num_bins=15), num_ceps=10), device=dev)
    for m in (mfcc16, mfcc8):
        mk = m.kernel
        raw = torch.from_numpy((1000.0 * rng.standard_normal(
            (4096, mk.win_size))).astype(np.float32)).to(dev)
        xm = preprocess_frames(raw, m.frame_opts)[0].contiguous()
        err = float((mk(xm) - fbank_reference(xm, mk.window, mk.cos, mk.sin,
                                              mk.mel)).abs().max())
        print(f"fbank: {m.frame_opts.samp_freq:.0f} Hz, {mk.n_mel} bins "
              f"(window {mk.win_size}, {mk.n_bins} DFT bins): kernel vs "
              f"plain on 4096 frames: max |diff| {err:.3e} (limit 2e-3)")
        if not err <= 2e-3:
            raise AssertionError(f"fbank kernel disagrees: {err}")
        fb_err = max(fb_err, err)
    # Fbank's use_power x use_log_fbank at 40 bins (launches here are not
    # counted): log mel energies within 2e-3, linear ones within 2e-3 of
    # their size (the same bar, e^2e-3 - 1 ~ 2e-3 relative)
    for use_power in (True, False):
        for use_log in (True, False):
            ko = CudaFbank(fopts.frame_opts, fopts.mel_opts, dev,
                           use_power=use_power, use_log=use_log)
            got = ko(x)
            want = fbank_reference(x, ko.window, ko.cos, ko.sin, ko.mel,
                                   use_power=use_power, use_log=use_log)
            d = (got - want).abs()
            err = float(d.max() if use_log else (d / want).max())
            ko_ms = min(device_ms(lambda: ko(x), 50) for _ in range(2))
            print(f"fbank: use_power={use_power} use_log_fbank={use_log}: "
                  f"kernel vs plain on 4096 frames: max "
                  f"{'|diff|' if use_log else '|diff| / plain'} {err:.3e} "
                  f"(limit 2e-3); kernel {ko_ms:.4f} ms on the card (best "
                  f"of 2 × 50) {tag}")
            if not err <= 2e-3:
                raise AssertionError(f"fbank kernel disagrees at use_power="
                                     f"{use_power} use_log={use_log}: {err}")
            if use_log:
                fb_err = max(fb_err, err)
    wide_err, wide_ms, wide_plain_ms, wide_bound, wide_launches = \
        wide_banks(dev, x, tag)

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

    # 6. the GMM decode path
    gmm_err, gmm_ms, gmm_plain_ms, gmm_bnd = gmm_kernel_check(dev, tag)
    b_gmm, b_fb, b_err, b_fb_err = gmm_beam_branch(dev, task, mfcc16, tag)
    task300 = make_largevocab_task(vocab_size=300, order=3, seed=7,
                                   closure=False, corpus_sentences=600)
    d_gmm, d_fb, d_err = gmm_dense_branch(dev, task300, mfcc16, tag)
    if min(b_gmm, b_fb, d_gmm, d_fb) <= 0:
        raise AssertionError(f"GMM path launches: beam branch GMM {b_gmm} "
                             f"fbank {b_fb}, dense branch GMM {d_gmm} "
                             f"fbank {d_fb}")

    # 7. the streaming decode path
    t0 = time.perf_counter()
    stream_beam(dec, cpu_dec, lls, best, tag)
    multistream(dec, lls, best, tag)
    s_fb, s_err = stream_wav(dev, waves, model, dec, tag)
    c_fb = online2_cli(dev, task300, tag)
    print(f"stream: phase 7 took {time.perf_counter() - t0:.1f} s")

    # 8. the chain training path (nnet3-chain-train)
    t0 = time.perf_counter()
    ctopo, ctree, cseqs, cden = bench_den_graph()
    P = ctree.num_pdfs
    print(f"den: the bench's graph: {len(ctopo.phones)} phones, trigram "
          f"phone LM, {cden.num_states} states, {len(cden.src)} arcs, "
          f"{P} pdfs (built in {time.perf_counter() - t0:.1f} s)")
    den_err, den_ms, den_plain_ms, den_bnd = den_kernel_check(dev, cden, P,
                                                              tag)
    bden, bP = biphone_den_graph()
    print(f"den: the left-biphone graph: {bden.num_states} states, "
          f"{len(bden.src)} arcs, {bP} pdfs")
    den_err = max(den_err, den_kernel_check(dev, bden, bP, tag)[0])
    dk = den_kernel(cden, dev)
    # the main path: waveforms → egs (a new Fbank computer, its count at
    # 0) → the four training points
    dk.launches = 0
    t1 = time.perf_counter()
    egs, cfb, egs_audio_s, cfeats, cruns = chain_egs(dev, ctopo, ctree,
                                                     cden, 48)
    t_egs = time.perf_counter() - t1
    rates = chain_train_points(dev, cden, egs, P, tag)
    t_fb = cfb.kernel.launches
    den_launches = dk.launches
    if min(t_fb, den_launches) <= 0:
        raise AssertionError(f"training path launches: fbank {t_fb}, den "
                             f"{den_launches}")
    print(f"train: egs: {egs_audio_s:.2f} s of audio → {egs.feats.shape[0]} "
          f"egs of {CHAIN_T} frames in {t_egs:.1f} s; fbank launches {t_fb}, "
          f"den kernel launches {den_launches} (forward and backward)")
    for key, v in rates.items():
        print(f"{key} {v:.4f} {tag}")
    card_step_equals_cpu(dev, cden, egs, P)
    chain_cli(dev, ctopo, ctree, cseqs, egs, tag)
    print(f"train: phase 8 took {time.perf_counter() - t0:.1f} s")

    # 9. the rest of the feature frontend
    t0 = time.perf_counter()
    sp_fb = spectrogram_plp(dev, waves, tag)
    W, fe_m, feats9, bf_fb, bf_err = batched_frontend(dev, tag)
    p_gmm, p_fb, p_err = gmm_provider(dev, W, fe_m, feats9, tag)
    del W, feats9
    cli_fb = feature_cli(dev, waves, tag)
    print(f"features: phase 9 took {time.perf_counter() - t0:.1f} s")

    # 10. GMM training and the GMM recipes; 10d's tools run in the
    # background beside 10b and 10c
    t0 = time.perf_counter()
    y_fb, y_gmm, ysys = yesno_recipe(dev, tag)
    tools = gmm_tools_start(dev, ysys)
    try:
        m_fb, m_gmm = mini_recipe(dev, tag)
        tri3b_training(dev, task300, tag)
        tool_gmm = gmm_tools_finish(dev, ysys, tools, tag)
    finally:
        if tools[0].poll() is None:
            tools[0].kill()
            tools[0].wait()
    print(f"train: phase 10 took {time.perf_counter() - t0:.1f} s")

    # 11. the flagship system on the card (its launches are counted), its
    # kernels at its shapes, card against CPU, the lattice tools on its
    # lattices; then the hard corpus
    # 12a's i-vector tools run in the background beside 11a
    t0 = time.perf_counter()
    device_time_check(dev, tag)
    iv_tools = ivector_tools_start(dev, task300, waves)
    procs = [iv_tools]
    try:
        f_fb, f_gm, f_den, f_results, fsys, f_wall = flagship_system(dev,
                                                                     tag)
        rnnlm_rung(f_results, fsys, tag)
        # 11c's, 13c's and 14c's tools run in the background from here,
        # beside 11a's and 11d's checks, 12's and 12b's in-process checks
        lat_tools = lattice_tools_start(fsys)
        procs.append(lat_tools)
        rnn_tools = rnnlm_tools_start(fsys, lat_tools[1])
        procs.append(rnn_tools)
        recipes = chain_recipes_start(dev)
        procs += [recipes, recipes[2:]]
        flagship_graphs(f_results, fsys)
        f_fb_err, f_gm_err, f_den_err = flagship_kernels(dev, fsys, tag)
        flagship_card_vs_cpu(dev, fsys, tag)
        ivector_card_vs_cpu(dev, fsys, tag)
        print(f"flagship: 11a and 11d took {time.perf_counter() - t0:.1f} s")
        # 12b's card run in the background beside 12a's check and 12b's
        # in-process check
        t1 = time.perf_counter()
        iv_gmm, iv_gmm_err = ivector_tools_finish(dev, iv_tools, tag)
        procs.append(stream_ivectors_start(iv_tools[1]))
        iv_fb = stream_ivectors(dev, waves, iv_tools[1], procs[-1], tag)
        lattice_tools_finish(fsys, lat_tools)
        rnnlm_tools_finish(dev, fsys, rnn_tools, tag)
        chain_recipes_finish(recipes, tag)
        print(f"ivectors: 12a's check, 12b, 11c's, 13c's and 14c's checks "
              f"took {time.perf_counter() - t1:.1f} s")
        # 13a, 13b: the RNNLM on the card alone (every background process
        # has ended)
        t1 = time.perf_counter()
        rnnlm_card_vs_cpu(dev, fsys, tag)
        rnnlm_timing(dev, fsys, tag)
        print(f"rnnlm: 13a and 13b took {time.perf_counter() - t1:.1f} s")
        del fsys
    finally:
        for p in procs:
            if p[0].poll() is None:
                p[0].kill()
                p[0].wait()
    t1 = time.perf_counter()
    hard_corpus(dev, tag)
    print(f"hard: 11b took {time.perf_counter() - t1:.1f} s; phases 11 and "
          f"12 {time.perf_counter() - t0:.1f} s")

    # 14. chain training on lattice supervision: 14a the FSA numerator on
    # phase 8b's utterances, 14b the trainer on its egs (the main path:
    # the den kernels' count zeroed before it and read after)
    t0 = time.perf_counter()
    lat_egs, lat = lattice_numerator(dev, ctopo, ctree, cden, cfeats, cruns,
                                     tag)
    dk.launches = 0
    lat_rates = chain_train_points(dev, cden, lat_egs, P, tag,
                                   points=LAT_POINTS, steps=LAT_STEPS,
                                   key_prefix="lat_",
                                   profile_steps=LAT_PROFILE_STEPS)
    lat_den = dk.launches
    if lat_den <= 0:
        raise AssertionError("lattice training launched no den kernel")
    for key, v in lat_rates.items():
        print(f"{key} {v:.4f} (phase 8b's {key[4:]}: {rates[key[4:]]:.4f}) "
              f"{tag}")
    print(f"train: lattice supervision: den kernel launches {lat_den}")
    card_step_equals_cpu(dev, cden, lat_egs, P)
    print(f"lattice: phase 14a and 14b took {time.perf_counter() - t0:.1f} s")

    print(card)
    print(json.dumps({"kernels": [{
        "name": "fbank_logmel", "route": "cuda",
        "source": "kaldi_tpu_torch/csrc/fbank.cu",
        "replaces": "kaldi_tpu/ops/pallas_frontend.py:53",
        "launches": fbank_launches + b_fb + d_fb + s_fb + c_fb + t_fb
        + sp_fb + bf_fb + p_fb + cli_fb + y_fb + m_fb + f_fb + iv_fb,
        "max_abs_err": max(fb_err, wav_err, b_fb_err, s_err, bf_err,
                           f_fb_err),
        "note": "max_abs_err over log-mel outputs; the one-bin filters of "
                "the spectrogram are held to their own bar (phase 9a)",
        "ms": fb_ms, "plain_ms": fb_plain_ms,
        "bound_ms": fb_bound[0], "bound_by": fb_bound[1],
        "library_ms": None}, {
        "name": "fbank_logmel_wide", "route": "cuda",
        "source": "kaldi_tpu_torch/csrc/fbank.cu",
        "replaces": "kaldi_tpu/ops/pallas_frontend.py:53",
        "note": "a 16 kHz bank of 17 bins: the fbank kernel on the pieces "
                "of its wide filters, then kt_fbank_sum_pieces; ms for "
                "both, launches of the pair on the wide-bank path",
        "launches": wide_launches, "max_abs_err": wide_err,
        "ms": wide_ms, "plain_ms": wide_plain_ms,
        "bound_ms": wide_bound[0], "bound_by": wide_bound[1],
        "library_ms": None}, {
        "name": "gmm_loglikes", "route": "cuda",
        "source": "kaldi_tpu_torch/csrc/gmm.cu",
        "replaces": "kaldi_tpu/ops/pallas_gmm.py:40",
        "launches": b_gmm + d_gmm + p_gmm + y_gmm + m_gmm + tool_gmm
        + f_gm + iv_gmm,
        "max_abs_err": max(gmm_err, b_err, d_err, p_err, f_gm_err,
                           iv_gmm_err),
        "ms": gmm_ms, "plain_ms": gmm_plain_ms,
        "bound_ms": gmm_bnd[0], "bound_by": gmm_bnd[1],
        "library_ms": None}, {
        "name": "chain_den", "route": "cuda",
        "source": "kaldi_tpu_torch/csrc/chain_den.cu",
        "replaces": "kaldi_tpu/am/chain.py:470",
        "note": "replaces an XLA program (lax.scan + jax.grad), not a "
                "Pallas kernel; forward and backward kernels, ms for both",
        "launches": den_launches + f_den + lat_den,
        "max_abs_err": max(den_err, f_den_err),
        "ms": den_ms, "plain_ms": den_plain_ms,
        "bound_ms": den_bnd[0], "bound_by": den_bnd[1],
        "library_ms": None}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
