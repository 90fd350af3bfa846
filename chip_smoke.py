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
        operating point (5000 words, 30,000 LM sentences, its 400 train
        utterances cut to FLAGSHIP_TRAIN_UTTS (300), its 160 test
        utterances to FLAGSHIP_TEST_UTTS (40), noise 0.10, warp 0.12; the
        TDNN of run, r5's 10 chain epochs cut to FLAGSHIP_CHAIN_EPOCHS
        (5)):
        MFCC through the fbank kernel, mono → tri → tri2b (LDA+MLLT) →
        tri3b (SAT) on the GMM kernel, the mono-GMM rung and the
        two-pass fMLLR tri3b rung on large-vocabulary graphs, the
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
        (40 utterances, noise 1.0, peak 4.0, up to 16 words) at arc
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
 15. xconfig chain models, the cross-entropy trainer, x-vectors and the
     LSTM (am/xconfig.py, cnn.py, lstm.py, xvector.py, pipelines/nnet.py):
     a. ChainTrainer with NG-SGD in float32 on 8b's egs and den at B = 32
        and 128, 20 timed steps (3 warm, 3 profiled) for two models:
        xc_tdnnf, 8b's TDNN-F written as xconfig (printed beside 8b's
        f32_B32), and xc_full, every layer type (Kaldi's CNN-TDNN front
        end of 64 / 128 filters at height 40, TDNN-F, an LSTMP of cell
        1024 and projection 256, restricted attention, a stats layer):
        Mframes/s under xc_*_f32_B{32,128}_Mframes_s, kernels and busy
        card a step, the den launches; one step of each at B = 4 equal
        to the port's CPU step (8b's rule); one LSTMP forward + backward
        at B = 32 profiled (the cuDNN route's kernels);
     b. (a third process beside 14c) ``python -m
        kaldi_tpu_torch.pipelines.chain_recipe --xconfig=default``, exit
        0 (WER under 20);
     c. ``nnet3-train`` at its defaults on 8b's features and full-rate
        seeded alignments (in the background), equal to XentTrainer in
        this process within 1e-5 relative in loss and frame accuracy; the
        frame accuracy over every chunk rises; one Adam step on the card
        equal to the CPU's (13a's bar);
     d. train_xvector at the voxceleb v2 recipe's widths (30 inputs, 512
        frame layers, 512 embeddings) on 32 seeded speakers × 8
        utterances (2 held out): same-speaker cosine above
        different-speaker; nnet3-xvector-compute and -batched on the card
        (in the background) equal to the library; card embeddings equal
        to the CPU's within 1e-4 of the largest;
     e. LstmChain (3 × LSTMP 1024 / 256, ×3) on 8 of 8b's utterances
        streamed in 21-frame chunks equal to offline within 1e-5 of the
        largest, the card equal to the CPU within 1e-4.
 16. decode and chain training across processes (kaldi_tpu_torch/parallel/):
     N = max(2, cards) ranks, one process each, joined through
     ``torch.distributed`` on a file store: NCCL with a card each where
     there are enough cards, else gloo with every rank on cuda:0; the
     backend and the rank→device map are printed.
     a. ``python -m kaldi_tpu_torch.parallel.distributed`` on the N
        ranks: stat reduction, the data-parallel gradient, the sharded
        lattice decode equal to each rank's single decode, one
        ChainTrainer(mesh=) step equal on every rank to the bit;
     b. phase 4's 32 utterances on its 20k graph (handed over as an
        .npz, packed and uploaded by each rank) by
        ShardedBeamDecoder.decode_compact_local, each rank its
        contiguous rows: every best path equal to phase 4's (words
        exactly, cost within 1e-3); audio-s/s over the wall in
        aggregate and per rank beside phase 4's; then every rank the
        whole batch (N times the work), its aggregate audio-s/s;
     c. ChainTrainer(mesh=) with NG-SGD in float32 on 8b's TDNN-F and
        egs at B = 128 (B / N a rank) for 10 steps: the ranks' weights
        equal to the bit after the first and the last step, the first
        step equal to one process's within 1e-4 of each tensor's
        largest; aggregate Mframes/s beside 15a's xc_tdnnf_f32_B128.
     The ranks' den kernel launches (a's step, c's training) come back in
     their output files.
 17. the tri3b GMM stack as Kaldi's tools (steps/train_deltas.sh →
     train_lda_mllt.sh → train_sat.sh → decode_fmllr.sh) on 10b's corpus:
     a. from 10b's waveforms, transcripts, speakers, mono model and mono
        alignments, one background process (``python3 chip_smoke.py
        --tri-tools``, started after 10b, beside 10c to 13) calls the
        port's tools in turn: compute-mfcc-feats (13 cepstra) →
        compute-cmvn-stats → apply-cmvn → add-deltas; tri1 (acc-tree-stats
        → sum-tree-stats → cluster-phones → compile-questions → build-tree
        → gmm-init-model → convert-ali → compile-train-graphs →
        {gmm-acc-stats-ali → gmm-est --mix-up → gmm-align-compiled} ×
        TRI_PASSES); tri2b (splice-feats ±3 → ali-to-post →
        weight-silence-post → acc-lda → est-lda (40) → transform-feats →
        the tree as tri1 → the passes, with gmm-acc-mllt → est-mllt →
        gmm-transform-means → compose-transforms → transform-feats after
        the passes of TRI_MLLT_AFTER); tri3b (gmm-boost-silence 1.25 →
        gmm-align-compiled → ali-to-post → weight-silence-post →
        gmm-est-fmllr --spk2utt → transform-feats by speaker → the passes
        → gmm-acc-stats-twofeats → gmm-est: the alignment model); each
        system decoded by compile-graph → gmm-latgen-faster →
        lattice-best-path → compute-wer, tri3b in two passes (the
        alignment model → lattice-to-post → weight-silence-post 0.01 →
        gmm-est-fmllr → transform-feats → the SAT model).  Then every
        call but the MFCC and CMVN tools (held in 9d) is held against the
        library on its own input files on the card (the bars at
        TRI_ACC_TOL).  Checked after phase 13: every call held, the GMM
        kernel's launches from the tools' log lines, mono's WER above 0
        and tri3b's no worse than mono's, printed beside 10b's;
     b. gmm-global-to-fgmm on 12a's UBM → fgmm-global-acc-stats →
        fgmm-global-est → fgmm-global-get-frame-likes, card = CPU;
     c. gmm-acc-stats on 10b's tri3b alignments and on lattice-to-post of
        its lattices of 8 test utterances → gmm-est-gaussians-ebw, card =
        CPU;
     d. the ladder's chain rung (``ladder.chain_stage``) on 10b's
        systems, LADDER_EPOCHS epochs: a finite objf, its WER beside the
        GMM rungs' (its den launches counted).
 18. Kaldi's other decoders, grammars, keyword search and MMI/sMBR
     sequence training, in one background process (``python3
     chip_smoke.py --seq-tools``, started after 10b beside 17a's, joined
     after 17d; its wall and the main process's wait at the join
     printed), every tool a call of the port's registry on the card,
     held against its library call on the same card:
     a. on 10b's tri3b model and SAT test features (30 utterances):
        gmm-decode-faster, gmm-decode-simple and gmm-latgen-simple on
        the unigram HCLG; gmm-latgen-biglm-faster and
        gmm-decode-biglm-faster on it with the bigram ARPA of the
        training transcripts, their best paths equal to SimpleDecoder's
        on the bigram HCLG (words equal, cost within SEQ_BIGLM_TOL);
        each tool's WER and wall;
     b. once 17d's model is written: make-grammar-fst (the chain
        topology's 8-word HCLG with a nonterminal slotted by a one-word
        list of the other 4), nnet3-latgen-grammar with 17d's model and
        online2-wav-nnet3-latgen-grammar (4 waveforms at 16 kHz, a
        seeded TDNN-F of 17d's widths on 13 MFCCs), each equal to the
        decode over ``replace_nonterminals``' expanded graph;
     c. lattice-to-kws-index over a's lattices in two shards,
        kws-index-union, kws-search of the 12 words, compute-atwv
        against the transcripts; the union's search equal to the direct
        ``keyword_search``;
     d. an xent TDNN-F at TdnnConfig's widths (512 / 128, 9 layers,
        frame rate 1) on 10b's 100 training utterances and tri3b
        alignments, den lattices from the DenseDecoder on the unigram
        HCLG, sMBR and then MMI through ``discriminative_finetune`` on
        the first SEQ_FT_UTTS (50) of them (each from the xent weights;
        the objective rises), test WERs before and after; the card's
        first step equal to the CPU's; then
        nnet3-discriminative-get-egs → -train → -compute-objf, equal to
        the library's steps on the same egs; last, once the main
        process waits at the join and the card is otherwise idle, ms a
        step, kernels a step and the busy share.
     The kernels' counts are set to 0 before each tool call and read
     after it; the GMM kernel's launches of 18a's five tools and the
     fbank kernel's of online2-wav-nnet3-latgen-grammar join the
     kernels line (not those of 18b's reference run on the expanded
     graph).
 19. Kaldi's chain training loop as tools (``python3 chip_smoke.py
     --chain-loop``, in the background since 10b; see LOOP_* below).
 20. Kaldi's serving binaries, in one background process (``python3
     chip_smoke.py --serve-tools <dir> <device>``, started after 10b
     beside 17a's, 18's and 19's workers, two host threads; joined
     before the kernels line, its wall and the main process's wait at
     the join printed), every tool a call of the port's registry on
     the card held against the library on the same files on the same
     card:
     a. on 7d's files (the 300-word task, the 13-layer 1024 / 128 raw
        TDNN-F on 13 MFCCs) and 8 of 7d's seeded waveforms:
        nnet3-compute, nnet3-compute-batch, apply-cmvn-online,
        online2-wav-dump-features, nnet3-latgen-faster-looped (its
        window scores equal to the offline forward),
        online2-wav-nnet3-latgen-incremental and the wake-word decoder
        (the wake word the first word of the library's streamed path);
     b. online2-tcp-nnet3-decode-faster (a process of its own, port 0,
        8 connections): 4 clients at once, then 4 more, each streaming
        a waveform in 0.18 s sends at the pace of speech; each final
        equal to the library's SingleUtteranceDecoder words, each with
        a partial first; reply latency p50 / p99, aggregate audio-s/s,
        the server's fbank launches (its log);
     c. on phase 4/5's 20k task (its HCLG written once, the write and
        read timed) with phase 5's TDNN-F as raw nnet3:
        nnet3-latgen-faster-batch --batch-size=32 on 32 seeded
        waveforms' fbank features (equal to decode_lattice_batch +
        determinization: best words, costs within SERVE_COST_TOL, state
        and arc counts; decode-only and whole-call audio-s/s beside
        phase 4's), nnet3-latgen-incremental on the same features and
        latgen-incremental-mapped on phase 4's log-likelihoods (final
        best paths equal to the offline decode at their settings);
     d. the online GMM family on 10b's tri1 tree and test HCLG with a
        GMM over the tools' 13 MFCCs + Δ+ΔΔ (estimated on the card from
        10b's training waveforms and tri1's alignments, mixed up to
        tri1's Gaussian count), 4 test waveforms at 8 kHz:
        online-wav-gmm-decode-faster, online-gmm-decode-faster,
        online2-wav-gmm-latgen-faster, the UDP server with 4
        online-net-client calls, the TCP audio server with 4
        online-audio-client calls at once; each tool's words equal to
        ``_gmm_stream`` in process; the fbank kernel at this MFCC
        (8 kHz, 23 bins) against its plain version on the 4 waveforms,
        the GMM kernel at this model against float64 on their
        features;
     e. on 10b's tri1 and 30 test utterances: the unadapted decode
        (gmm-latgen-faster) as first pass, gmm-make-regtree,
        gmm-est-regtree-fmllr / -fmllr-ali per speaker,
        gmm-est-regtree-mllr per speaker and over all, the three regtree
        decodes, gmm-latgen-map and gmm-rescore-lattice of the
        unadapted lattices with the MLLR-adapted model; each equal to
        am/regtree.py and the library; WERs beside the unadapted one;
        the GMM kernel at the MLLR-adapted model against float64 on the
        30 utterances' features.
     The kernels' counts are set to 0 before each tool call and read
     after it; the fbank launches of SERVE_FBANK_TOOLS (a–d) and the GMM
     launches of SERVE_GMM_TOOLS (d–e) join the kernels line, and d's
     and e's kernel checks its max_abs_err.
 21. Kaldi's nnet2 models as the port's tools, in a background process
     (``--nnet2-tools``) started beside 20's, on 7d's 300-word task and
     20's 8 waveforms, at the LibriSpeech online nnet2 recipe's width
     (6 p-norm layers 3500 → 350, mixed up to 12,000 softmax rows;
     13 MFCCs, splice ±2, seeded weights):
     a. nnet-am-init → nnet-am-compute (its summed posteriors as counts)
        → nnet-adjust-priors → nnet-am-mixup → nnet-am-info /
        nnet-to-raw-nnet / raw-nnet-info;
     b. nnet2-compute, nnet-am-compute --divide-by-priors and the raw
        net's forward against the library on the card;
     c. nnet-latgen-faster and -parallel against the library's decode +
        determinization of the same pseudo-log-likelihoods (best words,
        costs within NNET2_COST_TOL relative); nnet-align-compiled
        against DenseAligner;
     d. online2-wav-nnet2-am-compute's rows against the offline forward
        of the same MFCCs; online2-wav-nnet2-latgen-faster and
        -threaded: words equal to each other and to the offline decode
        of the streamed scores; audio-s/s of both and of the offline
        decode;
     e. every model tool once on the full-width model: its file reads
        back and equals the library operation (forwards on the card);
     f. the fbank kernel at the online2 tools' MFCC against its plain
        version on the 8 waveforms.
     The fbank launches of NNET2_FBANK_TOOLS (the three online2 tools)
     join the kernels line, f's error its max_abs_err.
 22. Kaldi's frame-level cross-entropy DNN recipes as the port's tools,
     in a background process (``--nnet-loop``) started beside 20's and
     21's on 10b's systems (its waveforms, transcripts, tri3b model and
     alignments, G):
     a. compute-fbank-feats (40 bins, 8 kHz; against Fbank), lengths
        against 10b's alignments, ali-to-pdf, analyze-counts, global
        CMVN (compute-cmvn-stats, cmvn-to-nnet, transform-feats), the
        ±5 splice and its normalization as a transf-to-nnet transform;
     b. Karel's pretrain_dbn.sh at its width (6 RBMs of 2048 on 440
        inputs): rbm-train-cd1-frmshuff a layer at a time,
        rbm-convert-to-nnet, nnet-concat, nnet-initialize's output
        layer; the first RBM against train_rbm, one CD-1 step card = CPU;
     c. nnet-set-learnrate (DBN frozen, held bit for bit and against
        finetune_xent) and nnet-train-frmshuff a pass at a time with
        the cv cross-entropy and frame accuracy; one step card = CPU;
     d. nnet-forward --feature-transform --divide-by-priors |
        latgen-faster-mapped on compile-graph's HCLG: WER ≤ 30 beside
        10b's; lattice-to-nbest;
     e. align-compiled-mapped (against DenseAligner), its agreement with
        10b's alignments, train-transitions;
     f. nnet-train-mmi-sequential and -mpe-sequential on a few
        utterances' lattices, against the library; nnet1-to-raw-nnet;
     g. nnet3's train_dnn.py loop at phases 5 and 8b's TDNN-F width
        (13 × 1024 / 128): nnet3-init, the egs tools, two nnet3-train
        jobs, nnet3-average, nnet3-combine, nnet3-compute-prob (card =
        CPU too), the .mdl tools, LDA stats, compute-from-egs and
        nnet3-align-compiled, each against the library;
     h. the fbank kernel at 40 bins, 8 kHz against its plain version.
     compute-fbank-feats' fbank launches join the kernels line, h's
     error its max_abs_err.
Before the last two lines, a line of its own is the card's name and
power limit as nvidia-smi reports them.  The line before the last is the
kernels' JSON record: launches on the paths (the den's include 14b's,
15a's, the ranks' of phase 16, 17d's, 18's and 19's; the GMM's
17a's, 17c's, 18a's and 20d–e's; the fbank's 18b's streaming grammar
tool's, 20a–d's, 21d's and 22a's),
the largest difference from
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

import atexit
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
                       model=None, **width):
    """8b (14b, 15a): NG-SGD training steps of ChainTrainer at each (B,
    dtype), after 3 warm steps; Mframes/s of input frames over ``steps``
    steps between two synchronizes; with ``profile_steps``, that many
    more steps under torch.profiler for the kernels and busy card time a
    step.  ``model(P)`` builds the model (default: the bench's TDNN-F
    config at each dtype).  → {key: Mframes/s}."""
    from kaldi_tpu_torch.tools.timing import profiled
    from kaldi_tpu_torch.pipelines.chain import ChainTrainConfig, ChainTrainer
    N = egs.feats.shape[0]
    out = {}
    for B, dtype in points:
        if N < B:
            raise AssertionError(f"{N} egs for a batch of {B}")
        tr = ChainTrainer(model(P) if model is not None
                          else tdnn_config(P, dtype, **width), den,
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


def card_step_equals_cpu(dev, den, egs, P: int, B: int = 4, model=None,
                         **width):
    """8b (14b, 15a): one f32 NG-SGD step at B on the card against the
    port's CPU step on the same egs and seed (TF32 off): loss and every
    parameter within 1e-4 of its largest value.  ``model(P)`` builds the
    model (default: the bench's TDNN-F config)."""
    from kaldi_tpu_torch.pipelines.chain import ChainTrainConfig, ChainTrainer
    res = []
    for d in (dev, "cpu"):
        tr = ChainTrainer(model(P) if model is not None
                          else tdnn_config(P, **width), den,
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
    rel, worst = max((float((pg[k] - pc[k]).abs().max()
                            / max(float(pc[k].abs().max()), 1e-12)), k)
                     for k in pc)
    moved = max(float((pc[k] - bc[k]).abs().max()) for k in pc)
    lrel = abs(lg - lc) / max(abs(lc), 1e-12)
    print(f"train: one step at B={B} on the card vs the port's CPU step: "
          f"loss {lg:.6f} vs {lc:.6f} (relative {lrel:.2e}), parameters "
          f"within {rel:.2e} of each tensor's largest ({worst}; limit 1e-4; "
          f"the step moved them by up to {moved:.3e})")
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
    corpus on the card.  → (fbank launches, GMM launches, WERs, the
    systems: phase 17's inputs)."""
    from kaldi_tpu_torch.pipelines import mini
    from kaldi_tpu_torch.pipelines.data import (confusable_formants,
                                                confusable_lexicon)
    stamps = {}

    def report(stage, it, ali, accs):
        stamps.setdefault(stage, []).append(
            (time.perf_counter(), accs.tot_like / accs.tot_frames))

    zero_totals()
    t0 = time.perf_counter()
    wers, sysd = mini.run(lexicon=confusable_lexicon(),
                          formants=confusable_formants(), device=dev,
                          report=report, return_systems=True,
                          **MINI_LADDER)
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
    return fb, gm, wers, sysd


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
# 11a's test set: r5's 160 utterances cut to 80 when phase 15 came (the
# five test decodes and their CUDA-graph replays (device_s) took 155 s of
# the run's 478 s at 160), then to 40, its training set from r5's 400
# utterances to 300 and its chain trainings from r5's 10 epochs to 5
# when phase 16 came: at 80 / 400 / 10 the whole script took 1267.6 s on
# a slow host, the run 451.5 s of it, its test decodes and replays 113
# s, the GMM ladder to tri3b 192 s and each chain training ~70 s (NVIDIA
# H100 80GB HBM3, 700.00 W)
FLAGSHIP_TEST_UTTS = 40
FLAGSHIP_TRAIN_UTTS = 300
FLAGSHIP_CHAIN_EPOCHS = 5
# the chain model on the card against the CPU: test utterances compared,
# the float32 bar of tests/test_torch_chain.py, and the best paths that
# must agree
CHAIN_CHECK_UTTS = 16
CHAIN_CHECK_TOL = 1e-4
CHAIN_CHECK_SAME = 15
# 11b: the hard corpus at HARDBENCH_r05's noise-1.0 point (20,000 words,
# noise 1.0, peak 4.0, up to 16 words) on 40 utterances (r5 ran 1200;
# cut so that the whole script, with its i-vector, RNNLM, lattice-
# supervision and multi-process phases and every decode's card time,
# stays within its time budget: 80 took 53.6 s of the slow host's 1267.6
# s), at the default and the loosest arc budget, both with escalation to
# 16384
HARD_TASK = dict(vocab=20000)
HARD_EVAL = dict(n_utts=40, noise=1.0, peak=4.0, max_words=16)
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
    LM sentences, 400 train and 160 test utterances cut to
    FLAGSHIP_TRAIN_UTTS and FLAGSHIP_TEST_UTTS, the TDNN of run: hidden
    256, bottleneck 64, 7 layers, subsampling 3; FLAGSHIP_CHAIN_EPOCHS
    chain epochs): every
    rung's record beside r5's WER; the rungs' WERs within
    FLAGSHIP_MAX_WER and their oracle WERs at most their WERs.  → (fbank,
    GMM and den launches of the run, its records, its systems, wall s)."""
    from kaldi_tpu_torch.ops.chain_den import CudaChainDen
    from kaldi_tpu_torch.pipelines import flagship
    zero_totals()
    t0 = time.perf_counter()
    results, sysm = flagship.run(device=dev, return_systems=True,
                                 **dict(flagship.R05_POINT,
                                        test_utts=FLAGSHIP_TEST_UTTS,
                                        train_utts=FLAGSHIP_TRAIN_UTTS,
                                        chain_epochs=FLAGSHIP_CHAIN_EPOCHS))
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
    # 15b: the same recipe on default_xconfig's model (am/xconfig.py)
    xrecipe = timed + (f"t chain_recipe_xconfig {py} -m "
                       f"kaldi_tpu_torch.pipelines.chain_recipe "
                       f"--xconfig=default {dv} > {w}/xrecipe.out 2> "
                       f"{w}/xrecipe.err\n")
    # two threads a process: the flagship's checks run beside them
    env = dict(os.environ, OMP_NUM_THREADS="2")
    procs = [subprocess.Popen(["bash", "-c", sh], cwd=repo, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for sh in (script, recipe, xrecipe)]
    return procs[0], w, procs[1], procs[2]


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
    proc, w, rproc, xproc = started
    t0 = time.perf_counter()
    err = proc.communicate(timeout=900)[1]
    rerr = rproc.communicate(timeout=900)[1]
    xerr = xproc.communicate(timeout=900)[1]
    waited = time.perf_counter() - t0

    def text(name):
        path = os.path.join(w, name)
        return open(path).read() if os.path.exists(path) else ""

    if proc.returncode != 0 or rproc.returncode != 0 \
            or xproc.returncode != 0:
        raise AssertionError(
            f"14c/15b failed ({proc.returncode}, {rproc.returncode}, "
            f"{xproc.returncode}):\n{err[-2000:]}\n{rerr[-2000:]}\n"
            f"{xerr[-2000:]}\n"
            f"{text('cli.err')[-2000:]}{text('tools.err')[-2000:]}"
            f"{text('recipe.err')[-2000:]}{text('xrecipe.err')[-2000:]}")
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
    print(f"xconfig: 15b: chain_recipe --xconfig=default (default_xconfig's "
          f"TDNN-F as an xconfig model, the recipe's defaults): "
          f"{text('xrecipe.out').strip().splitlines()[-1]}, exit 0 (WER "
          f"under 20) {tag}")
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


# 15. xconfig chain models, cross-entropy training, x-vectors, the LSTM
XC_POINTS = ((32, "float32"), (128, "float32"))
XC_STEPS, XC_PROFILE_STEPS = 20, 3
XC_TOL = 1e-4              # 8b's bar: card step = CPU step
XENT_DIR = os.path.join("build", "chip_smoke_xent")
XENT_TOL = 1e-5            # nnet3-train = XentTrainer in process, relative
XVEC_SPK, XVEC_UTTS, XVEC_HELD = 32, 8, 2
XVEC_TOL = 1e-4            # card embeddings = CPU, of the largest
XVEC_TOOL_TOL = 1e-5       # the tools = the library on the card
LSTM_UTTS, LSTM_CHUNK, LSTM_CPU_UTTS = 8, 21, 2
LSTM_STREAM_TOL = 1e-5     # streamed = offline, of the largest
LSTM_CPU_TOL = 1e-4        # card = CPU, of the largest


def xconfig_text(kind: str, P: int) -> str:
    """15a's two models.  xc_tdnnf: 8b's TDNN-F as xconfig (40 inputs,
    relu-batchnorm over Append(-1,0,1), 13 TDNN-F layers 1024 / 128 at
    time strides 1, 1, 1, 3 × 10, a 1024 prefinal, the output).  xc_full:
    every layer type: Kaldi's CNN-TDNN front end (64 then 128 filters at
    height 40, the second halving the height), TDNN-F, an LSTMP of
    Switchboard's TDNN-LSTM widths (cell 1024, projection 256),
    restricted attention (4 heads, 9 / 9 inputs), a stats layer, the
    prefinal and the output."""
    out = (f"relu-batchnorm-layer name=prefinal-chain dim=1024\n"
           f"output-layer name=output dim={P} include-log-softmax=false\n")
    if kind == "xc_tdnnf":
        body = "".join(
            f"tdnnf-layer name=tdnnf{i + 2} dim=1024 bottleneck-dim=128 "
            f"time-stride={s}\n" for i, s in enumerate([1, 1, 1] + [3] * 10))
        return ("input name=input dim=40\n"
                "relu-batchnorm-layer name=tdnn1 input=Append(-1,0,1) "
                "dim=1024\n" + body + out)
    return ("input name=input dim=40\n"
            "conv-relu-batchnorm-layer name=cnn1 height-in=40 "
            "num-filters-out=64\n"
            "conv-relu-batchnorm-layer name=cnn2 height-in=40 "
            "num-filters-out=128 height-subsample-out=2\n"
            "relu-batchnorm-layer name=tdnn1 input=Append(-1,0,1) dim=1024\n"
            "tdnnf-layer name=tdnnf2 dim=1024 bottleneck-dim=128 "
            "time-stride=1\n"
            "tdnnf-layer name=tdnnf3 dim=1024 bottleneck-dim=128 "
            "time-stride=1\n"
            "fast-lstmp-layer name=lstm1 cell-dim=1024 "
            "recurrent-projection-dim=256\n"
            "relu-batchnorm-layer name=tdnn4 input=Append(-3,0,3) dim=1024\n"
            "attention-relu-batchnorm-layer name=att1 dim=1024\n"
            "stats-layer name=stats1 config=mean+stddev(-99:3:9:99)\n" + out)


def xconfig_model(kind: str):
    """→ P ↦ a fresh xconfig chain model of ``kind`` (×3 subsampled)."""
    from kaldi_tpu_torch.am.xconfig import chain_model_from_xconfig
    return lambda P: chain_model_from_xconfig(xconfig_text(kind, P), 3)


def xconfig_training(dev, den, egs, P: int, rates, tag: str):
    """15a: ChainTrainer with NG-SGD, float32, on 8b's egs and den at B =
    32 and 128 for each model: Mframes/s, kernels and busy card a step.
    → {key: Mframes/s}."""
    out = {}
    for kind in ("xc_tdnnf", "xc_full"):
        m = xconfig_model(kind)(P)
        print(f"xconfig: {kind}: {len(m.net.xlines)} lines, "
              f"{sum(p.numel() for p in m.parameters()) / 1e6:.2f}M "
              f"parameters, layer types "
              f"{sorted({l.layer_type for l in m.net.xlines})}")
        out.update(chain_train_points(
            dev, den, egs, P, tag, points=XC_POINTS, steps=XC_STEPS,
            key_prefix=f"{kind}_", profile_steps=XC_PROFILE_STEPS,
            model=xconfig_model(kind)))
    for key, v in out.items():
        print(f"{key} {v:.4f}" + (f" (phase 8b's f32_B32_Mframes_s: "
                                  f"{rates['f32_B32_Mframes_s']:.4f})"
                                  if key == "xc_tdnnf_f32_B32_Mframes_s"
                                  else "") + f" {tag}")
    return out


def lstm_route(dev, tag: str) -> None:
    """15a: the LSTM recurrence's kernels: one forward + backward of
    xc_full's LSTMP layer (cell 1024, projection 256) at B = 32 × 150
    frames, profiled."""
    from kaldi_tpu_torch.am.lstm import LstmpLayer
    from kaldi_tpu_torch.am.tdnn import init_like_flax
    from kaldi_tpu_torch.tools.timing import profiled
    layer = init_like_flax(LstmpLayer(1024, 1024, 256), SEED).to(dev)
    x = torch.randn(32, CHAIN_T, 1024, device=dev,
                    generator=torch.Generator(dev).manual_seed(SEED))

    def run():
        layer(x)[0].square().sum().backward()
        torch.cuda.synchronize()

    run()
    wall, n_k, busy, _ = profiled(run)
    print(f"xconfig: the LSTM route (cuDNN through functional_call, "
          f"float32 without TF32): one LSTMP forward + backward at B = 32, "
          f"T = {CHAIN_T}: {n_k} kernels, {busy:.2f} ms busy card, "
          f"{wall:.2f} ms wall {tag}")


def pdf_alignment(tree, topo, runs):
    """Full-rate pdfs of (phone, frames) runs through the chain topology:
    a run's first frame its forward pdf, the rest its self-loop pdf."""
    out = []
    for ph, d in runs:
        st = topo.topology_for_phone(ph)[0]
        out.append(tree.compute([ph], st.forward_pdf_class))
        out += [tree.compute([ph], st.self_loop_pdf_class)] * (d - 1)
    return np.asarray(out, np.int32)


def xent_start(dev, feats, runs, tree, topo):
    """15c (in the background from here): ``nnet3-train`` at its defaults
    on 8b's features and its seeded alignments at the full frame rate.
    → (process, work dir, feats, pdf alignments, pdfs)."""
    import subprocess
    from kaldi_tpu_torch.core.table import TableWriter
    repo = os.path.dirname(os.path.abspath(__file__))
    w = os.path.join(repo, XENT_DIR)
    os.makedirs(w, exist_ok=True)
    ali = {u: pdf_alignment(tree, topo, runs[u])[:len(f)]
           for u, f in feats.items()}
    with TableWriter(f"ark:{w}/feats.ark", holder="mat") as wf, \
            TableWriter(f"ark:{w}/ali.ark", holder="ivec") as wa:
        for u in sorted(feats):
            wf[u] = feats[u]
            wa[u] = ali[u]
    proc = subprocess.Popen(
        [sys.executable, "-m", "kaldi_tpu_torch.cli", "nnet3-train",
         f"--num-pdfs={tree.num_pdfs}", f"--device={dev.type}",
         f"ark:{w}/feats.ark", f"ark:{w}/ali.ark", f"{w}/final.raw"],
        cwd=repo, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return proc, w, feats, ali, tree.num_pdfs


def _first_adam_step(tr, X, Y, M):
    """One XentTrainer step that keeps each parameter's gradient → (loss,
    {name: gradient})."""
    grads = {}
    step = tr.opt.step

    def spy(*a, **kw):
        for n, p in tr.model.named_parameters():
            grads[n] = p.grad.detach().cpu().clone()
        return step(*a, **kw)

    tr.opt.step = spy
    loss, _ = tr._step(X, Y, M)
    tr.opt.step = step
    return float(loss), grads


def xent_training(dev, started, tag: str) -> dict:
    """15c: XentTrainer in this process at nnet3-train's defaults on the
    same data: its loss and frame accuracy; the frame accuracy over
    every chunk before and after training (it must rise);
    one Adam step on the card equal to the CPU's (13a's bar: 1e-3·lr
    plus the step's sensitivity to a gradient error of 1e-5 of the
    largest).  → the in-process run's stats."""
    from kaldi_tpu_torch.am.tdnn import TdnnConfig
    from kaldi_tpu_torch.pipelines.nnet import XentTrainConfig, XentTrainer
    _, _, feats, ali, P = started
    cfg = TdnnConfig(feat_dim=40, num_pdfs=P, hidden_dim=256,
                     bottleneck_dim=64, num_layers=5,
                     frame_subsampling_factor=1)
    tr = XentTrainer(cfg, XentTrainConfig(num_epochs=4), device=dev)
    n_frames = sum(len(a) for a in ali.values())
    X, Y, M = tr.make_egs(feats, ali)

    def accuracy():
        # the trainer's own measure (masked argmax of the outputs in
        # training mode) over every chunk in batches of 16, the batch-norm
        # statistics put back after
        keep = {k: v.clone() for k, v in tr.model.state_dict().items()}
        tr.model.train()
        hits = 0
        with torch.no_grad():
            for i in range(0, len(X), 16):
                out = tr.model(torch.from_numpy(X[i:i + 16]).to(dev))
                hits += int(((out.argmax(-1).cpu().numpy() == Y[i:i + 16])
                             & M[i:i + 16]).sum())
        tr.model.load_state_dict(keep)
        return hits / int(M.sum())

    before = accuracy()
    t0 = time.perf_counter()
    stats = tr.train(feats, ali)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    after = accuracy()
    steps = 4 * (len(X) // 16)
    print(f"xent: XentTrainer at nnet3-train's defaults (TDNN-F 256 / 64, 5 "
          f"layers, 4 epochs, Adam 1e-3) on {len(feats)} utterances, "
          f"{n_frames} frames, {cfg.num_pdfs} pdfs: {steps} steps in "
          f"{wall:.2f} s = {steps * 16 * 64 / wall / 1e6:.4f} Mframes/s; "
          f"loss {stats['loss']:.6f}, last batch frame accuracy "
          f"{stats['frame_acc']:.4f}; frame accuracy over every chunk "
          f"{before:.4f} → {after:.4f} {tag}")
    if not (math.isfinite(stats["loss"]) and after > before):
        raise AssertionError(f"xent training: accuracy {before} → {after}, "
                             f"loss {stats['loss']}")
    # one Adam step on the card and on the CPU from the same weights
    res = []
    for d in (dev, torch.device("cpu")):
        t = XentTrainer(cfg, XentTrainConfig(num_epochs=4), device=d)
        loss, grads = _first_adam_step(t, X[:16], Y[:16], M[:16])
        res.append((loss, grads, {k: v.detach().cpu() for k, v in
                                  t.model.state_dict().items()}))
    (lg, _, sg), (lc, gc, sc) = res
    worst = max(_adam_step_ok(sg[k], sc[k], gc[k], 1e-3, 1e-5) for k in gc)
    lrel = abs(lg - lc) / abs(lc)
    print(f"xent: one Adam step at B = 16, card vs CPU: loss {lg:.6f} vs "
          f"{lc:.6f} (relative {lrel:.2e}), weights at most {worst:.3f} of "
          f"the first step's bar")
    if not (lrel <= 1e-5 and worst <= 1.0):
        raise AssertionError("xent: the card's Adam step differs from the "
                             "CPU's")
    return stats


def xent_finish(started, want, tag: str) -> None:
    """15c: nnet3-train exited 0; its logged loss and frame accuracy equal
    the in-process run's within XENT_TOL relative; its raw model reads
    back."""
    import ast
    from kaldi_tpu_torch.am.nnet3_io import read_nnet3_path
    proc, w = started[0], started[1]
    err = proc.communicate(timeout=600)[1]
    if proc.returncode != 0:
        raise AssertionError(f"nnet3-train failed:\n{err[-3000:]}")
    line = [ln for ln in err.splitlines() if "nnet3-train: {" in ln][-1]
    got = ast.literal_eval(line[line.index("{"):])
    rel = max(abs(got[k] - want[k]) / abs(want[k]) for k in want)
    n = len(read_nnet3_path(f"{w}/final.raw").components)
    print(f"xent: nnet3-train --device=cuda at its defaults: loss "
          f"{got['loss']:.6f}, frame accuracy {got['frame_acc']:.4f}, "
          f"within {rel:.2e} of the in-process run (limit {XENT_TOL:g}); "
          f"final.raw holds {n} components {tag}")
    if not rel <= XENT_TOL:
        raise AssertionError(f"nnet3-train differs from XentTrainer: {rel}")


def speaker_corpus(rng, n_spk: int, n_utt: int, D: int = 30):
    """Seeded speakers (tests/test_xvector.py's corpus at the recipe's
    30 MFCC dims): a per-speaker offset over shared frame noise, 2-4 s
    (200-400 frames) an utterance."""
    feats, utt2spk = {}, {}
    for s in range(n_spk):
        off = 3.0 * rng.standard_normal(D)
        for j in range(n_utt):
            u = f"spk{s:02d}-u{j}"
            T = int(rng.integers(200, 401))
            feats[u] = (off + rng.standard_normal((T, D))).astype(np.float32)
            utt2spk[u] = f"spk{s:02d}"
    return feats, utt2spk


def xvectors(dev, tag: str):
    """15d: train_xvector on the card at the voxceleb v2 recipe's widths
    (30 inputs, 512-wide frame layers, 512-wide embeddings; its
    1500-wide fifth layer is not expressible in XvectorConfig) on
    XVEC_SPK seeded speakers × XVEC_UTTS utterances, XVEC_HELD a speaker
    held out: same-speaker cosine above different-speaker cosine on the
    held-out utterances; the model's file; then both extraction tools
    on the card in the background.  → (model, held-out feats, work
    dir, tool processes)."""
    import subprocess
    from kaldi_tpu_torch.am.xvector import (XvectorConfig, extract_xvector,
                                            save_xvector_model,
                                            train_xvector)
    from kaldi_tpu_torch.core.table import TableWriter
    feats, utt2spk = speaker_corpus(np.random.default_rng(SEED + 15),
                                    XVEC_SPK, XVEC_UTTS)
    held = {u: f for u, f in feats.items()
            if int(u[-1]) >= XVEC_UTTS - XVEC_HELD}
    train = {u: f for u, f in feats.items() if u not in held}
    cfg = XvectorConfig(feat_dim=30, hidden_dim=512, embed_dim=512)
    t0 = time.perf_counter()
    model, spks = train_xvector(train, {u: utt2spk[u] for u in train}, cfg,
                                seed=SEED, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    embs = {u: extract_xvector(model, f) for u, f in held.items()}
    same, diff = [], []
    keys = sorted(embs)
    for i, a in enumerate(keys):
        for b in keys[i + 1:]:
            ea, eb = embs[a], embs[b]
            c = float(ea @ eb / (np.linalg.norm(ea) * np.linalg.norm(eb)))
            (same if utt2spk[a] == utt2spk[b] else diff).append(c)
    steps = 30 * (len(train) // 16)
    print(f"xvector: train_xvector on the card (30 → 512 × 5 frame layers, "
          f"512 embeddings, {len(spks)} speakers, {len(train)} utterances, "
          f"30 epochs of B = 16 chunks of 64 frames, Adam): {steps} steps in "
          f"{wall:.2f} s = {steps * 16 * 64 / wall / 1e6:.4f} Mframes/s; "
          f"held-out cosine: same speaker {np.mean(same):.4f}, different "
          f"{np.mean(diff):.4f} ({len(held)} utterances) {tag}")
    if not np.mean(same) > np.mean(diff):
        raise AssertionError("x-vectors do not separate speakers")
    repo = os.path.dirname(os.path.abspath(__file__))
    w = os.path.join(repo, "build", "chip_smoke_xvector")
    os.makedirs(w, exist_ok=True)
    save_xvector_model(f"{w}/final.raw", model, spks)
    with TableWriter(f"ark:{w}/feats.ark", holder="mat") as wf:
        for u in sorted(held):
            wf[u] = held[u]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "kaldi_tpu_torch.cli", tool,
         f"--device={dev.type}"] + opts + [f"{w}/final.raw",
                                           f"ark:{w}/feats.ark",
                                           f"ark:{w}/{tool}.ark"],
        cwd=repo, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for tool, opts in (("nnet3-xvector-compute", []),
                           ("nnet3-xvector-compute-batched", []))]
    return model, held, w, procs


def xvectors_finish(model, held, w, procs, tag: str) -> None:
    """15d: both extraction tools equal the library on the card (whole
    utterances; the mean over 100-frame windows) within XVEC_TOOL_TOL of
    the largest; the card's embeddings equal the CPU's within XVEC_TOL
    of the largest."""
    import copy
    from kaldi_tpu_torch.am.xvector import extract_xvector
    from kaldi_tpu_torch.core.table import SequentialTableReader
    worst = {}
    for p, tool in zip(procs, ("nnet3-xvector-compute",
                               "nnet3-xvector-compute-batched")):
        err = p.communicate(timeout=600)[1]
        if p.returncode != 0:
            raise AssertionError(f"{tool} failed:\n{err[-3000:]}")
        got = dict(SequentialTableReader(f"ark:{w}/{tool}.ark",
                                         holder="vec"))
        if sorted(got) != sorted(held):
            raise AssertionError(f"{tool}: keys differ")
        err = 0.0
        for u, f in held.items():
            if tool == "nnet3-xvector-compute":
                lib = extract_xvector(model, f)
            else:
                lib = np.mean([extract_xvector(model, f[lo:lo + 100])
                               for lo in range(0, len(f) - 99, 100)], axis=0)
            err = max(err, float(np.abs(got[u] - lib).max()
                                 / np.abs(lib).max()))
        worst[tool] = err
    cpu = copy.deepcopy(model).cpu()
    rel = max(float(np.abs(extract_xvector(model, f)
                           - extract_xvector(cpu, f)).max()
                    / np.abs(extract_xvector(cpu, f)).max())
              for f in held.values())
    print(f"xvector: nnet3-xvector-compute and -batched on the card equal "
          f"the library within {worst['nnet3-xvector-compute']:.2e} and "
          f"{worst['nnet3-xvector-compute-batched']:.2e} of the largest "
          f"(limit {XVEC_TOOL_TOL:g}); card vs CPU embeddings within "
          f"{rel:.2e} of the largest (limit {XVEC_TOL:g}) {tag}")
    if not (max(worst.values()) <= XVEC_TOOL_TOL and rel <= XVEC_TOL):
        raise AssertionError("x-vector extraction disagrees")


def lstm_scorer(dev, feats, P: int, tag: str) -> None:
    """15e: LstmChain at cell 1024, projection 256, 3 layers, ×3 (seeded
    weights, the output kernel drawn too) on LSTM_UTTS of 8b's
    utterances: streamed in LSTM_CHUNK-frame chunks equal to offline
    within LSTM_STREAM_TOL of the largest, the card's offline scores
    equal to the CPU's on LSTM_CPU_UTTS within LSTM_CPU_TOL."""
    import copy
    from kaldi_tpu_torch.am.lstm import (LstmChain, LstmConfig,
                                         StreamingLstmScorer)
    from kaldi_tpu_torch.am.tdnn import init_like_flax
    model = init_like_flax(LstmChain(LstmConfig(
        feat_dim=40, num_pdfs=P, hidden_dim=1024, proj_dim=256,
        num_layers=3, frame_subsampling_factor=3)), SEED)
    with torch.no_grad():
        model.output_affine.weight.normal_(
            0.0, 0.1, generator=torch.Generator().manual_seed(SEED))
    cpu = copy.deepcopy(model).eval()
    model = model.to(dev).eval()
    utts = sorted(feats)[:LSTM_UTTS]
    sc = StreamingLstmScorer(model)
    t_stream = t_off = 0.0
    s_err = c_err = 0.0
    frames = 0
    for i, u in enumerate(utts):
        f = feats[u][:len(feats[u]) // 3 * 3]
        frames += len(f)
        t0 = time.perf_counter()
        with torch.no_grad():
            off = model(torch.from_numpy(f).to(dev)[None])[0][0].cpu().numpy()
        t1 = time.perf_counter()
        sc.reset()
        streamed = np.concatenate([sc.accept_features(f[lo:lo + LSTM_CHUNK])
                                   for lo in range(0, len(f), LSTM_CHUNK)])
        t2 = time.perf_counter()
        t_off += t1 - t0
        t_stream += t2 - t1
        scale = float(np.abs(off).max())
        s_err = max(s_err, float(np.abs(streamed - off).max()) / scale)
        if i < LSTM_CPU_UTTS:
            with torch.no_grad():
                want = cpu(torch.from_numpy(f)[None])[0][0].numpy()
            c_err = max(c_err, float(np.abs(off - want).max())
                        / float(np.abs(want).max()))
    print(f"lstm: LstmChain (3 × LSTMP 1024 / 256, ×3) on {len(utts)} "
          f"utterances, {frames} frames: streamed in {LSTM_CHUNK}-frame "
          f"chunks vs offline within {s_err:.2e} of the largest (limit "
          f"{LSTM_STREAM_TOL:g}); card vs CPU on {LSTM_CPU_UTTS} within "
          f"{c_err:.2e} (limit {LSTM_CPU_TOL:g}); offline {t_off:.3f} s, "
          f"streamed {t_stream:.3f} s wall {tag}")
    if not (s_err <= LSTM_STREAM_TOL and c_err <= LSTM_CPU_TOL):
        raise AssertionError("the LSTM scorer disagrees")


# phase 16: decode and chain training across processes (parallel/).  N
# ranks, one process each: NCCL with a card each where there are enough
# cards, else gloo with every rank on cuda:0
POD_B = 128                # 16c's global batch (8b's egs and TDNN-F)
POD_STEPS = 10             # 16c's steps; the first is held to one process
POD_TIMEOUT = 240          # each rank's rendezvous, collectives and wait
POD_DIR = os.path.join("build", "chip_smoke_pod")
# 16d: tensor parallelism on one card (2 ranks on gloo sharing it; NCCL
# cannot put two ranks on one card): B, steps, and the bar of step 1
# against one process (16c's)
TP_B = 32
TP_STEPS = 4
TP_TOL = 1e-4


def pod_layout(dev_type: str = "cuda"):
    """(ranks, backend): max(2, cards) ranks, NCCL when each has a card of
    its own, else gloo sharing cuda:0 (or the CPU)."""
    cards = torch.cuda.device_count() if dev_type == "cuda" else 0
    n = max(2, cards)
    return n, ("nccl" if cards >= n else "gloo")


def _pod_wait(procs, what: str) -> None:
    """Wait for every rank within POD_TIMEOUT; kill them all if one fails
    or runs over."""
    try:
        for p in procs:
            _out, err = p.communicate(timeout=POD_TIMEOUT)
            if p.returncode != 0:
                raise AssertionError(f"{what}: a rank exited "
                                     f"{p.returncode}:\n"
                                     f"{err.decode()[-3000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def save_csr(path: str, csr) -> None:
    """A CsrGraph as an .npz (the ranks' copy of phase 4's graph)."""
    import dataclasses
    arrs = {}
    for f in dataclasses.fields(csr):
        v = getattr(csr, f.name)
        if v is None:
            continue
        arrs[f.name] = (np.asarray(v, dtype=object) if isinstance(v, list)
                        else np.asarray(v))
    np.savez(path, **arrs)


def load_csr(path: str):
    from kaldi_tpu_torch.fst.csr import CsrGraph
    z = np.load(path, allow_pickle=True)
    kw = {}
    for k in z.files:
        v = z[k]
        kw[k] = (v.tolist() if v.dtype == object
                 else v.item() if v.ndim == 0 else v)
    return CsrGraph(**kw)


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _state_digest(model) -> str:
    import hashlib
    h = hashlib.sha256()
    for k, v in model.state_dict().items():
        h.update(k.encode())
        h.update(v.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def pod_worker(argv) -> int:
    """One rank of 16b and 16c (``python3 chip_smoke.py --pod-worker
    <store> <ranks> <rank> <dir> <cuda|cpu> <backend>``): joins the
    process group through parallel/distributed.py, decodes its rows of
    phase 4's batch with ``ShardedBeamDecoder.decode_compact_local`` on
    the graph the parent wrote, then trains ``ChainTrainer(mesh=)`` for
    POD_STEPS steps on the parent's egs; pickles what it measured to
    ``<dir>/out.<rank>.pkl``."""
    import pickle
    import torch.distributed as dist
    store, n, pid, d, dev_type, backend = (argv[0], int(argv[1]),
                                           int(argv[2]), argv[3], argv[4],
                                           argv[5])
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from kaldi_tpu_torch.decoder.beam import BeamDecoder, BeamDecoderConfig
    from kaldi_tpu_torch.ops.chain_den import CudaChainDen
    from kaldi_tpu_torch.parallel import distributed, make_mesh
    from kaldi_tpu_torch.parallel.decode import ShardedBeamDecoder
    from kaldi_tpu_torch.pipelines.chain import (ChainEgs, ChainTrainConfig,
                                                 ChainTrainer)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = distributed.initialize(store, n, pid, backend=backend,
                                 device=dev_type, timeout_s=POD_TIMEOUT)
    out = {"device": str(dev), "backend": dist.get_backend()}
    try:
        with open(os.path.join(d, "inputs.pkl"), "rb") as f:
            inp = pickle.load(f)
        mesh = make_mesh()
        # 16b: this rank's rows of phase 4's batch, on its own graph copy
        t0 = time.perf_counter()
        dec = BeamDecoder(load_csr(os.path.join(d, "graph.npz")),
                          inp["tid_to_pdf"], BeamDecoderConfig(**inp["cfg"]),
                          device=dev)
        out["pack_s"] = time.perf_counter() - t0
        sharded = ShardedBeamDecoder(dec, mesh)
        B = len(inp["lens"])               # contiguous rows, any N
        rows = slice(pid * B // n, (pid + 1) * B // n)
        X, lens = inp["X"][rows], inp["lens"][rows]
        sharded.decode_compact_local(X[:2], lens[:2])          # warm
        _sync(dev)
        dist.barrier()
        t0 = time.perf_counter()
        stats = {}
        lats = sharded.decode_compact_local(X, lens, stats=stats)
        out["decode_wall"] = time.perf_counter() - t0
        dist.barrier()
        out["decode_all_wall"] = time.perf_counter() - t0
        out["rows"] = (rows.start, rows.stop)
        out["best"] = [lat.best_path() for lat in lats]
        out["decode_stats"] = stats
        # every rank the whole batch: N times phase 4's work
        _sync(dev)
        dist.barrier()
        t0 = time.perf_counter()
        lats = sharded.decode_compact_local(inp["X"], inp["lens"])
        dist.barrier()
        out["full_all_wall"] = time.perf_counter() - t0
        out["full_best"] = [lat.best_path() for lat in lats]
        # 16c: ChainTrainer(mesh=) on 8b's egs and TDNN-F
        tr = ChainTrainer(tdnn_config(inp["P"], **inp["width"]), inp["den"],
                          ChainTrainConfig(batch_size=inp["B"],
                                           optimizer="ngsgd", total_steps=0),
                          seed=SEED, mesh=mesh)
        egs = ChainEgs(**inp["egs"])
        N = egs.feats.shape[0]
        batches = [tr.batches(egs, (np.arange(inp["B"]) + i * inp["B"]) % N)
                   for i in range(4)]
        CudaChainDen.total_launches = 0
        tr._step(*batches[0])
        if pid == 0:
            torch.save({k: v.cpu() for k, v in
                        tr.model.state_dict().items()},
                       os.path.join(d, "step1.pt"))
        out["digest1"] = _state_digest(tr.model)
        _sync(dev)
        dist.barrier()
        t0 = time.perf_counter()
        objf = []
        for i in range(1, inp["steps"]):
            loss, diag = tr._step(*batches[i % 4])
            objf.append(float(diag["objf"]))
        _sync(dev)
        out["train_wall"] = time.perf_counter() - t0
        dist.barrier()
        out["train_all_wall"] = time.perf_counter() - t0
        out["den_launches"] = CudaChainDen.total_launches
        out["loss"], out["objf"] = float(loss), objf
        out["digest"] = _state_digest(tr.model)
        # the step's gradient all-reduce alone, on a buffer of its size
        flat = torch.cat([p.detach().reshape(-1)
                          for p in tr.model.parameters()])
        _sync(dev)
        dist.barrier()
        t0 = time.perf_counter()
        for _ in range(3):
            mesh.all_reduce_data(flat)
        _sync(dev)
        out["allreduce_ms"] = (time.perf_counter() - t0) / 3 * 1e3
        out["allreduce_mb"] = flat.numel() * 4 / 2 ** 20
        dist.barrier()
        del tr, flat
        # 16d: ChainTrainer(mesh=make_mesh(data, model)) on each layout
        out["tp"] = {f"{a}x{b}": pod_tp_layout(inp, egs, a, b, pid, d, dev)
                     for a, b in inp["tp_layouts"]}
    finally:
        distributed.shutdown()
    with open(os.path.join(d, f"out.{pid}.pkl"), "wb") as f:
        pickle.dump(out, f)
    return 0


def _replicated_digest(model) -> str:
    """sha256 of the tensors every rank holds whole (the () tensors of a
    model sharded over a model axis)."""
    import hashlib
    shards = getattr(model, "tp_shards", {})
    h = hashlib.sha256()
    for k, v in model.state_dict().items():
        if k not in shards:
            h.update(k.encode())
            h.update(v.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def pod_tp_layout(inp, egs, data: int, model: int, pid: int, d: str,
                  dev) -> dict:
    """16d on one rank: ChainTrainer(mesh=make_mesh(data, model)) at
    ``tp_B`` for ``tp_steps`` NG-SGD steps from SEED's weights; rank 0
    writes step 1's whole tensors (gathered) for the parent; then one
    step more with every collective (torch.distributed's all_reduce and
    all_gather, each between two synchronizes) timed.  → the digests of
    the replicated tensors after step 1 and the last, walls, the
    collectives' count, MiB and ms in that step, the den launches and
    the parameter and optimizer-state bytes this rank holds against the
    whole model's."""
    import torch.distributed as dist
    from kaldi_tpu_torch.ops.chain_den import CudaChainDen
    from kaldi_tpu_torch.parallel import make_mesh
    from kaldi_tpu_torch.pipelines.chain import ChainTrainConfig, ChainTrainer
    mesh = make_mesh(data, model)
    B, steps = inp["tp_B"], inp["tp_steps"]
    tr = ChainTrainer(tdnn_config(inp["P"], **inp["width"]), inp["den"],
                      ChainTrainConfig(batch_size=B, optimizer="ngsgd",
                                       total_steps=0), seed=SEED, mesh=mesh)
    N = egs.feats.shape[0]
    batches = [tr.batches(egs, (np.arange(B) + i * B) % N) for i in range(4)]
    r = {"param_bytes": sum(p.numel() * p.element_size()
                            for p in tr.model.parameters())}
    CudaChainDen.total_launches = 0
    tr._step(*batches[0])
    full = tr.state_dict()
    if pid == 0:
        torch.save({k: v.cpu() for k, v in full.items()},
                   os.path.join(d, f"tp_{data}x{model}.pt"))
    r["full_bytes"] = sum(full[k].numel() * full[k].element_size()
                          for k, _ in tr.model.named_parameters())
    r["opt_bytes"] = tr.opt.state_bytes()
    r["full_opt_bytes"] = tr.opt.state_bytes(whole=True)
    del full
    r["digest1"] = _replicated_digest(tr.model)
    _sync(dev)
    dist.barrier()
    t0 = time.perf_counter()
    objf = []
    for i in range(1, steps):
        loss, diag = tr._step(*batches[i % 4])
        objf.append(float(diag["objf"]))
    _sync(dev)
    r["train_wall"] = time.perf_counter() - t0
    dist.barrier()
    r["train_all_wall"] = time.perf_counter() - t0
    coll = {"n": 0, "mb": 0.0, "ms": 0.0}
    orig = {name: getattr(dist, name) for name in ("all_reduce",
                                                   "all_gather")}

    def timed(name):
        def call(*a, **kw):
            t = a[0] if name == "all_reduce" else a[1]
            _sync(dev)
            t1 = time.perf_counter()
            res = orig[name](*a, **kw)
            _sync(dev)
            coll["ms"] += (time.perf_counter() - t1) * 1e3
            coll["n"] += 1
            coll["mb"] += t.numel() * t.element_size() / 2 ** 20
            return res
        return call
    for name in orig:
        setattr(dist, name, timed(name))
    try:
        _sync(dev)
        t0 = time.perf_counter()
        tr._step(*batches[steps % 4])
        _sync(dev)
        r["timed_step_ms"] = (time.perf_counter() - t0) * 1e3
    finally:
        for name, fn in orig.items():
            setattr(dist, name, fn)
    r["coll"] = coll
    r["den_launches"] = CudaChainDen.total_launches
    r["loss"], r["objf"] = float(loss), objf
    r["digest"] = _replicated_digest(tr.model)
    dist.barrier()
    return r


def pod_worker_main_start(dev, n: int, backend: str, d: str):
    """16a: ``python -m kaldi_tpu_torch.parallel.distributed`` on n ranks
    (the original's four checks: stat reduction, the data-parallel
    gradient, the sharded lattice decode against the single one in each
    rank, one ChainTrainer(mesh=) step equal across ranks), started.
    → (processes, start time)."""
    import subprocess
    return [subprocess.Popen(
        [sys.executable, "-m", "kaldi_tpu_torch.parallel.distributed",
         f"file://{os.path.abspath(d)}/store_a", str(n), str(pid),
         os.path.join(d, "a"), f"--device={dev.type}",
         f"--backend={backend}"], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE) for pid in range(n)], time.perf_counter()


def pod_worker_main_finish(dev, n: int, backend: str, d: str, started,
                           tag: str) -> int:
    """16a's checks on what its ranks wrote.  → the den kernels' launches
    of its chain step over every rank."""
    procs, t0 = started
    _pod_wait(procs, "16a")
    wall = time.perf_counter() - t0
    r = [dict(np.load(os.path.join(d, f"a.{pid}.npz"))) for pid in range(n)]
    want = sum(np.random.default_rng(100 + pid).standard_normal(
        (4, 3)).astype(np.float32) for pid in range(n))
    gb = np.random.default_rng(7).standard_normal((n * 4, 8)).astype(
        np.float32)
    W = np.linspace(-1, 1, 8).astype(np.float32)
    grad = 2 * gb.T @ (gb @ W - gb @ (np.arange(8) * 0.1)) / len(gb)
    stat_err = max(float(np.abs(x["total"] - want).max()) for x in r)
    grad_err = max(float(np.abs(x["grad"] - grad).max()) for x in r)
    same = all(np.array_equal(x["chain_params"], r[0]["chain_params"])
               and float(x["chain_loss"]) == float(r[0]["chain_loss"])
               for x in r)
    print(f"pod: 16a: python -m kaldi_tpu_torch.parallel.distributed on "
          f"{n} ranks ({backend}; ranks on "
          f"{[str(x['device']) for x in r]}) in {wall:.1f} s: stats "
          f"|diff| {stat_err:.2e}, gradient |diff| {grad_err:.2e}, sharded "
          f"lattice decode = single {[int(x['decode_ok']) for x in r]}, "
          f"chain step loss {float(r[0]['chain_loss']):.6f} equal on every "
          f"rank to the bit: {same} {tag}")
    if not (stat_err <= 1e-5 and grad_err <= 1e-4 and same
            and all(int(x["decode_ok"]) == 1 and int(x["n_lats"]) == 2
                    for x in r)
            and all(str(x["backend"]) == backend for x in r)):
        raise AssertionError("16a: the distributed worker's checks failed")
    launches = sum(int(x["den_launches"]) for x in r)
    if dev.type == "cuda" and launches <= 0:
        raise AssertionError("16a: the chain step launched no den kernel")
    return launches


def pod_phase(dev, csr, tid_to_pdf, cfg, X, lens, best, p4_rate: float,
              den, egs, P: int, xc_rate, tag: str,
              B: int = POD_B, steps: int = POD_STEPS, tp_layouts=None,
              tp_B: int = TP_B, tp_steps: int = TP_STEPS, **width):
    """16: N = max(2, cards) ranks, each a process.  16a the port's
    distributed worker; 16b phase 4's batch by decode_compact_local, each
    utterance's best path equal to phase 4's (words exactly, cost within
    1e-3), audio-s/s over the wall and per rank beside phase 4's; 16c
    ChainTrainer(mesh=) at B (B / N a rank) for ``steps`` steps, the
    ranks' weights equal to the bit after the first and the last, the
    first step equal to one process's within 1e-4 of each tensor's
    largest, Mframes/s over the wall; 16d ChainTrainer(mesh=make_mesh(
    data, model)) on each of ``tp_layouts`` (default (1, N): tensor
    parallelism over every rank) at ``tp_B`` for ``tp_steps`` steps,
    step 1's whole tensors within TP_TOL of one process's, the
    replicated tensors equal to the bit on every rank, Mframes/s, the
    collectives' count, MiB and ms in a step, each rank's parameter
    bytes against the whole model's.  → the den kernels' launches over
    every rank (16a's step, 16c's and 16d's training)."""
    import dataclasses
    import pickle
    import shutil
    import subprocess
    from kaldi_tpu_torch.pipelines.chain import ChainTrainConfig, ChainTrainer
    n, backend = pod_layout(dev.type)
    B -= B % n                          # 16c's batch divides over the ranks
    tp_layouts = list(tp_layouts or [(1, n)])
    if dev.type == "cuda":
        torch.cuda.empty_cache()        # the ranks share this card
    shutil.rmtree(POD_DIR, ignore_errors=True)
    os.makedirs(POD_DIR)
    # 16a checks correctness only: it runs while the parent writes 16b's
    # and 16c's inputs and takes one process's training step
    started = pod_worker_main_start(dev, n, backend, POD_DIR)
    # 16b / 16c inputs: the graph as an .npz, the rest pickled
    save_csr(os.path.join(POD_DIR, "graph.npz"), csr)
    eg_fields = ("feats", "pdf_ali", "mask", "entry_pdf", "self_pdf",
                 "num_segs", "entry_w", "self_w", "init_w", "final_w")
    with open(os.path.join(POD_DIR, "inputs.pkl"), "wb") as f:
        pickle.dump(dict(tid_to_pdf=tid_to_pdf, cfg=dataclasses.asdict(cfg),
                         X=X, lens=lens, P=P, den=den, B=B, steps=steps,
                         width=width, tp_layouts=tp_layouts, tp_B=tp_B,
                         tp_steps=tp_steps,
                         egs={k: getattr(egs, k) for k in eg_fields}), f)
    # one process's first step on 16c's first batch, from the same seed
    tr = ChainTrainer(tdnn_config(P, **width), den,
                      ChainTrainConfig(batch_size=B, optimizer="ngsgd",
                                       total_steps=0), seed=SEED, device=dev)
    tr._step(*tr.batches(egs, np.arange(B) % egs.feats.shape[0]))
    single = {k: v.detach().cpu() for k, v in tr.model.state_dict().items()}
    del tr
    # and 16d's, at its batch
    tp_single = single
    if tp_B != B:
        tr = ChainTrainer(tdnn_config(P, **width), den,
                          ChainTrainConfig(batch_size=tp_B, optimizer="ngsgd",
                                           total_steps=0), seed=SEED,
                          device=dev)
        tr._step(*tr.batches(egs, np.arange(tp_B) % egs.feats.shape[0]))
        tp_single = {k: v.detach().cpu()
                     for k, v in tr.model.state_dict().items()}
        del tr
    if dev.type == "cuda":
        torch.cuda.empty_cache()        # the ranks share this card
    a_launches = pod_worker_main_finish(dev, n, backend, POD_DIR, started,
                                        tag)
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--pod-worker",
         f"file://{os.path.abspath(POD_DIR)}/store_b", str(n), str(pid),
         POD_DIR, dev.type, backend], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE) for pid in range(n)]
    _pod_wait(procs, "16b/16c")
    wall = time.perf_counter() - t0
    r = []
    for pid in range(n):
        with open(os.path.join(POD_DIR, f"out.{pid}.pkl"), "rb") as f:
            r.append(pickle.load(f))
    print(f"pod: 16b/16c: {n} ranks ({backend}): rank→device "
          f"{ {pid: x['device'] for pid, x in enumerate(r)} }, "
          f"{wall:.1f} s in all")
    # 16b
    got = [bp for x in r for bp in x["best"]]
    if len(got) != len(best):
        raise AssertionError(f"16b: {len(got)} lattices for {len(best)}")
    worst = 0.0
    for b, (g, w) in enumerate(zip(got, best)):
        if g[0] != w[0] or abs(g[2] - w[2]) > 1e-3:
            raise AssertionError(f"16b: utt {b}: {g[0]} {g[2]} vs phase 4's "
                                 f"{w[0]} {w[2]}")
        worst = max(worst, abs(g[2] - w[2]))
    frames = lens.astype(np.float64) * 0.03
    audio = float(frames.sum())
    agg = audio / max(x["decode_all_wall"] for x in r)
    per = [float(frames[slice(*x["rows"])].sum()) / x["decode_wall"]
           for x in r]
    print(f"pod: 16b: {len(got)} utterances of phase 4's batch by "
          f"decode_compact_local over {n} ranks: every best path equals "
          f"phase 4's (words exactly, cost within {worst:.2e}; limit 1e-3); "
          f"{audio:.2f} audio-s in {max(x['decode_all_wall'] for x in r):.3f}"
          f" s = {agg:.1f} audio-s/s aggregate (phase 4, one process: "
          f"{p4_rate:.1f}), per rank {[round(v, 1) for v in per]} audio-s/s; "
          f"graph packed and uploaded by each rank in "
          f"{max(x['pack_s'] for x in r):.1f} s; escalated "
          f"{sum(x['decode_stats']['n_escalated'] for x in r)} {tag}")
    for x in r:
        for g, w in zip(x["full_best"], best):
            if g[0] != w[0] or abs(g[2] - w[2]) > 1e-3:
                raise AssertionError("16b: a rank's decode of the whole "
                                     "batch differs from phase 4's")
    full = max(x["full_all_wall"] for x in r)
    print(f"pod: 16b: every rank the whole batch ({n} × {len(best)} "
          f"utterances, best paths equal to phase 4's): {n * audio:.2f} "
          f"audio-s in {full:.3f} s = {n * audio / full:.1f} audio-s/s "
          f"aggregate (phase 4, one process: {p4_rate:.1f}) {tag}")
    # 16c
    with_step1 = torch.load(os.path.join(POD_DIR, "step1.pt"),
                            weights_only=True)
    rel, worst_k = max((float((with_step1[k] - single[k]).abs().max()
                              / max(float(single[k].abs().max()), 1e-12)), k)
                       for k in single)
    same1 = len({x["digest1"] for x in r}) == 1
    same = len({x["digest"] for x in r}) == 1
    frames_step = B * egs.feats.shape[1]
    rate = frames_step * (steps - 1) / max(x["train_all_wall"]
                                           for x in r) / 1e6
    launches = sum(x["den_launches"] for x in r)
    objf = r[0]["objf"]
    print(f"pod: 16c: ChainTrainer(mesh=) NG-SGD float32 at B={B} "
          f"({B // n} a rank) for {steps} steps: weights equal on every rank "
          f"to the bit after step 1: {same1}, after step {steps}: {same}; "
          f"step 1 against one process's: {rel:.2e} of each tensor's largest"
          f" ({worst_k}; limit 1e-4); steps 2-{steps} "
          f"{1e3 * max(x['train_all_wall'] for x in r) / (steps - 1):.1f} ms "
          f"a step = {rate:.4f} Mframes/s aggregate"
          + (f" (15a's xc_tdnnf_f32_B128, one process: {xc_rate:.4f})"
             if xc_rate is not None else "")
          + f"; the gradients' all-reduce alone "
          f"({r[0]['allreduce_mb']:.1f} MiB) "
          f"{max(x['allreduce_ms'] for x in r):.1f} ms; loss "
          f"{r[0]['loss']:.4f}; den kernel launches {launches} {tag}")
    if not (same1 and same and rel <= 1e-4
            and all(math.isfinite(v) for v in objf)
            and math.isfinite(r[0]["loss"])):
        raise AssertionError("16c: the data-parallel trainer failed its "
                             "checks")
    if dev.type == "cuda" and launches <= 0:
        raise AssertionError("16c: the training launched no den kernel")
    return a_launches + launches + pod_tp_check(r, tp_layouts, tp_single,
                                                tp_B, tp_steps, egs, backend,
                                                dev, tag)


def pod_tp_check(r, layouts, single, B: int, steps: int, egs, backend,
                 dev, tag: str) -> int:
    """16d's checks on what the ranks wrote.  → its den launches."""
    launches = 0
    for data, model in layouts:
        key = f"{data}x{model}"
        x = [y["tp"][key] for y in r]
        got = torch.load(os.path.join(POD_DIR, f"tp_{key}.pt"),
                         weights_only=True)
        rel, worst_k = max((float((got[k] - single[k]).abs().max()
                                  / max(float(single[k].abs().max()),
                                        1e-12)), k) for k in single)
        same1 = len({y["digest1"] for y in x}) == 1
        same = len({y["digest"] for y in x}) == 1
        wall = max(y["train_all_wall"] for y in x)
        rate = B * egs.feats.shape[1] * (steps - 1) / wall / 1e6
        coll = x[0]["coll"]
        n_den = sum(y["den_launches"] for y in x)
        launches += n_den
        print(f"pod: 16d: ChainTrainer(mesh=make_mesh({data}, {model})) "
              f"NG-SGD float32 at B={B} ({backend}) for {steps} steps: step 1"
              f" against one process's: {rel:.2e} of each tensor's largest "
              f"({worst_k}; limit {TP_TOL:g}); replicated tensors equal on "
              f"every rank to the bit after step 1: {same1}, after step "
              f"{steps}: {same}; steps 2-{steps} "
              f"{1e3 * wall / (steps - 1):.1f} ms a step = {rate:.4f} "
              f"Mframes/s aggregate; one step with its collectives timed "
              f"{x[0]['timed_step_ms']:.1f} ms, of it {coll['n']} "
              f"collectives of {coll['mb']:.1f} MiB in {coll['ms']:.1f} ms "
              f"(rank 0); parameters a rank "
              f"{x[0]['param_bytes'] / 2 ** 20:.2f} MiB of the whole model's "
              f"{x[0]['full_bytes'] / 2 ** 20:.2f}, optimizer state a rank "
              f"{x[0]['opt_bytes'] / 2 ** 20:.2f} MiB of the whole model's "
              f"{x[0]['full_opt_bytes'] / 2 ** 20:.2f}; loss "
              f"{x[0]['loss']:.4f}; "
              f"den kernel launches {n_den} {tag}")
        if not (same1 and same and rel <= TP_TOL
                and all(math.isfinite(v) for v in x[0]["objf"])
                and math.isfinite(x[0]["loss"])):
            raise AssertionError(f"16d: the {key} trainer failed its checks")
        if model > 1 and not (x[0]["param_bytes"] < x[0]["full_bytes"] and
                              x[0]["opt_bytes"] < x[0]["full_opt_bytes"]):
            raise AssertionError(f"16d: {key}: a rank holds the whole model "
                                 f"or its whole optimizer state")
        if dev.type == "cuda" and n_den <= 0:
            raise AssertionError(f"16d: {key} launched no den kernel")
    return launches


# ---------------------------------------------------------------------------
# 17. tri3b as Kaldi's tools: train_deltas.sh → train_lda_mllt.sh →
# train_sat.sh → decode_fmllr.sh, each step a tool of the port
# ---------------------------------------------------------------------------

TRI_DIR = os.path.join("build", "chip_smoke_tri_tools")
# mini_librispeech run.sh's shapes: 13 cepstra (mfcc.conf), splice ±3
# (train_lda_mllt.sh's --splice-opts), LDA to 40, --boost-silence 1.25;
# the tree at 10b's ladder sizes (MINI_LADDER: 30 leaves, 600 Gaussians)
TRI_CEPS = 13
TRI_SPLICE = 3
TRI_LDA_DIM = 40
TRI_BOOST = 1.25
# {gmm-acc-stats-ali → gmm-est → gmm-align-compiled} passes of each of
# tri1, tri2b and tri3b (run.sh's scripts run 35; the depth knob), the
# mix-up reaching 600 Gaussians over the first TRI_MIX_PASSES, the MLLT
# re-estimated after the tri2b passes in TRI_MLLT_AFTER
TRI_PASSES = 8
TRI_MIX_PASSES = 6
TRI_MLLT_AFTER = (1, 3)
TRI_DECODE = ("--beam=16", "--max-active=2000", "--acoustic-scale=0.1")
# 17's bars, tool against library on the same input files in the same
# run on the card (the host code is the same code: equal files):
#  * accumulators through the GMM's mixture posteriors (gmm-acc-stats-ali,
#    gmm-acc-stats-twofeats, gmm-acc-mllt's float32 file): 10d's 1e-5
#    relative, of the largest entry;
#  * fMLLR matrices (float64 row updates from those statistics, written
#    as float32): 1e-5 of the largest entry;
#  * features out of add-deltas, splice-feats and transform-feats (the
#    same float32 device ops in another process): 1e-6 of the largest;
#  * decodes: the best path's words equal, its cost within 1e-4
#    relative (the tool determinizes with pruning, the library without);
#  * trees, tree statistics, questions, models, LDA, MLLT and composed
#    matrices, alignments, posteriors and graphs: equal.
TRI_ACC_TOL = 1e-5
TRI_MAT_TOL = 1e-5
TRI_FEAT_TOL = 1e-6
TRI_COST_TOL = 1e-4
# 17's other parts: the full-covariance GMM card = CPU (float64 both);
# the EBW statistics card = CPU at 10c's card-vs-CPU accumulator bar
# (1e-4 of each entry plus 1e-4 of the largest: float32 mixture
# posteriors of another device; at 10d's 1e-5 the card's were 1.112 of
# the bar on 10b's 40-dimensional SAT features) and the EBW update within
# 1e-4 of each parameter's largest; the ladder's chain rung at
# LADDER_EPOCHS epochs (ladder.py's 40 cut: its TDNN and data are the
# original's) on 10b's systems
FGMM_TOL = 1e-10
EBW_ACC_TOL = 1e-4
EBW_TOL = 1e-4
EBW_LATTICE_UTTS = 8
LADDER_EPOCHS = 6


def tri_tools_start(dev, sysd):
    """17, started: 10b's waveforms, transcripts, speakers, lexicon,
    topology, words, G, mono model, mono alignments and mono test
    features written into TRI_DIR, then ``python3 chip_smoke.py
    --tri-tools`` (``tri_tools_worker``) in the background.  → (process,
    dir, start time)."""
    import subprocess
    from kaldi_tpu_torch.am.serialize import write_mdl, write_topology
    from kaldi_tpu_torch.core import io as kio
    from kaldi_tpu_torch.core.table import TableWriter
    from kaldi_tpu_torch.fst.openfst_io import write_fst_path
    repo = os.path.dirname(os.path.abspath(__file__))
    d = os.path.join(repo, TRI_DIR)
    os.makedirs(d, exist_ok=True)
    lang, mono = sysd["lang"], sysd["mono"]
    for s, data in (("tr", sysd["train"]), ("te", sysd["test"])):
        with TableWriter(f"ark:{d}/wav_{s}.ark", holder="wav") as w:
            for u in data.utts:
                w[u] = data.wavs[u]
        with TableWriter(f"ark:{d}/text_{s}.ark", holder="text") as w:
            for u in data.utts:
                w[u] = data.text[u]
        with open(f"{d}/spk2utt_{s}", "w") as f:
            for spk, utts in data.spk2utt().items():
                f.write(f"{spk} {' '.join(utts)}\n")
        with open(f"{d}/utt2spk_{s}", "w") as f:
            for u in data.utts:
                f.write(f"{u} {data.utt2spk[u]}\n")
    with TableWriter(f"ark:{d}/mono_delta_te.ark", holder="mat") as w:
        for u, x in sysd["delta_te"].items():
            w[u] = x
    with TableWriter(f"ark:{d}/mono_ali.ark", holder="ivec") as w:
        for u, a in sysd["mono_ali"].items():
            w[u] = np.asarray(a, np.int32)
    with open(f"{d}/lexicon.txt", "w") as f:
        for word, pron in lang.lexicon.entries:
            f.write(f"{word} {' '.join(pron)}\n")
    with open(f"{d}/topo", "wb") as f:
        kio.init_kaldi_output_stream(f)
        write_topology(f, mono.tm.topo)
    lang.words.write(f"{d}/words.txt")
    write_fst_path(f"{d}/G.fst", sysd["G"])
    write_mdl(f"{d}/mono.mdl", mono.tm, mono.am)
    with open(f"{d}/meta.json", "w") as f:
        json.dump({"sil": ":".join(str(p) for p in lang.silence_phones),
                   "leaves": MINI_LADDER["tri_leaves"],
                   "gauss": MINI_LADDER["tri_gauss"]}, f)
    out = open(f"{d}/worker.out", "w")
    err = open(f"{d}/worker.err", "w")
    # two host threads: the process runs beside 11a's lattice builds
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--tri-tools", d,
         dev.type], cwd=repo, stdout=out, stderr=err,
        env=dict(os.environ, OMP_NUM_THREADS="2"))
    out.close()
    err.close()
    return proc, d, time.perf_counter()


def _tri_read(d, name):
    with open(f"{d}/{name}") as f:
        return {p[0]: p[1:] for p in (line.split() for line in f) if p}


def tri_tools_worker(argv) -> int:
    """17's background process: the tri3b recipe as tools (each a call of
    ``kaldi_tpu_torch.cli.tools.main``'s registry in this one process),
    then every call held against the library on its own input files
    (``tri_tools_check``).  Writes ``report.json`` (stage walls, WERs,
    each check) into the directory; exits 1 if a check fails."""
    import contextlib
    import io
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from kaldi_tpu_torch.am.serialize import read_mdl
    from kaldi_tpu_torch.cli import TOOLS
    from kaldi_tpu_torch.core import io as kio
    from kaldi_tpu_torch.core.table import SequentialTableReader, TableWriter
    t_start = time.perf_counter()
    d, dv = argv[0], argv[1]
    dev = f"--device={dv}"
    meta = json.load(open(f"{d}/meta.json"))
    sil = meta["sil"]
    calls, walls, wers = [], {}, {}

    def T(name, *args):
        args = [str(a) for a in args]
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = TOOLS[name](args)
        if rc:
            raise AssertionError(f"{name} {' '.join(args)}: rc {rc}")
        calls.append((name, args, buf.getvalue()))
        return buf.getvalue()

    def decode(stage, mdl, feats):
        """compile-graph → gmm-latgen-faster → lattice-best-path →
        compute-wer on the test set."""
        s = f"{d}/{stage}"
        T("compile-graph", f"{d}/lexicon.txt", mdl, f"{d}/G.fst",
          f"{s}/HCLG.fst")
        T("gmm-latgen-faster", dev, *TRI_DECODE, mdl, f"{s}/HCLG.fst",
          feats, f"ark:{s}/lat.ark")
        T("lattice-best-path", f"--word-symbol-table={d}/words.txt",
          f"ark:{s}/lat.ark", f"ark,t:{s}/hyp.txt")
        return T("compute-wer", f"ark:{d}/text_te.ark",
                 f"ark,t:{s}/hyp.txt").strip()

    def tree(stage, prev_mdl, feats, prev_ali):
        """acc-tree-stats → sum-tree-stats → cluster-phones →
        compile-questions → build-tree → gmm-init-model → convert-ali →
        compile-train-graphs (train_deltas.sh's head)."""
        s = f"{d}/{stage}"
        os.makedirs(s, exist_ok=True)
        T("acc-tree-stats", prev_mdl, feats, prev_ali, f"{s}/1.treeacc")
        T("sum-tree-stats", f"{s}/treeacc", f"{s}/1.treeacc")
        T("cluster-phones", f"{s}/treeacc", f"{s}/sets.txt")
        T("compile-questions", f"{s}/sets.txt", f"{s}/questions.txt")
        T("build-tree", f"--max-leaves={meta['leaves']}", f"{s}/treeacc",
          f"{s}/questions.txt", f"{s}/tree")
        T("gmm-init-model", f"{s}/tree", f"{s}/treeacc", f"{d}/topo",
          f"{s}/0.mdl")
        T("convert-ali", prev_mdl, f"{s}/0.mdl", f"{s}/tree", prev_ali,
          f"ark:{s}/ali.0.ark")
        T("compile-train-graphs", f"{d}/lexicon.txt", f"{s}/0.mdl",
          f"ark:{d}/text_tr.ark", f"ark:{s}/graphs.ark")

    def passes(stage, feats, after=None, graphs=None):
        """{gmm-acc-stats-ali → gmm-est (--mix-up) → gmm-align-compiled}
        TRI_PASSES times from ``0.mdl`` and ``ali.0.ark``; ``after(k, i,
        feats, mdl)`` may hand the next pass new features and a new
        model.  → (final model, final alignment rspec, features)."""
        s = f"{d}/{stage}"
        graphs = graphs or f"ark:{s}/graphs.ark"
        mdl = f"{s}/0.mdl"
        _, am = read_mdl(mdl, device="cpu")
        n0, want = am.num_gauss(), meta["gauss"]
        for i in range(TRI_PASSES):
            T("gmm-acc-stats-ali", dev, mdl, feats, f"ark:{s}/ali.{i}.ark",
              f"{s}/{i}.acc")
            mix = ([f"--mix-up={n0 + (want - n0) * (i + 1) // TRI_MIX_PASSES}"]
                   if i < TRI_MIX_PASSES and n0 < want else [])
            T("gmm-est", *mix, mdl, f"{s}/{i}.acc", f"{s}/{i + 1}.mdl")
            mdl = f"{s}/{i + 1}.mdl"
            T("gmm-align-compiled", dev, mdl, graphs, feats,
              f"ark:{s}/ali.{i + 1}.ark")
            if after is not None:
                feats, mdl = after(i, i + 1, feats, mdl)
        return mdl, f"ark:{s}/ali.{TRI_PASSES}.ark", feats

    def by_speaker(stage, trans, feats, sset, out):
        """transform-feats takes one matrix: split the set by speaker
        (utils/split_data.sh's role) and run it once a speaker with that
        speaker's matrix; → an scp of the adapted features."""
        s = f"{d}/{stage}"
        mats = dict(SequentialTableReader(f"ark:{trans}", holder="mat"))
        allf = dict(SequentialTableReader(feats, holder="mat"))
        lines = []
        for spk, utts in _tri_read(d, f"spk2utt_{sset}").items():
            with open(f"{s}/{out}.{spk}.mat", "wb") as f:
                kio.init_kaldi_output_stream(f)
                kio.write_matrix(f, mats[spk])
            with TableWriter(f"ark:{s}/{out}.{spk}.in.ark",
                             holder="mat") as w:
                for u in utts:
                    w[u] = allf[u]
            T("transform-feats", dev, f"{s}/{out}.{spk}.mat",
              f"ark:{s}/{out}.{spk}.in.ark",
              f"ark,scp:{s}/{out}.{spk}.ark,{s}/{out}.{spk}.scp")
            lines.append(open(f"{s}/{out}.{spk}.scp").read())
        with open(f"{s}/{out}.scp", "w") as f:
            f.write("".join(lines))
        return f"scp:{s}/{out}.scp"

    t0 = time.perf_counter()
    # features (make_mfcc.sh, compute_cmvn_stats.sh, the Δ+ΔΔ pipe)
    for s in ("tr", "te"):
        T("compute-mfcc-feats", dev, "--sample-frequency=8000",
          "--dither=0", "--num-mel-bins=15", f"--num-ceps={TRI_CEPS}",
          f"ark:{d}/wav_{s}.ark", f"ark:{d}/raw_{s}.ark")
        T("compute-cmvn-stats", dev, f"--spk2utt={d}/spk2utt_{s}",
          f"ark:{d}/raw_{s}.ark", f"ark:{d}/cmvn_{s}.ark")
        T("apply-cmvn", dev, f"--utt2spk={d}/utt2spk_{s}",
          f"ark:{d}/cmvn_{s}.ark", f"ark:{d}/raw_{s}.ark",
          f"ark:{d}/base_{s}.ark")
        T("add-deltas", dev, f"ark:{d}/base_{s}.ark",
          f"ark:{d}/delta_{s}.ark")
    walls["features"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    os.makedirs(f"{d}/mono", exist_ok=True)
    wers["mono"] = decode("mono", f"{d}/mono.mdl",
                          f"ark:{d}/mono_delta_te.ark")
    walls["mono"] = time.perf_counter() - t0

    # tri1: train_deltas.sh
    t0 = time.perf_counter()
    tree("tri1", f"{d}/mono.mdl", f"ark:{d}/delta_tr.ark",
         f"ark:{d}/mono_ali.ark")
    mdl1, ali1, _ = passes("tri1", f"ark:{d}/delta_tr.ark")
    wers["tri1"] = decode("tri1", mdl1, f"ark:{d}/delta_te.ark")
    walls["tri1"] = time.perf_counter() - t0

    # tri2b: train_lda_mllt.sh
    t0 = time.perf_counter()
    s = f"{d}/tri2b"
    os.makedirs(s, exist_ok=True)
    ctx = (f"--left-context={TRI_SPLICE}", f"--right-context={TRI_SPLICE}")
    for x in ("tr", "te"):
        T("splice-feats", dev, *ctx, f"ark:{d}/base_{x}.ark",
          f"ark:{s}/splice_{x}.ark")
    T("ali-to-post", ali1, f"ark:{s}/post.ark")
    T("weight-silence-post", "0.0", sil, mdl1, f"ark:{s}/post.ark",
      f"ark:{s}/wpost.ark")
    T("acc-lda", mdl1, f"ark:{s}/splice_tr.ark", f"ark:{s}/wpost.ark",
      f"{s}/lda.acc")
    T("est-lda", f"--dim={TRI_LDA_DIM}", f"{s}/0.mat", f"{s}/lda.acc")
    T("transform-feats", dev, f"{s}/0.mat", f"ark:{s}/splice_tr.ark",
      f"ark:{s}/feats_tr.0.ark")
    tree("tri2b", mdl1, f"ark:{s}/feats_tr.0.ark", ali1)
    cur = {"mat": f"{s}/0.mat"}

    def mllt(k, i, feats, mdl):
        """gmm-acc-mllt → est-mllt → gmm-transform-means →
        compose-transforms → transform-feats after pass ``k``."""
        if k not in TRI_MLLT_AFTER:
            return feats, mdl
        T("gmm-acc-mllt", dev, mdl, feats, f"ark:{s}/ali.{i}.ark",
          f"{s}/{i}.macc")
        T("est-mllt", f"{s}/{i}.mllt", f"{s}/{i}.macc")
        T("gmm-transform-means", f"{s}/{i}.mllt", mdl, f"{s}/{i}.mllt.mdl")
        T("compose-transforms", f"{s}/{i}.mllt", cur["mat"], f"{s}/{i}.mat")
        cur["mat"] = f"{s}/{i}.mat"
        T("transform-feats", dev, cur["mat"], f"ark:{s}/splice_tr.ark",
          f"ark:{s}/feats_tr.{i}.ark")
        return f"ark:{s}/feats_tr.{i}.ark", f"{s}/{i}.mllt.mdl"

    mdl2, ali2, lda_tr = passes("tri2b", f"ark:{s}/feats_tr.0.ark",
                                after=mllt)
    T("transform-feats", dev, cur["mat"], f"ark:{s}/splice_te.ark",
      f"ark:{s}/feats_te.ark")
    lda_te = f"ark:{s}/feats_te.ark"
    wers["tri2b"] = decode("tri2b", mdl2, lda_te)
    walls["tri2b"] = time.perf_counter() - t0

    # tri3b: train_sat.sh (fMLLR by speaker on the boosted alignment)
    t0 = time.perf_counter()
    s3 = f"{d}/tri3b"
    os.makedirs(s3, exist_ok=True)
    T("gmm-boost-silence", f"--boost={TRI_BOOST}", sil, mdl2,
      f"{s3}/boost.mdl")
    T("gmm-align-compiled", dev, f"{s3}/boost.mdl", f"ark:{s}/graphs.ark",
      lda_tr, f"ark:{s3}/ali.0.ark")
    T("ali-to-post", f"ark:{s3}/ali.0.ark", f"ark:{s3}/post.ark")
    T("weight-silence-post", "0.0", sil, mdl2, f"ark:{s3}/post.ark",
      f"ark:{s3}/wpost.ark")
    T("gmm-est-fmllr", dev, f"--spk2utt={d}/spk2utt_tr", mdl2, lda_tr,
      f"ark:{s3}/wpost.ark", f"ark:{s3}/trans.ark")
    sat_tr = by_speaker("tri3b", f"{s3}/trans.ark", lda_tr, "tr", "sat_tr")
    with open(mdl2, "rb") as f, open(f"{s3}/0.mdl", "wb") as g:
        g.write(f.read())
    mdl3, ali3, _ = passes("tri3b", sat_tr, graphs=f"ark:{s}/graphs.ark")
    T("gmm-acc-stats-twofeats", dev, mdl3, sat_tr, lda_tr, ali3,
      f"{s3}/twofeats.acc")
    T("gmm-est", mdl3, f"{s3}/twofeats.acc", f"{s3}/final.alimdl")
    walls["tri3b"] = time.perf_counter() - t0

    # decode_fmllr.sh: the alignment model's pass, lattice posteriors with
    # silence at 0.01, fMLLR by speaker, the SAT model's pass
    t0 = time.perf_counter()
    T("compile-graph", f"{d}/lexicon.txt", mdl3, f"{d}/G.fst",
      f"{s3}/HCLG.fst")
    T("gmm-latgen-faster", dev, *TRI_DECODE, f"{s3}/final.alimdl",
      f"{s3}/HCLG.fst", lda_te, f"ark:{s3}/lat_si.ark")
    T("lattice-to-post", f"ark:{s3}/lat_si.ark", f"ark:{s3}/post_te.ark")
    T("weight-silence-post", "0.01", sil, f"{s3}/final.alimdl",
      f"ark:{s3}/post_te.ark", f"ark:{s3}/wpost_te.ark")
    T("gmm-est-fmllr", dev, f"--spk2utt={d}/spk2utt_te", mdl3, lda_te,
      f"ark:{s3}/wpost_te.ark", f"ark:{s3}/trans_te.ark")
    sat_te = by_speaker("tri3b", f"{s3}/trans_te.ark", lda_te, "te",
                        "sat_te")
    T("gmm-latgen-faster", dev, *TRI_DECODE, mdl3, f"{s3}/HCLG.fst", sat_te,
      f"ark:{s3}/lat.ark")
    T("lattice-best-path", f"--word-symbol-table={d}/words.txt",
      f"ark:{s3}/lat.ark", f"ark,t:{s3}/hyp.txt")
    wers["tri3b"] = T("compute-wer", f"ark:{d}/text_te.ark",
                      f"ark,t:{s3}/hyp.txt").strip()
    walls["tri3b decode"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    checks = tri_tools_check(d, torch.device(dv), calls)
    walls["checks"] = time.perf_counter() - t0
    with open(f"{d}/report.json", "w") as f:
        json.dump({"walls": walls, "wers": wers, "checks": checks,
                   "calls": len(calls),
                   "total": time.perf_counter() - t_start}, f)
    bad = [c for c in checks if not c[2]]
    if bad:
        print(f"tri tools: {len(bad)} checks failed: {bad[:5]}",
              file=sys.stderr)
        return 1
    return 0


def _tri_opts(args):
    """A tool call's arguments → ({option: value}, [positional])."""
    opts, pos = {}, []
    for a in args:
        if a.startswith("--"):
            k, _, v = a[2:].partition("=")
            opts[k] = v
        else:
            pos.append(a)
    return opts, pos


def tri_tools_check(d, dev, calls):
    """Each tool call of 17's worker against the library on the same input
    files, on ``dev`` (the bars are TRI_*'s).  → [(tool, output, held,
    detail)]."""
    import tempfile
    from kaldi_tpu_torch.am.gmm import (GmmAccs, accumulate_stats,
                                        accumulate_stats_twofeats, mixup,
                                        mle_update)
    from kaldi_tpu_torch.am.serialize import (read_mdl, read_topology,
                                              read_tree, write_mdl,
                                              write_tree)
    from kaldi_tpu_torch.am.transforms import (FmllrAccs, LdaEstimate,
                                               MlltAccs,
                                               accumulate_fmllr_from_post,
                                               apply_transform,
                                               compose_transforms)
    from kaldi_tpu_torch.am.transitions import TransitionModel
    from kaldi_tpu_torch.am.tree import (read_tree_stats, sum_tree_stats,
                                         build_tree, write_tree_stats)
    from kaldi_tpu_torch.cli.tools_bank3 import _lang_from_lexicon
    from kaldi_tpu_torch.cli.tools_bank5 import (_read_phone_sets,
                                                 _write_phone_sets)
    from kaldi_tpu_torch.cli.tools_bank9 import read_lda_accs
    from kaldi_tpu_torch.cli.tools_extra import read_gmm_accs
    from kaldi_tpu_torch.core import io as kio
    from kaldi_tpu_torch.core.table import SequentialTableReader
    from kaldi_tpu_torch.decoder.align import (DenseAligner,
                                               pack_training_graphs)
    from kaldi_tpu_torch.decoder.training_graph import TrainingGraphCompiler
    from kaldi_tpu_torch.features import (DeltaFeaturesOptions, add_deltas,
                                          splice_frames)
    from kaldi_tpu_torch.fst import mkgraph
    from kaldi_tpu_torch.fst.openfst_io import read_fst_path, write_fst_path
    from kaldi_tpu_torch.lattice.functions import frame_posteriors
    from kaldi_tpu_torch.pipelines.decode import decode_gmm_lattice
    from kaldi_tpu_torch.pipelines.mono import realign
    from kaldi_tpu_torch.pipelines.score import compute_wer
    from kaldi_tpu_torch.pipelines.tri import (accumulate_tree_stats,
                                               cluster_phone_questions,
                                               convert_alignment,
                                               init_model_from_tree_stats)
    tmp = tempfile.mkdtemp(dir=d)
    lang = _lang_from_lexicon(f"{d}/lexicon.txt", "SIL")

    def table(spec, holder):
        """A table by its rspecifier, or an output's by its wspecifier
        (``ark,scp:a.ark,a.scp`` reads ``ark:a.ark``)."""
        head, _, rest = spec.partition(":")
        if "scp" in head.split(",")[1:]:
            spec = "ark:" + rest.split(",")[0]
        return dict(SequentialTableReader(spec, holder=holder))

    def mat(path):
        with kio.open_rxfilename(path) as f:
            kio.init_kaldi_input_stream(f)
            return kio.read_matrix(f)

    def same_bytes(path, write):
        """``write(tmp path)`` writes the library's result: the files'
        bytes equal."""
        out = os.path.join(tmp, "lib")
        write(out)
        with open(out, "rb") as f, open(path, "rb") as g:
            return f.read() == g.read()

    def rel(got, want):
        got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
        return float(np.abs(got - want).max()
                     / max(float(np.abs(want).max()), 1e-30))

    def model(path, where=dev):
        return read_mdl(path, device=where)

    def lib_mdl(tm, am):
        return lambda out: write_mdl(out, tm, am)

    def feats_of(rspec):
        return {k: np.asarray(v, np.float32)
                for k, v in table(rspec, "mat").items()}

    def on(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    def feats_close(out_rspec, lib):
        got = feats_of(out_rspec)
        worst = max(rel(got[u], lib[u]) for u in lib)
        return sorted(got) == sorted(lib) and worst <= TRI_FEAT_TOL, \
            f"{worst:.2e}"

    def pdf_posts(tm, frames):
        return [[(int(tm.tid_to_pdf_array[t]), p) for t, p in fr]
                for fr in frames]

    def c_acc_tree_stats(o, p):
        tm, _ = model(p[0], "cpu")
        feats, alis = feats_of(p[1]), table(p[2], "ivec")
        both = {k: feats[k] for k in feats if k in alis}
        stats = accumulate_tree_stats(
            both, {k: [int(x) for x in alis[k]] for k in both}, tm,
            int(o.get("context-width", 3)), int(o.get("central-position", 1)))
        return same_bytes(p[3], lambda out: write_tree_stats(out, stats)), ""

    def c_sum_tree_stats(o, p):
        total = sum_tree_stats(read_tree_stats(x) for x in p[1:])
        return same_bytes(p[0], lambda out: write_tree_stats(out, total)), ""

    def c_cluster_phones(o, p):
        qs = cluster_phone_questions(read_tree_stats(p[0]),
                                     int(o.get("central-position", 1)))
        return same_bytes(p[1], lambda out: _write_phone_sets(out, qs)), \
            f"{len(qs)} sets"

    def c_compile_questions(o, p):
        sets = _read_phone_sets(p[0])
        sets += [frozenset([q]) for q in sorted({x for s in sets for x in s})
                 if frozenset([q]) not in sets]
        return same_bytes(p[1], lambda out: _write_phone_sets(out, sets)), ""

    def c_build_tree(o, p):
        tree = build_tree(read_tree_stats(p[0]), _read_phone_sets(p[1]),
                          int(o.get("context-width", 3)),
                          int(o.get("central-position", 1)),
                          int(o["max-leaves"]), float(o.get("thresh", 0.0)))

        def write(out):
            with kio.open_wxfilename(out) as f:
                write_tree(f, tree)
        return same_bytes(p[2], write), f"{tree.num_pdfs} leaves"

    def c_gmm_init_model(o, p):
        with kio.open_rxfilename(p[0]) as f:
            kio.init_kaldi_input_stream(f)
            tree = read_tree(f)
        with kio.open_rxfilename(p[2]) as f:
            kio.init_kaldi_input_stream(f)
            topo = read_topology(f)
        am = init_model_from_tree_stats(tree, read_tree_stats(p[1]),
                                        device=dev)
        return same_bytes(p[3], lib_mdl(TransitionModel(topo, tree), am)), ""

    def c_convert_ali(o, p):
        (tm0, _), (tm1, _) = model(p[0], "cpu"), model(p[1], "cpu")
        got = table(p[-1], "ivec")
        want = {k: convert_alignment(tm0, tm1, list(a),
                                     tm1.tree.context_width,
                                     tm1.tree.central_position)
                for k, a in table(p[-2], "ivec").items()}
        return sorted(got) == sorted(want) and all(
            list(got[k]) == want[k] for k in want), ""

    def arcs(fst):
        return [[(a.ilabel, a.olabel, np.float32(a.weight), a.nextstate)
                 for a in arcs] for arcs in fst.arcs]

    def c_compile_train_graphs(o, p):
        tm, _ = model(p[1], "cpu")
        comp = TrainingGraphCompiler(lang, tm)
        got = table(p[3], "fst")
        return all(arcs(got[k]) == arcs(comp.compile_text(list(t)))
                   for k, t in table(p[2], "text").items()), ""

    def c_gmm_acc_stats_ali(o, p):
        tm, am = model(p[0])
        feats, alis = feats_of(p[1]), table(p[2], "ivec")
        accs = GmmAccs.zeros(am.num_pdfs, am.max_mix, am.dim)
        for k in feats:
            accumulate_stats(am, feats[k], tm.tid_to_pdf_array[
                np.asarray(alis[k])], accs)
        got = read_gmm_accs(p[3])
        worst = max(rel(getattr(got, n), getattr(accs, n))
                    for n in ("occ", "mean_acc", "var_acc"))
        return worst <= TRI_ACC_TOL, f"{worst:.2e}"

    def c_gmm_est(o, p):
        tm, am = model(p[0], "cpu")
        mle_update(am, read_gmm_accs(p[1]),
                   min_occ=float(o.get("min-gaussian-occupancy", 3.0)))
        if int(o.get("mix-up", 0)):
            am = mixup(am, int(o["mix-up"]))
        return same_bytes(p[2], lib_mdl(tm, am)), f"{am.num_gauss()} gauss"

    def c_gmm_align_compiled(o, p):
        tm, am = model(p[0])
        graphs, feats = table(p[1], "fst"), feats_of(p[2])
        utts = [u for u in feats if u in graphs]
        dense = dict(zip(utts, pack_training_graphs([graphs[u]
                                                     for u in utts])))
        want = realign(am, DenseAligner(tm.tid_to_pdf_array, device=dev),
                       dense, utts, feats)
        got = table(p[3], "ivec")
        return sorted(got) == sorted(want) and all(
            list(got[u]) == list(want[u]) for u in utts), ""

    def c_add_deltas(o, p):
        return feats_close(p[1], {
            k: add_deltas(on(x), DeltaFeaturesOptions()).cpu().numpy()
            for k, x in feats_of(p[0]).items()})

    def c_splice_feats(o, p):
        return feats_close(p[1], {
            k: splice_frames(on(x), int(o["left-context"]),
                             int(o["right-context"])).cpu().numpy()
            for k, x in feats_of(p[0]).items()})

    def c_transform_feats(o, p):
        m = mat(p[0])
        return feats_close(p[2], {k: apply_transform(on(x), m).cpu().numpy()
                                  for k, x in feats_of(p[1]).items()})

    def c_ali_to_post(o, p):
        got = table(p[1], "post")
        return all([[(int(t), 1.0)] for t in a] ==
                   [[(int(t), float(w)) for t, w in fr] for fr in got[k]]
                   for k, a in table(p[0], "ivec").items()), ""

    def c_weight_silence_post(o, p):
        w, sil = float(p[0]), {int(x) for x in p[1].split(":") if x}
        tm, _ = model(p[2], "cpu")
        got = table(p[4], "post")
        want = {k: [[(t, q * w if tm.transition_id_to_phone(t) in sil
                      else q) for t, q in fr] for fr in post]
                for k, post in table(p[3], "post").items()}
        want = {k: [[(t, q) for t, q in fr if q > 0] for fr in post]
                for k, post in want.items()}
        return all(len(got[k]) == len(want[k]) and all(
            [t for t, _ in g] == [t for t, _ in h]
            and np.allclose([q for _, q in g], [q for _, q in h], rtol=1e-6)
            for g, h in zip(got[k], want[k])) for k in want), ""

    def c_acc_lda(o, p):
        tm, _ = model(p[0], "cpu")
        posts = table(p[2], "post")
        lda = None
        for k, x in feats_of(p[1]).items():
            if k not in posts:
                continue
            if lda is None:
                lda = LdaEstimate(tm.num_pdfs, x.shape[1])
            for t, fr in enumerate(posts[k]):
                for tid, q in fr:
                    lda.accumulate(x[t], tm.transition_id_to_pdf(int(tid)),
                                   float(q))
        got = read_lda_accs(p[3])
        ok = all(np.array_equal(g, np.float32(w)) for g, w in
                 zip(got, (lda.counts, lda.first, lda.total_second)))
        return ok, ""

    def c_est_lda(o, p):
        counts, first, second = read_lda_accs(p[1])
        lda = LdaEstimate(len(counts), first.shape[1])
        lda.counts += counts
        lda.first += first
        lda.total_second += second
        m = lda.estimate(int(o["dim"]))
        return np.array_equal(mat(p[0]), np.float32(m)), f"{m.shape}"

    def c_gmm_acc_mllt(o, p):
        tm, am = model(p[0])
        alis = table(p[2], "ivec")
        accs = None
        for k, x in feats_of(p[1]).items():
            accs = accs or MlltAccs(x.shape[1])
            pdfs = tm.tid_to_pdf_array[np.asarray(alis[k], np.int64)]
            post = am.component_posteriors(x, pdfs).cpu().numpy()
            accs.accumulate(post, x, am.means[pdfs], 1.0 / am.vars[pdfs])
        with kio.open_rxfilename(p[3]) as f:
            kio.init_kaldi_input_stream(f)
            kio.expect_token(f, "<MLLTACCS>")
            beta = kio.read_basic_float(f)
            G = np.stack([kio.read_matrix(f) for _ in range(accs.G.shape[0])])
        worst = max(rel(G, accs.G), abs(beta - accs.beta) / accs.beta)
        return worst <= TRI_ACC_TOL, f"{worst:.2e}"

    def c_est_mllt(o, p):
        with kio.open_rxfilename(p[1]) as f:
            kio.init_kaldi_input_stream(f)
            kio.expect_token(f, "<MLLTACCS>")
            beta = kio.read_basic_float(f)
            G0 = kio.read_matrix(f)
            G = np.stack([G0] + [kio.read_matrix(f)
                                 for _ in range(G0.shape[0] - 1)])
        accs = MlltAccs(G0.shape[0])
        accs.beta += beta
        accs.G += G
        m, impr = accs.update()
        return np.array_equal(mat(p[0]), np.float32(m)), \
            f"objf impr {impr:.4f}"

    def c_gmm_transform_means(o, p):
        T_ = mat(p[0])
        tm, am = model(p[1], "cpu")
        D = am.dim
        b = T_[:, D] if T_.shape[1] == D + 1 else np.zeros(D)
        am.means = am.means @ T_[:, :D].T + b
        am.refresh()
        return same_bytes(p[2], lib_mdl(tm, am)), ""

    def c_compose_transforms(o, p):
        c = compose_transforms(mat(p[0]), mat(p[1]),
                               b_is_affine=o.get("b-is-affine") == "true")
        return np.array_equal(mat(p[2]), np.float32(c)), f"{c.shape}"

    def c_gmm_boost_silence(o, p):
        sil = {int(x) for x in p[0].split(":") if x}
        tm, am = model(p[1], "cpu")
        pdfs = {int(tm.tid_to_pdf_array[t])
                for t in range(1, tm.num_transition_ids + 1)
                if tm.transition_id_to_phone(t) in sil}
        for q in sorted(pdfs):
            am.weights[q] *= float(o.get("boost", 1.5))
        am.refresh()
        return same_bytes(p[2], lib_mdl(tm, am)), f"{len(pdfs)} pdfs"

    def c_gmm_est_fmllr(o, p):
        tm, am = model(p[0])
        feats, posts = feats_of(p[1]), table(p[2], "post")
        got = table(p[3], "mat")
        groups = (_tri_read(d, os.path.basename(o["spk2utt"]))
                  if "spk2utt" in o else {u: [u] for u in feats})
        worst = 0.0
        for spk, utts in groups.items():
            accs = FmllrAccs(am.dim)
            for u in utts:
                accumulate_fmllr_from_post(
                    accs, am, feats[u],
                    pdf_posts(tm, posts[u][:len(feats[u])]))
            W, _ = accs.update()
            worst = max(worst, rel(got[spk], W.astype(np.float32)))
        return sorted(got) == sorted(groups) and worst <= TRI_MAT_TOL, \
            f"{worst:.2e} over {len(groups)} speakers"

    def c_gmm_acc_stats_twofeats(o, p):
        tm, am = model(p[0])
        f1, f2, alis = feats_of(p[1]), feats_of(p[2]), table(p[3], "ivec")
        accs = GmmAccs.zeros(am.num_pdfs, am.max_mix, am.dim)
        for k in f1:
            accumulate_stats_twofeats(am, f1[k], f2[k], tm.tid_to_pdf_array[
                np.asarray(alis[k], np.int64)], accs)
        got = read_gmm_accs(p[4])
        worst = max(rel(getattr(got, n), getattr(accs, n))
                    for n in ("occ", "mean_acc", "var_acc"))
        return worst <= TRI_ACC_TOL, f"{worst:.2e}"

    def c_compile_graph(o, p):
        tm, _ = model(p[1], "cpu")
        G = read_fst_path(p[2])
        H = mkgraph(lang, tm, G, self_loop_scale=float(
            o.get("self-loop-scale", 0.1)))
        return same_bytes(p[3], lambda out: write_fst_path(out, H)), \
            f"{H.num_states} states"

    def c_gmm_latgen_faster(o, p):
        tm, am = model(p[0])
        res = decode_gmm_lattice(feats_of(p[2]), am, tm, read_fst_path(p[1]),
                                 lang, beam=float(o["beam"]),
                                 lattice_beam=float(o.get("lattice-beam", 6)),
                                 acoustic_scale=float(o["acoustic-scale"]),
                                 device=dev)
        got = table(p[3], "clat")
        worst, same = 0.0, sorted(got) == sorted(res.lattices)
        for k, clat in got.items():
            words, _, cost = clat.best_path()
            lw, _, lc = res.lattices[k].best_path()
            same = same and words == lw
            worst = max(worst, abs(cost - lc) / max(abs(lc), 1.0))
        return same and worst <= TRI_COST_TOL, f"cost {worst:.2e}"

    def c_lattice_to_post(o, p):
        got = table(p[1], "post")
        sc = float(o.get("acoustic-scale", 1.0))
        ok = True
        for k, clat in table(p[0], "clat").items():
            want = frame_posteriors(clat, acoustic_scale=sc)
            ok = ok and len(got[k]) == len(want) and all(
                [t for t, _ in g] == [t for t, _ in h]
                and np.allclose([q for _, q in g], [q for _, q in h],
                                rtol=1e-6, atol=1e-7)
                for g, h in zip(got[k], want))
        return ok, ""

    def c_lattice_best_path(o, p):
        got = table(p[1], "text")
        return all(got[k] == [lang.words.find(w) for w in
                              clat.best_path()[0]]
                   for k, clat in table(p[0], "clat").items()), ""

    def c_compute_wer(o, p, out):
        want = str(compute_wer(table(p[0], "text"), table(p[1], "text")))
        return out.strip() == want, want

    checks = {n[2:].replace("_", "-"): f for n, f in locals().items()
              if n.startswith("c_")}
    held = []
    for name, args, out in calls:
        o, p = _tri_opts(args)
        if name not in checks:
            continue
        ok, detail = (checks[name](o, p, out) if name == "compute-wer"
                      else checks[name](o, p))
        held.append((name, p[-1], bool(ok), detail))
    return held


def _wer_of(line: str) -> float:
    import re
    return float(re.search(r"%WER ([0-9.]+)", line).group(1))


def tri_tools_finish(started, lib_wers, tag: str):
    """17a, checked: the background run's exit, its checks (each tool
    against the library), the GMM kernel's launches from the tools' log
    lines, the ladder's rule on the tools' WERs (mono above 0, tri3b no
    worse than mono), printed beside 10b's library WERs with each stage's
    wall.  → (GMM launches, the tools' WERs)."""
    import re
    proc, d, t0 = started
    proc.wait(timeout=900)
    wall = time.perf_counter() - t0
    with open(f"{d}/worker.err") as f:
        err = f.read()
    if proc.returncode != 0:
        raise AssertionError(f"tri tools failed ({proc.returncode}):\n"
                             f"{err[-3000:]}")
    with open(f"{d}/report.json") as f:
        rep = json.load(f)
    launches = sum(int(n) for n in
                   re.findall(r"GMM kernel launches (\d+)", err))
    by_tool = {}
    for name, out, held, detail in rep["checks"]:
        n, k, det = by_tool.get(name, (0, 0, []))
        by_tool[name] = (n + 1, k + int(held), det + ([detail] if detail
                                                    else []))
    print(f"tri: tri3b as tools, {rep['calls']} tool calls in one "
          f"background process ({rep['total']:.1f} s after its imports; "
          f"started {wall:.1f} s before this check, at 10b); each call "
          f"against the library on its input files:")
    for name, (n, k, det) in by_tool.items():
        print(f"tri:   {name}: {k} of {n} equal the library"
              + (f" ({'; '.join(det[:3])}{'; …' if len(det) > 3 else ''})"
                 if det else ""))
    wers = {k: _wer_of(v) for k, v in rep["wers"].items()}
    for stage in ("mono", "tri1", "tri2b", "tri3b"):
        print(f"tri: {stage}: tools {rep['wers'][stage]}; 10b's library "
              f"{lib_wers[stage]}")
    print("tri: walls " + ", ".join(f"{k} {v:.1f} s"
                                     for k, v in rep["walls"].items())
          + f"; GMM kernel launches {launches} (the tools' log lines) {tag}")
    if not all(k == n for n, k, _ in by_tool.values()):
        raise AssertionError(f"tri tools vs library: {by_tool}")
    if not (wers["mono"] > 0 and wers["tri3b"] <= wers["mono"]):
        raise AssertionError(f"tri tools ladder: {rep['wers']}")
    if launches <= 0:
        raise AssertionError("tri tools launched no GMM kernel")
    return launches, wers


def fgmm_card_vs_cpu(dev, tag: str) -> None:
    """17b: gmm-global-to-fgmm on 12a's diagonal UBM →
    fgmm-global-acc-stats → fgmm-global-est →
    fgmm-global-get-frame-likes on 12a's features, on the card and on the
    CPU; the library's float64 statistics and frame likes on the card
    equal the CPU's within FGMM_TOL relative, and the tools' files (whose
    readers round to float32) within float32 rounding."""
    from kaldi_tpu_torch.am.full_gmm import AccumFullGmm
    from kaldi_tpu_torch.cli.tools import main as tool
    from kaldi_tpu_torch.cli.tools_bank13 import (_read_full_accs,
                                                  _read_full_gmm)
    from kaldi_tpu_torch.core.table import SequentialTableReader
    repo = os.path.dirname(os.path.abspath(__file__))
    d12 = os.path.join(repo, "build", "chip_smoke_ivector")
    d = os.path.join(repo, TRI_DIR, "fgmm")
    os.makedirs(d, exist_ok=True)
    t0 = time.perf_counter()
    feats = f"ark:{d12}/feats.ark"
    assert tool(["gmm-global-to-fgmm", f"{d12}/ubm", f"{d}/0.fubm"]) == 0
    for side, dv in (("card", dev.type), ("cpu", "cpu")):
        for argv in (["fgmm-global-acc-stats", f"--device={dv}",
                      f"{d}/0.fubm", feats, f"{d}/{side}.acc"],
                     ["fgmm-global-est", f"{d}/0.fubm", f"{d}/{side}.acc",
                      f"{d}/{side}.fubm"],
                     ["fgmm-global-get-frame-likes", f"--device={dv}",
                      f"{d}/{side}.fubm", feats, f"ark:{d}/{side}.likes"]):
            if tool(argv) != 0:
                raise AssertionError(f"{argv[0]} --device={dv} failed")
    f32 = 2.0 ** -23

    def rel(a, b):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        return float(np.abs(a - b).max() / np.abs(b).max())

    ca, pa = _read_full_accs(f"{d}/card.acc"), _read_full_accs(f"{d}/cpu.acc")
    tool_acc = max(rel(getattr(ca, n), getattr(pa, n))
                   for n in ("occ", "mean_acc", "cov_acc"))
    with open(f"{d}/card.fubm", "rb") as f, open(f"{d}/cpu.fubm", "rb") as g:
        same_est = f.read() == g.read()
    cl = dict(SequentialTableReader(f"ark:{d}/card.likes", holder="vec"))
    pl = dict(SequentialTableReader(f"ark:{d}/cpu.likes", holder="vec"))
    tool_likes = max(rel(cl[k], pl[k]) for k in pl)
    # the library in float64 on both devices
    xs = [np.asarray(x, np.float64) for _, x in
          SequentialTableReader(feats, holder="mat")]
    g0 = {dv: _read_full_gmm(f"{d}/0.fubm", dv) for dv in (dev, "cpu")}
    acc = {dv: AccumFullGmm(g.num_mix, g.dim) for dv, g in g0.items()}
    for x in xs:
        for dv, g in g0.items():
            acc[dv].accumulate(g, x)
    lib_acc = max(rel(getattr(acc[dev], n), getattr(acc["cpu"], n))
                  for n in ("occ", "mean_acc", "cov_acc"))
    g1 = {dv: _read_full_gmm(f"{d}/cpu.fubm", dv) for dv in (dev, "cpu")}
    lib_likes = max(rel(g1[dev].loglikes(x).cpu().numpy(),
                        g1["cpu"].loglikes(x).numpy()) for x in xs)
    gain = float(np.mean(np.concatenate([pl[k] for k in pl]))) - float(
        np.mean([g0["cpu"].loglikes(x).numpy().mean() for x in xs]))
    print(f"fgmm: 12a's {g0['cpu'].num_mix}-Gaussian UBM (D = "
          f"{g0['cpu'].dim}) as a full-covariance GMM, one EM step on "
          f"{len(xs)} utterances by the tools, card and CPU: the "
          f"library's float64 statistics {lib_acc:.2e} and frame likes "
          f"{lib_likes:.2e} relative apart (limit {FGMM_TOL:.0e}); the "
          f"tools' statistics {tool_acc:.2e}, frame likes "
          f"{tool_likes:.2e} (float32 files, limit {f32:.2e}), estimated "
          f"models {'equal' if same_est else 'DIFFERENT'}; like/frame "
          f"+{gain:.4f} after the step; {time.perf_counter() - t0:.1f} s "
          f"{tag}")
    if not (lib_acc <= FGMM_TOL and lib_likes <= FGMM_TOL and same_est
            and tool_acc <= f32 and tool_likes <= f32):
        raise AssertionError("full GMM: card and CPU disagree")


def ebw_card_vs_cpu(dev, sysd, tag: str) -> int:
    """17c: gmm-acc-stats on 10b's tri3b alignments (ali-to-post) and on
    lattice-to-post of the library's lattices of EBW_LATTICE_UTTS of its
    test utterances, then gmm-est-gaussians-ebw, on the card and on the
    CPU: statistics within 10c's card-vs-CPU bar (EBW_ACC_TOL of each
    entry plus EBW_ACC_TOL of the largest), the updated means and
    variances within EBW_TOL of each one's largest.  → GMM kernel
    launches of the lattice decode."""
    from kaldi_tpu_torch.am.serialize import read_mdl, write_mdl
    from kaldi_tpu_torch.cli.tools import main as tool
    from kaldi_tpu_torch.cli.tools_extra import read_gmm_accs
    from kaldi_tpu_torch.core.table import TableWriter
    from kaldi_tpu_torch.fst import mkgraph
    from kaldi_tpu_torch.ops.gmm import CudaGmm
    from kaldi_tpu_torch.pipelines.decode import decode_gmm_lattice
    repo = os.path.dirname(os.path.abspath(__file__))
    d = os.path.join(repo, TRI_DIR, "ebw")
    os.makedirs(d, exist_ok=True)
    t0 = time.perf_counter()
    sys3, lang = sysd["tri3b"], sysd["lang"]
    write_mdl(f"{d}/tri3b.mdl", sys3.tm, sys3.am)
    test = sorted(sysd["sat_te"])[:EBW_LATTICE_UTTS]
    with TableWriter(f"ark:{d}/num_feats.ark", holder="mat") as w:
        for u, x in sysd["sat_tr"].items():
            w[u] = x
    with TableWriter(f"ark:{d}/ali.ark", holder="ivec") as w:
        for u, a in sysd["tri3b_ali"].items():
            w[u] = np.asarray(a, np.int32)
    n0 = CudaGmm.total_launches
    res = decode_gmm_lattice({u: sysd["sat_te"][u] for u in test}, sys3.am,
                             sys3.tm, mkgraph(lang, sys3.tm, sysd["G"]),
                             lang, device=dev)
    launches = CudaGmm.total_launches - n0
    with TableWriter(f"ark:{d}/den_feats.ark", holder="mat") as w:
        for u in test:
            w[u] = sysd["sat_te"][u]
    with TableWriter(f"ark:{d}/lat.ark", holder="clat") as w:
        for u in test:
            w[u] = res.lattices[u]
    steps = [["ali-to-post", f"ark:{d}/ali.ark", f"ark:{d}/num.post"],
             ["lattice-to-post", f"ark:{d}/lat.ark", f"ark:{d}/den.post"]]
    for side, dv in (("card", dev.type), ("cpu", "cpu")):
        steps += [["gmm-acc-stats", f"--device={dv}", f"{d}/tri3b.mdl",
                   f"ark:{d}/num_feats.ark", f"ark:{d}/num.post",
                   f"{d}/{side}.num"],
                  ["gmm-acc-stats", f"--device={dv}", f"{d}/tri3b.mdl",
                   f"ark:{d}/den_feats.ark", f"ark:{d}/den.post",
                   f"{d}/{side}.den"],
                  ["gmm-est-gaussians-ebw", f"{d}/tri3b.mdl",
                   f"{d}/{side}.num", f"{d}/{side}.den",
                   f"{d}/{side}.ebw.mdl"]]
    for argv in steps:
        if tool(argv) != 0:
            raise AssertionError(f"{' '.join(argv[:2])} failed")

    def rel(a, b):
        return float(np.abs(a - b).max() / np.abs(b).max())

    def acc_share(a, b):
        # 10c's bar: |card - cpu| ≤ tol·|cpu| + tol·max|cpu|, as a share
        return float((np.abs(a - b) / (EBW_ACC_TOL * np.abs(b) + EBW_ACC_TOL
                                        * np.abs(b).max())).max())

    acc = max(acc_share(getattr(read_gmm_accs(f"{d}/card.{k}"), n),
                        getattr(read_gmm_accs(f"{d}/cpu.{k}"), n))
              for k in ("num", "den") for n in ("occ", "mean_acc", "var_acc"))
    (_, ca), (_, pa) = (read_mdl(f"{d}/{dv}.ebw.mdl", device="cpu")
                        for dv in ("card", "cpu"))
    upd = max(rel(ca.means, pa.means), rel(ca.vars, pa.vars))
    moved = float(np.abs(pa.means - sys3.am.means).max())
    den_occ = float(read_gmm_accs(f"{d}/cpu.den").occ.sum())
    print(f"ebw: 10b's tri3b ({sys3.am.num_pdfs} pdfs, "
          f"{sys3.am.num_gauss()} Gaussians): numerator from its "
          f"{len(sysd['tri3b_ali'])} training alignments, denominator from "
          f"the lattices of {len(test)} test utterances ({den_occ:.0f} "
          f"frames of posterior); gmm-acc-stats card vs CPU at most "
          f"{acc:.3f} of 10c's limit {EBW_ACC_TOL:.0e}·|cpu| + "
          f"{EBW_ACC_TOL:.0e}·max|cpu|, gmm-est-gaussians-ebw's means and "
          f"variances {upd:.2e} (limit {EBW_TOL:.0e}); the update moved "
          f"the means by up to {moved:.3f}; GMM launches {launches}; "
          f"{time.perf_counter() - t0:.1f} s {tag}")
    if not (acc <= 1.0 and upd <= EBW_TOL and moved > 0):
        raise AssertionError("EBW: card and CPU disagree")
    if launches <= 0:
        raise AssertionError("EBW's lattice decode launched no GMM kernel")
    return launches


def ladder_rung(dev, sysd, lib_wers, tool_wers, tag: str, keep=None) -> int:
    """17d: the ladder's chain rung (``ladder.chain_stage``, den-LM order
    3, LADDER_EPOCHS epochs) on 10b's systems on the card: a finite objf,
    its WER beside the GMM rungs'; ``keep`` receives the trained model
    (18b decodes with it).  → den kernel launches."""
    from kaldi_tpu_torch.ops.chain_den import CudaChainDen
    from kaldi_tpu_torch.pipelines import ladder
    CudaChainDen.total_launches = 0
    t0 = time.perf_counter()
    stats = {}
    wer = ladder.chain_stage(sysd, order=3, num_epochs=LADDER_EPOCHS,
                             device=dev, stats=stats, keep=keep)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    den = CudaChainDen.total_launches
    print(f"ladder: chain rung on 10b's tri3b alignments and SAT "
          f"features, {LADDER_EPOCHS} epochs (ladder.py's 40 cut): objf "
          f"{stats['objf']:.4f}, {wer}; {wall:.1f} s; den kernel launches "
          f"{den} {tag}")
    print("ladder: WER by rung, 10b's library / 17a's tools: "
          + ", ".join(f"{s} {lib_wers[s].wer:.2f} / {tool_wers[s]:.2f}"
                      for s in ("mono", "tri1", "tri2b", "tri3b"))
          + f", chain {wer.wer:.2f}")
    if not math.isfinite(stats["objf"]):
        raise AssertionError(f"ladder chain rung: objf {stats['objf']}")
    if den <= 0:
        raise AssertionError("ladder chain rung launched no den kernel")
    return den


# ---------------------------------------------------------------------------
# 18. Kaldi's other decoders (simple, biglm), grammars, keyword search and
# MMI/sMBR sequence training, as tools and library calls, in one background
# process started after 10b
# ---------------------------------------------------------------------------

SEQ_DIR = os.path.join("build", "chip_smoke_seq_tools")
# the GMM decoders' search (the ladder's decode, pipelines/mini.py dcfg:
# beam 16, acoustic scale 0.1); gmm-latgen-simple's lattice beam
SEQ_DECODE = ("--beam=16", "--max-active=7000", "--acoustic-scale=0.1")
SEQ_LATTICE_BEAM = 6.0
# 18's bars: a tool against its library call on the same card, words and
# alignments equal, best-path costs within SEQ_COST_TOL relative; biglm's
# best path against SimpleDecoder on the bigram graph, words equal and the
# cost within SEQ_BIGLM_TOL (tests/test_biglm.py's bar); the union index's
# search against the direct search, posteriors within SEQ_KWS_TOL relative
# (the index file stores α and β as float32, and the GMM lattices' totals
# run to ~10^3 nats: 2^-24 of that is ~6e-5 a term)
SEQ_COST_TOL = 1e-5
SEQ_BIGLM_TOL = 1e-3
SEQ_KWS_TOL = 1e-3
# kws-search's decision threshold (its --min-posterior): ATWV charges each
# false alarm β / (trials) = 999.9 / ~58 s of test audio
SEQ_KWS_THRESHOLD = 0.5
SEQ_NT = 9000              # the grammar's nonterminal: above every tid
# nnet3-latgen-grammar's lattice beam: a chain model a few epochs old is
# near flat, and its lattices at the tool's 8 determinize for minutes
SEQ_GRAMMAR_LATTICE_BEAM = 5.0
SEQ_LIST_WORDS = 4         # its word-list sub-grammar: the lexicon's last 4
SEQ_ONLINE_WAVES = 4       # test waveforms through the streaming grammar tool
# 18d: the xent model at TdnnConfig's default widths, frame rate 1 (10 of
# XentTrainConfig's 20 epochs) on all of 10b's training utterances; the
# sequence epochs of each criterion at the original's acoustic scale (2 of
# DiscriminativeConfig's 4) on the first SEQ_FT_UTTS of them (a step is
# one utterance, ~13,000 launches and ~0.2 s of host: at 100 utterances
# the two criteria took ~110 s of host beside 11a); the tools on the first
# SEQ_TOOL_UTTS; the card's first step against the CPU's (objective
# relative, each gradient tensor within the bar of its largest entry); the
# tools' objective against the library's on the same egs (float32 atomics
# of another process's run: relative); the step's timing once the main
# process has reached the join, with the card otherwise idle
SEQ_XENT = dict(num_epochs=10, batch_size=16, chunk_size=64,
                learning_rate=1e-3)
SEQ_EPOCHS = 2
SEQ_FT_UTTS = 50
SEQ_LR = 2e-5
SEQ_KAPPA = 0.1
SEQ_TOOL_UTTS = 10
SEQ_TOOL_EPOCHS = 2
SEQ_STEP_TOL = 1e-4
SEQ_OBJF_TOL = 1e-4
# the step's timing at the join: its wall over SEQ_TIME_STEPS, kernels
# and busy card time from a window of SEQ_PROFILE_STEPS recording the
# card's activity alone (with the host's operators, 5 steps' profile took
# 40.8 s of the join; NVIDIA H100 80GB HBM3, 700.00 W)
SEQ_TIME_STEPS = 10
SEQ_PROFILE_STEPS = 2
SEQ_CHAIN_WAIT = 1500.0    # the worker's wait for 17d's model, seconds
# the 18 tools whose kernel launches join the kernels line: the GMM
# decoders of 18a and the streaming grammar tool of 18b (not the
# streaming tool run on the expanded graph as 18b's reference)
SEQ_GMM_TOOLS = ("gmm-decode-faster", "gmm-decode-simple",
                 "gmm-latgen-simple", "gmm-latgen-biglm-faster",
                 "gmm-decode-biglm-faster")
SEQ_FBANK_TOOL = "online2-wav-nnet3-latgen-grammar"


def seq_tools_start(dev, sysd):
    """18, started: 10b's lexicon, G, tri3b transition model, alignments,
    SAT features, transcripts (``systems.pkl``), tri3b model and test
    waveforms written into SEQ_DIR, then ``python3 chip_smoke.py
    --seq-tools`` (``seq_tools_worker``) in the background.  → (process,
    dir, start time)."""
    import pickle
    import subprocess
    from kaldi_tpu_torch.am.serialize import write_mdl
    from kaldi_tpu_torch.core.table import TableWriter
    repo = os.path.dirname(os.path.abspath(__file__))
    d = os.path.join(repo, SEQ_DIR)
    os.makedirs(d, exist_ok=True)
    for stale in ("chain_ready", "joined", "report.json"):
        if os.path.exists(f"{d}/{stale}"):
            os.remove(f"{d}/{stale}")
    tri3b = sysd["tri3b"]
    train, test = sysd["train"], sysd["test"]
    with open(f"{d}/systems.pkl", "wb") as f:
        pickle.dump({
            "lang": sysd["lang"], "G": sysd["G"], "tm": tri3b.tm,
            "ali": {u: np.asarray(a, np.int32)
                    for u, a in sysd["tri3b_ali"].items()},
            "sat_tr": {u: np.asarray(x, np.float32)
                       for u, x in sysd["sat_tr"].items()},
            "sat_te": {u: np.asarray(x, np.float32)
                       for u, x in sysd["sat_te"].items()},
            "text_tr": {u: list(train.text[u]) for u in train.utts},
            "text_te": {u: list(test.text[u]) for u in test.utts}}, f)
    write_mdl(f"{d}/tri3b.mdl", tri3b.tm, tri3b.am)
    with TableWriter(f"ark:{d}/wav_te.ark", holder="wav") as w:
        for u in test.utts[:SEQ_ONLINE_WAVES]:
            w[u] = test.wavs[u]
    out = open(f"{d}/worker.out", "w")
    err = open(f"{d}/worker.err", "w")
    # two host threads: the process runs beside 11a's lattice builds
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--seq-tools", d,
         dev.type], cwd=repo, stdout=out, stderr=err,
        env=dict(os.environ, OMP_NUM_THREADS="2"))
    out.close()
    err.close()
    return proc, d, time.perf_counter()


def seq_chain_ready(started, keep) -> None:
    """17d's chain model for 18b: its transition model (in a .mdl beside a
    flat one-Gaussian GMM: the nnet3 tools read only the transition
    model) and the raw TDNN-F, then the flag the worker waits for."""
    from kaldi_tpu_torch.am.gmm import AmDiagGmm
    from kaldi_tpu_torch.am.nnet3_io import write_raw_model
    from kaldi_tpu_torch.am.serialize import write_mdl
    _, d, _ = started
    cfg = keep["config"]
    write_mdl(f"{d}/chain.mdl", keep["tm"], AmDiagGmm.flat_start(
        keep["tm"].num_pdfs, np.zeros(cfg.feat_dim), np.ones(cfg.feat_dim),
        device="cpu"))
    write_raw_model(f"{d}/chain.raw", keep["model"].state_dict(), cfg)
    with open(f"{d}/chain_ready", "w") as f:
        f.write("ok\n")


def _seq_read(spec, holder):
    from kaldi_tpu_torch.core.table import SequentialTableReader
    return dict(SequentialTableReader(spec, holder=holder))


def _best_same(got, want, what: str, tol: float = SEQ_COST_TOL):
    """Two (words, tids, cost) best paths: → (held, detail)."""
    ok = (list(got[0]) == list(want[0]) and list(got[1]) == list(want[1])
          and abs(got[2] - want[2]) <= tol * max(abs(want[2]), 1.0))
    return ok, (None if ok else f"{what}: {got[0]} {got[2]:.6f} against "
                f"{want[0]} {want[2]:.6f}")


def seq_gmm_decoders(T, held, d, dev, sysd, walls, wers):
    """18a: gmm-decode-faster, gmm-decode-simple and gmm-latgen-simple on
    the unigram HCLG, gmm-latgen-biglm-faster and gmm-decode-biglm-faster
    on the unigram HCLG with the training transcripts' bigram ARPA; each
    equal to its library call on the card; biglm's best paths equal to
    SimpleDecoder's on the bigram HCLG."""
    from kaldi_tpu_torch.am.serialize import read_mdl
    from kaldi_tpu_torch.cli.latgen import _load_hclg
    from kaldi_tpu_torch.core.table import TableWriter
    from kaldi_tpu_torch.decoder import SimpleDecoder
    from kaldi_tpu_torch.decoder.biglm import (BiglmDecoderConfig,
                                               BiglmFasterDecoder)
    from kaldi_tpu_torch.decoder.dense import (DenseDecoder,
                                               DenseDecoderConfig)
    from kaldi_tpu_torch.fst import ArpaModel, arpa_to_fst, mkgraph
    from kaldi_tpu_torch.fst.arpa import (estimate_arpa, make_unigram_arpa,
                                          write_arpa)
    from kaldi_tpu_torch.fst.openfst_io import write_fst_path
    from kaldi_tpu_torch.lattice.determinize import \
        determinize_lattice_pruned
    lang, tm = sysd["lang"], sysd["tm"]
    vocab = {w: 1.0 for w, _ in lang.lexicon.entries}
    with open(f"{d}/small.arpa", "w") as f:
        f.write(make_unigram_arpa(vocab))
    write_arpa(estimate_arpa([sysd["text_tr"][u]
                              for u in sorted(sysd["text_tr"])],
                             order=2, prune_count=1, vocab=list(vocab)),
               f"{d}/big.arpa")
    small = ArpaModel.parse(f"{d}/small.arpa")
    big = ArpaModel.parse(f"{d}/big.arpa")
    write_fst_path(f"{d}/HCLG.fst", mkgraph(lang, tm, arpa_to_fst(
        small, lang.words)))
    write_fst_path(f"{d}/HCLG_big.fst", mkgraph(lang, tm, arpa_to_fst(
        big, lang.words)))
    lang.words.write(f"{d}/words.txt")
    with TableWriter(f"ark:{d}/sat_te.ark", holder="mat") as w:
        for u in sorted(sysd["sat_te"]):
            w[u] = sysd["sat_te"][u]
    with TableWriter(f"ark:{d}/text_te.ark", holder="text") as w:
        for u in sorted(sysd["text_te"]):
            w[u] = sysd["text_te"][u]
    dv = f"--device={dev.type}"
    mdl, feats = f"{d}/tri3b.mdl", f"ark:{d}/sat_te.ark"
    wsym = f"--word-symbol-table={d}/words.txt"

    def timed(name, *args):
        t0 = time.perf_counter()
        T(name, *args)
        walls[name] = time.perf_counter() - t0

    for name in ("gmm-decode-faster", "gmm-decode-simple"):
        timed(name, dv, "--acoustic-scale=0.1", wsym, mdl, f"{d}/HCLG.fst",
              feats, f"ark,t:{d}/{name}.tra", f"ark:{d}/{name}.ali")
    timed("gmm-latgen-simple", dv, f"--lattice-beam={SEQ_LATTICE_BEAM}",
          "--acoustic-scale=0.1", mdl, f"{d}/HCLG.fst", feats,
          f"ark:{d}/lat.ark")
    T("lattice-best-path", wsym, f"ark:{d}/lat.ark",
      f"ark,t:{d}/gmm-latgen-simple.tra")
    for name in ("gmm-latgen-biglm-faster", "gmm-decode-biglm-faster"):
        outs = [f"ark,t:{d}/{name}.tra"] + (
            [f"ark:{d}/{name}.ali"] if "decode" in name else [])
        timed(name, dv, *SEQ_DECODE, wsym, mdl, f"{d}/HCLG.fst",
              f"{d}/small.arpa", f"{d}/big.arpa", feats, *outs)
    for name in ("gmm-decode-faster", "gmm-decode-simple",
                 "gmm-latgen-simple", "gmm-latgen-biglm-faster",
                 "gmm-decode-biglm-faster"):
        wers[name] = T("compute-wer", f"ark:{d}/text_te.ark",
                       f"ark,t:{d}/{name}.tra").strip()

    # the library calls on the same card
    _, am = read_mdl(mdl, device=dev)
    t2p = tm.tid_to_pdf_array
    HCLG, HCLG_big = _load_hclg(f"{d}/HCLG.fst"), _load_hclg(
        f"{d}/HCLG_big.fst")
    dense = DenseDecoder(HCLG, t2p, DenseDecoderConfig(
        beam=16.0, acoustic_scale=0.1), device=dev)
    simple, oracle = (SimpleDecoder(g, acoustic_scale=0.1)
                      for g in (HCLG, HCLG_big))
    latgen = DenseDecoder(HCLG, t2p, DenseDecoderConfig(
        beam=1e9, lattice_beam=SEQ_LATTICE_BEAM, acoustic_scale=0.1),
        device=dev)
    biglm = BiglmFasterDecoder(HCLG, t2p, small.score, big.score,
                               lang.words, BiglmDecoderConfig(
                                   beam=16.0, max_active=7000,
                                   acoustic_scale=0.1, history_len=1))
    tra = {n: _seq_read(f"ark,t:{d}/{n}.tra", "text") for n in wers}
    ali = {n: _seq_read(f"ark:{d}/{n}.ali", "ivec") for n in
           ("gmm-decode-faster", "gmm-decode-simple",
            "gmm-decode-biglm-faster")}
    lats = _seq_read(f"ark:{d}/lat.ark", "clat")
    worst = 0.0
    for u, x in sorted(sysd["sat_te"].items()):
        ll = am.loglikes(x)
        ll_np = ll.cpu().numpy()
        lib = {"gmm-decode-faster": dense.decode(ll),
               "gmm-decode-simple": simple.decode(ll_np, t2p),
               "gmm-decode-biglm-faster": biglm.decode(ll_np)}
        lib["gmm-latgen-biglm-faster"] = lib["gmm-decode-biglm-faster"]
        for n, (tids, ols, _) in lib.items():
            ok = tra[n][u] == [lang.words.find(o) for o in ols] and (
                n not in ali or list(ali[n][u]) == list(tids))
            held(n, ok, None if ok else f"{u}: {tra[n][u]} against "
                 f"{[lang.words.find(o) for o in ols]}")
        lat = determinize_lattice_pruned(latgen.decode_lattice(ll)[0],
                                         SEQ_LATTICE_BEAM)
        held("gmm-latgen-simple", *_best_same(lats[u].best_path(),
                                              lat.best_path(), u))
        _, ols_o, cost_o = oracle.decode(ll_np, t2p)
        _, ols_b, cost_b = lib["gmm-decode-biglm-faster"]
        ok = ols_b == ols_o and abs(cost_b - cost_o) <= SEQ_BIGLM_TOL
        worst = max(worst, float(abs(cost_b - cost_o)))
        held("biglm = SimpleDecoder on the bigram HCLG", ok,
             None if ok else f"{u}: {ols_b} {cost_b:.4f} against {ols_o} "
             f"{cost_o:.4f}")
    return {"biglm_cost_diff": worst,
            "hclg_states": [HCLG.num_states, HCLG_big.num_states]}


def seq_kws(T, held, d, sysd, walls):
    """18c: lattice-to-kws-index over 18a's lattices in two shards,
    kws-index-union, kws-search of every word, compute-atwv against the
    test transcripts (each occurrence a reference spanning its
    utterance); the union's search equal to the direct search, the
    search tool equal to the library's index search."""
    from kaldi_tpu_torch import kws
    from kaldi_tpu_torch.core import io as kio
    from kaldi_tpu_torch.core.table import TableWriter
    lang = sysd["lang"]
    lats = _seq_read(f"ark:{d}/lat.ark", "clat")
    keys = sorted(lats)
    half = len(keys) // 2
    t0 = time.perf_counter()
    for name, part in (("a", keys[:half]), ("b", keys[half:])):
        with TableWriter(f"ark:{d}/lat_{name}.ark", holder="clat") as w:
            for k in part:
                w[k] = lats[k]
        T("lattice-to-kws-index", f"ark:{d}/lat_{name}.ark",
          f"{d}/kws.{name}.idx")
    T("kws-index-union", f"{d}/kws.idx", f"{d}/kws.a.idx", f"{d}/kws.b.idx")
    vocab = list(dict.fromkeys(w for w, _ in lang.lexicon.entries))
    kwl = {f"KW{i:02d}": [lang.words[w]] for i, w in enumerate(vocab)}
    with open(f"{d}/keywords.txt", "w") as f:
        for kw, seq in kwl.items():
            f.write(f"{kw} {' '.join(map(str, seq))}\n")
    T("kws-search", f"--min-posterior={SEQ_KWS_THRESHOLD}",
      f"ark:{d}/lat.ark", f"{d}/keywords.txt", f"ark,t:{d}/hits.txt")
    n = {}
    frames = {u: x.shape[0] for u, x in sysd["sat_te"].items()}
    with TableWriter(f"ark,t:{d}/kws_ref.txt", holder="text") as w:
        for i, word in enumerate(vocab):
            for u in sorted(sysd["text_te"]):
                for _ in range(sysd["text_te"][u].count(word)):
                    n[i] = n.get(i, 0) + 1
                    w[f"KW{i:02d}-{n[i]}"] = [u, "0", str(frames[u] - 1)]
    atwv = float(T("compute-atwv", str(sum(frames.values())),
                   f"ark,t:{d}/kws_ref.txt",
                   f"ark,t:{d}/hits.txt").strip().splitlines()[-1])
    walls["kws"] = time.perf_counter() - t0
    with kio.open_rxfilename(f"{d}/kws.idx") as f:
        kio.init_kaldi_input_stream(f)
        union = kws.read_lattice_index(f)
    direct = kws.keyword_search(lats, kwl, 0.0)
    index = kws.LatticeIndex.build(lats)
    hits = _seq_read(f"ark,t:{d}/hits.txt", "text")
    n_hits, worst = 0, 0.0
    for kw, seq in kwl.items():
        got = sorted((h.utt, h.begin_frame, h.end_frame, h.posterior)
                     for h in union.search(seq))
        want = sorted((h.utt, h.begin_frame, h.end_frame, h.posterior)
                      for h in direct[kw])
        rel = [abs(g[3] - x[3]) / x[3] for g, x in zip(got, want)]
        worst = max([worst] + rel)
        ok = [g[:3] for g in got] == [x[:3] for x in want] and all(
            r <= SEQ_KWS_TOL for r in rel)
        held("index search = direct search", ok,
             None if ok else f"{kw}: {got[:3]} against {want[:3]}")
        lib = index.search(seq, SEQ_KWS_THRESHOLD)
        ok = all(hits.get(f"{kw}-{i + 1}") == [
            h.utt, str(h.begin_frame), str(h.end_frame),
            f"{h.posterior:.4f}"] for i, h in enumerate(lib)) and \
            f"{kw}-{len(lib) + 1}" not in hits
        held("kws-search", ok, None if ok else f"{kw}")
        n_hits += len(lib)
    return {"atwv": atwv, "keywords": len(kwl), "hits": n_hits,
            "index_utts": len(union.utts), "posterior_rel": worst}


def _seq_grads(model):
    return {k: p.grad.detach().cpu().clone()
            for k, p in model.named_parameters() if p.grad is not None}


def seq_training(T, held, d, dev, sysd, walls, wers):
    """18d: the xent TDNN-F at TdnnConfig's default widths on 10b's SAT
    features and tri3b alignments, den lattices from the DenseDecoder on
    the unigram HCLG, sMBR and then MMI through discriminative_finetune
    on the first SEQ_FT_UTTS utterances (each from the xent weights), the
    card's first step against the CPU's, and the tools (get-egs → train →
    compute-objf) against the library on the same egs.  → (numbers, the
    step's timing: a function to call when the card is otherwise idle,
    None off the card)."""
    import copy
    from kaldi_tpu_torch.am.discriminative import frame_accuracy
    from kaldi_tpu_torch.am.nnet3_io import write_raw_model
    from kaldi_tpu_torch.am.tdnn import TdnnConfig
    from kaldi_tpu_torch.cli.latgen import _load_hclg
    from kaldi_tpu_torch.cli.tools_bank16 import _read_raw_auto
    from kaldi_tpu_torch.core.table import TableWriter
    from kaldi_tpu_torch.decoder.dense import (DenseDecoder,
                                               DenseDecoderConfig)
    from kaldi_tpu_torch.lattice.determinize import \
        determinize_lattice_pruned
    from kaldi_tpu_torch.ops.chain_den import CudaChainDen
    from kaldi_tpu_torch.pipelines import discriminative as disc
    from kaldi_tpu_torch.pipelines.nnet import XentTrainConfig, XentTrainer
    from kaldi_tpu_torch.pipelines.score import compute_wer
    lang, tm = sysd["lang"], sysd["tm"]
    t2p = tm.tid_to_pdf_array
    feats = sysd["sat_tr"]
    num_ali = {u: t2p[np.asarray(a)].astype(np.int32)
               for u, a in sysd["ali"].items() if u in feats}
    feats = {u: feats[u] for u in num_ali}
    D = next(iter(feats.values())).shape[1]
    out = {"frames_per_utt": float(np.mean([x.shape[0]
                                            for x in feats.values()])),
           "utts": len(feats)}
    t0 = time.perf_counter()
    xent = XentTrainer(TdnnConfig(feat_dim=D, num_pdfs=tm.num_pdfs,
                                  frame_subsampling_factor=1),
                       XentTrainConfig(**SEQ_XENT), device=dev)
    out["xent"] = xent.train(feats, num_ali)
    walls["xent"] = time.perf_counter() - t0
    out["params"] = sum(p.numel() for p in xent.model.parameters())
    dec = DenseDecoder(_load_hclg(f"{d}/HCLG.fst"), t2p,
                       DenseDecoderConfig(beam=16.0, acoustic_scale=0.1,
                                          lattice_beam=8.0), device=dev)

    def test_wer(trainer):
        scorer = trainer.loglikes_fn()
        hyps = {u: [lang.words.find(o) for o in
                    dec.decode(scorer(x))[1]]
                for u, x in sysd["sat_te"].items()}
        return str(compute_wer(sysd["text_te"], hyps))

    wers["xent"] = test_wer(xent)
    start = copy.deepcopy(xent.model.state_dict())

    # the card's first step against the CPU's, from the xent weights on
    # the first training utterance's den lattice
    u0 = sorted(feats)[0]
    lat0 = disc.make_degs(dec, {u0: xent.loglikes_fn()(feats[u0])})[u0]
    acc0 = frame_accuracy(lat0, num_ali[u0])
    steps = {}
    for where in (dev, torch.device("cpu")):
        m = copy.deepcopy(xent.model).to(where)
        opt = disc.adam(m, SEQ_LR)
        lp = torch.from_numpy(xent.log_priors).to(where)
        o = disc.sequence_step(m, opt, "smbr", *disc.utterance_tensors(
            feats[u0], num_ali[u0], lat0, acc0, where), SEQ_KAPPA, lp)
        steps[where.type] = (float(o), _seq_grads(m))
    (oc, gc), (oh, gh) = steps[dev.type], steps["cpu"]
    rel_o = abs(oc - oh) / max(abs(oh), 1e-30)
    rel_g = max(float((gc[k] - gh[k]).abs().max())
                / max(float(gh[k].abs().max()), 1e-30) for k in gh)
    out["first_step"] = {"objf_card": oc, "objf_cpu": oh, "objf_rel": rel_o,
                         "grad_rel": rel_g}
    held("card first step = CPU", rel_o <= SEQ_STEP_TOL
         and rel_g <= SEQ_STEP_TOL, f"objf {rel_o:.2e}, gradients "
         f"{rel_g:.2e} of each tensor's largest (bar {SEQ_STEP_TOL})")

    timing = None
    if dev.type == "cuda":
        timing = _seq_step_timing(copy.deepcopy(xent.model), xent.log_priors,
                                  disc.utterance_tensors(feats[u0],
                                                         num_ali[u0], lat0,
                                                         acc0, dev), dev)
        out["frames_step"] = int(lat0.T)

    # sMBR, then MMI, each from the xent weights
    ft = sorted(feats)[:SEQ_FT_UTTS]
    out["ft_utts"] = len(ft)
    hists = {}
    for crit in ("smbr", "mmi"):
        xent.model.load_state_dict(start)
        t1 = time.perf_counter()
        hists[crit] = disc.discriminative_finetune(
            xent, dec, {u: feats[u] for u in ft}, num_ali,
            disc.DiscriminativeConfig(
                criterion=crit, num_epochs=SEQ_EPOCHS,
                learning_rate=SEQ_LR, acoustic_scale=SEQ_KAPPA))["objf"]
        walls[crit] = time.perf_counter() - t1
        wers[crit] = test_wer(xent)
        h = hists[crit]
        held(f"{crit} objective rises", all(np.isfinite(h))
             and h[-1] > h[0], f"{crit} objf/utt by epoch {h}")
    out["objf"] = hists

    # the tools: den lattices of the first SEQ_TOOL_UTTS training
    # utterances (the xent model's scores, determinized: get_degs.sh's
    # role), get-egs, train, compute-objf before and after
    xent.model.load_state_dict(start)
    tool_utts = sorted(feats)[:SEQ_TOOL_UTTS]
    scorer = xent.loglikes_fn()
    with TableWriter(f"ark:{d}/seq_feats.ark", holder="mat") as wf, \
            TableWriter(f"ark:{d}/seq_ali.ark", holder="ivec") as wa, \
            TableWriter(f"ark:{d}/denlats.ark", holder="clat") as wl:
        for u in tool_utts:
            wf[u], wa[u] = feats[u], num_ali[u]
            wl[u] = determinize_lattice_pruned(
                dec.decode_lattice(scorer(feats[u]))[0], 8.0)
    write_raw_model(f"{d}/xent.raw", start, xent.model_cfg)
    dv = f"--device={dev.type}"
    t1 = time.perf_counter()
    T("nnet3-discriminative-get-egs", f"{d}/tri3b.mdl",
      f"ark:{d}/seq_feats.ark", f"ark:{d}/seq_ali.ark",
      f"ark:{d}/denlats.ark", f"ark:{d}/degs.ark")
    egs = _seq_read(f"ark:{d}/degs.ark", "deg")
    tools = {}
    for crit in ("smbr", "mmi"):
        c = f"--criterion={crit}"

        def objf(raw):
            return float(T("nnet3-discriminative-compute-objf", dv, c, raw,
                           f"ark:{d}/degs.ark").split()[1])

        before = objf(f"{d}/xent.raw")
        T("nnet3-discriminative-train", dv, c,
          f"--num-epochs={SEQ_TOOL_EPOCHS}", f"--learning-rate={SEQ_LR}",
          f"--acoustic-scale={SEQ_KAPPA}", f"{d}/xent.raw",
          f"ark:{d}/degs.ark", f"{d}/{crit}.raw")
        after = objf(f"{d}/{crit}.raw")
        # the library on the same egs from the same weights
        net, _ = _read_raw_auto(f"{d}/xent.raw", dev)
        opt = disc.adam(net, SEQ_LR)
        data = [disc.eg_tensors(eg, crit, dev) for eg in egs.values()]

        def lib_objf():
            with torch.no_grad():
                return float(np.mean([float(disc.sequence_objf(
                    crit, lat, torch.log_softmax(net(x[None])[0], dim=-1),
                    num, acc, SEQ_KAPPA)) for x, num, acc, lat in data]))

        lib_before = lib_objf()
        for _ in range(SEQ_TOOL_EPOCHS):
            for x, num, acc, lat in data:
                disc.sequence_step(net, opt, crit, x, num, acc, lat,
                                   SEQ_KAPPA)
        lib_after = lib_objf()
        tools[crit] = {"before": before, "after": after,
                       "lib_before": lib_before, "lib_after": lib_after}
        for a, b, what in ((before, lib_before, "before"),
                           (after, lib_after, "after")):
            rel = abs(a - b) / max(abs(b), 1e-30)
            held(f"nnet3-discriminative tools = library ({crit})",
                 rel <= SEQ_OBJF_TOL, f"{what} training: tools {a:.6f}, "
                 f"library {b:.6f} ({rel:.2e})")
        held(f"nnet3-discriminative-train raises {crit}", after > before,
             f"{before:.6f} → {after:.6f}")
    walls["seq tools"] = time.perf_counter() - t1
    out["tools"] = tools
    out["egs"] = len(egs)
    out["den_launches"] = CudaChainDen.total_launches
    return out, timing


def _seq_step_timing(m, log_priors, tensors, dev):
    """18d's sMBR step on the card, timed when called: wall a step over
    SEQ_TIME_STEPS, kernels and busy card time from a profile of
    SEQ_PROFILE_STEPS, and the objective's forward and backward as one
    CUDA graph.  → a function returning those numbers."""
    from kaldi_tpu_torch.pipelines import discriminative as disc
    from kaldi_tpu_torch.tools.timing import graph_ms, profiled
    opt = disc.adam(m, SEQ_LR)
    lp = torch.from_numpy(log_priors).to(dev)
    x0, n0, a0, l0 = tensors

    def step():
        disc.sequence_step(m, opt, "smbr", x0, n0, a0, l0, SEQ_KAPPA, lp)

    def steps():
        for _ in range(SEQ_PROFILE_STEPS):
            step()
        torch.cuda.synchronize()

    def objf_backward():
        m.eval()
        s = torch.log_softmax(m(x0[None])[0], dim=-1) - lp[None, :]
        disc.smbr_objf(l0, s, a0, SEQ_KAPPA).backward()

    def timing():
        out = {}
        for _ in range(3):
            step()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(SEQ_TIME_STEPS):
            step()
        torch.cuda.synchronize()
        out["step_ms"] = 1e3 * (time.perf_counter() - t1) / SEQ_TIME_STEPS
        wall, n_k, k_ms, _ = profiled(steps, cpu_ops=False)
        if n_k <= 0:
            raise AssertionError("18d: the profile saw no kernel")
        out["kernels_per_step"] = n_k / SEQ_PROFILE_STEPS
        out["busy_ms_per_step"] = k_ms / SEQ_PROFILE_STEPS
        out["busy_share"] = k_ms / wall
        # warm on a side stream, as graph capture wants
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            objf_backward()
        torch.cuda.current_stream().wait_stream(side)
        out["graph_ms"] = graph_ms(objf_backward)
        return out

    return timing


def seq_grammar(T, held, d, dev, sysd, walls, wers):
    """18b, once 17d's model is written: make-grammar-fst (the chain
    topology's unigram HCLG over all but the lexicon's last
    SEQ_LIST_WORDS words, with a nonterminal self-loop at its start and at
    each final state, slotted by the HCLG of one word of that list), then
    nnet3-latgen-grammar with 17d's model on the SAT test features and
    online2-wav-nnet3-latgen-grammar on SEQ_ONLINE_WAVES test waveforms
    (resampled to 16 kHz) with a TDNN-F of 17d's widths reading 13 MFCCs
    (seeded weights: 17d's model reads the SAT front-end, whose fMLLR
    needs a first pass, so it cannot stream); each against the library
    decode over ``replace_nonterminals``' expanded graph."""
    from kaldi_tpu_torch.am.nnet3_io import write_raw_model
    from kaldi_tpu_torch.am.serialize import read_mdl
    from kaldi_tpu_torch.am.tdnn import TdnnChain, TdnnConfig
    from kaldi_tpu_torch.cli.latgen import _LatgenDecoder, _load_hclg
    from kaldi_tpu_torch.cli.online2 import _load_tdnn
    from kaldi_tpu_torch.core.table import TableWriter
    from kaldi_tpu_torch.features.resample import linear_resample
    from kaldi_tpu_torch.fst import (ArpaModel, Arc, VectorFst, arpa_to_fst,
                                     mkgraph)
    from kaldi_tpu_torch.fst.arpa import make_unigram_arpa
    from kaldi_tpu_torch.fst.csr import csr_to_vector_fst, pack_fst
    from kaldi_tpu_torch.fst.grammar import replace_nonterminals
    from kaldi_tpu_torch.fst.openfst_io import write_fst_path
    from kaldi_tpu_torch.pipelines.score import compute_wer
    walls["waited for 17d"] = _seq_wait(f"{d}/chain_ready",
                                        "18b: 17d's chain model")
    t0 = time.perf_counter()
    lang = sysd["lang"]
    tm, _ = read_mdl(f"{d}/chain.mdl", device="cpu")
    vocab = list(dict.fromkeys(w for w, _ in lang.lexicon.entries))
    top_words, list_words = vocab[:-SEQ_LIST_WORDS], vocab[-SEQ_LIST_WORDS:]

    top = mkgraph(lang, tm, arpa_to_fst(ArpaModel.parse(make_unigram_arpa(
        {w: 1.0 for w in top_words})), lang.words), self_loop_scale=1.0)
    for s in sorted({top.start, *top.finals}):
        top.add_arc(s, Arc(SEQ_NT, 0, 0.0, s))
    # the slot: exactly one word of the list (no empty path, so no ε
    # cycle through the nonterminal's self-loop)
    G = VectorFst()
    g0, g1 = G.add_state(), G.add_state()
    G.set_start(g0)
    G.set_final(g1, 0.0)
    for w in list_words:
        G.add_arc(g0, Arc(lang.words[w], lang.words[w],
                          math.log(len(list_words)), g1))
    write_fst_path(f"{d}/top.fst", top)
    write_fst_path(f"{d}/list.fst", mkgraph(lang, tm, G,
                                            self_loop_scale=1.0))
    T("make-grammar-fst", f"{d}/top.fst", str(SEQ_NT), f"{d}/list.fst",
      f"{d}/grammar.fst")
    expanded = replace_nonterminals(pack_fst(_load_hclg(f"{d}/top.fst")),
                                    {SEQ_NT: pack_fst(_load_hclg(
                                        f"{d}/list.fst"))})
    got = pack_fst(_load_hclg(f"{d}/grammar.fst"))
    lib = pack_fst(csr_to_vector_fst(expanded))
    held("make-grammar-fst", all(
        np.array_equal(getattr(got, k), getattr(lib, k)) for k in
        ("e_offsets", "e_ilabel", "e_olabel", "e_weight", "e_nextstate",
         "n_offsets", "n_olabel", "n_weight", "n_nextstate",
         "final_costs")), f"{got.num_states} states")
    write_fst_path(f"{d}/expanded.fst", csr_to_vector_fst(expanded))
    walls["make-grammar-fst"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    T("nnet3-latgen-grammar", f"--device={dev.type}",
      "--frame-subsampling-factor=3", "--acoustic-scale=1.0",
      f"--lattice-beam={SEQ_GRAMMAR_LATTICE_BEAM}",
      f"{d}/chain.mdl", f"{d}/chain.raw", f"{d}/top.fst", str(SEQ_NT),
      f"{d}/list.fst", f"ark:{d}/sat_te.ark", f"ark:{d}/grammar_lat.ark")
    walls["nnet3-latgen-grammar"] = time.perf_counter() - t0
    lats = _seq_read(f"ark:{d}/grammar_lat.ark", "clat")
    _, net = _load_tdnn(f"{d}/chain.raw", 3, dev)
    dec = _LatgenDecoder(csr_to_vector_fst(expanded), tm.tid_to_pdf_array,
                         15.0, SEQ_GRAMMAR_LATTICE_BEAM, 1.0, device=dev)
    hyps = {}
    for u, x in sorted(sysd["sat_te"].items()):
        with torch.no_grad():
            lib = dec.decode_to_clat(net(torch.from_numpy(x).to(dev)[None])[0])
        bp = lats[u].best_path()
        held("nnet3-latgen-grammar", *_best_same(bp, lib.best_path(), u))
        hyps[u] = [lang.words.find(w) for w in bp[0]]
    wers["nnet3-latgen-grammar"] = str(compute_wer(sysd["text_te"], hyps))

    # the streaming grammar tool: 16 kHz waveforms, 13 MFCCs
    waves = _seq_read(f"ark:{d}/wav_te.ark", "wav")
    with TableWriter(f"ark:{d}/wav16_te.ark", holder="wav") as w:
        for u, (x, rate) in waves.items():
            y = linear_resample(np.asarray(x, np.float32), rate, 16000)
            w[u] = (np.clip(y, -32768, 32767).astype(np.int16), 16000)
    cfg = TdnnConfig(feat_dim=13, num_pdfs=tm.num_pdfs, hidden_dim=96,
                     bottleneck_dim=24, num_layers=5,
                     frame_subsampling_factor=3)
    rng = np.random.default_rng(SEED + 18)
    sd = {k: torch.from_numpy((1.0 + rng.random(v.shape)) if
                              k.endswith(".var") else 0.3 *
                              rng.standard_normal(v.shape)).float()
          for k, v in TdnnChain(cfg).state_dict().items()}
    write_raw_model(f"{d}/online.raw", sd, cfg)
    common = [f"--device={dev.type}", "--frame-subsampling-factor=3",
              "--acoustic-scale=1.0", f"--word-symbol-table={d}/words.txt"]
    t0 = time.perf_counter()
    T("online2-wav-nnet3-latgen-grammar", *common, f"{d}/chain.mdl",
      f"{d}/online.raw", f"{d}/top.fst", str(SEQ_NT), f"{d}/list.fst",
      f"ark:{d}/wav16_te.ark", f"ark,t:{d}/online_grammar.tra")
    walls["online2-wav-nnet3-latgen-grammar"] = time.perf_counter() - t0
    T("online2-wav-nnet3-latgen-faster", *common, f"{d}/chain.mdl",
      f"{d}/online.raw", f"{d}/expanded.fst", f"ark:{d}/wav16_te.ark",
      f"ark,t:{d}/online_expanded.tra")
    a = _seq_read(f"ark,t:{d}/online_grammar.tra", "text")
    b = _seq_read(f"ark,t:{d}/online_expanded.tra", "text")
    held("online2-wav-nnet3-latgen-grammar", a == b and len(a) == len(waves),
         None if a == b else f"{a} against {b}")
    return {"grammar_states": int(expanded.num_states),
            "top_words": len(top_words), "list_words": len(list_words)}


def _seq_wait(path: str, what: str) -> float:
    """Wait for the flag file ``path`` (at most SEQ_CHAIN_WAIT s).
    → seconds waited."""
    t0 = time.perf_counter()
    while not os.path.exists(path):
        if time.perf_counter() - t0 > SEQ_CHAIN_WAIT:
            raise AssertionError(f"{what} never came")
        time.sleep(0.2)
    return time.perf_counter() - t0


def seq_tools_worker(argv) -> int:
    """18's background process: 18a, 18c and 18d as soon as it starts,
    18b once 17d's model is written, 18d's step timing once the main
    process waits at the join; every tool a call of the port's registry
    in this process, each held against its library call on the same
    card, the fbank and GMM kernels' counts set to 0 before each call and
    read after it.  Writes ``report.json`` (walls, WERs, the numbers,
    each check, each tool's launches) into the directory; exits 1 if a
    check fails."""
    import contextlib
    import io
    import pickle
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import kaldi_tpu_torch.features  # noqa: F401  (before ops.fbank)
    from kaldi_tpu_torch.cli import TOOLS
    from kaldi_tpu_torch.ops.fbank import CudaFbank
    from kaldi_tpu_torch.ops.gmm import CudaGmm
    t_start = time.perf_counter()
    d, dv = argv[0], argv[1]
    dev = torch.device(dv, 0) if dv == "cuda" else torch.device(dv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with open(f"{d}/systems.pkl", "rb") as f:
        sysd = pickle.load(f)
    calls, checks, walls, wers, rep = [], [], {}, {}, {}
    launches = {"gmm": {}, "fbank": {}}

    def T(name, *args):
        args = [str(a) for a in args]
        buf = io.StringIO()
        CudaGmm.total_launches = CudaFbank.total_launches = 0
        with contextlib.redirect_stdout(buf):
            rc = TOOLS[name](args)
        for k, n in (("gmm", CudaGmm.total_launches),
                     ("fbank", CudaFbank.total_launches)):
            launches[k][name] = launches[k].get(name, 0) + n
        if rc:
            raise AssertionError(f"{name} {' '.join(args)}: rc {rc}")
        calls.append(name)
        return buf.getvalue()

    def held(name, ok, detail):
        checks.append((name, bool(ok), detail))

    t0 = time.perf_counter()
    rep["gmm"] = seq_gmm_decoders(T, held, d, dev, sysd, walls, wers)
    walls["18a"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rep["kws"] = seq_kws(T, held, d, sysd, walls)
    walls["18c"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rep["seq"], timing = seq_training(T, held, d, dev, sysd, walls, wers)
    walls["18d"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rep["grammar"] = seq_grammar(T, held, d, dev, sysd, walls, wers)
    walls["18b"] = time.perf_counter() - t0
    if timing is not None:
        walls["waited for the join"] = _seq_wait(f"{d}/joined",
                                                 "18d: the join")
        t0 = time.perf_counter()
        rep["seq"].update(timing())
        walls["18d step timing"] = time.perf_counter() - t0
    with open(f"{d}/report.json", "w") as f:
        json.dump({"walls": walls, "wers": wers, "checks": checks,
                   "calls": len(calls), "tools": sorted(set(calls)),
                   "launches": launches,
                   "total": time.perf_counter() - t_start, **rep}, f,
                  default=float)
    bad = [c for c in checks if not c[1]]
    if bad:
        print(f"seq tools: {len(bad)} checks failed: {bad[:5]}",
              file=sys.stderr)
        return 1
    return 0


def seq_tools_finish(started, tag: str):
    """18, joined after 17d: the flag that lets the worker time 18d's
    step on the otherwise idle card, then the background run's exit, its
    checks, the kernels' launches in the tools under test (the GMM
    kernel's in 18a's SEQ_GMM_TOOLS, the fbank kernel's in
    SEQ_FBANK_TOOL), the den kernel's (none expected), each tool's wall
    and WER, the ATWV and the sequence step's numbers; the worker's wall
    and the main process's wait here.  → (GMM launches, fbank launches,
    den launches)."""
    proc, d, t0 = started
    with open(f"{d}/joined", "w") as f:
        f.write("ok\n")
    t_wait = time.perf_counter()
    proc.wait(timeout=900)
    wait = time.perf_counter() - t_wait
    wall = time.perf_counter() - t0
    with open(f"{d}/worker.err") as f:
        err = f.read()
    if proc.returncode != 0:
        raise AssertionError(f"seq tools failed ({proc.returncode}):\n"
                             f"{err[-3000:]}")
    with open(f"{d}/report.json") as f:
        rep = json.load(f)
    gmm = sum(rep["launches"]["gmm"].get(n, 0) for n in SEQ_GMM_TOOLS)
    fb = rep["launches"]["fbank"].get(SEQ_FBANK_TOOL, 0)
    den = rep["seq"]["den_launches"]
    by = {}
    for name, ok, detail in rep["checks"]:
        n, k, det = by.get(name, (0, 0, []))
        by[name] = (n + 1, k + int(ok), det + ([detail] if detail else []))
    print(f"seq: {rep['calls']} tool calls of {len(rep['tools'])} tools in "
          f"one background process started at 10b: {wall:.1f} s to the "
          f"join ({rep['total']:.1f} s of work after its imports); the main "
          f"process waited {wait:.1f} s here, "
          f"{rep['walls'].get('18d step timing', 0.0):.1f} s of it 18d's "
          f"step timing on the otherwise idle card {tag}")
    for name, (n, k, det) in by.items():
        print(f"seq:   {name}: {k} of {n} held"
              + (f" ({'; '.join(det[:2])})" if det else ""))
    g = rep["gmm"]
    print(f"seq: 18a on 10b's tri3b and SAT test features (HCLG "
          f"{g['hclg_states'][0]} states, bigram HCLG "
          f"{g['hclg_states'][1]}): biglm against SimpleDecoder on the "
          f"bigram HCLG, largest cost difference {g['biglm_cost_diff']:.2e} "
          f"(bar {SEQ_BIGLM_TOL})")
    for name, w in rep["wers"].items():
        print(f"seq:   {name}: {w}"
              + (f"; {rep['walls'][name]:.2f} s" if name in rep["walls"]
                 else ""))
    k = rep["kws"]
    print(f"seq: 18c: {k['keywords']} keywords over {k['index_utts']} "
          f"lattices, {k['hits']} hits at posterior ≥ {SEQ_KWS_THRESHOLD}, "
          f"ATWV {k['atwv']:.4f}; the union index's search against the "
          f"direct search: posteriors within {k['posterior_rel']:.2e} "
          f"relative (bar {SEQ_KWS_TOL}); {rep['walls']['kws']:.2f} s")
    s = rep["seq"]
    print(f"seq: 18d: xent TDNN-F {s['params']} parameters on {s['utts']} "
          f"utterances of {s['frames_per_utt']:.1f} frames on average "
          f"(loss {s['xent']['loss']:.4f}, frame accuracy "
          f"{s['xent']['frame_acc']:.3f}; {rep['walls']['xent']:.1f} s); "
          f"sequence training on the first {s['ft_utts']} of them")
    for crit in ("smbr", "mmi"):
        print(f"seq:   {crit}: objf/utt by epoch "
              f"{[round(x, 5) for x in s['objf'][crit]]}; "
              f"{rep['walls'][crit]:.1f} s")
    fs = s["first_step"]
    print(f"seq:   card's first sMBR step against the CPU's: objf "
          f"{fs['objf_card']:.6f} / {fs['objf_cpu']:.6f} ({fs['objf_rel']:.2e}),"
          f" gradients {fs['grad_rel']:.2e} of each tensor's largest (bar "
          f"{SEQ_STEP_TOL})")
    if "step_ms" in s:
        print(f"seq:   an sMBR step on the card ({s['frames_step']} frames):"
              f" {s['step_ms']:.2f} ms wall over {SEQ_TIME_STEPS} steps; "
              f"{s['kernels_per_step']:.1f} kernels and "
              f"{s['busy_ms_per_step']:.3f} busy card ms a step "
              f"({100 * s['busy_share']:.1f}% busy, {SEQ_PROFILE_STEPS} "
              f"profiled); the objective's forward and backward as one "
              f"CUDA graph {s['graph_ms']:.3f} ms; timed at the join, the "
              f"card otherwise idle {tag}")
    for crit, t in s["tools"].items():
        print(f"seq:   tools ({crit}, {s['egs']} egs, {SEQ_TOOL_EPOCHS} "
              f"epochs): compute-objf {t['before']:.6f} → {t['after']:.6f}; "
              f"library {t['lib_before']:.6f} → {t['lib_after']:.6f}")
    gr = rep["grammar"]
    print(f"seq: 18b: grammar of {gr['top_words']} top words and a "
          f"{gr['list_words']}-word list: {gr['grammar_states']} states; "
          f"17d's model ready after {rep['walls']['waited for 17d']:.1f} s "
          f"of waiting")
    print(f"seq: walls " + ", ".join(f"{n} {v:.1f} s" for n, v in
                                     rep["walls"].items()))
    ref_fb = sum(n for t, n in rep["launches"]["fbank"].items()
                 if t != SEQ_FBANK_TOOL)
    print(f"seq: GMM kernel launches {gmm} ({', '.join(SEQ_GMM_TOOLS)}), "
          f"fbank {fb} ({SEQ_FBANK_TOOL}; {ref_fb} more in the reference "
          f"runs, not counted), den {den} {tag}")
    bad = [c for c in rep["checks"] if not c[1]]
    if bad:
        raise AssertionError(f"18: {len(bad)} checks failed: {bad[:3]}")
    if torch.cuda.is_available() and min(gmm, fb) <= 0:
        raise AssertionError(f"18: launches GMM {gmm}, fbank {fb}")
    return gmm, fb, den


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
    p4_rate = audio_s / wall
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
        m_fb, m_gmm, m_wers, msys = mini_recipe(dev, tag)
        # 17a's tools start here, in the background beside 10c to 13, and
        # 18's worker beside them
        tri = tri_tools_start(dev, msys)
        atexit.register(_stop, tri[0])
        seq = seq_tools_start(dev, msys)
        atexit.register(_stop, seq[0])
        loop = chain_loop_start(dev)
        atexit.register(_stop, loop[0])
        # 20's worker, beside them: Kaldi's serving binaries
        serve = serve_tools_start(serve_tools_write(
            task, task300, fbank, model, tcfg, utts, lls, msys), dev)
        atexit.register(_stop, serve[0])
        # 21's worker, beside it: Kaldi's nnet2 models as tools
        nnet2 = nnet2_tools_start(nnet2_tools_write(task300), dev)
        atexit.register(_stop, nnet2[0])
        # 22's worker, beside them: the cross-entropy DNN recipes as tools
        nloop = nnet_loop_start(nnet_loop_write(msys, m_wers), dev)
        atexit.register(_stop, nloop[0])
        # 23's worker, beside them, on 22's inputs: the nnet2 training
        # recipe as tools
        n2t = nnet2_train_start(nloop[1], dev)
        atexit.register(_stop, n2t[0])
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
        procs += [recipes, recipes[2:], recipes[3:]]
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
    # 17. tri3b as Kaldi's tools (17a, in the background since 10b), the
    # full-covariance GMM, EBW and the ladder's chain rung on 10b's systems
    t1 = time.perf_counter()
    tri_gmm, tri_wers = tri_tools_finish(tri, m_wers, tag)
    fgmm_card_vs_cpu(dev, tag)
    ebw_gmm = ebw_card_vs_cpu(dev, msys, tag)
    keep = {}
    ladder_den = ladder_rung(dev, msys, m_wers, tri_wers, tag, keep=keep)
    del msys
    print(f"tri: phase 17 took {time.perf_counter() - t1:.1f} s after phase "
          f"13")
    # 18. the other decoders, grammars, KWS and sequence training (in the
    # background since 10b; 18b decodes with 17d's model, written here)
    seq_chain_ready(seq, keep)
    del keep
    seq_gmm, seq_fb, seq_den = seq_tools_finish(seq, tag)
    # 19. the chain training loop's tools (in the background since 10b)
    loop_den = chain_loop_finish(loop, tag)
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

    # 15. xconfig chain models on 8b's egs (the main path: the den
    # kernels' count zeroed before 15a's training and read after), the
    # cross-entropy trainer and nnet3-train (in the background), x-vectors
    # and their tools (in the background), the LSTM scorer; 15b ran
    # beside 14c
    t0 = time.perf_counter()
    dk.launches = 0
    xc_rates = xconfig_training(dev, cden, egs, P, rates, tag)
    xc_den = dk.launches
    if xc_den <= 0:
        raise AssertionError("xconfig training launched no den kernel")
    print(f"xconfig: den kernel launches {xc_den} in 15a's "
          f"{len(xc_rates)} training points")
    for model_kind in ("xc_tdnnf", "xc_full"):
        print(f"xconfig: {model_kind}: one step at B = 4, card vs CPU:")
        card_step_equals_cpu(dev, cden, egs, P,
                             model=xconfig_model(model_kind))
    lstm_route(dev, tag)
    xent = xent_start(dev, cfeats, cruns, ctree, ctopo)
    procs = [xent]
    try:
        xent_stats = xent_training(dev, xent, tag)
        xmodel, xheld, xdir, xprocs = xvectors(dev, tag)
        procs += [(p,) for p in xprocs]
        lstm_scorer(dev, cfeats, P, tag)
        xvectors_finish(xmodel, xheld, xdir, xprocs, tag)
        xent_finish(xent, xent_stats, tag)
    finally:
        for p in procs:
            if p[0].poll() is None:
                p[0].kill()
                p[0].wait()
    print(f"xconfig: phase 15 took {time.perf_counter() - t0:.1f} s")

    # 16. decode and chain training across processes (parallel/): the
    # workers zero their den kernels' count before their training and
    # report it
    t0 = time.perf_counter()
    pod_den = pod_phase(dev, csr, task.tm.tid_to_pdf_array, cfg, X, lens,
                        best, p4_rate, cden, egs, P,
                        xc_rates.get("xc_tdnnf_f32_B128_Mframes_s"), tag)
    print(f"pod: phase 16 took {time.perf_counter() - t0:.1f} s")

    # 20. Kaldi's serving binaries (in the background since 10b)
    sv_fb, sv_gm, sv_fb_err, sv_gm_err = serve_tools_finish(serve, tag,
                                                            p4_rate)
    # 21. Kaldi's nnet2 models as tools (in the background since 10b)
    n2_fb, n2_fb_err = nnet2_tools_finish(nnet2, tag)
    # 22. the cross-entropy DNN recipes as tools (in the background since
    # 10b)
    nl_fb, nl_fb_err = nnet_loop_finish(nloop, tag)
    # 23. the nnet2 training recipe as tools (in the background since 10b)
    n2t_fb, n2t_fb_err = nnet2_train_finish(n2t, tag)

    print(card)
    print(json.dumps({"kernels": [{
        "name": "fbank_logmel", "route": "cuda",
        "source": "kaldi_tpu_torch/csrc/fbank.cu",
        "replaces": "kaldi_tpu/ops/pallas_frontend.py:53",
        "launches": fbank_launches + b_fb + d_fb + s_fb + c_fb + t_fb
        + sp_fb + bf_fb + p_fb + cli_fb + y_fb + m_fb + f_fb + iv_fb
        + seq_fb + sv_fb + n2_fb + nl_fb + n2t_fb,
        "max_abs_err": max(fb_err, wav_err, b_fb_err, s_err, bf_err,
                           f_fb_err, sv_fb_err, n2_fb_err, nl_fb_err,
                           n2t_fb_err),
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
        + f_gm + iv_gmm + tri_gmm + ebw_gmm + seq_gmm + sv_gm,
        "max_abs_err": max(gmm_err, b_err, d_err, p_err, f_gm_err,
                           iv_gmm_err, sv_gm_err),
        "ms": gmm_ms, "plain_ms": gmm_plain_ms,
        "bound_ms": gmm_bnd[0], "bound_by": gmm_bnd[1],
        "library_ms": None}, {
        "name": "chain_den", "route": "cuda",
        "source": "kaldi_tpu_torch/csrc/chain_den.cu",
        "replaces": "kaldi_tpu/am/chain.py:470",
        "note": "replaces an XLA program (lax.scan + jax.grad), not a "
                "Pallas kernel; forward and backward kernels, ms for both",
        "launches": den_launches + f_den + lat_den + xc_den + pod_den
        + ladder_den + seq_den + loop_den,
        "max_abs_err": max(den_err, f_den_err),
        "ms": den_ms, "plain_ms": den_plain_ms,
        "bound_ms": den_bnd[0], "bound_by": den_bnd[1],
        "library_ms": None}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


# ---------------------------------------------------------------------------
# 19. Kaldi's chain training loop (steps/nnet3/chain/train.py) as tools, on
# 8c's files: subsets, two parallel jobs, average, combine, posteriors,
# priors and progress
# ---------------------------------------------------------------------------

LOOP_DIR = os.path.join("build", "chip_smoke_chain_loop")
LOOP_EGS = 16              # egs a job's subset (one step of B = 16)
LOOP_COMBINE_ITERS = 10    # nnet3-chain-combine's Adam steps (the tool's 30)
LOOP_POST_UTTS = 4         # utterances through nnet3-chain-compute-post
# 19's bars, tool against library on the same files on the card.  The
# den kernel sums with atomics, so two runs' gradients differ in their
# last bits, and AdamW's first step (lr·g/(|g| + eps) an entry, ±lr
# where |g| ≫ eps) hides a gradient's size:
#  * nnet3-chain-train: the step's loss and objf within LOOP_LOSS_TOL
#    of the library's (of the larger of its size and 1: a loss near 0 is
#    a difference of the numerator's and the den's log-probabilities,
#    each ~1 a frame, in float32; it reads the den), the share of entries
#    off by more than lr/1000 at most LOOP_TRAIN_OFF (a wrong gradient's
#    signs; the sound runs read 0.0058-0.0061%, a tool that never trains
#    ~100%), and no entry off by more than 2·lr (one whose gradient sign
#    rides on the atomics);
#  * nnet3-chain-combine: Adam's trajectory near the optimum turns the
#    atomics' last bits into ~1e-3 of weight (0.936675 against the
#    library's own 0.933047 in one run, NVIDIA H100 80GB HBM3, 700.00 W,
#    their first iterations 2.5e-05 apart), so the library replays the
#    tool's logged gradients: at each
#    of the tool's LOOP_COMBINE_ITERS points its loss within
#    LOOP_LOSS_TOL and its gradient on the logits within LOOP_GRAD_TOL of
#    the first iteration's largest (which Adam's normalisation does not
#    hide), the replayed weight within LOOP_WEIGHT_TOL of the tool's
#    (recovered from its model by least squares), and the tool's model
#    within LOOP_MIX_TOL of each tensor's largest from that mix of its
#    inputs.
# A faulty control must fail these gates, or the phase fails: the
# library with the den's leaky-HMM coefficient at LOOP_CONTROL_LEAKY
# (ChainTrainingOptions' is 0.1), and for nnet3-chain-train also the
# untrained model.
LOOP_LOSS_TOL = 1e-5
LOOP_TRAIN_OFF = 1e-3
LOOP_TRAIN_TOL = 2 * CLI_LR
LOOP_GRAD_TOL = 1e-3
LOOP_WEIGHT_TOL = 1e-4
LOOP_MIX_TOL = 1e-5
LOOP_CONTROL_LEAKY = 0.2
LOOP_POST_TOL = 1e-5       # posteriors = the library's, absolute


def chain_loop_start(dev):
    """19, started: ``python3 chip_smoke.py --chain-loop <8c's dir>
    <dir> <device>`` (``chain_loop_worker``) in the background.  →
    (process, dir, start time)."""
    import subprocess
    repo = os.path.dirname(os.path.abspath(__file__))
    d = os.path.join(repo, LOOP_DIR)
    os.makedirs(d, exist_ok=True)
    if os.path.exists(f"{d}/report.json"):
        os.remove(f"{d}/report.json")
    out = open(f"{d}/worker.out", "w")
    err = open(f"{d}/worker.err", "w")
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--chain-loop",
         os.path.join(repo, "build", "chip_smoke_chain"), d, dev.type],
        cwd=repo, stdout=out, stderr=err,
        env=dict(os.environ, OMP_NUM_THREADS="2"))
    out.close()
    err.close()
    return proc, d, time.perf_counter()


def _rel_sd(got, want) -> float:
    """The largest |got − want| of each tensor over its largest |want|,
    over the state dict."""
    return max(float((got[k].float().cpu() - want[k].float().cpu())
                     .abs().max()) / max(float(want[k].abs().max()), 1e-12)
               for k in want)


def chain_loop_worker(argv) -> int:
    """19's background process: train.py's loop as calls of the port's
    registry in this process on 8c's model, phone sequences and egs
    (``<src>``), each held against its library call on the same card:
    nnet3-chain-make-den-fst; nnet3-chain-subset-egs for two jobs'
    subsets and a validation subset; nnet3-chain-train on each job's
    subset (one epoch); nnet3-average of the two; nnet3-chain-combine of
    the two on the validation subset; nnet3-chain-compute-post of the
    combined model; nnet3-am-adjust-priors on its .mdl (8c's transition
    model and the combined nnet, as nnet3-am-init joins them) with the
    egs' pdf counts; nnet3-am-copy --raw; nnet3-show-progress from 8c's
    model to the combined one.  The den kernel's count is set to 0
    before each tool call and read after it.  Writes ``report.json``
    (checks, walls, numbers, each tool's den launches); exits 1 if a
    check fails."""
    import ast
    import contextlib
    import io
    import logging
    import re
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from kaldi_tpu_torch.am.chain import (ChainTrainingOptions,
                                          make_denominator_graph,
                                          read_denominator_graph)
    from kaldi_tpu_torch.am.nnet3_io import (infer_tdnn_config,
                                             nnet3_to_state_dict,
                                             read_nnet3_path)
    from kaldi_tpu_torch.am.serialize import read_mdl
    from kaldi_tpu_torch.am.tdnn import TdnnChain, params_to_flax
    from kaldi_tpu_torch.cli import TOOLS
    from kaldi_tpu_torch.cli.tools_bank23 import (_split_mdl,
                                                  _write_mdl_blobs)
    from kaldi_tpu_torch.core import io as kio
    from kaldi_tpu_torch.core.table import (SequentialTableReader,
                                            TableWriter)
    from kaldi_tpu_torch.ops.chain_den import CudaChainDen
    from kaldi_tpu_torch.pipelines.chain import (ChainEgs, ChainTrainConfig,
                                                 ChainTrainer,
                                                 combine_models)
    from kaldi_tpu_torch.pipelines.egs_io import read_egs_ark
    t_start = time.perf_counter()
    src, d, dv = argv[0], argv[1], argv[2]
    dev = torch.device(dv, 0) if dv == "cuda" else torch.device(dv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    calls, checks, walls, den_launches, rep = [], [], {}, {}, {}

    class Logged(logging.Handler):
        def emit(self, record):
            logs.append(record.getMessage())

    logs = []
    logging.getLogger("kaldi_tpu_torch").addHandler(Logged())

    def T(name, *args):
        """Run tool ``name`` → (its stdout, its log messages)."""
        args = [str(a) for a in args]
        buf = io.StringIO()
        logs.clear()
        CudaChainDen.total_launches = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = TOOLS[name](args)
        walls[name] = walls.get(name, 0.0) + time.perf_counter() - t0
        den_launches[name] = (den_launches.get(name, 0)
                              + CudaChainDen.total_launches)
        if rc:
            raise AssertionError(f"{name} {' '.join(args)}: rc {rc}")
        calls.append(name)
        return buf.getvalue(), list(logs)

    def held(name, ok, detail):
        checks.append((name, bool(ok), detail))

    def raw(path):
        m = read_nnet3_path(path)
        cfg = infer_tdnn_config(m)
        return nnet3_to_state_dict(m, cfg), cfg

    dflag = f"--device={dev.type}"
    mdl, ph, egs_all = f"{src}/final.mdl", f"ark:{src}/ph.ark", \
        f"ark:{src}/egs.ark"
    tm, _ = read_mdl(mdl, device="cpu")
    seqs = [[int(x) for x in v] for _k, v in
            SequentialTableReader(ph, holder="ivec")]
    # the den graph
    T("nnet3-chain-make-den-fst", "--lm-order=3", mdl, ph, f"{d}/den.fst")
    den = make_denominator_graph(seqs, tm.tree, tm.topo, order=3)
    with kio.open_rxfilename(f"{d}/den.fst") as f:
        kio.init_kaldi_input_stream(f)
        got = read_denominator_graph(f)
    held("nnet3-chain-make-den-fst",
         got.num_states == den.num_states and all(
             np.array_equal(getattr(got, a), getattr(den, a))
             for a in ("src", "dst", "pdf", "logw", "final", "initial")),
         f"{den.num_states} states, {len(den.src)} arcs")
    # the jobs' and the validation subsets
    full = read_egs_ark(egs_all)
    keys = [k for k, _ in SequentialTableReader(egs_all, holder="ceg")]
    subsets = {}
    for job, srand in (("a", 1), ("b", 2), ("valid", 3)):
        T("nnet3-chain-subset-egs", f"--n={LOOP_EGS}", f"--srand={srand}",
          egs_all, f"ark:{d}/{job}.ark")
        idx = np.sort(np.random.default_rng(srand).permutation(
            len(keys))[:LOOP_EGS])
        subsets[job] = read_egs_ark(f"ark:{d}/{job}.ark")
        held("nnet3-chain-subset-egs",
             np.array_equal(subsets[job].feats, full.feats[idx])
             and np.array_equal(subsets[job].pdf_ali, full.pdf_ali[idx]),
             f"{job}: {LOOP_EGS} of {len(keys)}")
    # two jobs of nnet3-chain-train
    init, cfg = raw(f"{src}/0.raw")
    control = ChainTrainingOptions(leaky_hmm_coefficient=LOOP_CONTROL_LEAKY)

    def library_job(job, opts=None):
        tr = ChainTrainer(cfg, den, ChainTrainConfig(
            num_epochs=1, learning_rate=CLI_LR,
            **({"opts": opts} if opts else {})), device=dev)
        tr.model.load_state_dict(init)
        stats = tr.train(subsets[job])
        return {k: v.cpu() for k, v in tr.model.state_dict().items()}, stats

    def train_gaps(got, got_stats, want, want_stats):
        diff = [(got[k] - want[k]).abs() for k in want]
        off = (sum(int((x > CLI_LR / 1000).sum()) for x in diff)
               / sum(x.numel() for x in diff))
        loss = max(abs(got_stats[k] - want_stats[k])
                   / max(abs(want_stats[k]), 1.0) for k in ("loss", "objf"))
        return max(float(x.max()) for x in diff), off, loss

    def train_ok(e, off, loss):
        return (e <= LOOP_TRAIN_TOL and off <= LOOP_TRAIN_OFF
                and loss <= LOOP_LOSS_TOL)

    jobs = {}
    for job in ("a", "b"):
        _o, lg = T("nnet3-chain-train", dflag, "--num-epochs=1",
                   f"--learning-rate={CLI_LR}", mdl, f"{src}/0.raw", ph,
                   f"ark:{d}/{job}.ark", f"{d}/1{job}.raw")
        tool_stats = ast.literal_eval(next(
            m for m in lg if m.startswith("nnet3-chain-train: {"))
            .split(": ", 1)[1])
        jobs[job] = raw(f"{d}/1{job}.raw")[0]
        lib, lib_stats = library_job(job)
        e, off, loss = train_gaps(jobs[job], tool_stats, lib, lib_stats)
        held("nnet3-chain-train", train_ok(e, off, loss),
             f"job {job}: max |diff| {e:.2e}, {100 * off:.4f}% of entries "
             f"off by > lr/1000, loss {loss:.1e} from the library's")
        rep[f"train_{job}"] = dict(abs=e, off=off, loss=loss)
        if job == "a":
            # the faulty controls: a tool that never trains, a wrong den
            ctl = {"untrained": train_gaps(init, lib_stats, lib, lib_stats),
                   "leaky": train_gaps(*library_job(job, control), lib,
                                       lib_stats)}
            held("nnet3-chain-train controls",
                 not any(train_ok(*g) for g in ctl.values()),
                 "; ".join(f"{n}: max |diff| {g[0]:.2e}, {100 * g[1]:.4f}%,"
                           f" loss {g[2]:.1e}" for n, g in ctl.items()))
            rep["train_controls"] = {n: dict(abs=g[0], off=g[1], loss=g[2])
                                     for n, g in ctl.items()}
    # nnet3-average
    T("nnet3-average", f"{d}/avg.raw", f"{d}/1a.raw", f"{d}/1b.raw")
    avg = raw(f"{d}/avg.raw")[0]
    e = max(float((avg[k] - ((jobs["a"][k].double() + jobs["b"][k])
                             / 2).float()).abs().max()) for k in avg)
    held("nnet3-average", e == 0.0, f"{e:.2e}")
    # nnet3-chain-combine on the validation subset
    _o, lg = T("nnet3-chain-combine", dflag,
               f"--num-iters={LOOP_COMBINE_ITERS}", f"{d}/den.fst",
               f"ark:{d}/valid.ark", f"{d}/1a.raw", f"{d}/1b.raw",
               f"{d}/combined.raw")
    tool_trace = []
    for m in lg:
        it = re.match(r"nnet3-chain-combine: iteration (\d+): loss (\S+), "
                      r"gradient on the logits (.*)$", m)
        if it:
            tool_trace.append((float(it.group(2)), np.array(
                [float(x) for x in it.group(3).split()])))
    nets = []
    for job in ("a", "b"):
        net = TdnnChain(cfg)
        net.load_state_dict(jobs[job])
        nets.append(net.eval().to(dev))
    lib_trace, ctl_trace, own = [], [], []
    _sd, wgt, objf = combine_models(
        nets, den, subsets["valid"], LOOP_COMBINE_ITERS, trace=lib_trace,
        replay=[g for _l, g in tool_trace])
    # the library's own trajectory (reported) and the faulty control
    _sd, wgt_own, _objf = combine_models(nets, den, subsets["valid"],
                                         LOOP_COMBINE_ITERS, trace=own)
    combine_models(nets, den, subsets["valid"], 1, opts=control,
                   trace=ctl_trace)
    g_scale = max(float(np.abs(lib_trace[0][1]).max()), 1e-30)

    def gaps(got, want):
        return (max(abs(a[0] - b[0]) / max(abs(b[0]), 1.0)
                    for a, b in zip(got, want)),
                max(float(np.abs(a[1] - b[1]).max()) / g_scale
                    for a, b in zip(got, want)))

    combined = raw(f"{d}/combined.raw")[0]
    names = [k for k, _ in nets[0].named_parameters()]
    a, b, c = (torch.cat([sd[k].double().cpu().reshape(-1) for k in names])
               for sd in (jobs["a"], jobs["b"], combined))
    w_tool = float((c - b) @ (a - b) / ((a - b) @ (a - b)))
    mix = {k: w_tool * jobs["a"][k].double() + (1 - w_tool)
           * jobs["b"][k].double() for k in names}
    e = _rel_sd({k: combined[k] for k in names}, mix)
    dw = abs(w_tool - float(wgt[0]))
    l1, g1 = gaps(tool_trace, lib_trace)
    cl1, cg1 = gaps(ctl_trace, lib_trace[:1])
    held("nnet3-chain-combine",
         len(tool_trace) == LOOP_COMBINE_ITERS and l1 <= LOOP_LOSS_TOL
         and g1 <= LOOP_GRAD_TOL and dw <= LOOP_WEIGHT_TOL
         and e <= LOOP_MIX_TOL,
         f"{len(tool_trace)} iterations: loss {l1:.1e}, gradient on the "
         f"logits {g1:.1e} from the library's at the tool's points; weight "
         f"{w_tool:.6f} against the replay's {float(wgt[0]):.6f} (the "
         f"library's own trajectory {float(wgt_own[0]):.6f}); the model "
         f"{e:.2e} from that mix of its inputs")
    held("nnet3-chain-combine control",
         cl1 > LOOP_LOSS_TOL or cg1 > LOOP_GRAD_TOL,
         f"leaky-HMM {LOOP_CONTROL_LEAKY:g}: loss {cl1:.1e}, gradient "
         f"{cg1:.1e}")
    rep.update(combine_loss=l1, combine_grad=g1, combine_dw=dw,
               combine_own_dw=abs(w_tool - float(wgt_own[0])),
               combine_mix=e, combine_control=dict(loss=cl1, grad=cg1),
               combine_weights=[float(w) for w in wgt], combine_objf=objf)
    # nnet3-chain-compute-post
    with TableWriter(f"ark:{d}/feats.ark", holder="mat") as w:
        for i in range(LOOP_POST_UTTS):
            w[f"utt{i}"] = full.feats[i]
    T("nnet3-chain-compute-post", dflag, f"{d}/combined.raw",
      f"ark:{d}/feats.ark", f"ark:{d}/post.ark")
    net = TdnnChain(cfg)
    net.load_state_dict(combined)
    net = net.eval().to(dev)
    e = 0.0
    with torch.no_grad():
        for k, post in SequentialTableReader(f"ark:{d}/post.ark",
                                             holder="mat"):
            x = torch.as_tensor(full.feats[int(k[3:])]).to(dev)
            want = torch.softmax(net(x[None])[0], -1).cpu().numpy()
            e = max(e, float(np.abs(post - want).max()))
    held("nnet3-chain-compute-post", e <= LOOP_POST_TOL, f"{e:.2e}")
    rep["post_abs"] = e
    # the .mdl (nnet3-am-init's join), its priors, its raw nnet
    tm_blob, _n, _p = _split_mdl(mdl)
    with open(f"{d}/combined.raw", "rb") as f:
        raw_bytes = f.read()
    _write_mdl_blobs(f"{d}/final_nnet.mdl", tm_blob, raw_bytes[2:])
    counts = np.bincount(full.pdf_ali[full.mask], minlength=tm.num_pdfs)
    with kio.open_wxfilename(f"{d}/counts.vec") as f:
        kio.init_kaldi_output_stream(f)
        kio.write_vector(f, counts.astype(np.float32))
    T("nnet3-am-adjust-priors", f"{d}/final_nnet.mdl", f"{d}/counts.vec",
      f"{d}/final_adj.mdl")
    _t, nnet_blob, priors = _split_mdl(f"{d}/final_adj.mdl")
    c = counts.astype(np.float64)
    want = (c + 0.5) / (c.sum() + 0.5 * len(c))
    held("nnet3-am-adjust-priors",
         priors is not None and np.allclose(priors, want, rtol=1e-12)
         and nnet_blob == raw_bytes[2:], f"{len(c)} pdfs")
    T("nnet3-am-copy", "--raw=true", f"{d}/final_adj.mdl",
      f"{d}/final.raw")
    with open(f"{d}/final.raw", "rb") as f:
        held("nnet3-am-copy", f.read() == raw_bytes, "the combined nnet")
    # nnet3-show-progress
    out, _lg = T("nnet3-show-progress", f"{src}/0.raw",
                 f"{d}/combined.raw")
    old, new = (params_to_flax(sd)["params"] for sd in (init, combined))
    lines = out.strip().splitlines()
    worst, n = 0.0, 0
    for line in lines:
        name, val = line.split(": rel-param-change ")
        a, b = old, new
        for k in name.split("/"):
            a, b = a[k], b[k]
        want = float(np.linalg.norm(b - a)) / (float(np.linalg.norm(a))
                                              + 1e-20)
        worst = max(worst, abs(float(val) - want))
        n += 1
    held("nnet3-show-progress", n > 0 and worst <= 1e-6,
         f"{n} tensors, |diff| {worst:.1e}")
    rep["progress"] = lines
    with open(f"{d}/report.json", "w") as f:
        json.dump({"walls": walls, "checks": checks, "calls": len(calls),
                   "tools": sorted(set(calls)), "den_launches": den_launches,
                   "total": time.perf_counter() - t_start, **rep}, f,
                  default=float)
    bad = [c for c in checks if not c[1]]
    if bad:
        print(f"chain loop: {len(bad)} checks failed: {bad[:5]}",
              file=sys.stderr)
        return 1
    return 0


def chain_loop_finish(started, tag: str) -> int:
    """19, joined: the background run's exit, its checks, each tool's
    wall and the den kernel's launches in the tools.  → the den
    launches."""
    proc, d, t0 = started
    t_wait = time.perf_counter()
    proc.wait(timeout=900)
    wait = time.perf_counter() - t_wait
    wall = time.perf_counter() - t0
    with open(f"{d}/worker.err") as f:
        err = f.read()
    if not os.path.exists(f"{d}/report.json"):
        raise AssertionError(f"chain loop tools failed ({proc.returncode}):"
                             f"\n{err[-3000:]}")
    with open(f"{d}/report.json") as f:
        rep = json.load(f)
    by = {}
    for name, ok, detail in rep["checks"]:
        n, k, det = by.get(name, (0, 0, []))
        by[name] = (n + 1, k + int(ok), det + ([detail] if detail else []))
    den = sum(rep["den_launches"].values())
    print(f"loop: 19: train.py's loop as {rep['calls']} calls of "
          f"{len(rep['tools'])} tools on 8c's files in one background "
          f"process started at 10b: {wall:.1f} s to the join "
          f"({rep['total']:.1f} s of work after its imports); the main "
          f"process waited {wait:.1f} s here {tag}")
    for name, (n, k, det) in by.items():
        print(f"loop:   {name}: {k} of {n} held against the library"
              + (f" ({'; '.join(det[:3])})" if det else "")
              + f"; {rep['walls'].get(name, 0.0):.2f} s")
    print(f"loop: nnet3-chain-combine weights "
          f"{[round(w, 4) for w in rep['combine_weights']]}, objf "
          f"{rep['combine_objf']:.4f}; nnet3-show-progress "
          f"{rep['progress'][:2]}")
    print(f"loop: den kernel launches {den} "
          f"({', '.join(f'{t} {n}' for t, n in rep['den_launches'].items() if n)})"
          f" {tag}")
    bad = [c for c in rep["checks"] if not c[1]]
    if bad or proc.returncode != 0:
        raise AssertionError(f"19: {len(bad)} checks failed: {bad[:3]} "
                             f"(exit {proc.returncode})")
    if torch.cuda.is_available() and den <= 0:
        raise AssertionError("19: the loop's tools launched no den kernel")
    return den


# ---------------------------------------------------------------------------
# 20. Kaldi's serving binaries: the batched, looped and incremental nnet3
# decodes, the online2 TCP server, wake-word, the legacy online GMM
# servers and the regression-tree adapted decodes, as the port's tools
# ---------------------------------------------------------------------------

SERVE_DIR = os.path.join("build", "chip_smoke_serve")
SERVE_WAVES = 8            # 20a, 20b: 7d's seeded waveforms
SERVE_TCP_GROUP = 4        # 20b: clients at once (twice)
SERVE_CHUNK_S = 0.18       # 20b: seconds of audio a client send
SERVE_BATCH = 32           # 20c: waveforms through the batched decode
SERVE_GMM_WAVES = 4        # 20d: test waveforms through the online GMM tools
SERVE_REGTREE_UTTS = 30    # 20e: 10b's test utterances
SERVE_TRI1_ITERS = 6       # 20d: EM iterations of its model (5 mix-ups)
# 20e's regtree occupancy gate: a test speaker's 10 utterances hold fewer
# frames than the tools' defaults (100 for MLLR, 200 for fMLLR) ask of a
# node below the root
SERVE_MIN_COUNT = 50.0
# 20c's decode: phase 4's headline point (beam 13, lattice beam 7,
# max-active 7000, acoustic scale 1)
SERVE_BIG = ("--beam=13", "--lattice-beam=7", "--max-active=7000",
             "--acoustic-scale=1.0")
SERVE_COST_TOL = 1e-3      # best-path costs, tool against library
SERVE_SCORE_TOL = 1e-4     # scores and features, of the largest entry
SERVE_JOIN = 900           # the main process's longest wait, seconds
# the tools whose kernel launches join the kernels line
SERVE_FBANK_TOOLS = ("online2-wav-dump-features",
                     "online2-wav-nnet3-latgen-incremental",
                     "online2-wav-nnet3-wake-word-decoder-faster",
                     "online2-tcp-nnet3-decode-faster",
                     "online-wav-gmm-decode-faster",
                     "online-gmm-decode-faster",
                     "online-server-gmm-decode-faster",
                     "online-audio-server-decode-faster",
                     "online2-wav-gmm-latgen-faster")
SERVE_GMM_TOOLS = SERVE_FBANK_TOOLS[4:] + (
    "gmm-latgen-faster", "gmm-est-regtree-mllr", "gmm-est-regtree-fmllr",
    "gmm-est-regtree-fmllr-ali", "gmm-decode-faster-regtree-fmllr",
    "gmm-decode-faster-regtree-mllr", "gmm-latgen-faster-regtree-fmllr",
    "gmm-latgen-map", "gmm-rescore-lattice")


def _int16(wave) -> np.ndarray:
    return np.clip(np.asarray(wave, np.float64), -32768,
                   32767).astype(np.int16)


def serve_tools_write(task, task300, fbank, model, tcfg, utts, lls,
                      msys) -> str:
    """20's inputs, written by the main process: 7d's 8 waveforms and
    the 300-word task's words (7d's .mdl, HCLG and raw TDNN-F stay in
    build/chip_smoke_online2); phase 4/5's 20k HCLG (its write timed),
    transition model, phase 5's TDNN-F as raw nnet3, the 40-bin fbank
    features of SERVE_BATCH seeded waveforms (launches not counted) and
    phase 4's log-likelihoods; 10b's tri1 (.mdl, HCLG, training
    alignments), its Δ+ΔΔ test features, transcripts, speakers and the
    8 kHz waveforms.  → the directory."""
    import pickle
    from kaldi_tpu_torch.am.gmm import AmDiagGmm
    from kaldi_tpu_torch.am.nnet3_io import write_raw_model
    from kaldi_tpu_torch.am.serialize import write_mdl
    from kaldi_tpu_torch.core.table import TableWriter
    from kaldi_tpu_torch.fst.csr import csr_to_vector_fst
    from kaldi_tpu_torch.fst.openfst_io import write_fst_path
    repo = os.path.dirname(os.path.abspath(__file__))
    d = os.path.join(repo, SERVE_DIR)
    os.makedirs(d, exist_ok=True)
    for stale in ("report.json", "worker.out", "worker.err"):
        if os.path.exists(f"{d}/{stale}"):
            os.remove(f"{d}/{stale}")
    # a, b
    waves = speech_set(task300, SERVE_WAVES, SEED + 8)[0]
    with TableWriter(f"ark:{d}/wav8.ark", holder="wav") as w:
        for i, x in enumerate(waves):
            w[f"utt{i}"] = (_int16(x), SAMP_FREQ)
    task300.words.write(f"{d}/words300.txt")
    # c
    t0 = time.perf_counter()
    write_fst_path(f"{d}/HCLG20k.fst", csr_to_vector_fst(task.graph.csr))
    write_s = time.perf_counter() - t0
    write_mdl(f"{d}/big.mdl", task.tm, AmDiagGmm.flat_start(
        task.num_pdfs, np.zeros(tcfg.feat_dim), np.ones(tcfg.feat_dim),
        device="cpu"))
    write_raw_model(f"{d}/p5.raw", {k: v.cpu() for k, v in
                                    model.state_dict().items()}, tcfg)
    bwaves = synth_waveforms(np.random.default_rng(SEED + 20), SERVE_BATCH)
    with TableWriter(f"ark:{d}/fbank32.ark", holder="mat") as w:
        for i, x in enumerate(bwaves):
            w[f"b{i:02d}"] = fbank.compute(x).cpu().numpy()
    with TableWriter(f"ark:{d}/ll4.ark", holder="mat") as w:
        for u, ll in zip(utts, lls):
            w[u] = np.asarray(ll, np.float32)
    # d, e
    tri1, test, train = msys["tri1"], msys["test"], msys["train"]
    write_mdl(f"{d}/tri1.mdl", tri1.tm, tri1.am)
    write_fst_path(f"{d}/HCLG1.fst", msys["HCLG1"])
    msys["lang"].words.write(f"{d}/words.txt")
    te = sorted(msys["delta_te"])[:SERVE_REGTREE_UTTS]
    with TableWriter(f"ark:{d}/delta_te.ark", holder="mat") as w:
        for u in te:
            w[u] = np.asarray(msys["delta_te"][u], np.float32)
    with TableWriter(f"ark:{d}/ali_tr.ark", holder="ivec") as w:
        for u in sorted(msys["tri1_ali"]):
            w[u] = np.asarray(msys["tri1_ali"][u], np.int32)
    with TableWriter(f"ark:{d}/wav_tr8k.ark", holder="wav") as w:
        for u in train.utts:
            w[u] = (_int16(train.wavs[u][0] * 32768.0), train.wavs[u][1])
    with TableWriter(f"ark:{d}/wav_te8k.ark", holder="wav") as w:
        for u in te[:SERVE_GMM_WAVES]:
            w[u] = (_int16(test.wavs[u][0] * 32768.0), test.wavs[u][1])
    with open(f"{d}/inputs.pkl", "wb") as f:
        pickle.dump({"text_te": {u: list(test.text[u]) for u in te},
                     "utt2spk": {u: test.utt2spk[u] for u in te},
                     "audio_batch_s": sum(len(x) for x in bwaves)
                     / SAMP_FREQ,
                     "hclg20k_write_s": write_s}, f)
    return d


def serve_tools_start(d: str, dev):
    """20, started: ``python3 chip_smoke.py --serve-tools <dir> <device>``
    (``serve_tools_worker``) in the background, two host threads.  →
    (process, dir, start time)."""
    import subprocess
    repo = os.path.dirname(os.path.abspath(__file__))
    out = open(f"{d}/worker.out", "w")
    err = open(f"{d}/worker.err", "w")
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--serve-tools", d,
         dev.type], cwd=repo, stdout=out, stderr=err,
        env=dict(os.environ, OMP_NUM_THREADS="2"))
    out.close()
    err.close()
    return proc, d, time.perf_counter()


class _LogTap:
    """The port's log lines while a tool runs in this process (its
    handler holds the stderr of start-up, so redirecting stderr misses
    them)."""

    def __init__(self):
        import logging
        tap = self

        class Handler(logging.Handler):
            def emit(self, record):
                tap.lines.append(record.getMessage())

        self.lines = []
        self.handler = Handler()
        self.logger = logging.getLogger("kaldi_tpu_torch")

    def __enter__(self):
        self.lines = []
        self.logger.addHandler(self.handler)
        return self

    def __exit__(self, *exc):
        self.logger.removeHandler(self.handler)
        return False


def _serve_read(spec, holder):
    from kaldi_tpu_torch.core.table import SequentialTableReader
    return dict(SequentialTableReader(spec, holder=holder))


def _rel(got, want) -> float:
    """The largest difference over the larger of 1 and the largest
    |want| (inf when the shapes differ)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if got.shape != want.shape:
        return float("inf")
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


def _best_diff(got, want):
    """Two CompactLattice tables → (keys and best words equal, the
    largest best-path cost difference)."""
    if sorted(got) != sorted(want):
        return False, float("inf")
    ok, worst = True, 0.0
    for k in want:
        gw, _, gc = got[k].best_path()
        ww, _, wc = want[k].best_path()
        ok &= list(gw) == list(ww)
        worst = max(worst, abs(gc - wc))
    return ok, worst


def _stream(mfcc, net, dev, wave, decoders, wake=None):
    """The library's online2 loop over one waveform (WAV_CHUNK pieces →
    NnetStream → each decoder's advance), ended at the first piece whose
    partial best path holds ``wake`` when given.  → the frame of that
    piece (-1: never)."""
    from kaldi_tpu_torch.cli.online2 import NnetStream
    st = NnetStream(mfcc, net, 3, dev)
    wave = np.asarray(wave, np.float32)
    for i in range(0, len(wave), WAV_CHUNK):
        st.accept_waveform(wave[i:i + WAV_CHUNK])
        s = st.pump(False)
        if s.numel():
            for dec in decoders:
                dec.advance_decoding(s)
        if wake is not None and decoders[0].num_frames_decoded and wake in \
                decoders[0].get_best_path(use_final_probs=False)[1]:
            return decoders[0].num_frames_decoded
    s = st.pump(True)
    if s.numel():
        for dec in decoders:
            dec.advance_decoding(s)
    if wake is not None and wake in \
            decoders[0].get_best_path(use_final_probs=True)[1]:
        return decoders[0].num_frames_decoded
    return -1


def serve_nnet3(T, held, d, dev, rep):
    """20a: nnet3-compute, nnet3-compute-batch, apply-cmvn-online,
    online2-wav-dump-features, nnet3-latgen-faster-looped,
    online2-wav-nnet3-latgen-incremental and the wake-word decoder on
    7d's files and 8 waveforms; each against the library on the card.
    → the library's streamed words per utterance (20b's reference)."""
    from kaldi_tpu_torch.am.serialize import read_mdl
    from kaldi_tpu_torch.cli.latgen import _LatgenDecoder, _load_hclg
    from kaldi_tpu_torch.cli.online2 import _load_tdnn
    from kaldi_tpu_torch.cli.tools_bank29 import looped_scores
    from kaldi_tpu_torch.cli.tools_bank31 import incremental_decoder
    from kaldi_tpu_torch.core import io as kio
    from kaldi_tpu_torch.core.table import TableWriter
    from kaldi_tpu_torch.decoder.dense import DenseDecoder, DenseDecoderConfig
    from kaldi_tpu_torch.decoder.online import SingleUtteranceDecoder
    from kaldi_tpu_torch.features.compute import Mfcc, MfccOptions
    from kaldi_tpu_torch.features.online import (OnlineCmvnOptions,
                                                 online_cmvn)
    from kaldi_tpu_torch.features.window import FrameExtractionOptions
    o2 = os.path.join(os.path.dirname(d), "chip_smoke_online2")
    mdl, raw, fst = f"{o2}/final.mdl", f"{o2}/final.raw", f"{o2}/HCLG.fst"
    dv = f"--device={dev.type}"
    tm, _ = read_mdl(mdl, device="cpu")
    _, net = _load_tdnn(raw, 3, dev)
    mfcc = Mfcc(MfccOptions(frame_opts=FrameExtractionOptions(dither=0.0),
                            num_ceps=13), device=dev)
    waves = _serve_read(f"ark:{d}/wav8.ark", "wav")
    feats = {k: mfcc.compute(np.asarray(w, np.float32))
             for k, (w, _r) in waves.items()}
    with TableWriter(f"ark:{d}/feats8.ark", holder="mat") as w:
        for k, x in feats.items():
            w[k] = x.cpu().numpy()
    with torch.no_grad():
        scores = {k: net(x[None])[0] for k, x in feats.items()}
    # 1. nnet3-compute
    T("nnet3-compute", dv, raw, f"ark:{d}/feats8.ark", f"ark:{d}/nc.ark")
    got = _serve_read(f"ark:{d}/nc.ark", "mat")
    err = max(_rel(got[k], scores[k].cpu()) for k in scores)
    held("nnet3-compute = TdnnChain", err <= SERVE_SCORE_TOL, f"{err:.2e}")
    # 2. nnet3-compute-batch: the tool's batch (8, 64-frame buckets, zero
    # padding) through the library's TdnnChain
    T("nnet3-compute-batch", dv, "--frame-subsampling-factor=3", raw,
      f"ark:{d}/feats8.ark", f"ark:{d}/ncb.ark")
    got = _serve_read(f"ark:{d}/ncb.ark", "mat")
    keys = sorted(feats, key=lambda k: (feats[k].shape[0], k))
    T_pad = -(-max(feats[k].shape[0] for k in keys) // 64) * 64
    Xb = torch.zeros((8, T_pad, 13), device=dev)
    for b, k in enumerate(keys):
        Xb[b, :feats[k].shape[0]] = feats[k]
    with torch.no_grad():
        out = net(Xb)
    err = max(_rel(got[k], out[b, :feats[k].shape[0] // 3].cpu())
              for b, k in enumerate(keys))
    held("nnet3-compute-batch = TdnnChain on its batch",
         err <= SERVE_SCORE_TOL, f"{err:.2e}")
    # 3. apply-cmvn-online with the utterances' global statistics
    allx = torch.cat(list(feats.values())).double().cpu().numpy()
    g = np.zeros((2, 14))
    g[0, :13], g[1, :13], g[0, 13] = allx.sum(0), (allx ** 2).sum(0), \
        len(allx)
    with kio.open_wxfilename(f"{d}/gstats") as f:
        kio.init_kaldi_output_stream(f)
        kio.write_matrix(f, g)
    T("apply-cmvn-online", dv, "--cmn-window=600", f"{d}/gstats",
      f"ark:{d}/feats8.ark", f"ark:{d}/cmvn.ark")
    got = _serve_read(f"ark:{d}/cmvn.ark", "mat")
    o = OnlineCmvnOptions(cmn_window=600, global_stats=g)
    err = max(_rel(got[k], online_cmvn(x, o).cpu()) for k, x in feats.items())
    held("apply-cmvn-online = online_cmvn", err <= SERVE_SCORE_TOL,
         f"{err:.2e}")
    # 4. online2-wav-dump-features
    T("online2-wav-dump-features", dv, f"ark:{d}/wav8.ark",
      f"ark:{d}/dump.ark")
    got = _serve_read(f"ark:{d}/dump.ark", "mat")
    err = max(_rel(got[k], x.cpu()) for k, x in feats.items())
    held("online2-wav-dump-features = Mfcc", err <= SERVE_SCORE_TOL,
         f"{err:.2e}")
    # 6. nnet3-latgen-faster-looped (context 36 ≥ the receptive field 34)
    HCLG = _load_hclg(fst)
    T("nnet3-latgen-faster-looped", dv, "--chunk-frames=51",
      "--extra-context=36", "--acoustic-scale=1.0", mdl, raw, fst,
      f"ark:{d}/feats8.ark", f"ark:{d}/looped.ark")
    lat = _LatgenDecoder(HCLG, tm.tid_to_pdf_array, 15.0, 8.0, 1.0,
                         device=dev)
    looped_err, want = 0.0, {}
    with torch.no_grad():
        for k, x in feats.items():
            ls = looped_scores(net, x, 51, 36, 3)
            looped_err = max(looped_err, _rel(ls.cpu(),
                                              scores[k][:len(ls)].cpu()))
            want[k] = lat.decode_to_clat(ls)
    ok, worst = _best_diff(_serve_read(f"ark:{d}/looped.ark", "clat"), want)
    held("looped scores = the offline forward",
         looped_err <= SERVE_SCORE_TOL, f"{looped_err:.2e}")
    held("nnet3-latgen-faster-looped = library",
         ok and worst <= SERVE_COST_TOL, f"{worst:.2e}")
    rep["looped_err"] = looped_err
    # 9. online2-wav-nnet3-latgen-incremental; the library's streamed
    # words on the dense decoder beside it (10's and 20b's reference)
    T("online2-wav-nnet3-latgen-incremental", dv, "--acoustic-scale=1.0",
      mdl, raw, fst, f"ark:{d}/wav8.ark", f"ark:{d}/incr_wav.ark")
    po = {"beam": 15.0, "lattice-beam": 8.0, "max-active": 7000,
          "acoustic-scale": 1.0}
    _tm, ob = incremental_decoder(mdl, fst, po, dev, record_capacity=65536)
    dense = DenseDecoder(HCLG, tm.tid_to_pdf_array,
                         DenseDecoderConfig(beam=15.0, acoustic_scale=1.0),
                         device=dev)
    want, words = {}, {}
    with torch.no_grad():
        for k, (w, _r) in waves.items():
            online = SingleUtteranceDecoder(dense)
            ob.reset()
            _stream(mfcc, net, dev, w, [online, ob])
            want[k] = ob.finalize()
            words[k] = online.get_best_path(use_final_probs=True)[1]
    ok, worst = _best_diff(_serve_read(f"ark:{d}/incr_wav.ark", "clat"),
                           want)
    held("online2-wav-nnet3-latgen-incremental = library",
         ok and worst <= SERVE_COST_TOL, f"{worst:.2e}")
    # 10. the wake word: the first word of the first streamed path that
    # holds one (utterance 0's on the card)
    first = next((k for k in sorted(words) if words[k]), None)
    if first is None:
        raise AssertionError("20a: no utterance decodes to a word")
    wake = int(words[first][0])
    with torch.no_grad():
        lib = {}
        for k, (w, _r) in waves.items():
            hit = _stream(mfcc, net, dev, w, [SingleUtteranceDecoder(dense)],
                          wake=wake)
            lib[k] = [str(int(hit >= 0)), str(hit)]
    T("online2-wav-nnet3-wake-word-decoder-faster", dv,
      "--acoustic-scale=1.0", mdl, raw, fst, str(wake), f"ark:{d}/wav8.ark",
      f"ark,t:{d}/wake.txt")
    got = {k: list(v) for k, v in
           _serve_read(f"ark,t:{d}/wake.txt", "text").items()}
    held("wake-word = library", got == lib and got[first][0] == "1",
         f"{first} {got.get(first)} library {lib[first]}")
    rep["wake"] = {"word": wake, "utt": first,
                   "frame": int(got[first][1]),
                   "detected": sum(int(v[0]) for v in got.values())}
    return {k: [int(o) for o in v] for k, v in words.items()}


def serve_tcp(held, d, dev, words, rep, launches):
    """20b: online2-tcp-nnet3-decode-faster (a process of its own, one
    thread a connection) on 7d's files: SERVE_TCP_GROUP clients at once,
    twice, each streaming a waveform in SERVE_CHUNK_S sends at the pace
    of speech; each final hypothesis equal to the library's streamed
    words, each connection with a partial first; the reply latency of
    each partial from the send before it, the aggregate audio-s/s, the
    tool's fbank launches (its log)."""
    import re
    import socket
    import subprocess
    import threading
    from kaldi_tpu_torch.fst.fst import SymbolTable
    o2 = os.path.join(os.path.dirname(d), "chip_smoke_online2")
    repo = os.path.dirname(os.path.abspath(__file__))
    n_conn = 2 * SERVE_TCP_GROUP
    err = open(f"{d}/tcp.err", "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "kaldi_tpu_torch.cli",
         "online2-tcp-nnet3-decode-faster", f"--device={dev.type}",
         "--port-num=0", f"--max-connections={n_conn}", "--read-timeout=30",
         f"{o2}/final.mdl", f"{o2}/final.raw", f"{o2}/HCLG.fst",
         f"{d}/words300.txt"], cwd=repo, stdout=subprocess.PIPE,
        stderr=err, text=True)
    err.close()
    waves = _serve_read(f"ark:{d}/wav8.ark", "wav")
    keys = sorted(waves)
    step = 2 * int(SERVE_CHUNK_S * SAMP_FREQ)
    replies, lat_ms = {}, {0: [], 1: []}
    lock = threading.Lock()
    try:
        port = int(proc.stdout.readline())

        def client(k, group):
            pcm = _int16(waves[k][0]).tobytes()
            sends, got = [], []
            sock = socket.create_connection(("127.0.0.1", port),
                                            timeout=120)
            sock.settimeout(120)

            def reader():
                buf = b""
                while True:
                    data = sock.recv(4096)
                    if not data:
                        break
                    t = time.perf_counter()
                    got.extend([t] * data.count(b"\r"))
                    buf += data
                replies[k] = buf

            rt = threading.Thread(target=reader, daemon=True)
            rt.start()
            t0 = time.perf_counter()
            for i in range(0, len(pcm), step):
                sends.append(time.perf_counter())
                sock.sendall(pcm[i:i + step])
                time.sleep(max(0.0, t0 + len(sends) * SERVE_CHUNK_S
                               - time.perf_counter()))
            sock.shutdown(socket.SHUT_WR)
            rt.join(timeout=120)
            sock.close()
            with lock:
                lat_ms[group].extend(
                    1e3 * (t - max(s for s in sends if s <= t)) for t in got)

        t0 = time.perf_counter()
        for g in range(0, n_conn, SERVE_TCP_GROUP):
            ths = [threading.Thread(target=client,
                                    args=(k, g // SERVE_TCP_GROUP),
                                    daemon=True)
                   for k in keys[g:g + SERVE_TCP_GROUP]]
            for th in ths:
                th.start()
            for th in ths:
                th.join(timeout=300)
        wall = time.perf_counter() - t0
        proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    with open(f"{d}/tcp.err") as f:
        log_text = f.read()
    held("online2-tcp-nnet3-decode-faster exit 0", proc.returncode == 0,
         log_text[-300:] if proc.returncode else "")
    table = SymbolTable.read(f"{d}/words300.txt")
    for k in keys:
        r = replies.get(k, b"")
        parts = r[:-1].split(b"\r") if r.endswith(b"\n") else []
        want = " ".join(table.find(o) for o in words[k])
        held("tcp final = library", bool(parts)
             and parts[-1].decode() == want, "" if parts else k)
        held("tcp partial before the final", len(parts) > 1, "")
    m = re.findall(r"fbank kernel launches (\d+)", log_text)
    launches["fbank"]["online2-tcp-nnet3-decode-faster"] = \
        int(m[-1]) if m else 0
    audio = sum(len(waves[k][0]) for k in keys) / SAMP_FREQ
    rep["tcp"] = {"connections": n_conn, "audio_s": audio, "wall_s": wall,
                  "audio_s_per_s": audio / wall}
    # the first group meets a cold server (its first forwards and
    # kernel loads), the second a warm one
    for name, xs in (("all", lat_ms[0] + lat_ms[1]), ("warm", lat_ms[1])):
        rep["tcp"][name] = [len(xs)] + ([pctl(xs, 50), pctl(xs, 99)]
                                        if xs else [float("nan")] * 2)


def serve_big(T, held, d, dev, rep, walls, log_lines):
    """20c: nnet3-latgen-faster-batch (its beam branch, one batch of
    SERVE_BATCH) on phase 4/5's 20k HCLG with phase 5's TDNN-F on the
    40-bin fbank of SERVE_BATCH waveforms, nnet3-latgen-incremental on
    the same features and latgen-incremental-mapped on phase 4's
    log-likelihoods; each against the library on the card."""
    import re
    from kaldi_tpu_torch.am.serialize import read_mdl
    from kaldi_tpu_torch.cli.latgen import _load_hclg
    from kaldi_tpu_torch.cli.online2 import _load_tdnn
    from kaldi_tpu_torch.decoder.beam import BeamDecoder, BeamDecoderConfig
    from kaldi_tpu_torch.fst.csr import pack_fst
    from kaldi_tpu_torch.lattice.determinize import \
        determinize_lattice_pruned
    dv = f"--device={dev.type}"
    mdl, raw, fst = f"{d}/big.mdl", f"{d}/p5.raw", f"{d}/HCLG20k.fst"
    t0 = time.perf_counter()
    HCLG = _load_hclg(fst)
    rep["hclg20k_load_s"] = time.perf_counter() - t0
    rep["hclg20k_states"] = HCLG.num_states
    csr = pack_fst(HCLG)
    del HCLG
    tm, _ = read_mdl(mdl, device="cpu")
    _, net = _load_tdnn(raw, 3, dev)
    feats = _serve_read(f"ark:{d}/fbank32.ark", "mat")
    keys = sorted(feats)
    with torch.no_grad():
        scores = {k: net(torch.as_tensor(feats[k]).to(dev)[None])[0]
                  for k in keys}

    def cfg(**kw):
        return BeamDecoderConfig(beam=13.0, lattice_beam=7.0,
                                 acoustic_scale=1.0, max_active=7000,
                                 lattice_arcs_per_frame=14000, **kw)

    T("nnet3-latgen-faster-batch", dv, *SERVE_BIG,
      f"--batch-size={SERVE_BATCH}", mdl, raw, fst,
      f"ark:{d}/fbank32.ark", f"ark:{d}/batch.ark")
    m = re.search(r"decode ([0-9.]+) s", " ".join(
        ln for ln in log_lines() if "nnet3-latgen-faster-batch:" in ln))
    rep["batch_decode_s"] = float(m.group(1)) if m else float("nan")
    dec = BeamDecoder(csr, tm.tid_to_pdf_array, cfg(), device=dev)
    lens = np.array([scores[k].shape[0] for k in keys], np.int64)
    X = torch.zeros((len(keys), int(lens.max()), scores[keys[0]].shape[1]),
                    device=dev)
    for b, k in enumerate(keys):
        X[b, :lens[b]] = scores[k]
    want = {k: determinize_lattice_pruned(r, 7.0) for k, r in
            zip(keys, dec.decode_lattice_batch(X, lens))}
    got = _serve_read(f"ark:{d}/batch.ark", "clat")
    ok, worst = _best_diff(got, want)
    shapes = all(got[k].num_states == want[k].num_states
                 and got[k].num_arcs == want[k].num_arcs for k in want)
    held("nnet3-latgen-faster-batch = decode_lattice_batch",
         ok and shapes and worst <= SERVE_COST_TOL,
         f"{worst:.2e}{'' if shapes else ', shapes differ'}")
    rep["batch_frames"] = int(lens.sum())
    del dec, X
    # the incremental tools against the library's offline decode at
    # their decoder's settings
    inc = BeamDecoder(csr, tm.tid_to_pdf_array, cfg(record_capacity=16384),
                      device=dev)
    off = {k: determinize_lattice_pruned(inc.decode_lattice(scores[k]), 7.0)
           for k in keys}
    T("nnet3-latgen-incremental", dv, *SERVE_BIG, mdl, raw, fst,
      f"ark:{d}/fbank32.ark", f"ark:{d}/incr.ark")
    ok, worst = _best_diff(_serve_read(f"ark:{d}/incr.ark", "clat"), off)
    held("nnet3-latgen-incremental = offline",
         ok and worst <= SERVE_COST_TOL, f"{worst:.2e}")
    lls = _serve_read(f"ark:{d}/ll4.ark", "mat")
    off4 = {k: determinize_lattice_pruned(inc.decode_lattice(v), 7.0)
            for k, v in lls.items()}
    T("latgen-incremental-mapped", dv, *SERVE_BIG, mdl, fst,
      f"ark:{d}/ll4.ark", f"ark:{d}/incr4.ark")
    ok, worst = _best_diff(_serve_read(f"ark:{d}/incr4.ark", "clat"), off4)
    held("latgen-incremental-mapped = offline",
         ok and worst <= SERVE_COST_TOL, f"{worst:.2e}")


def _tri1_39(dev, d) -> tuple:
    """20d's model: tri1's tree and transition model with a GMM over the
    legacy tools' features (13 MFCCs of the 8 kHz waveforms, Δ+ΔΔ, no
    CMVN), estimated on the card from 10b's training waveforms and
    tri1's alignments (the gmm-init-model + gmm-acc-stats-ali + gmm-est
    steps of a feature change): one Gaussian a pdf, then
    SERVE_TRI1_ITERS EM iterations on those alignments, mixing up after
    each but the last, as train_deltas does, to tri1's Gaussian count
    (the last update may drop a Gaussian that no frame reaches).  → (the
    sample rate, its Gaussians, tri1's)."""
    from kaldi_tpu_torch.am.gmm import (AmDiagGmm, GmmAccs,
                                        accumulate_stats, mixup, mle_update)
    from kaldi_tpu_torch.am.serialize import read_mdl, write_mdl
    from kaldi_tpu_torch.features import DeltaFeaturesOptions, add_deltas
    from kaldi_tpu_torch.features.compute import Mfcc, MfccOptions
    from kaldi_tpu_torch.features.window import FrameExtractionOptions
    tm, tri1 = read_mdl(f"{d}/tri1.mdl", device="cpu")
    waves = _serve_read(f"ark:{d}/wav_tr8k.ark", "wav")
    alis = _serve_read(f"ark:{d}/ali_tr.ark", "ivec")
    rate = float(next(iter(waves.values()))[1])
    mfcc = Mfcc(MfccOptions(frame_opts=FrameExtractionOptions(
        samp_freq=rate, dither=0.0)), device=dev)
    feats, pdfs = [], []
    for u, (w, _r) in waves.items():
        if u in alis:
            f = add_deltas(mfcc.compute(np.asarray(w, np.float32)),
                           DeltaFeaturesOptions()).cpu().numpy()
            n = min(len(f), len(alis[u]))
            feats.append(f[:n])
            pdfs.append(tm.tid_to_pdf_array[np.asarray(alis[u][:n],
                                                       np.int64)])
    allf, allp = np.concatenate(feats), np.concatenate(pdfs)
    am = AmDiagGmm.flat_start(tm.num_pdfs, allf.mean(0), allf.var(0),
                              device=dev)
    target = tri1.num_gauss()
    for it in range(SERVE_TRI1_ITERS):
        accs = GmmAccs.zeros(am.num_pdfs, am.max_mix, am.dim)
        accumulate_stats(am, allf, allp, accs)
        mle_update(am, accs)
        n, left = am.num_gauss(), SERVE_TRI1_ITERS - 1 - it
        if left and n < target:
            am = mixup(am, n + math.ceil((target - n) / left), seed=it)
    write_mdl(f"{d}/tri1_39.mdl", tm, am)
    return rate, am.num_gauss(), target


def _stream_feats(mfcc, wave):
    """The features ``_gmm_stream`` scores for ``wave``: online MFCC +
    Δ+ΔΔ over the whole input."""
    from kaldi_tpu_torch.features.functions import DeltaFeaturesOptions
    from kaldi_tpu_torch.features.online import OnlineFeaturePipeline
    pipe = OnlineFeaturePipeline(mfcc, deltas=DeltaFeaturesOptions())
    pipe.accept_waveform(wave)
    pipe.input_finished()
    return pipe.get_frames(0, pipe.num_frames_ready())


def serve_gmm(T, held, d, dev, rep, walls, wers, text):
    """20d: online-wav-gmm-decode-faster, online-gmm-decode-faster,
    online2-wav-gmm-latgen-faster, the UDP server and client (one
    utterance after another) and the TCP audio server and clients (all
    at once) on 10b's tri1 graph and SERVE_GMM_WAVES test waveforms; each
    tool's words equal to the library's chunked stream
    (cli/tools_bank30.py ``_gmm_stream``) in this process."""
    import contextlib
    import io
    import socket
    import threading
    from kaldi_tpu_torch.cli import TOOLS
    from kaldi_tpu_torch.cli.online2 import online_mfcc
    from kaldi_tpu_torch.cli.tools_bank30 import (_gmm_online_setup,
                                                  _gmm_stream)
    from kaldi_tpu_torch.core.table import TableWriter
    from kaldi_tpu_torch.fst.fst import SymbolTable
    from kaldi_tpu_torch.pipelines.score import compute_wer
    t0 = time.perf_counter()
    rate, *rep["gauss_20d"] = _tri1_39(dev, d)
    walls["20d model"] = time.perf_counter() - t0
    dv = f"--device={dev.type}"
    mdl, fst, wtab = f"{d}/tri1_39.mdl", f"{d}/HCLG1.fst", f"{d}/words.txt"
    table = SymbolTable.read(wtab)
    _tm, am, dec = _gmm_online_setup(mdl, fst, 16.0, 0.1, dev)
    mfcc = online_mfcc(rate, dev)
    waves = _serve_read(f"ark:{d}/wav_te8k.ark", "wav")
    keys = sorted(waves)
    with torch.no_grad():
        lib = {k: [table.find(o) for o in _gmm_stream(
            am, dec, mfcc, waves[k][0], int(0.18 * rate))[0]] for k in keys}
        # both kernels at this path's shapes against their references:
        # the fbank kernel at 8 kHz and 23 bins, the GMM kernel at this
        # model on the features the streams score
        xs = [np.asarray(waves[k][0], np.float32) for k in keys]
        rep["fbank_err_20d"] = check_path_fbank(mfcc, xs, "serve: 20d")
        rep["gmm_err_20d"] = check_path_loglikes_f64(
            am, [_stream_feats(mfcc, x) for x in xs], "serve: 20d")
    wers["20d _gmm_stream"] = str(compute_wer({k: text[k] for k in keys},
                                              lib))

    def words_of(spec):
        return {k: list(v) for k, v in _serve_read(spec, "text").items()}

    T("online-wav-gmm-decode-faster", dv, f"--word-symbol-table={wtab}",
      mdl, fst, f"ark:{d}/wav_te8k.ark", f"ark,t:{d}/owg.txt",
      f"ark:{d}/owg.ali")
    held("online-wav-gmm-decode-faster = _gmm_stream",
         words_of(f"ark,t:{d}/owg.txt") == lib, "")
    with open(f"{d}/mic.raw", "wb") as f:
        f.write(_int16(waves[keys[0]][0]).tobytes())
    lines = T("online-gmm-decode-faster", dv, f"--samp-freq={rate}",
              f"--audio={d}/mic.raw", mdl, fst, wtab).strip().splitlines()
    held("online-gmm-decode-faster = _gmm_stream",
         bool(lines) and lines[-1].split() == lib[keys[0]], "")
    T("online2-wav-gmm-latgen-faster", dv, f"--sample-frequency={rate}",
      f"--word-symbol-table={wtab}", mdl, fst, f"ark:{d}/wav_te8k.ark",
      f"ark,t:{d}/o2g.txt")
    held("online2-wav-gmm-latgen-faster = _gmm_stream",
         words_of(f"ark,t:{d}/o2g.txt") == lib, "")
    for k in keys:
        with TableWriter(f"ark:{d}/one_{k}.ark", holder="wav") as w:
            w[k] = (_int16(waves[k][0]), waves[k][1])

    def free_port(kind):
        s = socket.socket(socket.AF_INET, kind)
        s.bind(("127.0.0.1", 0))
        p = s.getsockname()[1]
        s.close()
        return p

    def serve(name, argv, clients, concurrent) -> str:
        """The server ``name`` on a thread of this process and its
        clients (at once or in turn); the kernels' counts cover both
        (the clients launch none).  → what they printed."""
        holder = {}

        def target():
            try:
                holder["rc"] = TOOLS[name](argv)
            except BaseException as e:      # read below
                holder["error"] = e

        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            th = threading.Thread(target=target, daemon=True)
            th.start()
            time.sleep(1.0)
            if concurrent:
                cs = [threading.Thread(target=c, daemon=True)
                      for c in clients]
                for c in cs:
                    c.start()
                for c in cs:
                    c.join(timeout=120)
            else:
                for c in clients:
                    c()
            th.join(timeout=120)
        held(f"{name} exit 0", holder.get("rc") == 0 and not th.is_alive(),
             repr(holder.get("error", ""))[:200])
        return buf.getvalue()

    port = free_port(socket.SOCK_DGRAM)
    out = T("online-server-gmm-decode-faster", serve, [
        dv, f"--udp-port={port}", f"--samp-freq={rate}",
        f"--max-utterances={len(keys)}", mdl, fst, wtab],
        [lambda k=k: TOOLS["online-net-client"](
            ["127.0.0.1", str(port), f"ark:{d}/one_{k}.ark"])
         for k in keys], False)
    got = {ln.split()[0]: ln.split()[1:] for ln in out.splitlines()
           if ln.split() and ln.split()[0] in waves}
    held("UDP server = _gmm_stream", got == lib,
         "" if got == lib else f"{got} vs {lib}"[:300])
    port = free_port(socket.SOCK_STREAM)
    out = T("online-audio-server-decode-faster", serve, [
        dv, f"--port-num={port}", f"--samp-freq={rate}",
        f"--max-connections={len(keys)}", mdl, fst, wtab],
        [lambda k=k: TOOLS["online-audio-client"](
            ["127.0.0.1", str(port), f"ark:{d}/one_{k}.ark"])
         for k in keys], True)
    res = {ln.split()[0]: ln.split("RESULT:")[1].split()
           for ln in out.splitlines() if " RESULT:" in ln}
    n_words = {k: sum(1 for ln in out.splitlines()
                      if ln.startswith(f"{k} WORD:")) for k in keys}
    held("TCP audio server = _gmm_stream", res == lib and all(
        n_words[k] == len(lib[k]) for k in keys),
         "" if res == lib else f"{out} vs {lib}"[:300])


def serve_regtree(T, held, d, dev, rep, wers, text, utt2spk):
    """20e: on 10b's tri1 and SERVE_REGTREE_UTTS test utterances: the
    unadapted decode (gmm-latgen-faster) and its best paths as first-pass
    alignments, gmm-make-regtree, gmm-est-regtree-fmllr / -fmllr-ali per
    speaker, gmm-est-regtree-mllr per speaker and over all, the three
    regtree decodes with the fMLLR transforms, gmm-latgen-map, and
    gmm-rescore-lattice of the unadapted lattices with the MLLR-adapted
    model; each against the library on the card; WERs beside the
    unadapted decode's."""
    from kaldi_tpu_torch.am.gmm import (AmDiagGmm, GmmAccs,
                                        accumulate_stats, map_update)
    from kaldi_tpu_torch.am.regtree import (RegressionTree,
                                            RegtreeFmllrAccs,
                                            RegtreeMllrAccs, write_regtree)
    from kaldi_tpu_torch.am.serialize import read_mdl
    from kaldi_tpu_torch.am.transforms import apply_transform
    from kaldi_tpu_torch.cli.latgen import _LatgenDecoder, _load_hclg
    from kaldi_tpu_torch.core.table import TableWriter
    from kaldi_tpu_torch.decoder.dense import DenseDecoder, DenseDecoderConfig
    from kaldi_tpu_torch.fst.fst import SymbolTable
    from kaldi_tpu_torch.lattice.functions import state_times
    from kaldi_tpu_torch.pipelines.score import compute_wer
    dv = f"--device={dev.type}"
    mdl, fst, feats_spec = (f"{d}/tri1.mdl", f"{d}/HCLG1.fst",
                            f"ark:{d}/delta_te.ark")
    table = SymbolTable.read(f"{d}/words.txt")
    tm, am = read_mdl(mdl, device=dev)
    HCLG = _load_hclg(fst)
    feats = _serve_read(feats_spec, "mat")
    keys = sorted(feats)
    spk2utt = {}
    for u in keys:
        spk2utt.setdefault(utt2spk[u], []).append(u)
    with open(f"{d}/utt2spk", "w") as f:
        f.writelines(f"{u} {utt2spk[u]}\n" for u in keys)
    with open(f"{d}/spk2utt", "w") as f:
        f.writelines(f"{s} {' '.join(us)}\n" for s, us in spk2utt.items())
    refs = {u: text[u] for u in keys}

    def wer_of(hyps, name):
        wers[name] = str(compute_wer(refs, hyps))

    def clat_words(spec):
        return {k: [table.find(o) for o in c.best_path()[0]]
                for k, c in _serve_read(spec, "clat").items()}

    # the unadapted decode → first-pass alignments
    T("gmm-latgen-faster", dv, "--acoustic-scale=0.1", "--beam=16", mdl,
      fst, feats_spec, f"ark:{d}/lat0.ark")
    lats0 = _serve_read(f"ark:{d}/lat0.ark", "clat")
    wer_of(clat_words(f"ark:{d}/lat0.ark"), "20e unadapted gmm-latgen-faster")
    alis = {k: np.asarray(c.best_path()[1], np.int32)
            for k, c in lats0.items()}
    pdfs = {k: tm.tid_to_pdf_array[alis[k].astype(np.int64)] for k in keys}
    for s, us in list(spk2utt.items()) + [("all", keys)]:
        with TableWriter(f"ark:{d}/ali_{s}.ark", holder="ivec") as w:
            for u in us:
                w[u] = alis[u]
    # the tree (the estimators build their own, as in the original)
    T("gmm-make-regtree", "--max-leaves=4", mdl, f"{d}/regtree")
    write_regtree(f"{d}/regtree.lib", RegressionTree.build(
        read_mdl(mdl, device="cpu")[1], num_base_classes=4))
    with open(f"{d}/regtree", "rb") as f, open(f"{d}/regtree.lib",
                                               "rb") as g:
        held("gmm-make-regtree = RegressionTree.build",
             f.read() == g.read(), "")
    tree = RegressionTree.build(am, 4)
    # fMLLR per speaker
    lib_tr = {}
    for s, us in spk2utt.items():
        accs = RegtreeFmllrAccs(tree, am.dim)
        for u in us:
            accs.accumulate(am, feats[u], pdfs[u])
        lib_tr[s] = accs.estimate(min_count=SERVE_MIN_COUNT) \
            .root_transform().astype(np.float32)
    for name in ("gmm-est-regtree-fmllr", "gmm-est-regtree-fmllr-ali"):
        T(name, dv, f"--min-count={SERVE_MIN_COUNT}",
          f"--spk2utt=ark,t:{d}/spk2utt", mdl, feats_spec,
          f"ark:{d}/ali_all.ark", f"ark:{d}/{name}.ark")
        got = _serve_read(f"ark:{d}/{name}.ark", "mat")
        err = max(_rel(got[s], lib_tr[s]) for s in lib_tr) \
            if sorted(got) == sorted(lib_tr) else float("inf")
        held(f"{name} = RegtreeFmllrAccs", err <= 1e-6, f"{err:.2e}")
    # MLLR per speaker and over all
    for s, us in list(spk2utt.items()) + [("all", keys)]:
        T("gmm-est-regtree-mllr", dv, f"--min-count={SERVE_MIN_COUNT}", mdl,
          feats_spec, f"ark:{d}/ali_{s}.ark", f"{d}/mllr_{s}.mdl")
        accs = RegtreeMllrAccs(tree, am.dim)
        for u in us:
            accs.accumulate(am, feats[u], pdfs[u])
        want = accs.estimate(min_count=SERVE_MIN_COUNT).transform_model(am)
        err = _rel(read_mdl(f"{d}/mllr_{s}.mdl", device="cpu")[1].means,
                   want.means)
        held("gmm-est-regtree-mllr = RegtreeMllrAccs", err <= 1e-6,
             f"{s} {err:.2e}")
    # the regtree decodes with the fMLLR transforms
    trans = f"ark:{d}/gmm-est-regtree-fmllr.ark"
    dense = DenseDecoder(HCLG, tm.tid_to_pdf_array,
                         DenseDecoderConfig(beam=16.0, acoustic_scale=0.1),
                         device=dev)
    xs = {u: apply_transform(torch.as_tensor(feats[u]).to(dev),
                             lib_tr[utt2spk[u]]).contiguous() for u in keys}
    lib_words = {u: [table.find(o) for o in
                     dense.decode(am.loglikes(xs[u]))[1]] for u in keys}
    for name in ("gmm-decode-faster-regtree-fmllr",
                 "gmm-decode-faster-regtree-mllr"):
        T(name, dv, f"--utt2spk=ark,t:{d}/utt2spk",
          f"--word-symbol-table={d}/words.txt", mdl, fst, trans, feats_spec,
          f"ark,t:{d}/{name}.txt")
        got = {k: list(v) for k, v in
               _serve_read(f"ark,t:{d}/{name}.txt", "text").items()}
        held(f"{name} = library", got == lib_words, "")
        wer_of(got, f"20e {name}")
    T("gmm-latgen-faster-regtree-fmllr", dv, "--beam=16",
      f"--utt2spk=ark,t:{d}/utt2spk", mdl, fst, trans, feats_spec,
      f"ark:{d}/lat_fmllr.ark")
    lat = _LatgenDecoder(HCLG, tm.tid_to_pdf_array, 16.0, 6.0, 0.1,
                         device=dev)
    ok, worst = _best_diff(_serve_read(f"ark:{d}/lat_fmllr.ark", "clat"),
                           {u: lat.decode_to_clat(am.loglikes(xs[u]))
                            for u in keys})
    held("gmm-latgen-faster-regtree-fmllr = library",
         ok and worst <= SERVE_COST_TOL, f"{worst:.2e}")
    wer_of(clat_words(f"ark:{d}/lat_fmllr.ark"),
           "20e gmm-latgen-faster-regtree-fmllr")
    # MAP, a model a speaker
    T("gmm-latgen-map", dv, "--mean-tau=10", f"--utt2spk=ark,t:{d}/utt2spk",
      mdl, fst, feats_spec, f"ark:{d}/ali_all.ark", f"ark:{d}/lat_map.ark")
    lat13 = _LatgenDecoder(HCLG, tm.tid_to_pdf_array, 13.0, 6.0, 0.1,
                           device=dev)
    want = {}
    for s, us in spk2utt.items():
        accs = GmmAccs.zeros(am.num_pdfs, am.max_mix, am.dim)
        for u in us:
            accumulate_stats(am, feats[u], pdfs[u], accs)
        adapted = AmDiagGmm(am.weights, am.means, am.vars, device=dev)
        map_update(adapted, accs, mean_tau=10.0)
        for u in us:
            want[u] = lat13.decode_to_clat(adapted.loglikes(feats[u]))
    ok, worst = _best_diff(_serve_read(f"ark:{d}/lat_map.ark", "clat"),
                           want)
    held("gmm-latgen-map = library", ok and worst <= SERVE_COST_TOL,
         f"{worst:.2e}")
    wer_of(clat_words(f"ark:{d}/lat_map.ark"), "20e gmm-latgen-map")
    # the unadapted lattices rescored with the MLLR-adapted model
    T("gmm-rescore-lattice", dv, f"{d}/mllr_all.mdl", f"ark:{d}/lat0.ark",
      feats_spec, f"ark:{d}/lat_rescored.ark")
    _, mam = read_mdl(f"{d}/mllr_all.mdl", device=dev)
    rep["gmm_err_20e"] = check_path_loglikes_f64(
        mam, [feats[k] for k in keys], "serve: 20e MLLR-adapted tri1")
    worst = 0.0
    for k, c in _serve_read(f"ark:{d}/lat_rescored.ark", "clat").items():
        ll = mam.loglikes(feats[k]).cpu().numpy().astype(np.float64)
        times = state_times(c)
        for st in range(c.num_states):
            for a in c.arcs[st]:
                t = times[st] + np.arange(len(a.tids))
                ac = -ll[t, tm.tid_to_pdf_array[np.asarray(
                    a.tids, np.int64)]].sum() if len(a.tids) else 0.0
                worst = max(worst, abs(a.acoustic_cost - ac)
                            / max(1.0, abs(ac)))
    held("gmm-rescore-lattice = the adapted model's log-likelihoods",
         worst <= 1e-6, f"{worst:.2e}")
    wer_of(clat_words(f"ark:{d}/lat_rescored.ark"),
           "20e gmm-rescore-lattice (MLLR over all)")
    rep["regtree"] = {"utts": len(keys), "speakers": len(spk2utt)}


def serve_tools_worker(argv) -> int:
    """20's background process: 20a–20e in turn, every tool a call of the
    port's registry in this process (20b's server a process of its own),
    each held against the library on the same card, the fbank and GMM
    kernels' counts set to 0 before each call and read after it.  Writes
    ``report.json`` into the directory; exits 1 if a check fails."""
    import contextlib
    import io
    import pickle
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import kaldi_tpu_torch.features  # noqa: F401  (before ops.fbank)
    from kaldi_tpu_torch.cli import TOOLS
    from kaldi_tpu_torch.ops.fbank import CudaFbank
    from kaldi_tpu_torch.ops.gmm import CudaGmm
    t_start = time.perf_counter()
    d, dv = argv[0], argv[1]
    dev = torch.device(dv, 0) if dv == "cuda" else torch.device(dv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with open(f"{d}/inputs.pkl", "rb") as f:
        inp = pickle.load(f)
    calls, checks, walls, wers, rep = [], [], {}, {}, {}
    launches = {"gmm": {}, "fbank": {}}
    tap = _LogTap()

    def T(name, *args):
        """Tool ``name`` (or, with a callable first, ``serve(name, ...)``
        for a server and its clients), its kernel launches counted and
        its wall added up; → what it printed."""
        out = io.StringIO()
        CudaGmm.total_launches = CudaFbank.total_launches = 0
        t0 = time.perf_counter()
        with tap:
            if args and callable(args[0]):
                out.write(args[0](name, *args[1:]))
                rc = 0
            else:
                with contextlib.redirect_stdout(out):
                    rc = TOOLS[name]([str(a) for a in args])
        walls[name] = walls.get(name, 0.0) + time.perf_counter() - t0
        for k, n in (("gmm", CudaGmm.total_launches),
                     ("fbank", CudaFbank.total_launches)):
            launches[k][name] = launches[k].get(name, 0) + n
        if rc:
            raise AssertionError(f"{name}: rc {rc}")
        calls.append(name)
        return out.getvalue()

    def held(name, ok, detail):
        checks.append((name, bool(ok), detail))

    t0 = time.perf_counter()
    words = serve_nnet3(T, held, d, dev, rep)
    walls["20a"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    serve_tcp(held, d, dev, words, rep, launches)
    calls.append("online2-tcp-nnet3-decode-faster")
    walls["20b"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    serve_big(T, held, d, dev, rep, walls, lambda: tap.lines)
    walls["20c"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    serve_gmm(T, held, d, dev, rep, walls, wers, inp["text_te"])
    walls["20d"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    serve_regtree(T, held, d, dev, rep, wers, inp["text_te"],
                  inp["utt2spk"])
    walls["20e"] = time.perf_counter() - t0
    with open(f"{d}/report.json", "w") as f:
        json.dump({"walls": walls, "wers": wers, "checks": checks,
                   "calls": len(calls), "tools": sorted(set(calls)),
                   "launches": launches, "inputs": {
                       k: v for k, v in inp.items()
                       if k not in ("text_te", "utt2spk")},
                   "total": time.perf_counter() - t_start, **rep}, f,
                  default=float)
    bad = [c for c in checks if not c[1]]
    if bad:
        print(f"serve tools: {len(bad)} checks failed: {bad[:5]}",
              file=sys.stderr)
        return 1
    return 0


def serve_tools_finish(started, tag: str, p4_rate: float):
    """20, joined before the kernels line: the worker's exit, its checks,
    the kernels' launches in the tools (fbank: SERVE_FBANK_TOOLS, GMM:
    SERVE_GMM_TOOLS), the TCP server's reply latency and audio-s/s, the
    batched decode's audio-s/s beside phase 4's, each WER; the worker's
    wall and the main process's wait here.  → (fbank launches, GMM
    launches, the fbank kernel's max |diff| from its plain version at
    20d's MFCC, the GMM kernel's from float64 at 20d's and 20e's
    models)."""
    proc, d, t0 = started
    t_wait = time.perf_counter()
    proc.wait(timeout=SERVE_JOIN)
    wait = time.perf_counter() - t_wait
    wall = time.perf_counter() - t0
    with open(f"{d}/worker.err") as f:
        err = f.read()
    if proc.returncode != 0 or not os.path.exists(f"{d}/report.json"):
        raise AssertionError(f"serve tools failed ({proc.returncode}):\n"
                             f"{err[-3000:]}")
    with open(f"{d}/report.json") as f:
        rep = json.load(f)
    fb = sum(rep["launches"]["fbank"].get(n, 0) for n in SERVE_FBANK_TOOLS)
    gm = sum(rep["launches"]["gmm"].get(n, 0) for n in SERVE_GMM_TOOLS)
    by = {}
    for name, ok, detail in rep["checks"]:
        n, k, det = by.get(name, (0, 0, []))
        by[name] = (n + 1, k + int(ok), det + ([detail] if detail else []))
    print(f"serve: {rep['calls']} tool calls of {len(rep['tools'])} tools "
          f"in one background process started after 10b: {wall:.1f} s to "
          f"the join ({rep['total']:.1f} s of work after its imports); the "
          f"main process waited {wait:.1f} s here {tag}")
    for name, (n, k, det) in by.items():
        print(f"serve:   {name}: {k} of {n} held"
              + (f" ({'; '.join(det[:2])})" if det else ""))
    w = rep["wake"]
    print(f"serve: 20a: looped scores within {rep['looped_err']:.2e} of the "
          f"offline forward; wake word {w['word']} detected in "
          f"{w['detected']} of {SERVE_WAVES} utterances ({w['utt']}'s "
          f"first word; there at frame {w['frame']})")
    tcp = rep["tcp"]
    print(f"serve: 20b: online2-tcp-nnet3-decode-faster, "
          f"{tcp['connections']} connections {SERVE_TCP_GROUP} at a time, "
          f"{SERVE_CHUNK_S} s sends at the pace of speech: reply latency "
          f"p50 {tcp['all'][1]:.3f} ms, p99 {tcp['all'][2]:.3f} ms over "
          f"{tcp['all'][0]} partials (the second group, on a warm server: "
          f"p50 {tcp['warm'][1]:.3f} ms, p99 {tcp['warm'][2]:.3f} ms over "
          f"{tcp['warm'][0]}); {tcp['audio_s']:.2f} s of audio in "
          f"{tcp['wall_s']:.2f} s = {tcp['audio_s_per_s']:.2f} audio-s/s "
          f"aggregate; fbank launches "
          f"{rep['launches']['fbank'].get('online2-tcp-nnet3-decode-faster')}"
          f" (the server's log) {tag}")
    inp = rep["inputs"]
    audio = inp["audio_batch_s"]
    call = rep["walls"]["nnet3-latgen-faster-batch"]
    print(f"serve: 20c: the 20k HCLG ({rep['hclg20k_states']} states) "
          f"written in {inp['hclg20k_write_s']:.2f} s, read in "
          f"{rep['hclg20k_load_s']:.2f} s; nnet3-latgen-faster-batch "
          f"--batch-size={SERVE_BATCH} on {audio:.2f} s of audio "
          f"({rep['batch_frames']} frames): decode "
          f"{rep['batch_decode_s']:.3f} s = "
          f"{audio / rep['batch_decode_s']:.1f} audio-s/s (its log), whole "
          f"call {call:.2f} s = {audio / call:.1f} audio-s/s; phase 4's "
          f"{p4_rate:.1f} audio-s/s {tag}")
    for name, v in rep["wers"].items():
        print(f"serve:   {name}: {v}")
    print("serve: walls " + ", ".join(f"{n} {v:.1f} s" for n, v in
                                      rep["walls"].items()))
    print(f"serve: fbank kernel launches {fb} ({len(SERVE_FBANK_TOOLS)} "
          f"streaming tools), GMM kernel launches {gm} (20d's and 20e's "
          f"tools) {tag}")
    with open(f"{d}/worker.out") as f:      # the kernels' checks' lines
        print("".join(ln for ln in f if ln.startswith("serve: 20")),
              end="")
    gm_err = max(rep["gmm_err_20d"], rep["gmm_err_20e"])
    print(f"serve: 20d's GMM {rep['gauss_20d'][0]} Gaussians (tri1 "
          f"{rep['gauss_20d'][1]}); fbank kernel vs plain max |diff| "
          f"{rep['fbank_err_20d']:.3e}; GMM kernel vs float64 max |diff| "
          f"20d {rep['gmm_err_20d']:.3e}, 20e {rep['gmm_err_20e']:.3e}")
    bad = [c for c in rep["checks"] if not c[1]]
    if bad:
        raise AssertionError(f"20: {len(bad)} checks failed: {bad[:3]}")
    if min(fb, gm) <= 0:
        raise AssertionError(f"20: launches fbank {fb}, GMM {gm}")
    return fb, gm, rep["fbank_err_20d"], gm_err


# ---------------------------------------------------------------------------
# 21. Kaldi's nnet2 models as the port's tools: p-norm networks, priors,
# mix-up, raw nets, the nnet2 decodes and alignment, the online2 nnet2
# streaming tools and the model tools, on 7d's task and 20's waveforms
# ---------------------------------------------------------------------------

NNET2_DIR = os.path.join("build", "chip_smoke_nnet2")
# egs/librispeech/s5/local/online/run_nnet2.sh (train_multisplice_accel2.sh):
# 6 hidden layers of p-norm 3500 → 350, the softmax mixed up to 12,000 rows;
# cut to the tools' 13 MFCCs and one input splice of ±2
NNET2_LAYERS = 6
NNET2_PNORM_IN = 3500
NNET2_PNORM_OUT = 350
NNET2_MIX = 12000
NNET2_WIDEN = 3850         # 21e's nnet-am-widen: one more group of 350
NNET2_RANK = 100           # 21e's nnet-am-limit-rank --dim
NNET2_SRAND = 21
NNET2_THREADS = 4          # -parallel's and -threaded's threads
NNET2_EG_FRAMES = 8        # 21e's egs: chunks of this many frames
# 21c's decode: a seeded model's outputs barely move from frame to
# frame, so its lattices at the tools' acoustic scale 0.1 and lattice
# beam 6 determinize out of the host's memory; at scale 10 and lattice
# beam 2 they stay small
NNET2_LAT = ("--beam=13", "--lattice-beam=2", "--acoustic-scale=10.0")
NNET2_COST_TOL = 1e-4      # best-path costs, relative
NNET2_JOIN = 600           # the main process's longest wait, seconds
NNET2_FBANK_TOOLS = ("online2-wav-nnet2-am-compute",
                     "online2-wav-nnet2-latgen-faster",
                     "online2-wav-nnet2-latgen-threaded")


def nnet2_tools_write(task300) -> str:
    """21's inputs beside 20's (the waveforms in build/chip_smoke_serve,
    7d's .mdl and HCLG in build/chip_smoke_online2): the training graphs
    of 20's 8 waveforms' reference sentences.  → the directory."""
    from kaldi_tpu_torch.core.table import TableWriter
    from kaldi_tpu_torch.decoder.training_graph import TrainingGraphCompiler
    from kaldi_tpu_torch.fst.lang import Lang, Lexicon
    repo = os.path.dirname(os.path.abspath(__file__))
    d = os.path.join(repo, NNET2_DIR)
    os.makedirs(d, exist_ok=True)
    for stale in ("report.json", "worker.out", "worker.err"):
        if os.path.exists(f"{d}/{stale}"):
            os.remove(f"{d}/{stale}")
    refs = speech_set(task300, SERVE_WAVES, SEED + 8)[2]
    lang = Lang(Lexicon(entries=list(task300.entries)))
    if any(lang.phones.find(i) != task300.phones.find(i)
           for i in range(len(lang.phone_list()) + 1)):
        raise AssertionError("21: the lexicon's phone ids differ")
    comp = TrainingGraphCompiler(lang, task300.tm)
    with TableWriter(f"ark:{d}/graphs8.ark", holder="fst") as w:
        for i, r in enumerate(refs):
            w[f"utt{i}"] = comp.compile_text(r)
    return d


def nnet2_tools_start(d: str, dev):
    """21, started: ``python3 chip_smoke.py --nnet2-tools <dir> <device>``
    (``nnet2_tools_worker``) in the background, two host threads.  →
    (process, dir, start time)."""
    import subprocess
    repo = os.path.dirname(os.path.abspath(__file__))
    out = open(f"{d}/worker.out", "w")
    err = open(f"{d}/worker.err", "w")
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--nnet2-tools", d,
         dev.type], cwd=repo, stdout=out, stderr=err,
        env=dict(os.environ, OMP_NUM_THREADS="2"))
    out.close()
    err.close()
    return proc, d, time.perf_counter()


def _leaf_diff(a, b) -> float:
    """The largest |a - b| over two parameter trees' leaves, relative to
    the larger of 1 and the leaf's largest |b| (inf when they differ in
    keys or shapes)."""
    from kaldi_tpu_torch.am.nnet2 import tree_leaves
    la, lb = dict(tree_leaves(a)), dict(tree_leaves(b))
    if sorted(la) != sorted(lb):
        return float("inf")
    return max(_rel(la[k], lb[k]) for k in lb)


def nnet2_make(T, held, d, dev, feats, P, rep):
    """21a: init → posteriors → priors → mix-up → info / raw conversion.
    → (the priors' model tree, its priors)."""
    from kaldi_tpu_torch.am.nnet2 import (load_nnet2_full, nnet2_model,
                                          tree_leaves)
    from kaldi_tpu_torch.am.raw_nnet import load_raw_nnet
    from kaldi_tpu_torch.core import io as kio
    dv = f"--device={dev.type}"
    T("nnet-am-init", "--feat-dim=13", f"--num-pdfs={P}",
      f"--num-hidden-layers={NNET2_LAYERS}",
      f"--pnorm-input-dim={NNET2_PNORM_IN}",
      f"--pnorm-output-dim={NNET2_PNORM_OUT}", f"--srand={NNET2_SRAND}",
      f"{d}/init.mdl")
    p0, cfg0, pri0 = load_nnet2_full(f"{d}/init.mdl")
    n_params = sum(np.asarray(v).size for _k, v in tree_leaves(p0))
    scale_ok = all(
        (not v.any()) if k[-1] == "bias" else
        0.7 < float(np.std(v)) * math.sqrt(v.shape[0]) < 1.3
        for k, v in tree_leaves(p0))
    held("nnet-am-init: the recipe's width, zero biases, lecun scale",
         cfg0.num_hidden_layers == NNET2_LAYERS and pri0 is None
         and scale_ok, f"{n_params} parameters")
    rep["init_params"] = n_params
    T("nnet-am-compute", dv, f"{d}/init.mdl", f"ark:{d}/feats8.ark",
      f"ark:{d}/post.ark")
    post = _serve_read(f"ark:{d}/post.ark", "mat")
    model = nnet2_model(p0, cfg0, dev)
    with torch.no_grad():
        err = max(_rel(post[k], model(x[None])[0].cpu())
                  for k, x in feats.items())
    held("nnet-am-compute = Nnet2Model", err <= SERVE_SCORE_TOL,
         f"{err:.2e}")
    counts = sum(np.exp(np.asarray(v, np.float64)).sum(0)
                 for v in post.values())
    with kio.open_wxfilename(f"{d}/counts.vec") as f:
        kio.init_kaldi_output_stream(f)
        kio.write_vector(f, counts)
    T("nnet-adjust-priors", f"{d}/init.mdl", f"{d}/counts.vec",
      f"{d}/pri.mdl")
    p1, cfg1, pri1 = load_nnet2_full(f"{d}/pri.mdl")
    c32 = np.asarray(counts, np.float32).astype(np.float64)
    want = (c32 + 0.5) / (c32.sum() + 0.5 * P)
    held("nnet-adjust-priors: (counts + 0.5) / (N + P / 2)",
         _rel(pri1, want) <= 1e-6 and _leaf_diff(p1, p0) == 0.0,
         f"{_rel(pri1, want):.2e}")
    T("nnet-am-mixup", f"--num-mixtures={NNET2_MIX}",
      f"--srand={NNET2_SRAND}", f"{d}/pri.mdl", f"{d}/final.mdl")
    p2, cfg2, pri2 = load_nnet2_full(f"{d}/final.mdl")
    rows = np.bincount(np.asarray(cfg2.mix2pdf), minlength=P)
    held("nnet-am-mixup: 12,000 rows, every pdf one or more, priors kept",
         len(cfg2.mix2pdf) == NNET2_MIX and rows.min() >= 1
         and np.array_equal(pri2, pri1)
         and np.asarray(p2["output_affine"]["kernel"]).shape
         == (NNET2_PNORM_OUT, NNET2_MIX),
         f"rows a pdf {rows.min()}–{rows.max()}")
    out = T("nnet-am-info", f"{d}/final.mdl")
    held("nnet-am-info", f"num-hidden-layers {NNET2_LAYERS}" in out
         and f"pnorm-input-dim {NNET2_PNORM_IN}" in out, "")
    T("nnet-to-raw-nnet", f"{d}/pri.mdl", f"{d}/pri.raw")
    out = T("raw-nnet-info", f"{d}/pri.raw")
    comps = load_raw_nnet(f"{d}/pri.raw")
    held("nnet-to-raw-nnet / raw-nnet-info",
         len(comps) == 3 * NNET2_LAYERS + 3
         and f"num-components {len(comps)}" in out
         and f"num-parameters {n_params}" in out, out.splitlines()[-1])
    rep["mix_rows"] = [int(rows.min()), int(rows.max())]
    return p1, pri1


def nnet2_forward(T, held, d, dev, feats, rep):
    """21b: nnet2-compute, nnet-am-compute --divide-by-priors and the raw
    net's forward against the library.  → (the mixed-up model's
    log-priors on the card, its log-posteriors per utterance there)."""
    from kaldi_tpu_torch.am.nnet2 import (load_nnet2_full, log_priors,
                                          nnet2_model)
    from kaldi_tpu_torch.am.raw_nnet import forward, load_raw_nnet
    dv = f"--device={dev.type}"
    params, cfg, pri = load_nnet2_full(f"{d}/final.mdl")
    model = nnet2_model(params, cfg, dev)
    logpri = torch.from_numpy(log_priors(pri)).to(dev)
    with torch.no_grad():
        lib = {k: model(x[None])[0] for k, x in feats.items()}
    T("nnet2-compute", dv, f"{d}/final.mdl", f"ark:{d}/feats8.ark",
      f"ark:{d}/nc.ark")
    got = _serve_read(f"ark:{d}/nc.ark", "mat")
    err = max(_rel(got[k], lib[k].cpu()) for k in lib)
    held("nnet2-compute = Nnet2Model (mixed up)", err <= SERVE_SCORE_TOL,
         f"{err:.2e}")
    T("nnet-am-compute", dv, "--divide-by-priors=true", f"{d}/final.mdl",
      f"ark:{d}/feats8.ark", f"ark:{d}/amc.ark")
    got = _serve_read(f"ark:{d}/amc.ark", "mat")
    err = max(_rel(got[k], (lib[k] - logpri).cpu()) for k in lib)
    held("nnet-am-compute --divide-by-priors = Nnet2Model - log priors",
         err <= SERVE_SCORE_TOL, f"{err:.2e}")
    T("nnet2-compute", dv, f"{d}/pri.mdl", f"ark:{d}/feats8.ark",
      f"ark:{d}/ncp.ark")
    got = _serve_read(f"ark:{d}/ncp.ark", "mat")
    comps = load_raw_nnet(f"{d}/pri.raw")
    err = max(_rel(got[k], forward(comps, x, dev).cpu())
              for k, x in feats.items())
    held("raw_nnet.forward of nnet-to-raw-nnet = nnet2-compute",
         err <= SERVE_SCORE_TOL, f"{err:.2e}")
    rep["forward_err"] = err
    return logpri, lib


def _best_rel(got, want):
    """Two CompactLattice tables → (keys and best words equal, the
    largest best-path cost difference relative to the larger of 1 and
    the cost)."""
    if sorted(got) != sorted(want):
        return False, float("inf")
    ok, worst = True, 0.0
    for k in want:
        gw, _, gc = got[k].best_path()
        ww, _, wc = want[k].best_path()
        ok &= list(gw) == list(ww)
        worst = max(worst, abs(gc - wc) / max(1.0, abs(wc)))
    return ok, worst


def nnet2_decode(T, held, d, dev, logpri, lib, rep):
    """21c: nnet-latgen-faster and -parallel against the library's
    decode + determinization of the same pseudo-log-likelihoods;
    nnet-align-compiled against DenseAligner.  → the alignments."""
    from kaldi_tpu_torch.am.serialize import read_mdl
    from kaldi_tpu_torch.cli.latgen import _LatgenDecoder, _load_hclg
    from kaldi_tpu_torch.decoder.align import (DenseAligner, in_degrees,
                                               pack_dense_reverse)
    o2 = os.path.join(os.path.dirname(d), "chip_smoke_online2")
    dv = f"--device={dev.type}"
    tm, _ = read_mdl(f"{o2}/final.mdl", device="cpu")
    HCLG = _load_hclg(f"{o2}/HCLG.fst")
    lat = _LatgenDecoder(HCLG, tm.tid_to_pdf_array, 13.0, 2.0, 10.0,
                         device=dev)
    want = {k: lat.decode_to_clat(v - logpri) for k, v in lib.items()}
    got = {}
    for name, extra in (("nnet-latgen-faster", ()),
                        ("nnet-latgen-faster-parallel",
                         (f"--num-threads={NNET2_THREADS}",))):
        T(name, dv, *NNET2_LAT, *extra, f"{o2}/final.mdl", f"{d}/final.mdl",
          f"{o2}/HCLG.fst", f"ark:{d}/feats8.ark", f"ark:{d}/{name}.ark")
        got[name] = _serve_read(f"ark:{d}/{name}.ark", "clat")
        ok, worst = _best_rel(got[name], want)
        held(f"{name} = library decode of Nnet2Model - log priors",
             ok and worst <= NNET2_COST_TOL, f"{worst:.2e}")
    ok, worst = _best_rel(got["nnet-latgen-faster-parallel"],
                          got["nnet-latgen-faster"])
    held("nnet-latgen-faster-parallel = nnet-latgen-faster",
         ok and worst <= NNET2_COST_TOL, f"{worst:.2e}")
    rep["lattice_states"] = sum(c.num_states for c in
                                got["nnet-latgen-faster"].values())
    # alignment of the reference sentences
    T("nnet-align-compiled", dv, f"{o2}/final.mdl", f"{d}/final.mdl",
      f"ark:{d}/graphs8.ark", f"ark:{d}/feats8.ark", f"ark:{d}/ali.ark")
    ali = _serve_read(f"ark:{d}/ali.ark", "ivec")
    graphs = _serve_read(f"ark:{d}/graphs8.ark", "fst")
    ae = an = smax = 1
    for g in graphs.values():
        e, n = in_degrees(g)
        ae, an, smax = max(ae, e), max(an, n), max(smax, g.num_states)
    aligner = DenseAligner(tm.tid_to_pdf_array, acoustic_scale=0.1,
                           device=dev)
    same = sorted(ali) == sorted(lib)
    for k in lib:
        (tids, _c), = aligner.align_batch(
            [pack_dense_reverse(graphs[k], smax, ae, an)], [lib[k] - logpri])
        same &= k in ali and list(ali[k]) == list(tids)
    held("nnet-align-compiled = DenseAligner", same, f"{len(ali)} utts")
    return tm, ali


def nnet2_online(T, held, d, dev, logpri, rep, audio_s, tm):
    """21d: online2-wav-nnet2-am-compute's rows against the offline
    forward of the same MFCCs (nnet2-compute's), the two online2 decodes'
    words against each other and the offline decode of the streamed
    scores; audio-s/s of each."""
    from kaldi_tpu_torch.cli.latgen import _load_hclg
    from kaldi_tpu_torch.decoder.dense import DenseDecoder, DenseDecoderConfig
    o2 = os.path.join(os.path.dirname(d), "chip_smoke_online2")
    sv = os.path.join(os.path.dirname(d), "chip_smoke_serve")
    dv = f"--device={dev.type}"
    T("online2-wav-nnet2-am-compute", dv, f"{d}/final.mdl",
      f"ark:{sv}/wav8.ark", f"ark:{d}/oam.ark")
    got = _serve_read(f"ark:{d}/oam.ark", "mat")
    want = _serve_read(f"ark:{d}/nc.ark", "mat")
    err = max(_rel(got[k], want[k]) for k in want)
    held("online2-wav-nnet2-am-compute = the offline forward",
         err <= SERVE_SCORE_TOL, f"{err:.2e}")
    rep["stream_err"] = err
    words = {}
    for name, extra in (("online2-wav-nnet2-latgen-faster", ()),
                        ("online2-wav-nnet2-latgen-threaded",
                         (f"--num-threads={NNET2_THREADS}",))):
        T(name, dv, *extra, f"{o2}/final.mdl", f"{d}/final.mdl",
          f"{o2}/HCLG.fst", f"ark:{sv}/wav8.ark", f"ark,t:{d}/{name}.txt")
        words[name] = {k: list(v) for k, v in _serve_read(
            f"ark,t:{d}/{name}.txt", "text").items()}
    dec = DenseDecoder(_load_hclg(f"{o2}/HCLG.fst"), tm.tid_to_pdf_array,
                       DenseDecoderConfig(beam=15.0, acoustic_scale=0.1),
                       device=dev)
    offline = {}
    for k, v in got.items():
        _t, ols, _c = dec.decode(torch.from_numpy(v).to(dev) - logpri)
        offline[k] = [str(o) for o in ols]
    a, b = (words[n] for n in ("online2-wav-nnet2-latgen-faster",
                               "online2-wav-nnet2-latgen-threaded"))
    held("online2-wav-nnet2-latgen-threaded = -faster", a == b,
         f"{sum(map(len, a.values()))} words")
    held("online2-wav-nnet2-latgen-faster = the offline decode of the "
         "streamed scores", a == offline, "")
    rep["audio_s"] = audio_s


def nnet2_model_tools(T, held, d, dev, feats, p1, pri1, tm, ali):
    """21e: every model tool once on the full-width model, its file read
    back and held against the library operation (forwards on the
    card)."""
    import dataclasses
    from kaldi_tpu_torch.am.nnet2 import (layer_names, load_nnet2_full,
                                          nnet2_model, save_nnet2, tree_leaves,
                                          tree_map)
    from kaldi_tpu_torch.am.raw_nnet import load_raw_nnet
    from kaldi_tpu_torch.am.serialize import (read_transition_model,
                                              write_transition_model)
    from kaldi_tpu_torch.am.tdnn import splice
    from kaldi_tpu_torch.cli.tools_bank26 import compute_prob
    from kaldi_tpu_torch.core import io as kio
    from kaldi_tpu_torch.core.table import SequentialTableReader, TableWriter
    from kaldi_tpu_torch.pipelines.egs_io import XentEg
    dv = f"--device={dev.type}"
    pf, cfgf, prif = load_nnet2_full(f"{d}/final.mdl")
    x0 = feats[sorted(feats)[0]]

    def raw(path):
        with open(path, "rb") as f:
            return f.read()

    def runs(path, params, cfg):
        """The tool's file on the card against ``params``: equal trees,
        and its forward on one utterance against the library model of
        ``params`` (relative error)."""
        got, gcfg, _ = load_nnet2_full(path)
        with torch.no_grad():
            a = nnet2_model(got, gcfg, dev)(x0[None])[0]
            b = nnet2_model(params, cfg, dev)(x0[None])[0]
        f32 = tree_map(lambda v: np.asarray(v, np.float32), params)
        return (gcfg == cfg and _leaf_diff(got, f32) == 0.0
                and bool(torch.isfinite(a).all())), _rel(a.cpu(), b.cpu())

    def file_equal(name, path, params, cfg, priors):
        """``path`` byte-equal to the library's writer of the expected
        model, and its forward equal to the library model's."""
        save_nnet2(f"{d}/want.mdl", params, cfg, priors=priors)
        same, err = runs(path, params, cfg)
        held(f"{name} = library", same and raw(path) == raw(f"{d}/want.mdl")
             and err <= SERVE_SCORE_TOL, f"{err:.2e}")

    # copies carry the priors; the average of a model with itself is it
    T("nnet2-am-copy", f"{d}/final.mdl", f"{d}/copy2.mdl")
    T("nnet-am-copy", f"{d}/final.mdl", f"{d}/copy.mdl")
    T("nnet-am-average", f"{d}/avg.mdl", f"{d}/final.mdl", f"{d}/final.mdl")
    for name, out in (("nnet2-am-copy", "copy2"), ("nnet-am-copy", "copy"),
                      ("nnet-am-average", "avg")):
        held(f"{name}: the input's bytes, priors and all",
             raw(f"{d}/{out}.mdl") == raw(f"{d}/final.mdl"), "")
    cap = 0.05
    T("nnet-am-fix", f"--max-param-value={cap}", f"{d}/final.mdl",
      f"{d}/fix.mdl")
    file_equal("nnet-am-fix", f"{d}/fix.mdl",
               tree_map(lambda a: np.clip(np.where(np.isfinite(a), a, 0.0),
                                          -cap, cap), pf), cfgf, prif)
    T("nnet-am-switch-preconditioning", f"{d}/final.mdl", f"{d}/pc.mdl")
    file_equal("nnet-am-switch-preconditioning", f"{d}/pc.mdl", pf,
               dataclasses.replace(cfgf, preconditioned=True), prif)
    # SVD rank limit: the reduced products
    T("nnet-am-limit-rank", f"--dim={NNET2_RANK}", f"{d}/pri.mdl",
      f"{d}/lr.mdl")
    want = {k: v for k, v in p1.items()}
    for name in layer_names(cfgf)[:-1]:
        W = np.asarray(p1[name]["affine"]["kernel"], np.float64)
        U, S, Vt = np.linalg.svd(W, full_matrices=False)
        want[name] = {"affine": {
            "kernel": ((U[:, :NNET2_RANK] * S[:NNET2_RANK])
                       @ Vt[:NNET2_RANK]).astype(np.float32),
            "bias": p1[name]["affine"]["bias"]}}
    got, gcfg, gpri = load_nnet2_full(f"{d}/lr.mdl")
    err = _leaf_diff(got, want)
    with torch.no_grad():
        ferr = _rel(nnet2_model(got, gcfg, dev)(x0[None])[0].cpu(),
                    nnet2_model(want, gcfg, dev)(x0[None])[0].cpu())
    held("nnet-am-limit-rank = the library's SVD products",
         err <= 1e-5 and ferr <= SERVE_SCORE_TOL
         and np.array_equal(gpri, pri1), f"{err:.2e}, forward {ferr:.2e}")
    # the draws from np.random.default_rng(srand), in the original's order
    T("nnet-insert", f"--srand={NNET2_SRAND}", f"{d}/final.mdl",
      f"{d}/ins.mdl")
    rng = np.random.default_rng(NNET2_SRAND)
    k = (rng.standard_normal((NNET2_PNORM_OUT, NNET2_PNORM_IN)) * 0.1
         / np.sqrt(NNET2_PNORM_OUT)).astype(np.float32)
    want = dict(pf)
    want[f"pnorm{NNET2_LAYERS + 1}"] = {"affine": {
        "kernel": k, "bias": np.zeros(NNET2_PNORM_IN, np.float32)}}
    file_equal("nnet-insert", f"{d}/ins.mdl", want, dataclasses.replace(
        cfgf, num_hidden_layers=NNET2_LAYERS + 1), prif)
    T("nnet-am-widen", f"--hidden-layer-dim={NNET2_WIDEN}",
      f"--srand={NNET2_SRAND}", f"{d}/final.mdl", f"{d}/wide.mdl")
    rng = np.random.default_rng(NNET2_SRAND)
    want = dict(pf)
    for i in range(NNET2_LAYERS):
        kk = np.asarray(pf[f"pnorm{i + 1}"]["affine"]["kernel"])
        extra = NNET2_WIDEN - kk.shape[1]
        want[f"pnorm{i + 1}"] = {"affine": {
            "kernel": np.concatenate([kk, rng.standard_normal(
                (kk.shape[0], extra)).astype(np.float32) * 0.02
                / np.sqrt(kk.shape[0])], axis=1),
            "bias": np.concatenate([pf[f"pnorm{i + 1}"]["affine"]["bias"],
                                    np.zeros(extra, np.float32)])}}
    file_equal("nnet-am-widen", f"{d}/wide.mdl", want, dataclasses.replace(
        cfgf, pnorm_input_dim=NNET2_WIDEN), prif)
    o2 = os.path.join(os.path.dirname(d), "chip_smoke_online2")
    T("nnet-am-reinitialize", f"--srand={NNET2_SRAND}", f"{d}/final.mdl",
      f"{o2}/final.mdl", f"{d}/reinit.mdl")
    P = tm.num_pdfs
    rng = np.random.default_rng(NNET2_SRAND)
    want = dict(pf)
    want["output_affine"] = {
        "kernel": (rng.standard_normal((NNET2_PNORM_OUT, P))
                   / np.sqrt(NNET2_PNORM_OUT)).astype(np.float32),
        "bias": np.zeros(P, np.float32)}
    file_equal("nnet-am-reinitialize", f"{d}/reinit.mdl", want,
               dataclasses.replace(cfgf, mix2pdf=None), None)
    T("nnet-modify-learning-rates", f"{d}/pri.mdl", f"{d}/lr.mdl",
      f"{d}/mlr.mdl")
    got, gcfg, _ = load_nnet2_full(f"{d}/mlr.mdl")
    lrs = np.asarray(gcfg.learn_rates or (), np.float64)
    held("nnet-modify-learning-rates: a rate a layer, geometric mean "
         "2e-3", len(lrs) == NNET2_LAYERS + 1
         and abs(np.exp(np.log(lrs).mean()) - 2e-3) <= 1e-8
         and _leaf_diff(got, load_nnet2_full(f"{d}/lr.mdl")[0]) == 0.0,
         " ".join(f"{v:.2e}" for v in lrs))
    # fresh draws of flax's init: shapes, zero biases, kernels' scale
    T("nnet-replace-last-layers", "--num-layers-to-remove=2",
      f"--srand={NNET2_SRAND}", f"{d}/final.mdl", f"{d}/rep.mdl")
    got, gcfg, gpri = load_nnet2_full(f"{d}/rep.mdl")
    kept = all(_leaf_diff(got[f"pnorm{i + 1}"], pf[f"pnorm{i + 1}"]) == 0.0
               for i in range(NNET2_LAYERS - 2))
    fresh = [(k, v) for k, v in tree_leaves(
        {n: got[n] for n in (f"pnorm{NNET2_LAYERS - 1}",
                             f"pnorm{NNET2_LAYERS}", "output_affine")})]
    scale_ok = all((not v.any()) if k[-1] == "bias" else
                   0.7 < float(np.std(v)) * math.sqrt(v.shape[0]) < 1.3
                   for k, v in fresh)
    same, _err = runs(f"{d}/rep.mdl", got, gcfg)
    held("nnet-replace-last-layers: kept layers, fresh lecun draws",
         kept and scale_ok and same and gcfg.mix2pdf is None
         and gpri is None, "")
    with open(f"{d}/nnet.config", "w") as f:
        f.write(f"feat-dim = 13\nnum-pdfs = {P}\n"
                f"num-hidden-layers = {NNET2_LAYERS}\n"
                f"pnorm-input-dim = {NNET2_PNORM_IN}\n"
                f"pnorm-output-dim = {NNET2_PNORM_OUT}\n"
                "splice = -2 -1 0 1 2\n")
    T("nnet-init", f"--srand={NNET2_SRAND}", f"{d}/nnet.config",
      f"{d}/init.raw")
    comps = load_raw_nnet(f"{d}/init.raw")
    kinds = [c for c, _ in comps]
    held("nnet-init: the raw p-norm stack", kinds == [c for c, _ in
                                                      load_raw_nnet(
                                                          f"{d}/pri.raw")]
         and all((not np.asarray(p["bias"]).any()) for c, p in comps
                 if c == "affine"), f"{len(comps)} components")
    T("raw-nnet-copy", "--truncate=4", f"{d}/pri.raw", f"{d}/trunc.raw")
    T("raw-nnet-copy", "--truncate=1", f"{d}/pri.raw", f"{d}/splice.raw")
    T("raw-nnet-concat", f"{d}/pri.raw", f"{d}/splice.raw", f"{d}/cat.raw")
    a, b, sp, c = (load_raw_nnet(f"{d}/{n}.raw")
                   for n in ("pri", "trunc", "splice", "cat"))
    held("raw-nnet-copy --truncate / raw-nnet-concat",
         [t for t, _ in b] == [t for t, _ in a[:4]]
         and [t for t, _ in c] == [t for t, _ in a + sp]
         and _leaf_diff(dict(enumerate(p for _, p in c)),
                        dict(enumerate(p for _, p in a + sp))) == 0.0, "")
    # egs from the alignments: pre-spliced windows, pdf targets
    pdf_of = tm.tid_to_pdf_array
    with TableWriter(f"ark:{d}/egs.ark", holder="xeg") as w:
        for k in sorted(feats):
            x = splice(feats[k][None], (-2, -1, 0, 1, 2))[0].cpu().numpy()
            y = pdf_of[np.asarray(ali[k])]
            n = len(y) // NNET2_EG_FRAMES * NNET2_EG_FRAMES
            w[k] = XentEg(feats=x[:n].reshape(-1, NNET2_EG_FRAMES,
                                              x.shape[1]),
                          pdfs=y[:n].reshape(-1, NNET2_EG_FRAMES)
                          .astype(np.int32))
    out = T("nnet-compute-prob", dv, f"{d}/final.mdl", f"ark:{d}/egs.ark")
    want = compute_prob(nnet2_model(pf, cfgf, dev), f"ark:{d}/egs.ark", dev)
    held("nnet-compute-prob = the library's", abs(float(out) - want)
         <= 1e-5 * max(1.0, abs(want)), f"{float(out)} / {want:.6f}")
    T("nnet-compute-from-egs", dv, f"{d}/final.mdl", f"ark:{d}/egs.ark",
      f"ark:{d}/cfe.ark")
    got = _serve_read(f"ark:{d}/cfe.ark", "mat")
    eg_model = nnet2_model(pf, cfgf, dev)
    err = 0.0
    with torch.no_grad():
        for k, eg in SequentialTableReader(f"ark:{d}/egs.ark", holder="xeg"):
            o = eg_model(torch.from_numpy(eg.feats).to(dev))
            err = max(err, _rel(got[k], o.reshape(-1, o.shape[-1]).cpu()))
    held("nnet-compute-from-egs = Nnet2Model on the egs",
         err <= SERVE_SCORE_TOL, f"{err:.2e}")
    out = T("nnet-show-progress", dv, f"{d}/pri.mdl", f"{d}/lr.mdl",
            f"ark:{d}/egs.ark").splitlines()
    old = compute_prob(nnet2_model(p1, dataclasses.replace(
        cfgf, mix2pdf=None), dev), f"ark:{d}/egs.ark", dev)
    held("nnet-show-progress: a line a leaf, objf-old the library's",
         len(out) == 2 * (NNET2_LAYERS + 1) + 2
         and abs(float(out[-2].split()[1]) - old)
         <= 1e-5 * max(1.0, abs(old)), f"{out[-2]} / {old:.6f}")
    # transitions and priors from the alignments
    with kio.open_wxfilename(f"{d}/final.tm") as f:
        kio.init_kaldi_output_stream(f)
        write_transition_model(f, tm)
    T("nnet-train-transitions", f"{d}/final.tm", f"ark:{d}/ali.ark",
      f"{d}/final.mdl", f"{d}/tt.tm", f"{d}/tt.mdl")
    cnt = np.zeros(P)
    for v in ali.values():
        np.add.at(cnt, pdf_of[np.asarray(v, np.int64)], 1.0)
    got, gcfg, gpri = load_nnet2_full(f"{d}/tt.mdl")
    with kio.open_rxfilename(f"{d}/tt.tm") as f:
        kio.init_kaldi_input_stream(f)
        tt = read_transition_model(f)
    held("nnet-train-transitions: priors of the alignments' pdf counts",
         _rel(gpri, (cnt + 0.5) / (cnt.sum() + 0.5 * P)) <= 1e-6
         and tt.num_transition_ids == tm.num_transition_ids
         and _leaf_diff(got, pf) == 0.0, f"{int(cnt.sum())} frames")
    for stale in os.listdir(d):
        if stale.endswith((".mdl", ".raw")):
            os.remove(f"{d}/{stale}")


def nnet2_tools_worker(argv) -> int:
    """21's background process: 21a–21f in turn, every tool a call of
    the port's registry in this process, each held against the library
    on the same card, the fbank kernel's count set to 0 before each call
    and read after it.  Writes ``report.json`` into the directory; exits
    1 if a check fails."""
    import contextlib
    import io
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import kaldi_tpu_torch.features  # noqa: F401  (before ops.fbank)
    from kaldi_tpu_torch.am.serialize import read_mdl
    from kaldi_tpu_torch.cli import TOOLS
    from kaldi_tpu_torch.cli.online2 import online_mfcc
    from kaldi_tpu_torch.core.table import TableWriter
    from kaldi_tpu_torch.ops.fbank import CudaFbank
    t_start = time.perf_counter()
    d, dv = argv[0], argv[1]
    dev = torch.device(dv, 0) if dv == "cuda" else torch.device(dv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the host's cores go to the main process first: this worker has
    # until the join, ~800 s after its start, for ~80 s of work
    os.nice(10)
    calls, checks, walls, rep = [], [], {}, {}
    launches = {}

    def T(name, *args):
        """Tool ``name``, its fbank launches counted and its wall added
        up; → what it printed."""
        out = io.StringIO()
        CudaFbank.total_launches = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = TOOLS[name]([str(a) for a in args])
        walls[name] = walls.get(name, 0.0) + time.perf_counter() - t0
        launches[name] = launches.get(name, 0) + CudaFbank.total_launches
        if rc:
            raise AssertionError(f"{name}: rc {rc}")
        calls.append(name)
        return out.getvalue()

    def held(name, ok, detail):
        checks.append((name, bool(ok), detail))

    o2 = os.path.join(os.path.dirname(d), "chip_smoke_online2")
    sv = os.path.join(os.path.dirname(d), "chip_smoke_serve")
    tm, _ = read_mdl(f"{o2}/final.mdl", device="cpu")
    mfcc = online_mfcc(SAMP_FREQ, dev)
    waves = {k: np.asarray(w, np.float32)
             for k, (w, _r) in _serve_read(f"ark:{sv}/wav8.ark",
                                           "wav").items()}
    audio_s = sum(len(w) for w in waves.values()) / SAMP_FREQ
    feats = {k: mfcc.compute(w) for k, w in waves.items()}
    with TableWriter(f"ark:{d}/feats8.ark", holder="mat") as w:
        for k, x in feats.items():
            w[k] = x.cpu().numpy()
    t0 = time.perf_counter()
    p1, pri1 = nnet2_make(T, held, d, dev, feats, tm.num_pdfs, rep)
    walls["21a"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    logpri, lib = nnet2_forward(T, held, d, dev, feats, rep)
    walls["21b"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    tm, ali = nnet2_decode(T, held, d, dev, logpri, lib, rep)
    walls["21c"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    nnet2_online(T, held, d, dev, logpri, rep, audio_s, tm)
    walls["21d"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    nnet2_model_tools(T, held, d, dev, feats, p1, pri1, tm, ali)
    walls["21e"] = time.perf_counter() - t0
    rep["fbank_err"] = check_path_fbank(mfcc, list(waves.values()),
                                        "nnet2: 21f")
    with open(f"{d}/report.json", "w") as f:
        json.dump({"walls": walls, "checks": checks, "calls": len(calls),
                   "tools": sorted(set(calls)), "launches": launches,
                   "total": time.perf_counter() - t_start, **rep}, f,
                  default=float)
    bad = [c for c in checks if not c[1]]
    if bad:
        print(f"nnet2 tools: {len(bad)} checks failed: {bad[:5]}",
              file=sys.stderr)
        return 1
    return 0


def nnet2_tools_finish(started, tag: str):
    """21, joined before the kernels line: the worker's exit, its checks,
    the fbank launches of NNET2_FBANK_TOOLS, the audio-s/s of the online2
    decodes and of the offline decode, the worker's wall and the main
    process's wait here.  → (fbank launches, the fbank kernel's max |diff|
    from its plain version at the tools' MFCC)."""
    proc, d, t0 = started
    t_wait = time.perf_counter()
    proc.wait(timeout=NNET2_JOIN)
    wait = time.perf_counter() - t_wait
    wall = time.perf_counter() - t0
    with open(f"{d}/worker.err") as f:
        err = f.read()
    if proc.returncode != 0 or not os.path.exists(f"{d}/report.json"):
        raise AssertionError(f"nnet2 tools failed ({proc.returncode}):\n"
                             f"{err[-3000:]}")
    with open(f"{d}/report.json") as f:
        rep = json.load(f)
    fb = sum(rep["launches"].get(n, 0) for n in NNET2_FBANK_TOOLS)
    print(f"nnet2: {rep['calls']} tool calls of {len(rep['tools'])} tools "
          f"in one background process: {wall:.1f} s to "
          f"the join ({rep['total']:.1f} s of work after its imports); the "
          f"main process waited {wait:.1f} s here {tag}")
    for name, ok, detail in rep["checks"]:
        print(f"nnet2:   {name}: {'held' if ok else 'FAILED'}"
              + (f" ({detail})" if detail else ""))
    audio, walls = rep["audio_s"], rep["walls"]
    print(f"nnet2: the model {rep['init_params']} parameters before the "
          f"mix-up ({NNET2_LAYERS} × p-norm {NNET2_PNORM_IN} → "
          f"{NNET2_PNORM_OUT}), {NNET2_MIX} softmax rows ({rep['mix_rows'][0]}"
          f"–{rep['mix_rows'][1]} a pdf); {audio:.2f} s of audio: "
          + ", ".join(f"{n} {audio / walls[n]:.1f} audio-s/s"
                      for n in ("online2-wav-nnet2-latgen-faster",
                                "online2-wav-nnet2-latgen-threaded",
                                "nnet-latgen-faster",
                                "nnet-latgen-faster-parallel"))
          + f" (whole calls); streamed rows within {rep['stream_err']:.2e} "
          f"of the offline forward {tag}")
    print("nnet2: walls " + ", ".join(f"{n} {v:.1f} s" for n, v in
                                      walls.items()))
    with open(f"{d}/worker.out") as f:      # 21f's kernel check
        print("".join(ln for ln in f if ln.startswith("nnet2: 21")),
              end="")
    print(f"nnet2: fbank kernel launches {fb} (" + ", ".join(
        f"{n} {rep['launches'].get(n, 0)}" for n in NNET2_FBANK_TOOLS)
        + f"); 21f fbank kernel vs plain max |diff| {rep['fbank_err']:.3e} "
        f"{tag}")
    bad = [c for c in rep["checks"] if not c[1]]
    if bad:
        raise AssertionError(f"21: {len(bad)} checks failed: {bad[:3]}")
    if any(rep["launches"].get(n, 0) <= 0 for n in NNET2_FBANK_TOOLS):
        raise AssertionError(f"21: fbank launches {rep['launches']}")
    return fb, rep["fbank_err"]


# ---------------------------------------------------------------------------
# 22. Kaldi's frame-level cross-entropy DNN recipes as the port's tools, on
# 10b's mini-ladder systems: Karel's nnet1 (steps/nnet/{pretrain_dbn,
# train,align,make_denlats,train_mpe}.sh) and nnet3's train_dnn.py loop
# (get-egs, shuffle / merge, train, compute-prob, combine, realign)
# ---------------------------------------------------------------------------

NLOOP_DIR = os.path.join("build", "chip_smoke_nnet_loop")
NLOOP_BINS = 40            # 40 log-mel bins at 8 kHz
NLOOP_SPLICE = 5           # ±5 frames: 440 inputs
# steps/nnet/pretrain_dbn.sh: nn_depth=6, hid_dim=2048; rbm_iter=1, one
# pass over ~100 hours (~10^5 CD-1 updates a layer), the Gaussian-Bernoulli
# first layer twice as many.  10b's ~15,300 frames give 60 updates a pass:
# 10 passes a layer (20 the first) keep the stack's hidden units varying
# from frame to frame; at 1 pass they are constant by the fourth layer
NNET1_DEPTH = 6
NNET1_HID = 2048
NNET1_RBM_EPOCHS = (20, 10)  # the first layer's passes, every other layer's
# CD-1 rates: an update sums over the 2048 units, so the recipe's rates
# (0.01 Gaussian, 0.4 Bernoulli, with momentum and L2) and the tool's 0.05
# diverge or saturate here (as in the original); at 2048 units the
# Gaussian layer holds at 0.002, the Bernoulli layers at 0.0125
NNET1_RBM_LR_GAUSS = 0.002
NNET1_RBM_LR = 0.0125
# fine-tuning passes after 1 of the output layer: newbob's shape at fixed
# points (steps/nnet/train_scheduler.sh: the rate halves each pass once the
# cv gain falls off; 20 passes at most), 14 passes at one rate, then
# halved each of 6.  The rate is the recipe's 0.008 a frame summed over
# 256 frames (2.0 on the mean) over 8: the output layer's step grows
# with the 2048 sigmoid inputs' squared norm, and the recipe's own rate
# (or the tool's 0.5) overshoots it
NNET1_LR = 0.25
NNET1_FT_EPOCHS = 20
NNET1_HALVINGS = 6
NNET1_CV_UTTS = 10         # 10b's training utterances held out (cv)
NNET1_SEED = 22
NNET1_WER_MAX = 30.0
NNET1_SEQ_UTTS = 4         # utterances through the sequence trainers
# lattice beams small enough that the lattices determinize: a weak hybrid's
# lattices at the tools' beam 6 run the host out of memory (on the CPU at
# width 96)
NNET1_SEQ_LAT = ("--beam=13", "--lattice-beam=3", "--acoustic-scale=0.1")
NNET1_DECODE = ("--beam=13", "--lattice-beam=2", "--acoustic-scale=0.1")
# phases 5 and 8b's TDNN-F: 13 layers of 1024 / 128
NNET3_HID = 1024
NNET3_BN = 128
NNET3_LAYERS = 13
# nnet3-train's passes over a job's half of the training set (7 steps of
# 16 × 64 frames a pass): its batch norm's running statistics move 1% a
# step, and at the tool's 4 passes they are still mostly their init, so
# the model in eval mode scores garbage (nnet3-compute-prob -1076 a frame
# on the card); 60 passes, 420 steps, bring them within 2%
NNET3_EPOCHS = 60
NNET3_CHUNK = 64
NNET3_SUBSET = 40          # egs in each diagnostic subset
NNET3_MERGE = 8
NNET3_COMBINE_ITERS = 10   # nnet3-combine's Adam steps (the tool's 40)
NLOOP_TOL = SERVE_SCORE_TOL
NLOOP_JOIN = 900           # the main process's longest wait, seconds


def nnet_loop_write(sysd, wers) -> str:
    """22's inputs from 10b's systems: the waveforms, transcripts and
    speakers of both sets, the lexicon, words, G, the tri3b model and its
    training alignments, and 10b's WERs.  → the directory."""
    from kaldi_tpu_torch.am.serialize import write_mdl
    from kaldi_tpu_torch.core.table import TableWriter
    from kaldi_tpu_torch.fst.openfst_io import write_fst_path
    repo = os.path.dirname(os.path.abspath(__file__))
    d = os.path.join(repo, NLOOP_DIR)
    os.makedirs(d, exist_ok=True)
    for stale in ("report.json", "worker.out", "worker.err"):
        if os.path.exists(f"{d}/{stale}"):
            os.remove(f"{d}/{stale}")
    lang, tri3b = sysd["lang"], sysd["tri3b"]
    for s, data in (("tr", sysd["train"]), ("te", sysd["test"])):
        with TableWriter(f"ark:{d}/wav_{s}.ark", holder="wav") as w:
            for u in data.utts:
                w[u] = data.wavs[u]
        with TableWriter(f"ark:{d}/text_{s}.ark", holder="text") as w:
            for u in data.utts:
                w[u] = data.text[u]
        with open(f"{d}/spk2utt_{s}", "w") as f:
            for spk, utts in data.spk2utt().items():
                f.write(f"{spk} {' '.join(utts)}\n")
        with open(f"{d}/utt2spk_{s}", "w") as f:
            for u in data.utts:
                f.write(f"{u} {data.utt2spk[u]}\n")
    with TableWriter(f"ark:{d}/ali_tr.ark", holder="ivec") as w:
        for u, a in sysd["tri3b_ali"].items():
            w[u] = np.asarray(a, np.int32)
    with open(f"{d}/lexicon.txt", "w") as f:
        for word, pron in lang.lexicon.entries:
            f.write(f"{word} {' '.join(pron)}\n")
    lang.words.write(f"{d}/words.txt")
    write_fst_path(f"{d}/G.fst", sysd["G"])
    write_mdl(f"{d}/tri3b.mdl", tri3b.tm, tri3b.am)
    with open(f"{d}/meta.json", "w") as f:
        json.dump({"wers": {k: v.wer for k, v in wers.items()}}, f)
    return d


def nnet_loop_start(d: str, dev):
    """22, started: ``python3 chip_smoke.py --nnet-loop <dir> <device>``
    (``nnet_loop_worker``) in the background, two host threads.  →
    (process, dir, start time)."""
    import subprocess
    repo = os.path.dirname(os.path.abspath(__file__))
    out = open(f"{d}/worker.out", "w")
    err = open(f"{d}/worker.err", "w")
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--nnet-loop", d,
         dev.type], cwd=repo, stdout=out, stderr=err,
        env=dict(os.environ, OMP_NUM_THREADS="2"))
    out.close()
    err.close()
    return proc, d, time.perf_counter()


def _subset_ark(src: str, keys, dst: str, holder: str = "mat") -> str:
    """The entries of ``src`` whose keys are in ``keys``, in its order,
    written to the archive ``dst``.  → its rspecifier."""
    from kaldi_tpu_torch.core.table import SequentialTableReader, TableWriter
    keys = set(keys)
    with TableWriter(f"ark:{dst}", holder=holder) as w:
        for k, v in SequentialTableReader(src, holder=holder):
            if k in keys:
                w[k] = v
    return f"ark:{dst}"


def _global_cmvn(T, d, dv, feats: str, name: str, utts) -> str:
    """compute_cmvn_stats.sh over the whole set (one 'speaker' of every
    utterance) → cmvn-to-nnet's affine normalization.  → its path."""
    with open(f"{d}/global_spk2utt", "w") as f:
        f.write("global " + " ".join(utts) + "\n")
    T("compute-cmvn-stats", dv, f"--spk2utt={d}/global_spk2utt", feats,
      f"ark,scp:{d}/{name}.stats.ark,{d}/{name}.stats.scp")
    with open(f"{d}/{name}.stats.scp") as f:
        rx = f.read().split()[1]
    T("cmvn-to-nnet", rx, f"{d}/{name}.mat")
    return f"{d}/{name}.mat"


def nloop_features(T, held, d, dv, dev, rep):
    """22a: compute-fbank-feats (40 bins, 8 kHz) on 10b's waveforms, the
    lengths against 10b's alignments, pdf targets (ali-to-pdf), CMVN per
    speaker (compute-cmvn-stats, apply-cmvn), then global CMVN
    (compute-cmvn-stats over the set, cmvn-to-nnet, transform-feats),
    the ±5 splice and its normalization as a feature transform
    (transf-to-nnet).  → (the fbank computer, the test waveforms, train /
    cv utterances)."""
    from kaldi_tpu_torch.core import io as kio
    from kaldi_tpu_torch.features import Fbank, FbankOptions, MelBanksOptions
    from kaldi_tpu_torch.features.window import FrameExtractionOptions
    fbank_opts = ("--sample-frequency=8000", "--dither=0",
                  f"--num-mel-bins={NLOOP_BINS}")
    for s in ("tr", "te"):
        T("compute-fbank-feats", dv, *fbank_opts, f"ark:{d}/wav_{s}.ark",
          f"ark:{d}/fbank_{s}.ark")
    fb = Fbank(FbankOptions(
        frame_opts=FrameExtractionOptions(samp_freq=8000.0, dither=0.0),
        mel_opts=MelBanksOptions(num_bins=NLOOP_BINS)), device=dev)
    waves = {k: np.asarray(w, np.float32) for k, (w, _r) in
             _serve_read(f"ark:{d}/wav_te.ark", "wav").items()}
    got = _serve_read(f"ark:{d}/fbank_te.ark", "mat")
    err = max(_rel(got[k], fb.compute(w).cpu()) for k, w in waves.items())
    held("compute-fbank-feats = Fbank (40 bins, 8 kHz)", err <= NLOOP_TOL,
         f"{err:.2e}")
    dim = T("feat-to-dim", f"ark:{d}/fbank_tr.ark").strip()
    T("feat-to-len", f"ark:{d}/fbank_tr.ark", f"ark,t:{d}/len_tr.txt")
    lens = {k: int(v[0]) for k, v in
            _serve_read(f"ark,t:{d}/len_tr.txt", "text").items()}
    ali = _serve_read(f"ark:{d}/ali_tr.ark", "ivec")
    held("the fbank features' lengths = 10b's alignments'",
         dim == str(NLOOP_BINS) and sorted(lens) == sorted(ali)
         and all(lens[k] == len(ali[k]) for k in ali),
         f"{len(ali)} utterances, {sum(lens.values())} frames")
    T("ali-to-pdf", f"{d}/tri3b.mdl", f"ark:{d}/ali_tr.ark",
      f"ark:{d}/pdf_tr.ark")
    T("analyze-counts", f"ark:{d}/pdf_tr.ark", f"{d}/pdf_counts.txt")
    with open(f"{d}/pdf_counts.txt") as f:
        counts = [int(c) for c in f.read().split()[1:-1]]
    held("analyze-counts: every aligned frame once",
         sum(counts) == sum(lens.values()), f"{len(counts)} pdfs seen")
    utts = sorted(ali)
    cv, trn = utts[-NNET1_CV_UTTS:], utts[:-NNET1_CV_UTTS]
    # CMVN per speaker (the test set's speakers are held out of training,
    # their voices warped), then a 40-d global CMVN (the nnet3 loop's
    # input) and the ±5 splice normalized after splicing (nnet1's input,
    # its transform for nnet-forward)
    for s in ("tr", "te"):
        T("compute-cmvn-stats", dv, f"--spk2utt={d}/spk2utt_{s}",
          f"ark:{d}/fbank_{s}.ark", f"ark:{d}/spk_cmvn_{s}.ark")
        T("apply-cmvn", dv, "--norm-vars=true", f"--utt2spk={d}/utt2spk_{s}",
          f"ark:{d}/spk_cmvn_{s}.ark", f"ark:{d}/fbank_{s}.ark",
          f"ark:{d}/cmn_{s}.ark")
    c40 = _global_cmvn(T, d, dv, f"ark:{d}/cmn_tr.ark", "cmvn40", trn)
    ctx = (f"--left-context={NLOOP_SPLICE}",
           f"--right-context={NLOOP_SPLICE}")
    for s in ("tr", "te"):
        T("transform-feats", dv, c40, f"ark:{d}/cmn_{s}.ark",
          f"ark:{d}/norm40_{s}.ark")
        T("splice-feats", dv, *ctx, f"ark:{d}/cmn_{s}.ark",
          f"ark:{d}/raw440_{s}.ark")
    c440 = _global_cmvn(T, d, dv, f"ark:{d}/raw440_tr.ark", "cmvn440", trn)
    T("transf-to-nnet", c440, f"{d}/ft.nnet")
    T("transform-feats", dv, c440, f"ark:{d}/raw440_tr.ark",
      f"ark:{d}/norm440_tr.ark")
    fbk = _serve_read(f"ark:{d}/cmn_tr.ark", "mat")
    x = np.concatenate([fbk[k] for k in trn]).astype(np.float64)
    with kio.open_rxfilename(c40) as f:
        kio.init_kaldi_input_stream(f)
        mat = np.asarray(kio.read_matrix(f), np.float64)
    sd = np.sqrt(np.maximum((x ** 2).mean(0) - x.mean(0) ** 2, 1e-10))
    want = np.concatenate([np.diag(1 / sd), (-x.mean(0) / sd)[:, None]], 1)
    n440 = _serve_read(f"ark:{d}/norm440_tr.ark", "mat")
    z = np.concatenate([n440[k] for k in trn]).astype(np.float64)
    held("apply-cmvn | compute-cmvn-stats | cmvn-to-nnet = the training "
         "set's mean and deviation; the spliced features normalized",
         _rel(mat, want) <= 1e-4 and z.shape[1] == NLOOP_BINS * 11
         and np.abs(z.mean(0)).max() < 1e-3
         and np.abs(z.std(0) - 1).max() < 1e-3,
         f"{z.shape[0]} frames × {z.shape[1]}")
    for name in ("norm440", "norm40"):
        _subset_ark(f"ark:{d}/{name}_tr.ark", trn, f"{d}/{name}_trn.ark")
        _subset_ark(f"ark:{d}/{name}_tr.ark", cv, f"{d}/{name}_cv.ark")
    rep["frames"] = sum(lens.values())
    rep["utts"] = [len(trn), len(cv), len(waves)]
    return fb, list(waves.values()), trn, cv


def _cv_diag(model, feats, pdfs, dev):
    """Frame cross-entropy and accuracy of an nnet1 ``model`` on the cv
    utterances."""
    x = torch.cat([torch.from_numpy(feats[k]) for k in sorted(feats)]).to(dev)
    y = torch.cat([torch.from_numpy(np.asarray(pdfs[k], np.int64))
                   for k in sorted(feats)]).to(dev)
    with torch.no_grad():
        lp = model(x)
    return (float(-lp.gather(1, y[:, None]).mean()),
            float((lp.argmax(1) == y).double().mean()))


def nloop_pretrain(T, held, d, dv, dev, rep, P):
    """22b: rbm-train-cd1-frmshuff a layer at a time (the next layer's
    input the stack's hidden probabilities), rbm-convert-to-nnet and
    nnet-concat into the DBN, nnet-initialize's output layer on top; the
    first RBM against train_rbm on the card, one CD-1 step on the card
    against the CPU with the same draws.  → the DBN + output layer's
    path."""
    from kaldi_tpu_torch.am import nnet1 as n1
    from kaldi_tpu_torch.core.table import SequentialTableReader, TableWriter
    feats = f"ark:{d}/norm440_trn.ark"
    dbn = None
    for li in range(NNET1_DEPTH):
        ep = NNET1_RBM_EPOCHS[0 if li == 0 else 1]
        lr = NNET1_RBM_LR_GAUSS if li == 0 else NNET1_RBM_LR
        T("rbm-train-cd1-frmshuff", dv, f"--hid-dim={NNET1_HID}",
          f"--num-epochs={ep}", f"--learn-rate={lr}",
          f"--gaussian-visible={'true' if li == 0 else 'false'}", feats,
          f"{d}/rbm{li + 1}.nnet")
        T("rbm-convert-to-nnet", f"{d}/rbm{li + 1}.nnet",
          f"{d}/rbm{li + 1}.conv.nnet")
        if dbn is None:
            dbn = f"{d}/rbm1.conv.nnet"
        else:
            T("nnet-concat", "--drop-output=true", dbn,
              f"{d}/rbm{li + 1}.conv.nnet", f"{d}/dbn{li + 1}.nnet")
            dbn = f"{d}/dbn{li + 1}.nnet"
        p, _h, _n, _ = n1.load_nnet1(f"{d}/rbm{li + 1}.nnet")
        if li == 0:
            frames = np.concatenate([np.asarray(m, np.float32) for _k, m in
                                     SequentialTableReader(feats,
                                                           holder="mat")])
            train = getattr(n1.train_rbm, "inner", n1.train_rbm)
            lib, _errs = train(frames, NNET1_HID, num_epochs=ep,
                               lr=NNET1_RBM_LR_GAUSS, gaussian_visible=True,
                               device=dev)
            err = max(_rel(p["hidden1"]["kernel"], lib.W),
                      _rel(p["hidden1"]["bias"], lib.hid_bias))
            held("rbm-train-cd1-frmshuff = train_rbm (layer 1)",
                 err <= 1e-5, f"{err:.2e}")
            rep["cd1_step"] = _cd1_card_vs_cpu(held, lib, frames, dev)
        # the next RBM's input: this layer's hidden probabilities, and
        # how much they vary from frame to frame (their std, averaged over
        # the units)
        W = torch.from_numpy(np.asarray(p["hidden1"]["kernel"])).to(dev)
        b = torch.from_numpy(np.asarray(p["hidden1"]["bias"])).to(dev)
        nxt = f"{d}/h{li + 1}.ark"
        s1 = s2 = 0.0
        n = 0
        with TableWriter(f"ark:{nxt}", holder="mat") as w, torch.no_grad():
            for k, m in SequentialTableReader(feats, holder="mat"):
                h = torch.sigmoid(torch.from_numpy(m).to(dev) @ W + b)
                s1, s2, n = s1 + h.sum(0), s2 + (h * h).sum(0), n + len(h)
                if li < NNET1_DEPTH - 1:
                    w[k] = h.cpu().numpy()
        rep.setdefault("rbm_hstd", []).append(float(torch.sqrt(torch.clamp_min(
            s2 / n - (s1 / n) ** 2, 0.0)).mean()))
        if li > 0:
            os.remove(feats[4:])
        feats = f"ark:{nxt}"
    os.remove(feats[4:])
    held("the stack's hidden units vary from frame to frame at every "
         "layer", min(rep["rbm_hstd"]) > 0.01,
         " ".join(f"{v:.3f}" for v in rep["rbm_hstd"]))
    with open(f"{d}/out.proto", "w") as f:
        f.write(f"<AffineTransform> <InputDim> {NNET1_HID} <OutputDim> {P}\n"
                "<Softmax>\n")
    T("nnet-initialize", f"--seed={NNET1_SEED}", f"{d}/out.proto",
      f"{d}/out.nnet")
    T("nnet-concat", "--drop-output=true", dbn, f"{d}/out.nnet",
      f"{d}/dbn_out.nnet")
    info = T("nnet-info", f"{d}/dbn_out.nnet")
    _p, hid, npdf, _ = n1.load_nnet1(f"{d}/dbn_out.nnet")
    held("the DBN: 6 × 2048 sigmoid layers and the output layer",
         hid == (NNET1_HID,) * NNET1_DEPTH and npdf == P
         and f"input-dim {NLOOP_BINS * 11}" in info, f"{P} pdfs")
    return f"{d}/dbn_out.nnet"


def _cd1_card_vs_cpu(held, rbm, frames, dev) -> dict:
    """One CD-1 step from the trained first RBM on 256 frames, on the
    card and on the CPU, with the same uniform draws (drawn on the host).
    A hidden sample flips where a draw lies within float32 rounding of
    its probability on one side: the flips are counted, and each may
    move W by about lr · |v| · |h| / B."""
    from kaldi_tpu_torch.am.nnet1 import cd1_update
    g = torch.Generator().manual_seed(NNET1_SEED)
    v = torch.from_numpy(frames[:256])
    u = torch.rand((256, NNET1_HID), generator=g)
    st = {"W": torch.from_numpy(rbm.W), "vis_bias":
          torch.from_numpy(rbm.vis_bias), "hid_bias":
          torch.from_numpy(rbm.hid_bias)}
    out = {}
    for side, dv_ in (("card", dev), ("cpu", torch.device("cpu"))):
        s = {k: t.to(dv_) for k, t in st.items()}
        p = torch.sigmoid(v.to(dv_) @ s["W"] + s["hid_bias"])
        new, err = cd1_update(s, v.to(dv_), u.to(dv_), NNET1_RBM_LR_GAUSS,
                              True)
        out[side] = ({k: t.cpu().numpy() for k, t in new.items()},
                     float(err), (u < p.cpu()).numpy())
    flips = int((out["card"][2] != out["cpu"][2]).sum())
    err = max(_rel(out["card"][0][k], out["cpu"][0][k]) for k in st)
    bar = 1e-5 + flips * NNET1_RBM_LR_GAUSS * float(
        np.abs(frames[:256]).max()) / 256
    held("CD-1 step: card = CPU with the same draws", err <= bar,
         f"{err:.2e} ({flips} flips of {u.numel()} samples)")
    return {"err": err, "flips": flips}


def _leaves_rel(got, want) -> float:
    """The largest ``_rel`` over two nnet1 parameter trees' leaves (inf
    when their keys differ)."""
    from kaldi_tpu_torch.am.nnet2 import tree_leaves
    lg, lw = dict(tree_leaves(got)), dict(tree_leaves(want))
    if sorted(lg) != sorted(lw):
        return float("inf")
    return max(_rel(lg[k], lw[k]) for k in lw)


def _delta_rel(got, want, start) -> float:
    """How far a trained tree is from another training's, relative to
    the larger update: max |got - want| / max |want - start| over the
    leaves."""
    from kaldi_tpu_torch.am.nnet2 import tree_leaves
    lg, lw, ls = (dict(tree_leaves(t)) for t in (got, want, start))
    num = max(float(np.abs(np.asarray(lg[k], np.float64)
                           - np.asarray(lw[k], np.float64)).max()) for k in lw)
    den = max(float(np.abs(np.asarray(lw[k], np.float64)
                           - np.asarray(ls[k], np.float64)).max()) for k in lw)
    return num / max(den, 1e-30)


def nloop_finetune(T, held, d, dv, dev, rep, dbn, P):
    """22c: nnet-set-learnrate freezes the DBN for one pass of the
    output layer (held bit for bit, and against finetune_xent on the
    card), then nnet-train-frmshuff a pass at a time with the cv set's
    cross-entropy and frame accuracy after each; one step on the card
    against the CPU.  → the final model's path."""
    from kaldi_tpu_torch.am import nnet1 as n1
    from kaldi_tpu_torch.cli.tools_bank19 import nnet1_frames
    trn, pdf = f"ark:{d}/norm440_trn.ark", f"ark:{d}/pdf_tr.ark"
    pdfs = _serve_read(pdf, "ivec")
    cvf = _serve_read(f"ark:{d}/norm440_cv.ark", "mat")
    coefs = ":".join(["0"] * NNET1_DEPTH + ["1"])
    T("nnet-set-learnrate", f"--coefs={coefs}", dbn, f"{d}/lr.nnet")
    T("nnet-train-frmshuff", dv, "--num-epochs=1",
      f"--learning-rate={NNET1_LR}", f"{d}/lr.nnet", trn, pdf,
      f"{d}/ft0.nnet")
    p0, hid, _n, _ = n1.load_nnet1(dbn)
    p1, _h, _n, pri = n1.load_nnet1(f"{d}/ft0.nnet")
    frozen = all(np.array_equal(p1[f"hidden{i + 1}"][k],
                                p0[f"hidden{i + 1}"][k])
                 for i in range(NNET1_DEPTH) for k in ("kernel", "bias"))
    frames, targets = nnet1_frames(trn, pdf)
    factors = {n: float(c) for n, c in zip(n1.layer_names(hid),
                                          coefs.split(":"))}
    lib, _loss = n1.finetune_xent(p0, hid, P, frames, targets, num_epochs=1,
                                  lr=NNET1_LR, lr_factors=factors, device=dev)
    err = _leaves_rel(p1, lib)
    counts = np.bincount(targets, minlength=P) + 0.5
    held("nnet-set-learnrate | nnet-train-frmshuff: the DBN frozen bit for "
         "bit, = finetune_xent, priors the targets' counts + 0.5",
         frozen and err <= 1e-4 and np.array_equal(pri, counts.astype(
             np.float32)) and not np.array_equal(
                 p1["output_affine"]["kernel"],
                 p0["output_affine"]["kernel"]), f"{err:.2e}")
    diag = [_cv_diag(n1.nnet1_model(p1, hid, P, dev), cvf, pdfs, dev)]
    prev, lr = f"{d}/ft0.nnet", NNET1_LR
    for e in range(1, NNET1_FT_EPOCHS + 1):
        if e > NNET1_FT_EPOCHS - NNET1_HALVINGS:
            lr /= 2
        T("nnet-train-frmshuff", dv, "--num-epochs=1",
          f"--learning-rate={lr}", prev, trn, pdf, f"{d}/ft{e}.nnet")
        prev = f"{d}/ft{e}.nnet"
        diag.append(_cv_diag(n1.nnet1_model(n1.load_nnet1(prev)[0], hid, P,
                                            dev), cvf, pdfs, dev))
    T("nnet-copy", prev, f"{d}/final.nnet")
    with open(prev, "rb") as f, open(f"{d}/final.nnet", "rb") as g:
        same = f.read() == g.read()
    held("nnet-train-frmshuff passes: the cv cross-entropy falls; nnet-copy",
         same and diag[-1][0] < diag[0][0],
         " → ".join(f"{x:.3f}" for x, _a in diag))
    rep["ft_diag"] = diag
    # card = CPU: one step (one utterance's frames, one minibatch)
    one = _subset_ark(trn, [next(iter(_serve_read(trn, "mat")))],
                      f"{d}/one.ark")
    for side in (dv, "--device=cpu"):
        T("nnet-train-frmshuff", side, "--num-epochs=1", f"{d}/final.nnet",
          one, pdf, f"{d}/step.{side[9:]}.nnet")
    a = n1.load_nnet1(f"{d}/step.{dv[9:]}.nnet")[0]
    b = n1.load_nnet1(f"{d}/step.cpu.nnet")[0]
    start = n1.load_nnet1(f"{d}/final.nnet")[0]
    err, derr = _leaves_rel(a, b), _delta_rel(a, b, start)
    held("nnet-train-frmshuff step: card = CPU", err <= 1e-4,
         f"{err:.2e} ({derr:.2e} of the step)")
    rep["ft_step"] = [err, derr]
    return f"{d}/final.nnet"


def nloop_decode(T, held, d, dv, dev, rep, final, P):
    """22d: nnet-forward --feature-transform --divide-by-priors on the
    test set (held against the library's forward) | latgen-faster-mapped
    on 10b's HCLG (compile-graph), the WER, lattice-to-nbest."""
    from kaldi_tpu_torch.am import nnet1 as n1
    from kaldi_tpu_torch.am.transforms import apply_transform
    from kaldi_tpu_torch.cli.tools_bank19 import nnet1_log_priors
    from kaldi_tpu_torch.cli.tools_bank25 import read_nnet1_transform
    T("compile-graph", f"{d}/lexicon.txt", f"{d}/tri3b.mdl", f"{d}/G.fst",
      f"{d}/HCLG.fst")
    T("nnet-forward", dv, "--divide-by-priors=true",
      f"--feature-transform={d}/ft.nnet", final, f"ark:{d}/raw440_te.ark",
      f"ark:{d}/pll_te.ark")
    params, hid, _n, pri = n1.load_nnet1(final)
    model = n1.nnet1_model(params, hid, P, dev)
    ft = read_nnet1_transform(f"{d}/ft.nnet")
    lp = torch.from_numpy(nnet1_log_priors(pri)).to(dev)
    got = _serve_read(f"ark:{d}/pll_te.ark", "mat")
    raw = _serve_read(f"ark:{d}/raw440_te.ark", "mat")
    with torch.no_grad():
        err = max(_rel(got[k], (model(apply_transform(
            torch.from_numpy(x).to(dev), ft)) - lp).cpu())
            for k, x in raw.items())
    held("nnet-forward --feature-transform --divide-by-priors = SigmoidDnn "
         "- log priors", err <= NLOOP_TOL and sorted(got) == sorted(raw),
         f"{err:.2e}")
    T("latgen-faster-mapped", dv, *NNET1_DECODE,
      f"--word-symbol-table={d}/words.txt", f"{d}/tri3b.mdl",
      f"{d}/HCLG.fst", f"ark:{d}/pll_te.ark", f"ark:{d}/lat_te.ark",
      f"ark,t:{d}/hyp_te.txt")
    out = T("compute-wer", f"ark:{d}/text_te.ark",
            f"ark,t:{d}/hyp_te.txt").strip()
    wer = _wer_of(out)
    held(f"the nnet1 hybrid's WER ≤ {NNET1_WER_MAX:g}", wer <= NNET1_WER_MAX,
         out)
    T("lattice-to-nbest", "--n=3", f"ark:{d}/lat_te.ark",
      f"ark:{d}/nbest.ark")
    nb = _serve_read(f"ark:{d}/nbest.ark", "clat")
    held("lattice-to-nbest: 1 to 3 paths an utterance",
         all(any(f"{k}-{i}" in nb for i in (1, 2, 3)) for k in raw)
         and all(len(c.arcs[c.start]) <= 1 for c in nb.values()),
         f"{len(nb)} paths")
    rep["wer"] = out


def _agreement(ali, ref, tid_to_pdf) -> float:
    """The share of frames whose pdf agrees between two alignments."""
    same = tot = 0
    for k, a in ali.items():
        b = np.asarray(ref[k])
        n = min(len(a), len(b))
        same += int((tid_to_pdf[np.asarray(a[:n])]
                     == tid_to_pdf[b[:n]]).sum())
        tot += n
    return same / max(tot, 1)


def _aligned_by_library(graphs, scores, tid_to_pdf, dev, scale) -> dict:
    """DenseAligner on ``dev`` over ``scores`` (key → (T, P) tensor), one
    utterance a call over the table's padded graphs, as the tools."""
    from kaldi_tpu_torch.decoder.align import (DenseAligner, in_degrees,
                                               pack_dense_reverse)
    ae = an = smax = 1
    for g in graphs.values():
        e, n = in_degrees(g)
        ae, an, smax = max(ae, e), max(an, n), max(smax, g.num_states)
    aligner = DenseAligner(tid_to_pdf, acoustic_scale=scale, device=dev)
    out = {}
    for k, ll in scores.items():
        (tids, _c), = aligner.align_batch(
            [pack_dense_reverse(graphs[k], smax, ae, an)], [ll])
        out[k] = list(tids)
    return out


def nloop_realign(T, held, d, dv, dev, rep, final, tm):
    """22e: steps/nnet/align.sh — nnet-forward --divide-by-priors on the
    training set | align-compiled-mapped over compile-train-graphs'
    graphs, held against DenseAligner; its agreement with 10b's tri3b
    alignments; train-transitions on it."""
    from kaldi_tpu_torch.am.serialize import write_transition_model
    from kaldi_tpu_torch.core import io as kio
    T("nnet-forward", dv, "--divide-by-priors=true", final,
      f"ark:{d}/norm440_tr.ark", f"ark:{d}/pll_tr.ark")
    T("compile-train-graphs", f"{d}/lexicon.txt", f"{d}/tri3b.mdl",
      f"ark:{d}/text_tr.ark", f"ark:{d}/graphs_tr.ark")
    T("align-compiled-mapped", dv, "--acoustic-scale=0.1", f"{d}/tri3b.mdl",
      f"ark:{d}/graphs_tr.ark", f"ark:{d}/pll_tr.ark", f"ark:{d}/ali1.ark")
    ali = _serve_read(f"ark:{d}/ali1.ark", "ivec")
    graphs = _serve_read(f"ark:{d}/graphs_tr.ark", "fst")
    pll = _serve_read(f"ark:{d}/pll_tr.ark", "mat")
    keys = sorted(pll)[:8]
    lib = _aligned_by_library(graphs, {k: torch.from_numpy(pll[k]).to(dev)
                                       for k in keys},
                              tm.tid_to_pdf_array, dev, 0.1)
    held("align-compiled-mapped = DenseAligner", sorted(ali) == sorted(pll)
         and all(list(ali[k]) == lib[k] for k in keys),
         f"{len(ali)} utterances")
    ref = _serve_read(f"ark:{d}/ali_tr.ark", "ivec")
    rep["agree_nnet1"] = _agreement(ali, ref, tm.tid_to_pdf_array)
    with kio.open_wxfilename(f"{d}/tri3b.tm") as f:
        kio.init_kaldi_output_stream(f)
        write_transition_model(f, tm)
    T("train-transitions", f"{d}/tri3b.tm", f"ark:{d}/ali1.ark",
      f"{d}/nnet1.tm")


def nloop_sequence(T, held, d, dv, dev, rep, final, tm, trn, P):
    """22f: steps/nnet/make_denlats.sh + train_mpe.sh on a few
    utterances: latgen-faster-mapped's lattices (lattice beam 3), then one
    nnet-train-mmi-sequential and one -mpe-sequential pass, each held
    against the library (am/discriminative.py, ε arcs removed, plain SGD)
    on the card."""
    from kaldi_tpu_torch.am import nnet1 as n1
    from kaldi_tpu_torch.am.discriminative import (lattice_to,
                                                   lattice_to_dense,
                                                   mmi_objf,
                                                   remove_eps_arcs,
                                                   smbr_objf)
    from kaldi_tpu_torch.lattice.lattice import compact_to_lattice
    seq = trn[:NNET1_SEQ_UTTS]
    pll = _subset_ark(f"ark:{d}/pll_tr.ark", seq, f"{d}/pll_seq.ark")
    feats = _subset_ark(f"ark:{d}/norm440_tr.ark", seq, f"{d}/norm_seq.ark")
    T("latgen-faster-mapped", dv, *NNET1_SEQ_LAT, f"{d}/tri3b.mdl",
      f"{d}/HCLG.fst", pll, f"ark:{d}/lat_seq.ark")
    lats = _serve_read(f"ark:{d}/lat_seq.ark", "clat")
    ali = _serve_read(f"ark:{d}/ali_tr.ark", "ivec")
    x = _serve_read(feats, "mat")
    lr = 1e-3
    start, hid, _n, _ = n1.load_nnet1(final)
    rep["seq_states"] = sum(c.num_states for c in lats.values())
    for name, crit in (("nnet-train-mmi-sequential", "mmi"),
                       ("nnet-train-mpe-sequential", "mpe")):
        T(name, dv, f"--learn-rate={lr}", f"{d}/tri3b.mdl", final, feats,
          f"ark:{d}/ali_tr.ark", f"ark:{d}/lat_seq.ark", f"{d}/{crit}.nnet")
        model = n1.nnet1_model(start, hid, P, dev).train()
        for k in seq:
            raw = compact_to_lattice(lats[k])
            if any(a.ilabel == 0 for arcs in raw.arcs for a in arcs):
                raw = remove_eps_arcs(raw)
            dense = lattice_to_dense(raw, tm.tid_to_pdf_array)
            num = tm.tid_to_pdf_array[np.asarray(ali[k], np.int64)]
            sc = model(torch.from_numpy(x[k][:dense.T]).to(dev))
            lat = lattice_to(dense, dev)
            objf = (mmi_objf(lat, sc, num[:dense.T], 0.1) if crit == "mmi"
                    else smbr_objf(lat, sc, (np.asarray(dense.pdf)
                                             == num[:dense.T, None])
                                   .astype(np.float32), 0.1))
            n1.sgd_step(model, -objf, lr)
        got = n1.load_nnet1(f"{d}/{crit}.nnet")[0]
        derr = _delta_rel(got, n1.nnet1_params(model), start)
        held(f"{name} = the library's {crit} SGD (ε arcs removed)",
             derr <= 1e-3, f"{derr:.2e} of the update")
        rep[f"seq_{crit}"] = derr
    T("nnet1-to-raw-nnet", final, f"{d}/final.raw1")
    from kaldi_tpu_torch.am.raw_nnet import forward, load_raw_nnet
    k = seq[0]
    with torch.no_grad():
        want = n1.nnet1_model(start, hid, P, dev)(
            torch.from_numpy(x[k]).to(dev)).cpu()
        err = _rel(forward(load_raw_nnet(f"{d}/final.raw1"), x[k],
                           dev).cpu(), want)
    held("nnet1-to-raw-nnet: raw_nnet.forward = SigmoidDnn",
         err <= NLOOP_TOL, f"{err:.2e}")


def _prob_numbers(line: str):
    w = line.split()
    return float(w[3]), float(w[5]), int(w[7])


def nloop_nnet3(T, held, d, dv, dev, rep, trn, cv, tm, P):
    """22g: nnet3's train_dnn.py loop at phases 5 and 8b's width —
    nnet3-init, egs (get-egs, shuffle, copy, subsets, merge,
    get-egs-simple), two nnet3-train jobs on halves of the training set,
    nnet3-average, nnet3-combine, nnet3-compute-prob on both subsets for
    each model, the .mdl tools, LDA stats, compute-from-egs, and
    nnet3-align-compiled; each computing tool held against the library on
    the card, nnet3-compute-prob also against the CPU."""
    from kaldi_tpu_torch.am.serialize import (read_transition_model,
                                              write_transition_model)
    from kaldi_tpu_torch.am.transforms import LdaEstimate
    from kaldi_tpu_torch.cli.tools_bank14 import compute_prob
    from kaldi_tpu_torch.cli.tools_bank16 import _read_raw_auto, combine_xent
    from kaldi_tpu_torch.cli.tools_bank23 import _split_mdl, _write_mdl_blobs
    from kaldi_tpu_torch.core import io as kio
    from kaldi_tpu_torch.core.table import SequentialTableReader
    import io as pio
    width = (f"--hidden-dim={NNET3_HID}", f"--bottleneck-dim={NNET3_BN}",
             f"--num-layers={NNET3_LAYERS}")
    pdf = f"ark:{d}/pdf_tr.ark"

    def raw(path):
        with open(path, "rb") as f:
            return f.read()

    T("nnet3-init", f"--feat-dim={NLOOP_BINS}", f"--num-pdfs={P}", *width,
      f"--srand={NNET1_SEED}", f"{d}/0.raw")
    info = T("nnet3-info", f"{d}/0.raw")
    T("nnet3-copy", f"{d}/0.raw", f"{d}/0c.raw")
    held("nnet3-init | nnet3-info | nnet3-copy",
         info.startswith("num-components") and raw(f"{d}/0.raw")
         == raw(f"{d}/0c.raw"), info.splitlines()[0])
    chunk = f"--chunk-size={NNET3_CHUNK}"
    T("nnet3-get-egs", chunk, f"ark:{d}/norm40_trn.ark", pdf,
      f"ark:{d}/egs_trn.ark")
    T("nnet3-get-egs", chunk, f"ark:{d}/norm40_cv.ark", pdf,
      f"ark:{d}/egs_cv.ark")
    T("nnet3-shuffle-egs", "--srand=1", f"ark:{d}/egs_trn.ark",
      f"ark:{d}/egs_shuf.ark")
    T("nnet3-copy-egs", f"ark:{d}/egs_shuf.ark", f"ark:{d}/egs_copy.ark")
    T("nnet3-subset-egs", f"--n={NNET3_SUBSET}", "--srand=2",
      f"ark:{d}/egs_shuf.ark", f"ark:{d}/egs_diag.ark")
    T("nnet3-subset-egs", f"--n={NNET3_SUBSET}", "--srand=3",
      f"ark:{d}/egs_cv.ark", f"ark:{d}/egs_valid.ark")
    for s in ("diag", "valid"):
        T("nnet3-merge-egs", f"--minibatch-size={NNET3_MERGE}",
          f"ark:{d}/egs_{s}.ark", f"ark:{d}/egs_{s}_m.ark")
    T("nnet3-get-egs-simple", f"ark:{d}/norm40_cv.ark", pdf,
      f"ark:{d}/egs_simple.ark")
    n_egs = len(_serve_read(f"ark:{d}/egs_shuf.ark", "xeg"))
    merged = _serve_read(f"ark:{d}/egs_valid_m.ark", "xeg")
    held("the egs: shuffled, copied, subsets, merged, whole utterances",
         raw(f"{d}/egs_shuf.ark") == raw(f"{d}/egs_copy.ark")
         and len(_serve_read(f"ark:{d}/egs_diag.ark", "xeg"))
         == min(NNET3_SUBSET, n_egs)
         and max(e.pdfs.shape[0] for e in merged.values()) == NNET3_MERGE
         and len(_serve_read(f"ark:{d}/egs_simple.ark", "xeg")) == len(cv),
         f"{n_egs} training egs of {NNET3_CHUNK} frames")
    # two jobs on halves of the training set, from one seed, averaged
    for j, part in ((1, trn[0::2]), (2, trn[1::2])):
        feats = _subset_ark(f"ark:{d}/norm40_trn.ark", part,
                            f"{d}/norm40_job{j}.ark")
        T("nnet3-train", dv, f"--num-pdfs={P}", *width,
          f"--num-epochs={NNET3_EPOCHS}", feats, pdf, f"{d}/job{j}.raw")
    T("nnet3-average", f"{d}/avg.raw", f"{d}/job1.raw", f"{d}/job2.raw")
    T("nnet3-combine", dv, f"--num-iters={NNET3_COMBINE_ITERS}",
      f"ark:{d}/norm40_cv.ark", pdf, f"{d}/job1.raw", f"{d}/job2.raw",
      f"{d}/comb.raw")
    nets = [_read_raw_auto(f"{d}/job{j}.raw", dev)[0] for j in (1, 2)]
    cvx = _serve_read(f"ark:{d}/norm40_cv.ark", "mat")
    alis = _serve_read(pdf, "ivec")
    sd, wts = combine_xent(
        nets, [torch.from_numpy(cvx[k]).to(dev) for k in cvx],
        [torch.from_numpy(np.asarray(alis[k], np.int64)[:len(cvx[k])])
         .to(dev) for k in cvx], NNET3_COMBINE_ITERS)
    got = _read_raw_auto(f"{d}/comb.raw", dev)[0].state_dict()
    err = max(_rel(got[k].cpu(), sd[k].cpu()) for k in sd)
    held("nnet3-combine = combine_xent (Adam over the weight logits)",
         err <= NLOOP_TOL, f"weights {np.round(wts, 4).tolist()}, {err:.2e}")
    rep["combine_weights"] = [float(w) for w in wts]
    probs = {}
    for m in ("0", "job1", "job2", "avg", "comb"):
        for s in ("diag", "valid"):
            probs[f"{m} {s}"] = T("nnet3-compute-prob", dv, f"{d}/{m}.raw",
                                  f"ark:{d}/egs_{s}_m.ark").strip()
    rep["compute_prob"] = probs
    net = _read_raw_auto(f"{d}/comb.raw", dev)[0]
    lp, correct, n = compute_prob(net, f"ark:{d}/egs_valid_m.ark", dev)
    g = _prob_numbers(probs["comb valid"])
    held("nnet3-compute-prob = the library's", abs(g[0] - lp / n) <= 1e-4
         and abs(g[1] - correct / n) <= 1e-4 and g[2] == n, probs["comb valid"])
    cpu = T("nnet3-compute-prob", "--device=cpu", f"{d}/comb.raw",
            f"ark:{d}/egs_valid_m.ark").strip()
    c = _prob_numbers(cpu)
    held("nnet3-compute-prob: card = CPU", abs(g[0] - c[0]) <= 1.5e-4
         and abs(g[1] - c[1]) <= 1.5e-4 and g[2] == c[2], cpu)
    # the .mdl tools, LDA stats, outputs from egs
    T("nnet3-am-init", f"{d}/tri3b.mdl", f"{d}/comb.raw", f"{d}/comb.mdl")
    info = T("nnet3-am-info", f"{d}/comb.mdl")
    T("nnet3-am-train-transitions", f"{d}/comb.mdl", f"ark:{d}/ali_tr.ark",
      f"{d}/comb2.mdl")
    tm_blob, nnet_blob, _p = _split_mdl(f"{d}/comb.mdl")
    tm2 = read_transition_model(pio.BytesIO(tm_blob))
    cnt = np.zeros(tm2.num_transition_ids + 1)
    for a in _serve_read(f"ark:{d}/ali_tr.ark", "ivec").values():
        np.add.at(cnt, np.asarray(a, np.int64), 1.0)
    tm2.mle_update(cnt)
    buf = pio.BytesIO()
    write_transition_model(buf, tm2)
    _write_mdl_blobs(f"{d}/want.mdl", buf.getvalue(), nnet_blob)
    held("nnet3-am-init | nnet3-am-info | nnet3-am-train-transitions",
         nnet_blob == raw(f"{d}/comb.raw")[2:] and info.startswith(
             "num-components") and raw(f"{d}/comb2.mdl")
         == raw(f"{d}/want.mdl"), "")
    T("nnet3-acc-lda-stats", f"--num-pdfs={P}", f"ark:{d}/egs_shuf.ark",
      f"{d}/lda.acc")
    lda = LdaEstimate(P, NLOOP_BINS)
    egs = list(SequentialTableReader(f"ark:{d}/egs_shuf.ark", holder="xeg"))
    lda.accumulate_batch(
        np.concatenate([e.feats.reshape(-1, NLOOP_BINS) for _k, e in egs]
                       ).astype(np.float64),
        np.concatenate([e.pdfs.reshape(-1) for _k, e in egs]))
    with kio.open_rxfilename(f"{d}/lda.acc") as f:
        kio.init_kaldi_input_stream(f)
        kio.expect_token(f, "<LDAACCS>")
        accs = [np.asarray(kio.read_matrix(f), np.float64) for _ in range(3)]
    err = max(_rel(a, np.asarray(b, np.float32)) for a, b in zip(
        accs, (lda.counts[None, :], lda.first, lda.total_second)))
    held("nnet3-acc-lda-stats = LdaEstimate", err <= 1e-6, f"{err:.2e}")
    T("nnet3-compute-from-egs", dv, f"{d}/comb.raw",
      f"ark:{d}/egs_valid_m.ark", f"ark:{d}/cfe.ark")
    cfe = _serve_read(f"ark:{d}/cfe.ark", "mat")
    with torch.no_grad():
        err = max(_rel(cfe[k], torch.log_softmax(net(torch.from_numpy(
            e.feats).to(dev)), -1).reshape(-1, P).cpu())
            for k, e in merged.items())
    held("nnet3-compute-from-egs = TdnnChain's log-softmax, every sequence",
         err <= NLOOP_TOL and sorted(cfe) == sorted(merged), f"{err:.2e}")
    # realignment
    T("nnet3-align-compiled", dv, "--acoustic-scale=0.1", f"{d}/tri3b.mdl",
      f"{d}/comb.raw", f"ark:{d}/graphs_tr.ark", f"ark:{d}/norm40_tr.ark",
      f"ark:{d}/ali3.ark")
    ali = _serve_read(f"ark:{d}/ali3.ark", "ivec")
    x40 = _serve_read(f"ark:{d}/norm40_tr.ark", "mat")
    keys = sorted(x40)[:8]
    with torch.no_grad():
        scores = {k: net(torch.from_numpy(x40[k]).to(dev)[None])[0]
                  for k in keys}
    lib = _aligned_by_library(_serve_read(f"ark:{d}/graphs_tr.ark", "fst"),
                              scores, tm.tid_to_pdf_array, dev, 0.1)
    held("nnet3-align-compiled = DenseAligner on TdnnChain's outputs",
         sorted(ali) == sorted(x40) and all(list(ali[k]) == lib[k]
                                            for k in keys),
         f"{len(ali)} utterances")
    rep["agree_nnet3"] = _agreement(
        ali, _serve_read(f"ark:{d}/ali_tr.ark", "ivec"), tm.tid_to_pdf_array)


def nnet_loop_worker(argv) -> int:
    """22's background process: 22a–22h in turn, every tool a call of the
    port's registry in this process, each held against the library on the
    same card, the fbank kernel's count set to 0 before each call and read
    after it.  Writes ``report.json`` into the directory; exits 1 if a
    check fails."""
    import contextlib
    import io
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import kaldi_tpu_torch.features  # noqa: F401  (before ops.fbank)
    from kaldi_tpu_torch.am import nnet1 as n1
    from kaldi_tpu_torch.am.serialize import read_mdl
    from kaldi_tpu_torch.cli import TOOLS
    from kaldi_tpu_torch.ops.fbank import CudaFbank
    t_start = time.perf_counter()
    d, dv_ = argv[0], argv[1]
    dev = torch.device(dv_, 0) if dv_ == "cuda" else torch.device(dv_)
    dv = f"--device={dev.type}"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the host's cores go to the main process first: this worker has
    # until the join, after phase 21's, for its work
    os.nice(10)
    calls, checks, walls, rep, launches = [], [], {}, {}, {}

    def T(name, *args):
        """Tool ``name``, its fbank launches counted and its wall added
        up; → what it printed."""
        out = io.StringIO()
        CudaFbank.total_launches = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = TOOLS[name]([str(a) for a in args])
        walls[name] = walls.get(name, 0.0) + time.perf_counter() - t0
        launches[name] = launches.get(name, 0) + CudaFbank.total_launches
        if rc:
            raise AssertionError(f"{name}: rc {rc}")
        calls.append(name)
        return out.getvalue()

    def held(name, ok, detail):
        checks.append((name, bool(ok), detail))

    # each RBM's reconstruction MSE per pass, as the tool trains it
    rbm_errs = []
    train_rbm = n1.train_rbm

    def recorded(*a, **k):
        rbm, errs = train_rbm(*a, **k)
        rbm_errs.append(errs)
        return rbm, errs

    n1.train_rbm = recorded
    recorded.inner = train_rbm
    tm, _ = read_mdl(f"{d}/tri3b.mdl", device="cpu")
    P = tm.num_pdfs
    stages = {}

    def stage(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(T, held, d, dv, dev, rep, *a)
        stages[name] = time.perf_counter() - t0
        return out

    fb, waves, trn, cv = stage("22a features", nloop_features)
    dbn = stage("22b pretraining", nloop_pretrain, P)
    rep["rbm_errs"] = [e for e in rbm_errs]
    final = stage("22c fine-tuning", nloop_finetune, dbn, P)
    stage("22d decode", nloop_decode, final, P)
    stage("22e realignment", nloop_realign, final, tm)
    stage("22f sequence training", nloop_sequence, final, tm, trn, P)
    stage("22g nnet3 loop", nloop_nnet3, trn, cv, tm, P)
    rep["fbank_err"] = check_path_fbank(fb, waves[:4], "nnet loop: 22h")
    with open(f"{d}/meta.json") as f:
        rep["ladder_wers"] = json.load(f)["wers"]
    with open(f"{d}/report.json", "w") as f:
        json.dump({"walls": walls, "stages": stages, "checks": checks,
                   "calls": len(calls), "tools": sorted(set(calls)),
                   "launches": launches,
                   "total": time.perf_counter() - t_start, **rep}, f,
                  default=float)
    bad = [c for c in checks if not c[1]]
    if bad:
        print(f"nnet loop: {len(bad)} checks failed: {bad[:5]}",
              file=sys.stderr)
        return 1
    return 0


def nnet_loop_finish(started, tag: str):
    """22, joined before the kernels line: the worker's exit, its checks,
    each tool's wall and fbank launches, the RBMs' reconstruction errors,
    the fine-tuning's cross-entropy and frame accuracy a pass, the nnet3
    diagnostics and combination weights, the WER beside 10b's, the
    realignments' agreement with 10b's, the worker's wall and the main
    process's wait here.  → (fbank launches, the fbank kernel's max |diff|
    from its plain version at 40 bins, 8 kHz)."""
    proc, d, t0 = started
    t_wait = time.perf_counter()
    proc.wait(timeout=NLOOP_JOIN)
    wait = time.perf_counter() - t_wait
    wall = time.perf_counter() - t0
    with open(f"{d}/worker.err") as f:
        err = f.read()
    # a worker whose checks failed still writes its report: print it
    if not os.path.exists(f"{d}/report.json"):
        raise AssertionError(f"nnet loop failed ({proc.returncode}):\n"
                             f"{err[-3000:]}")
    with open(f"{d}/report.json") as f:
        rep = json.load(f)
    fb = rep["launches"].get("compute-fbank-feats", 0)
    a, c, t = rep["utts"]
    print(f"nnet loop: {rep['calls']} tool calls of {len(rep['tools'])} tools "
          f"in one background process on 10b's {a} + {c} training (cv) and "
          f"{t} test utterances, {rep['frames']} frames: {wall:.1f} s to the "
          f"join ({rep['total']:.1f} s of work after its imports); the main "
          f"process waited {wait:.1f} s here {tag}")
    for name, ok, detail in rep["checks"]:
        print(f"nnet loop:   {name}: {'held' if ok else 'FAILED'}"
              + (f" ({detail})" if detail else ""))
    print("nnet loop: stages " + ", ".join(f"{n} {v:.1f} s" for n, v in
                                           rep["stages"].items()))
    print("nnet loop: tool walls " + ", ".join(
        f"{n} {v:.2f} s" for n, v in sorted(rep["walls"].items(),
                                            key=lambda x: -x[1])))
    for i, errs in enumerate(rep["rbm_errs"]):
        print(f"nnet loop: RBM {i + 1} ({'Gaussian' if i == 0 else 'Bernoulli'}"
              f"-Bernoulli, {NNET1_HID} hidden): reconstruction MSE a pass "
              + " ".join(f"{e:.4f}" for e in errs)
              + f"; its hidden units' std over frames {rep['rbm_hstd'][i]:.4f}")
    for e, (x, acc) in enumerate(rep["ft_diag"]):
        print(f"nnet loop: fine-tuning pass {e} "
              f"({'output layer only' if e == 0 else 'all layers'}): cv "
              f"cross-entropy {x:.4f}, frame accuracy {acc:.4f}")
    for k, line in rep["compute_prob"].items():
        print(f"nnet loop: nnet3-compute-prob {k}: {line}")
    print(f"nnet loop: nnet3-combine weights {rep['combine_weights']}")
    wers = rep["ladder_wers"]
    print(f"nnet loop: the nnet1 hybrid {rep['wer']} (10b: "
          + ", ".join(f"{k} {v:.2f}" for k, v in wers.items())
          + f") {tag}")
    print(f"nnet loop: realignments agree with 10b's tri3b alignments on "
          f"{100 * rep['agree_nnet1']:.2f}% (nnet1, align-compiled-mapped) "
          f"and {100 * rep['agree_nnet3']:.2f}% (nnet3-align-compiled) of "
          "the frames' pdfs")
    with open(f"{d}/worker.out") as f:      # 22h's kernel check
        print("".join(ln for ln in f if ln.startswith("nnet loop: 22")),
              end="")
    print(f"nnet loop: fbank kernel launches {fb} (compute-fbank-feats); "
          f"launches per tool " + ", ".join(
              f"{n} {v}" for n, v in rep["launches"].items() if v)
          + f"; 22h fbank kernel vs plain max |diff| {rep['fbank_err']:.3e} "
          f"{tag}")
    bad = [c for c in rep["checks"] if not c[1]]
    if bad or proc.returncode != 0:
        raise AssertionError(f"22: {len(bad)} checks failed: {bad[:3]} "
                             f"(worker exit {proc.returncode})")
    if fb <= 0:
        raise AssertionError(f"22: fbank launches {rep['launches']}")
    return fb, rep["fbank_err"]


# ---------------------------------------------------------------------------
# 23. Kaldi's nnet2 training recipe as the port's tools
# (steps/nnet2/train_pnorm_simple.sh and train_discriminative.sh run as
# binaries, with utils/' data-directory scripts) on 10b's corpus from 22's
# inputs, at the LibriSpeech online nnet2 network's width
# ---------------------------------------------------------------------------

N2T_DIR = os.path.join("build", "chip_smoke_nnet2_train")
N2T_SPLICE = 4             # ±4 frames of 40 fbank bins: 360 inputs
# nnet-am-init's input: 72 · 5 (its splice −2…2) = 360, so the network
# takes the pre-spliced, transformed frames (and egs windows) as they are
N2T_FEAT_DIM = 72
N2T_JOBS = 4               # split-data's jobs, one nnet-train-simple each
N2T_VALID_PER_SPK = 2      # subset-data-dir --per-spk: the validation set
N2T_ITERS = 16             # iterations of the jobs and nnet-am-average
N2T_LR = (0.07, 0.01)      # nnet-train-simple's rate, first and last
# train_pnorm_simple.sh's add_layers_period: nnet-am-init makes one hidden
# layer, nnet-insert adds one every N2T_ADD iterations up to NNET2_LAYERS
N2T_ADD = 2
N2T_CHUNK = 16             # frames a step of nnet-train-simple
N2T_SRAND = 23
N2T_SUBSET = 20            # egs in each diagnostic subset
N2T_COMBINE = 3            # the last iterations' models combined
N2T_WER_MAX = 30.0
N2T_SEQ_UTTS = 4           # training utterances through sequence training
N2T_SEQ_LR = 5e-5          # the discriminative trainers' default
N2T_LAT = ("--beam=13", "--lattice-beam=3", "--acoustic-scale=0.1")
N2T_GAP = 0.5              # seconds of silence at each join of 23b
N2T_TOL = 1e-4             # card = CPU: leaves within this of the largest
# card = CPU against the update, max |card − cpu| / max |cpu − start|: a
# card that takes no step scores 1, one whose step points elsewhere ~2
N2T_STEP_TOL = 1e-3        # the SGD trainers (and nnet-combine's weights)
# The Adam trainers (23i, one step on one eg): Adam's first step is
# −lr·g / (|g| + eps), ±lr wherever |g| ≫ eps, so a parameter whose
# gradient is float noise (an output row of a pdf outside the lattice:
# its gradient is softmax · (Σγ_num − Σγ_den), zero but for rounding)
# moves ±lr on either side at random.  So the step is held only where the
# CPU's gradient is at least N2T_NOISE of its leaf's largest (the card's
# gradient, held within N2T_GRAD_TOL of it, cannot flip those signs), to
# N2T_ADAM_STEP_TOL of the step: one float32 ulp of a parameter of 2 is
# 2.4e-7, 0.5% of lr = 5e-5.  And the gradient itself, which Adam's
# normalisation hides, card = CPU on every leaf.
N2T_NOISE = 1e-3
N2T_GRAD_TOL = 1e-3        # max |g_card − g_cpu| / max |g_cpu|, each leaf
N2T_ADAM_STEP_TOL = 1e-2
N2T_LIB_TOL = 1e-5         # tool = library on the same card
N2T_JOIN = 900             # the main process's longest wait, seconds


def nnet2_train_start(src: str, dev):
    """23, started: ``python3 chip_smoke.py --nnet2-train <22's inputs>
    <dir> <device>`` (``nnet2_train_worker``) in the background, two host
    threads.  → (process, dir, start time)."""
    import subprocess
    repo = os.path.dirname(os.path.abspath(__file__))
    d = os.path.join(repo, N2T_DIR)
    os.makedirs(d, exist_ok=True)
    for stale in ("report.json", "worker.out", "worker.err"):
        if os.path.exists(f"{d}/{stale}"):
            os.remove(f"{d}/{stale}")
    out = open(f"{d}/worker.out", "w")
    err = open(f"{d}/worker.err", "w")
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--nnet2-train", src, d,
         dev.type], cwd=repo, stdout=out, stderr=err,
        env=dict(os.environ, OMP_NUM_THREADS="2"))
    out.close()
    err.close()
    return proc, d, time.perf_counter()


def _raw(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def n2t_datadir(T, held, d, src, dv, dev, rep):
    """23a: 10b's training set as a data directory (wav-copy's scp, the
    transcripts, the speakers); utt2spk-to-spk2utt and back;
    validate-data-dir, a text line dropped, fix-data-dir; the validation
    set by subset-data-dir --per-spk and the training set by --utt-list;
    split-data into the jobs; sym2int / int2sym; wav-copy of the test
    waves.  → (training utterances, validation utterances, the jobs'
    utterances)."""
    import shutil
    from kaldi_tpu_torch.pipelines.datadir import (DataDir, _read_table,
                                                   read_data_dir,
                                                   write_data_dir)
    data = f"{d}/data"
    T("wav-copy", f"ark:{src}/wav_tr.ark",
      f"ark,scp:{d}/wav_tr.ark,{d}/wav_tr.scp")
    text = {k: list(v) for k, v in
            _serve_read(f"ark:{src}/text_tr.ark", "text").items()}
    write_data_dir(data, DataDir(wav_scp=_read_table(f"{d}/wav_tr.scp"),
                                 text=text,
                                 utt2spk=_read_table(f"{src}/utt2spk_tr")))
    T("utt2spk-to-spk2utt", f"{data}/utt2spk", f"{d}/spk2utt.rt")
    T("spk2utt-to-utt2spk", f"{d}/spk2utt.rt", f"{d}/utt2spk.rt")
    n, spk = len(text), len(_read_table(f"{data}/spk2utt"))
    held("utt2spk-to-spk2utt | spk2utt-to-utt2spk: there and back",
         _raw(f"{d}/spk2utt.rt") == _raw(f"{data}/spk2utt")
         and _raw(f"{d}/utt2spk.rt") == _raw(f"{data}/utt2spk"),
         f"{n} utterances, {spk} speakers")
    rcs = [T("validate-data-dir", data, rc_ok=(0, 1))[1]]
    broken = f"{d}/broken"
    shutil.rmtree(broken, ignore_errors=True)
    shutil.copytree(data, broken)
    with open(f"{broken}/text") as f:
        lines = f.read().splitlines()
    with open(f"{broken}/text", "w") as f:
        f.write("\n".join(lines[:3] + lines[4:]) + "\n")
    rcs.append(T("validate-data-dir", broken, rc_ok=(0, 1))[1])
    T("fix-data-dir", broken)
    rcs.append(T("validate-data-dir", broken, rc_ok=(0, 1))[1])
    held("validate-data-dir 0; a text line dropped, 1; fix-data-dir, 0",
         rcs == [0, 1, 0] and len(read_data_dir(broken).utt2spk) == n - 1,
         f"exits {rcs}")
    T("subset-data-dir", f"--per-spk={N2T_VALID_PER_SPK}", data,
      f"{d}/valid")
    valid = read_data_dir(f"{d}/valid").utts
    train = [u for u in sorted(text) if u not in set(valid)]
    with open(f"{d}/train.list", "w") as f:
        f.write("\n".join(train) + "\n")
    T("subset-data-dir", f"--utt-list={d}/train.list", data, f"{d}/train")
    T("split-data", f"{d}/train", str(N2T_JOBS))
    jobs = [read_data_dir(f"{d}/train/split{N2T_JOBS}/{j + 1}")
            for j in range(N2T_JOBS)]
    spks = [set(s.utt2spk.values()) for s in jobs]
    held("subset-data-dir --per-spk / --utt-list | split-data: the jobs "
         "cover the training set, each speaker in one job",
         len(valid) == N2T_VALID_PER_SPK * spk
         and sorted(u for s in jobs for u in s.utts) == train
         and sum(len(s) for s in spks) == len(set().union(*spks)),
         f"{len(train)} training, {len(valid)} validation utterances; "
         f"jobs of {[len(s.utts) for s in jobs]}")
    T("sym2int", f"{src}/words.txt", f"{data}/text", f"{d}/text.int")
    T("int2sym", f"{src}/words.txt", f"{d}/text.int", f"{d}/text.sym")
    with open(f"{d}/text.int") as f:
        ints = [w for ln in f for w in ln.split()[1:]]
    held("sym2int | int2sym: the transcripts there and back",
         _raw(f"{d}/text.sym") == _raw(f"{data}/text")
         and all(w.isdigit() for w in ints), f"{len(ints)} words")
    T("wav-copy", f"ark:{src}/wav_te.ark", f"ark:{d}/wav_te.ark")
    a = _serve_read(f"ark:{src}/wav_te.ark", "wav")
    b = _serve_read(f"ark:{d}/wav_te.ark", "wav")
    held("wav-copy: the test waves' samples equal",
         sorted(a) == sorted(b) and all(
             np.array_equal(a[k][0], b[k][0]) and a[k][1] == b[k][1]
             for k in a), f"{len(a)} waves")
    rep["utts"] = [len(train), len(valid), len(a)]
    return train, valid, [s.utts for s in jobs]


def n2t_long_audio(T, held, d, src, dv, dev, rep):
    """23b: the 30 test waves joined into 3 recordings with 0.5 s of
    silence at each join; segment-long-utterances; every utterance's span
    inside one segment, within the padding."""
    from kaldi_tpu_torch.core.table import TableWriter
    from kaldi_tpu_torch.pipelines.segment import SegmentationOptions
    waves = _serve_read(f"ark:{d}/wav_te.ark", "wav")
    keys = sorted(waves)
    rate = waves[keys[0]][1]
    gap = np.zeros(int(N2T_GAP * rate), np.float32)
    spans = []
    with TableWriter(f"ark:{d}/long.ark", holder="wav") as w:
        for r in range(3):
            parts, n = [], 0
            for k in keys[r::3]:
                x = np.asarray(waves[k][0], np.float32)
                if parts:
                    parts.append(gap)
                    n += len(gap)
                spans.append((f"rec{r}", n / rate, (n + len(x)) / rate))
                parts.append(x)
                n += len(x)
            w[f"rec{r}"] = (np.concatenate(parts).astype(np.int16), rate)
    T("segment-long-utterances", dv, f"ark:{d}/long.ark", f"{d}/segments")
    with open(f"{d}/segments") as f:
        segs = [(ln.split()[1], float(ln.split()[2]), float(ln.split()[3]))
                for ln in f if ln.strip()]
    tol = SegmentationOptions().segment_padding + 0.01
    inside = [any(r == sr and tb <= s + tol and te >= e - tol
                  for sr, tb, te in segs) for r, s, e in spans]
    held("segment-long-utterances: every utterance inside one segment "
         "(within the padding)", all(inside),
         f"{len(segs)} segments for {len(spans)} utterances, "
         f"{sum(inside)} inside")
    rep["segments"] = [len(segs), len(spans), sum(inside)]


def n2t_features(T, held, d, src, dv, dev, rep, train, valid, jobs):
    """23c: compute-fbank-feats (40 bins, 8 kHz) over the data
    directory's wav.scp and the test waves, against Fbank; CMVN per
    speaker; the ±4 splice; acc-lda on 10b's tri3b alignments;
    nnet-get-feature-transform (= LdaEstimate) and -multi with one group a
    context position (= LdaEstimate on each position's statistics, zero
    off its diagonal blocks); the transform applied (transform-feats);
    the sets' and jobs' subsets.  → the fbank computer and the test
    waves."""
    from kaldi_tpu_torch.am.transforms import LdaEstimate
    from kaldi_tpu_torch.cli.tools_bank9 import read_lda_accs
    from kaldi_tpu_torch.core import io as kio
    from kaldi_tpu_torch.features import Fbank, FbankOptions, MelBanksOptions
    from kaldi_tpu_torch.features.window import FrameExtractionOptions
    fbank_opts = ("--sample-frequency=8000", "--dither=0",
                  f"--num-mel-bins={NLOOP_BINS}")
    T("compute-fbank-feats", dv, *fbank_opts, f"scp:{d}/data/wav.scp",
      f"ark:{d}/fbank_tr.ark")
    T("compute-fbank-feats", dv, *fbank_opts, f"ark:{d}/wav_te.ark",
      f"ark:{d}/fbank_te.ark")
    fb = Fbank(FbankOptions(
        frame_opts=FrameExtractionOptions(samp_freq=8000.0, dither=0.0),
        mel_opts=MelBanksOptions(num_bins=NLOOP_BINS)), device=dev)
    waves = {k: np.asarray(w, np.float32) for k, (w, _r) in
             _serve_read(f"ark:{d}/wav_te.ark", "wav").items()}
    got = _serve_read(f"ark:{d}/fbank_te.ark", "mat")
    err = max(_rel(got[k], fb.compute(w).cpu()) for k, w in waves.items())
    held("compute-fbank-feats = Fbank (40 bins, 8 kHz)", err <= NLOOP_TOL,
         f"{err:.2e}")
    spk = {"tr": (f"{d}/data/spk2utt", f"{d}/data/utt2spk"),
           "te": (f"{src}/spk2utt_te", f"{src}/utt2spk_te")}
    ctx = (f"--left-context={N2T_SPLICE}", f"--right-context={N2T_SPLICE}")
    for s in ("tr", "te"):
        T("compute-cmvn-stats", dv, f"--spk2utt={spk[s][0]}",
          f"ark:{d}/fbank_{s}.ark", f"ark:{d}/cmvn_{s}.ark")
        T("apply-cmvn", dv, "--norm-vars=true", f"--utt2spk={spk[s][1]}",
          f"ark:{d}/cmvn_{s}.ark", f"ark:{d}/fbank_{s}.ark",
          f"ark:{d}/cmn_{s}.ark")
        T("splice-feats", dv, *ctx, f"ark:{d}/cmn_{s}.ark",
          f"ark:{d}/spl_{s}.ark")
    T("ali-to-pdf", f"{src}/tri3b.mdl", f"ark:{src}/ali_tr.ark",
      f"ark:{d}/pdf_tr.ark")
    spl = _subset_ark(f"ark:{d}/spl_tr.ark", train, f"{d}/spl_train.ark")
    T("ali-to-post", f"ark:{src}/ali_tr.ark", f"ark:{d}/post.ark")
    T("acc-lda", f"{src}/tri3b.mdl", spl, f"ark:{d}/post.ark",
      f"{d}/lda.acc")
    T("nnet-get-feature-transform", f"{d}/lda.mat", f"{d}/lda.acc")
    T("nnet-get-feature-transform-multi",
      "--context-groups=" + ":".join(str(c) for c in
                                     range(2 * N2T_SPLICE + 1)),
      f"--feat-dim={NLOOP_BINS}", f"{d}/lda.acc", f"{d}/lda_multi.mat")
    # the stats as each tool takes them: -multi as read (float32),
    # nnet-get-feature-transform summed into float64
    counts, first, second = read_lda_accs(f"{d}/lda.acc")
    mats = {}
    for name in ("lda", "lda_multi"):
        with kio.open_rxfilename(f"{d}/{name}.mat") as f:
            kio.init_kaldi_input_stream(f)
            mats[name] = np.asarray(kio.read_matrix(f), np.float64)
    lda = LdaEstimate(len(counts), first.shape[1])
    lda.counts += counts
    lda.first += first
    lda.total_second += second
    D = NLOOP_BINS * (2 * N2T_SPLICE + 1)
    want = lda.estimate(D, within_class_factor=0.001)
    multi, errs, off = mats["lda_multi"], [], 0.0
    for c in range(2 * N2T_SPLICE + 1):
        idx = np.arange(c * NLOOP_BINS, (c + 1) * NLOOP_BINS)
        sub = LdaEstimate(len(counts), NLOOP_BINS)
        sub.counts, sub.first = counts, first[:, idx]
        sub.total_second = second[np.ix_(idx, idx)]
        blk = sub.estimate(NLOOP_BINS, within_class_factor=0.001)
        rows = multi[idx]
        errs.append(max(_rel(rows[:, idx], blk[:, :-1]),
                        _rel(rows[:, -1], blk[:, -1])))
        off = max(off, float(np.abs(np.delete(rows[:, :-1], idx, 1)).max()))
    held("nnet-get-feature-transform = LdaEstimate; -multi: each context "
         "position's block = LdaEstimate of its statistics, zero off the "
         "diagonal blocks, the single transform's shape",
         _rel(mats["lda"], want) <= 1e-5 and max(errs) <= 1e-5
         and off == 0.0 and multi.shape == mats["lda"].shape == (D, D + 1),
         f"{mats['lda'].shape}, blocks {max(errs):.2e}")
    for s in ("tr", "te"):
        T("transform-feats", dv, f"{d}/lda.mat", f"ark:{d}/spl_{s}.ark",
          f"ark:{d}/x_{s}.ark")
    _subset_ark(f"ark:{d}/x_tr.ark", train, f"{d}/x_train.ark")
    _subset_ark(f"ark:{d}/x_tr.ark", valid, f"{d}/x_valid.ark")
    for j, utts in enumerate(jobs):
        _subset_ark(f"ark:{d}/x_tr.ark", utts, f"{d}/x_job{j + 1}.ark")
    rep["frames"] = sum(len(v) for v in _serve_read(
        f"ark:{d}/pdf_tr.ark", "ivec").values())
    return fb, list(waves.values())


def n2t_egs(T, held, d, src, dv, dev, rep, train):
    """23d: nnet-get-egs --provenance-keys=true (the transformed frames,
    no further context) into one archive a job and one of the
    validation set; nnet-copy-egs of the four into one; nnet-shuffle-egs;
    nnet-subset-egs of the training and validation egs (the
    diagnostics)."""
    prov = ("--left-context=0", "--right-context=0",
            "--provenance-keys=true")
    pdf = f"ark:{d}/pdf_tr.ark"
    for j in range(N2T_JOBS):
        T("nnet-get-egs", *prov, f"ark:{d}/x_job{j + 1}.ark", pdf,
          f"ark:{d}/egs.{j + 1}.ark")
    T("nnet-get-egs", *prov, f"ark:{d}/x_valid.ark", pdf,
      f"ark:{d}/egs_valid.ark")
    jobs = " ".join(f"{d}/egs.{j + 1}.ark" for j in range(N2T_JOBS))
    T("nnet-copy-egs", f"ark:cat {jobs} |", f"ark:{d}/egs_all.ark")
    T("nnet-shuffle-egs", f"--srand={N2T_SRAND}", f"ark:{d}/egs_all.ark",
      f"ark:{d}/egs_shuf.ark")
    T("nnet-subset-egs", f"--n={N2T_SUBSET}", "--srand=1",
      f"ark:{d}/egs_shuf.ark", f"ark:{d}/egs_diag.ark")
    T("nnet-subset-egs", f"--n={N2T_SUBSET}", "--srand=2",
      f"ark:{d}/egs_valid.ark", f"ark:{d}/egs_vdiag.ark")
    egs = _serve_read(f"ark:{d}/egs_all.ark", "xeg")
    shuf = _serve_read(f"ark:{d}/egs_shuf.ark", "xeg")
    n_frames = sum(len(e.pdfs) for e in egs.values())
    want = sum(len(v) for k, v in _serve_read(
        f"ark:{d}/pdf_tr.ark", "ivec").items() if k in set(train))
    held("nnet-get-egs a job | nnet-copy-egs | nnet-shuffle-egs | "
         "nnet-subset-egs: every training frame once, (B, 1, 360) windows",
         _raw(f"{d}/egs_all.ark") == b"".join(
             _raw(f"{d}/egs.{j + 1}.ark") for j in range(N2T_JOBS))
         and n_frames == want and sorted(shuf) == sorted(egs)
         and list(shuf) != list(egs)
         and len(_serve_read(f"ark:{d}/egs_diag.ark", "xeg")) == N2T_SUBSET
         and all(e.feats.shape[1:] == (1, NLOOP_BINS * 9)
                 for e in egs.values()),
         f"{len(egs)} egs, {n_frames} frames")
    rep["egs"] = [len(egs), n_frames]


def _prob(T, dv, mdl, egs) -> float:
    """nnet-compute-prob's average log-probability."""
    return float(T("nnet-compute-prob", dv, mdl, egs).strip())


def _n2_leaves_rel(a_path, b_path) -> float:
    from kaldi_tpu_torch.am.nnet2 import load_nnet2
    return _leaves_rel(load_nnet2(a_path)[0], load_nnet2(b_path)[0])


def _n2_lib_rel(path, params) -> float:
    from kaldi_tpu_torch.am.nnet2 import load_nnet2
    return _leaves_rel(load_nnet2(path)[0], params)


def _n2_step_rel(got, want, start) -> float:
    """``_delta_rel`` of two nnet2 files from a start (a file or a
    tree)."""
    from kaldi_tpu_torch.am.nnet2 import load_nnet2
    if isinstance(start, str):
        start = load_nnet2(start)[0]
    return _delta_rel(load_nnet2(got)[0], load_nnet2(want)[0], start)


def n2t_train(T, held, d, src, dv, dev, rep, jobs, P):
    """23e: nnet-am-init at the LibriSpeech online nnet2 width with one
    hidden layer, nnet-insert adding one every N2T_ADD iterations up to
    NNET2_LAYERS; iterations of N2T_JOBS nnet-train-simple jobs (one a
    split-data shard, the rate decaying from N2T_LR[0] to [1]) each
    followed by nnet-am-average, with
    nnet-compute-prob on both diagnostic subsets between them;
    nnet-modify-learning-rates before the last iteration (whose jobs read
    the rates); nnet-combine-fast over the last iterations' models;
    nnet-normalize-stddev of the combination (the same function).  Card =
    CPU and tool = library for nnet-train-simple, nnet-combine-fast and
    nnet-normalize-stddev.  → the final model's path."""
    from kaldi_tpu_torch.am import nnet2 as n2
    T("nnet-am-init", f"--feat-dim={N2T_FEAT_DIM}", f"--num-pdfs={P}",
      "--num-hidden-layers=1", f"--pnorm-input-dim={NNET2_PNORM_IN}",
      f"--pnorm-output-dim={NNET2_PNORM_OUT}", f"--srand={N2T_SRAND}",
      f"{d}/0.mdl")
    pdf = f"ark:{d}/pdf_tr.ark"
    diag = [(_prob(T, dv, f"{d}/0.mdl", f"ark:{d}/egs_diag.ark"),
             _prob(T, dv, f"{d}/0.mdl", f"ark:{d}/egs_vdiag.ark"))]
    lrs = np.geomspace(N2T_LR[0], N2T_LR[1], N2T_ITERS)
    cur, layers = f"{d}/0.mdl", 1
    for it in range(1, N2T_ITERS + 1):
        if it > 1 and (it - 1) % N2T_ADD == 0 and layers < NNET2_LAYERS:
            T("nnet-insert", f"--srand={N2T_SRAND + it}", cur,
              f"{d}/{it - 1}.ins.mdl")
            cur, layers = f"{d}/{it - 1}.ins.mdl", layers + 1
        if it == N2T_ITERS:
            T("nnet-modify-learning-rates",
              f"--average-learning-rate={lrs[it - 1]}", f"{d}/{it - 2}.mdl",
              cur, f"{d}/{it - 1}.lr.mdl")
            cur = f"{d}/{it - 1}.lr.mdl"
        outs = []
        for j in range(N2T_JOBS):
            outs.append(f"{d}/{it}.{j + 1}.mdl")
            T("nnet-train-simple", dv, f"--learning-rate={lrs[it - 1]}",
              f"--chunk-size={N2T_CHUNK}", cur, f"ark:{d}/x_job{j + 1}.ark",
              pdf, outs[-1])
        T("nnet-am-average", f"{d}/{it}.mdl", *outs)
        cur = f"{d}/{it}.mdl"
        diag.append((_prob(T, dv, cur, f"ark:{d}/egs_diag.ark"),
                     _prob(T, dv, cur, f"ark:{d}/egs_vdiag.ark")))
        print(f"nnet2 train: 23e iteration {it}: {layers} hidden layers, "
              f"lr {lrs[it - 1]:.4g}, train / valid log-prob "
              f"{diag[-1][0]:.4f} / {diag[-1][1]:.4f}", flush=True)
    info = T("nnet-am-info", cur)
    _p, cfg_lr = n2.load_nnet2(f"{d}/{N2T_ITERS - 1}.lr.mdl")
    held("nnet-am-init | nnet-insert | nnet-train-simple jobs | "
         "nnet-am-average: the cross-entropy falls on both subsets; "
         "nnet-modify-learning-rates set a rate a layer",
         f"num-hidden-layers {NNET2_LAYERS}" in info
         and diag[-1][0] > diag[0][0] and diag[-1][1] > diag[0][1]
         and len(cfg_lr.learn_rates) == NNET2_LAYERS + 1,
         " → ".join(f"{-a:.3f}/{-b:.3f}" for a, b in diag))
    rep["xent"] = [[-a, -b] for a, b in diag]
    # nnet-train-simple: card = CPU and tool = library, one utterance from
    # the rates-carrying model
    feats = _serve_read(f"ark:{d}/x_job1.ark", "mat")
    pdfs = _serve_read(pdf, "ivec")
    one = [sorted(feats)[0]]
    _subset_ark(f"ark:{d}/x_job1.ark", one, f"{d}/x_one.ark")
    for side in (dv, "--device=cpu"):
        T("nnet-train-simple", side, f"--learning-rate={lrs[-1]}",
          f"--chunk-size={N2T_CHUNK}", f"{d}/{N2T_ITERS - 1}.lr.mdl",
          f"ark:{d}/x_one.ark", pdf, f"{d}/one.{side[9:]}.mdl")
    p0, c0 = n2.load_nnet2(f"{d}/{N2T_ITERS - 1}.lr.mdl")
    lib, _loss, _n = n2.train_simple(
        p0, c0, n2.xent_chunks(((k, feats[k]) for k in one), pdfs,
                               N2T_CHUNK, dev), float(lrs[-1]), dev)
    cpu = _n2_leaves_rel(f"{d}/one.{dev.type}.mdl", f"{d}/one.cpu.mdl")
    step = _n2_step_rel(f"{d}/one.{dev.type}.mdl", f"{d}/one.cpu.mdl", p0)
    lib_err = _n2_lib_rel(f"{d}/one.{dev.type}.mdl", lib)
    held("nnet-train-simple: card = CPU (leaves; the update); tool = "
         "train_simple", cpu <= N2T_TOL and step <= N2T_STEP_TOL
         and lib_err <= N2T_LIB_TOL,
         f"{cpu:.2e}; {step:.2e} of the update / {lib_err:.2e}")
    rep["card_cpu"] = {"nnet-train-simple": cpu}
    rep["card_cpu_step"] = {"nnet-train-simple": step}
    rep["lib"] = {"nnet-train-simple": lib_err}
    # the combination of the last iterations, then its normalization
    last = [f"{d}/{it}.mdl" for it in
            range(N2T_ITERS - N2T_COMBINE + 1, N2T_ITERS + 1)]
    T("nnet-combine-fast", dv, f"ark:{d}/x_valid.ark", pdf, *last,
      f"{d}/comb.mdl")
    from kaldi_tpu_torch.cli.tools_bank25 import valid_frames
    X, y = valid_frames(f"ark:{d}/x_valid.ark", pdf)
    lib, wts, loss = n2.combine([n2.load_nnet2(m)[0] for m in last], cfg_lr,
                                X, y, device=dev)
    lib_err = _n2_lib_rel(f"{d}/comb.mdl", lib)
    comb = _prob(T, dv, f"{d}/comb.mdl", f"ark:{d}/egs_vdiag.ark")
    held("nnet-combine-fast = combine (Adam over the weights' logits); "
         "the combination no worse on the validation subset than the "
         "models' best - 0.05", lib_err <= N2T_LIB_TOL
         and comb >= max(a for _t, a in diag[-N2T_COMBINE:]) - 0.05,
         f"weights {np.round(wts, 4).tolist()}, valid log-prob "
         f"{comb:.4f}, {lib_err:.2e}")
    rep["combine"] = {"weights": [float(w) for w in wts], "valid": comb,
                      "xent": loss}
    rep["lib"]["nnet-combine-fast"] = lib_err
    T("nnet-normalize-stddev", dv, f"{d}/comb.mdl", f"ark:{d}/egs_diag.ark",
      f"{d}/final.mdl")
    T("nnet-normalize-stddev", "--device=cpu", f"{d}/comb.mdl",
      f"ark:{d}/egs_diag.ark", f"{d}/final.cpu.mdl")
    pc, cc, _ = n2.load_nnet2_full(f"{d}/comb.mdl")
    x = np.concatenate([e.feats for e in _serve_read(
        f"ark:{d}/egs_diag.ark", "xeg").values()])
    lib, _before = n2.normalize_stddev(pc, cc, x, 1.0, dev)
    cpu = _n2_leaves_rel(f"{d}/final.mdl", f"{d}/final.cpu.mdl")
    step = _n2_step_rel(f"{d}/final.mdl", f"{d}/final.cpu.mdl", pc)
    lib_err = _n2_lib_rel(f"{d}/final.mdl", lib)
    after = _prob(T, dv, f"{d}/final.mdl", f"ark:{d}/egs_vdiag.ark")
    held("nnet-normalize-stddev: the same function (valid log-prob); card "
         "= CPU (leaves; the rescaling); tool = normalize_stddev",
         abs(after - comb) <= 1e-4 and cpu <= N2T_TOL
         and step <= N2T_STEP_TOL and lib_err <= N2T_LIB_TOL,
         f"{after:.4f}; {cpu:.2e}; {step:.2e} of the rescaling / "
         f"{lib_err:.2e}")
    rep["card_cpu"]["nnet-normalize-stddev"] = cpu
    rep["card_cpu_step"]["nnet-normalize-stddev"] = step
    rep["lib"]["nnet-normalize-stddev"] = lib_err
    return f"{d}/final.mdl"


def _n2t_wer(T, d, src, dv, mdl, name) -> str:
    """nnet-latgen-faster on the test set | lattice-best-path |
    compute-wer."""
    T("nnet-latgen-faster", dv, *N2T_LAT, f"{src}/tri3b.mdl", mdl,
      f"{d}/HCLG.fst", f"ark:{d}/x_te.ark", f"ark:{d}/lat_{name}.ark")
    T("lattice-best-path", f"--word-symbol-table={src}/words.txt",
      f"ark:{d}/lat_{name}.ark", f"ark,t:{d}/hyp_{name}.txt")
    return T("compute-wer", f"ark:{src}/text_te.ark",
             f"ark,t:{d}/hyp_{name}.txt").strip()


def n2t_decode(T, held, d, src, dv, dev, rep, final, tm):
    """23f: nnet-train-transitions (the priors from 10b's alignments),
    compile-graph, nnet-latgen-faster on the test set, the WER.  → the
    model with priors."""
    from kaldi_tpu_torch.am.serialize import write_transition_model
    from kaldi_tpu_torch.core import io as kio
    with kio.open_wxfilename(f"{d}/tri3b.tm") as f:
        kio.init_kaldi_output_stream(f)
        write_transition_model(f, tm)
    T("nnet-train-transitions", f"{d}/tri3b.tm", f"ark:{src}/ali_tr.ark",
      final, f"{d}/nnet2.tm", f"{d}/final.pri.mdl")
    T("compile-graph", f"{src}/lexicon.txt", f"{src}/tri3b.mdl",
      f"{src}/G.fst", f"{d}/HCLG.fst")
    out = _n2t_wer(T, d, src, dv, f"{d}/final.pri.mdl", "final")
    wer = _wer_of(out)
    held(f"the nnet2 hybrid's WER ≤ {N2T_WER_MAX:g}", wer <= N2T_WER_MAX, out)
    rep["wer"] = out
    return f"{d}/final.pri.mdl"


def n2t_realign(T, held, d, src, dv, dev, rep, mdl, tm):
    """23g: compile-train-graphs | nnet-align-compiled | ali-to-pdf |
    nnet-relabel-egs: the relabelled egs carry the new alignment at each
    eg's provenance; the frames relabelled and the agreement with 10b's
    tri3b alignment."""
    T("compile-train-graphs", f"{src}/lexicon.txt", f"{src}/tri3b.mdl",
      f"ark:{src}/text_tr.ark", f"ark:{d}/graphs_tr.ark")
    T("nnet-align-compiled", dv, "--acoustic-scale=0.1", f"{src}/tri3b.mdl",
      mdl, f"ark:{d}/graphs_tr.ark", f"ark:{d}/x_tr.ark",
      f"ark:{d}/ali_nnet2.ark")
    T("ali-to-pdf", f"{src}/tri3b.mdl", f"ark:{d}/ali_nnet2.ark",
      f"ark:{d}/pdf_nnet2.ark")
    T("nnet-relabel-egs", f"ark:{d}/pdf_nnet2.ark", f"ark:{d}/egs_all.ark",
      f"ark:{d}/egs_relab.ark")
    old = _serve_read(f"ark:{d}/egs_all.ark", "xeg")
    new = _serve_read(f"ark:{d}/egs_relab.ark", "xeg")
    pdfs = _serve_read(f"ark:{d}/pdf_nnet2.ark", "ivec")
    ok, changed, n = sorted(old) == sorted(new), 0, 0
    for k, e in new.items():
        u, s = k.rsplit(":", 1)
        B = len(e.pdfs)
        ok = ok and np.array_equal(e.feats, old[k].feats) and np.array_equal(
            e.pdfs[:, 0], np.asarray(pdfs[u][int(s):int(s) + B]))
        changed += int((e.pdfs != old[k].pdfs).sum())
        n += B
    agree = _agreement(_serve_read(f"ark:{d}/ali_nnet2.ark", "ivec"),
                       _serve_read(f"ark:{src}/ali_tr.ark", "ivec"),
                       tm.tid_to_pdf_array)
    held("nnet-align-compiled | nnet-relabel-egs: each eg's pdfs the new "
         "alignment's at its provenance", ok,
         f"{changed} of {n} frames relabelled; {100 * agree:.2f}% of "
         "frames agree with tri3b's")
    rep["relabelled"] = [changed, n]
    rep["agree"] = agree


def n2t_trainers(T, held, d, src, dv, dev, rep):
    """23h: nnet-train-parallel with ``preconditioned`` off and on (from a
    fresh NG-SGD state its one step is SGD's), nnet-train-ensemble on the
    last two iterations' models, nnet-combine; each card = CPU and tool =
    library."""
    from kaldi_tpu_torch.am import nnet2 as n2
    from kaldi_tpu_torch.cli.tools_bank25 import valid_frames
    egs = f"ark:{d}/egs_diag.ark"
    eg_list = list(_serve_read(egs, "xeg").values())
    final = f"{d}/final.mdl"
    T("nnet-am-switch-preconditioning", final, f"{d}/final.pc.mdl")
    lr = "--learning-rate=0.01"
    for name, mdl in (("par", final), ("par_pc", f"{d}/final.pc.mdl")):
        for side in (dv, "--device=cpu"):
            T("nnet-train-parallel", side, lr, mdl, egs,
              f"{d}/{name}.{side[9:]}.mdl")
        p, c = n2.load_nnet2(mdl)
        lib, _l, _j, _n = n2.train_parallel(p, c, eg_list, 4, 0.01, dev)
        cpu = _n2_leaves_rel(f"{d}/{name}.{dev.type}.mdl",
                             f"{d}/{name}.cpu.mdl")
        step = _n2_step_rel(f"{d}/{name}.{dev.type}.mdl",
                            f"{d}/{name}.cpu.mdl", p)
        lib_err = _n2_lib_rel(f"{d}/{name}.{dev.type}.mdl", lib)
        held(f"nnet-train-parallel (preconditioned {c.preconditioned}): "
             "card = CPU (leaves; the update); tool = train_parallel",
             cpu <= N2T_TOL and step <= N2T_STEP_TOL
             and lib_err <= N2T_LIB_TOL,
             f"{cpu:.2e}; {step:.2e} of the update / {lib_err:.2e}")
        rep["card_cpu"][f"nnet-train-parallel {c.preconditioned}"] = cpu
        rep["card_cpu_step"][f"nnet-train-parallel {c.preconditioned}"] = \
            step
        rep["lib"][f"nnet-train-parallel {c.preconditioned}"] = lib_err
    sgd_ng = _n2_leaves_rel(f"{d}/par.{dev.type}.mdl",
                            f"{d}/par_pc.{dev.type}.mdl")
    held("nnet-train-parallel: NG-SGD's first step = SGD's",
         sgd_ng <= N2T_LIB_TOL, f"{sgd_ng:.2e}")
    two = [f"{d}/{N2T_ITERS - 1}.mdl", f"{d}/{N2T_ITERS}.mdl"]
    few = _subset_ark(egs, list(_serve_read(egs, "xeg"))[:8],
                      f"{d}/egs_few.ark", holder="xeg")
    for side in (dv, "--device=cpu"):
        T("nnet-train-ensemble", side, lr, few, *two,
          *[f"{d}/ens{i}.{side[9:]}.mdl" for i in (1, 2)])
    models = [n2.load_nnet2(m) for m in two]
    lib, _l, _n = n2.train_ensemble(
        [p for p, _c in models], models[0][1],
        list(_serve_read(few, "xeg").values()), 0.5, 0.01, dev)
    cpu = max(_n2_leaves_rel(f"{d}/ens{i}.{dev.type}.mdl",
                             f"{d}/ens{i}.cpu.mdl") for i in (1, 2))
    step = max(_n2_step_rel(f"{d}/ens{i + 1}.{dev.type}.mdl",
                            f"{d}/ens{i + 1}.cpu.mdl", models[i][0])
               for i in (0, 1))
    lib_err = max(_n2_lib_rel(f"{d}/ens{i + 1}.{dev.type}.mdl", lib[i])
                  for i in (0, 1))
    held("nnet-train-ensemble (2 models): card = CPU (leaves; the "
         "update); tool = train_ensemble", cpu <= N2T_TOL
         and step <= N2T_STEP_TOL and lib_err <= N2T_LIB_TOL,
         f"{cpu:.2e}; {step:.2e} of the update / {lib_err:.2e}")
    rep["card_cpu"]["nnet-train-ensemble"] = cpu
    rep["card_cpu_step"]["nnet-train-ensemble"] = step
    rep["lib"]["nnet-train-ensemble"] = lib_err
    vfew = _subset_ark(f"ark:{d}/x_valid.ark",
                       sorted(_serve_read(f"ark:{d}/x_valid.ark", "mat"))[:3],
                       f"{d}/x_vfew.ark")
    for side in (dv, "--device=cpu"):
        T("nnet-combine", side, "--num-iters=10", vfew,
          f"ark:{d}/pdf_tr.ark", *two, f"{d}/comb2.{side[9:]}.mdl")
    X, y = valid_frames(vfew, f"ark:{d}/pdf_tr.ark")
    lib, _w, _l = n2.combine([p for p, _c in models], models[0][1], X, y,
                             10, device=dev)
    # the start of its Adam steps: the weights' logits 0, the models' mean
    uniform = n2.combine([p for p, _c in models], models[0][1], X, y, 0,
                         device="cpu")[0]
    cpu = _n2_leaves_rel(f"{d}/comb2.{dev.type}.mdl", f"{d}/comb2.cpu.mdl")
    step = _n2_step_rel(f"{d}/comb2.{dev.type}.mdl", f"{d}/comb2.cpu.mdl",
                        uniform)
    lib_err = _n2_lib_rel(f"{d}/comb2.{dev.type}.mdl", lib)
    held("nnet-combine (2 models, 10 steps): card = CPU (leaves; the move "
         "from the models' mean); tool = combine", cpu <= N2T_TOL
         and step <= N2T_STEP_TOL and lib_err <= N2T_LIB_TOL,
         f"{cpu:.2e}; {step:.2e} of the move / {lib_err:.2e}")
    rep["card_cpu"]["nnet-combine"] = cpu
    rep["card_cpu_step"]["nnet-combine"] = step
    rep["lib"]["nnet-combine"] = lib_err


def _disc_grad(params, cfg, deg, crit, dev):
    """The −objective of one deg at ``params`` on ``dev`` and its
    gradient as a tree of flax's layout: what the discriminative
    trainers' first Adam step reads."""
    from kaldi_tpu_torch.am import nnet2 as n2
    from kaldi_tpu_torch.pipelines.discriminative import eg_tensors
    model = n2.nnet2_model(params, cfg, dev)
    loss = n2.discriminative_loss(model, eg_tensors(deg, crit, dev), crit,
                                  0.1)
    loss.backward()
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(p.grad)
    return float(loss.detach()), n2.nnet2_params(model)


def _adam_step_rel(got, want, start, grad):
    """Card = CPU for one Adam step from ``start``: over the entries whose
    gradient ``grad`` (the CPU's) is at least N2T_NOISE of its leaf's
    largest, max |got − want| / max |want − start|.  → (that, the share
    of entries held, the same over the others)."""
    from kaldi_tpu_torch.am.nnet2 import tree_leaves
    lg, lw, ls, gr = (dict(tree_leaves(t)) for t in (got, want, start,
                                                      grad))
    num = den = rest = 0.0
    held = total = 0
    for k in lw:
        g = np.abs(np.asarray(gr[k], np.float64))
        keep = g >= N2T_NOISE * g.max()
        w = np.asarray(lw[k], np.float64)
        diff = np.abs(np.asarray(lg[k], np.float64) - w)
        num = max(num, float(diff[keep].max(initial=0.0)))
        rest = max(rest, float(diff[~keep].max(initial=0.0)))
        den = max(den, float(np.abs(w - np.asarray(ls[k], np.float64))
                             [keep].max(initial=0.0)))
        held, total = held + int(keep.sum()), total + keep.size
    return num / max(den, 1e-30), held / total, rest / max(den, 1e-30)


def n2t_sequence(T, held, d, src, dv, dev, rep, mdl, train):
    """23i: train_discriminative.sh on a few training utterances:
    nnet-latgen-faster's denominator lattices, nnet3-discriminative-get-
    egs, nnet-train-discriminative-simple (sMBR) then -parallel (MMI), the
    test set decoded again; each trainer's objective finite, tool =
    library, and card = CPU: the objective and gradient at the start, and
    one Adam step where the gradient is not float noise."""
    from kaldi_tpu_torch.am import nnet2 as n2
    seq = train[:N2T_SEQ_UTTS]
    x = _subset_ark(f"ark:{d}/x_tr.ark", seq, f"{d}/x_seq.ark")
    T("nnet-latgen-faster", dv, *N2T_LAT, f"{src}/tri3b.mdl", mdl,
      f"{d}/HCLG.fst", x, f"ark:{d}/denlats.ark")
    T("nnet3-discriminative-get-egs", f"{src}/tri3b.mdl", x,
      f"ark:{d}/pdf_tr.ark", f"ark:{d}/denlats.ark", f"ark:{d}/degs.ark")
    degs = list(_serve_read(f"ark:{d}/degs.ark", "deg").values())
    one = _subset_ark(f"ark:{d}/degs.ark", [seq[0]], f"{d}/degs_one.ark",
                      holder="deg")
    steps = (("nnet-train-discriminative-simple", "smbr", mdl, None,
              f"{d}/smbr"),
             ("nnet-train-discriminative-parallel", "mmi", f"{d}/smbr.mdl",
              2, f"{d}/seq"))
    objf = {}
    for name, crit, start, threads, out in steps:
        opts = (f"--criterion={crit}", f"--learning-rate={N2T_SEQ_LR}",
                *(() if threads is None else (f"--num-threads={threads}",)))
        T(name, dv, *opts, start, f"ark:{d}/degs.ark", f"{out}.mdl")
        for side in (dv, "--device=cpu"):
            T(name, side, *opts, "--num-epochs=1", start, one,
              f"{out}.one.{side[9:]}.mdl")
        p, c = n2.load_nnet2(start)
        if threads is None:
            lib, loss = n2.train_discriminative(p, c, degs, crit, N2T_SEQ_LR,
                                                0.1, 2, dev)
        else:
            lib, loss, _n = n2.train_discriminative_parallel(
                p, c, degs, threads, crit, N2T_SEQ_LR, 0.1, 2, dev)
        lib_err = _n2_lib_rel(f"{out}.mdl", lib)
        cpu = _n2_leaves_rel(f"{out}.one.{dev.type}.mdl",
                             f"{out}.one.cpu.mdl")
        eg = _serve_read(one, "deg")[seq[0]]
        f_card, g_card = _disc_grad(p, c, eg, crit, dev)
        f_cpu, g_cpu = _disc_grad(p, c, eg, crit, torch.device("cpu"))
        ferr = abs(f_card - f_cpu) / max(abs(f_cpu), 1e-30)
        gerr = max(float(np.abs(a - b).max()) / max(float(np.abs(b).max()),
                                                     1e-30)
                   for (_k, a), (_k2, b) in zip(n2.tree_leaves(g_card),
                                                n2.tree_leaves(g_cpu)))
        step, share, rest = _adam_step_rel(
            n2.load_nnet2(f"{out}.one.{dev.type}.mdl")[0],
            n2.load_nnet2(f"{out}.one.cpu.mdl")[0], p, g_cpu)
        held(f"{name} ({crit}): objective finite; tool = "
             "train_discriminative; card = CPU: the objective and gradient "
             "at the start, one Adam step where the gradient is not noise",
             np.isfinite(loss) and lib_err <= N2T_LIB_TOL
             and ferr <= N2T_GRAD_TOL and gerr <= N2T_GRAD_TOL
             and step <= N2T_ADAM_STEP_TOL,
             f"-objf {loss:.4f}; {lib_err:.2e}; objective {ferr:.2e}, "
             f"gradient {gerr:.2e}, step {step:.2e} on "
             f"{100 * share:.2f}% of the entries ({rest:.2e} on the rest); "
             f"leaves {cpu:.2e}")
        objf[crit] = loss
        rep["card_cpu"][name] = cpu
        rep["card_cpu_step"][name] = step
        rep["card_cpu_grad"] = {**rep.get("card_cpu_grad", {}),
                                name: [ferr, gerr, share, rest]}
        rep["lib"][name] = lib_err
    rep["seq_objf"] = objf
    rep["wer_seq"] = _n2t_wer(T, d, src, dv, f"{d}/seq.mdl", "seq")
    rep["degs"] = len(degs)


def nnet2_train_worker(argv) -> int:
    """23's background process: 23a–23j in turn, every tool a call of the
    port's registry in this process, each trainer held against the CPU and
    against the library on the same card, the fbank kernel's count set to
    0 before each call and read after it.  Writes ``report.json`` into
    its directory; exits 1 if a check fails."""
    import contextlib
    import io
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import kaldi_tpu_torch.features  # noqa: F401  (before ops.fbank)
    from kaldi_tpu_torch.am.serialize import read_mdl
    from kaldi_tpu_torch.cli import TOOLS
    from kaldi_tpu_torch.ops.fbank import CudaFbank
    t_start = time.perf_counter()
    src, d, dv_ = argv[0], argv[1], argv[2]
    dev = torch.device(dv_, 0) if dv_ == "cuda" else torch.device(dv_)
    dv = f"--device={dev.type}"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the host's cores go to the main process first: this worker has
    # until the join, after phase 22's, for its work
    os.nice(10)
    calls, checks, walls, rep, launches = [], [], {}, {}, {}

    def T(name, *args, rc_ok=(0,)):
        """Tool ``name``, its fbank launches counted and its wall added
        up; → what it printed (and its exit code when ``rc_ok`` allows
        more than 0)."""
        out = io.StringIO()
        CudaFbank.total_launches = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = TOOLS[name]([str(a) for a in args])
        walls[name] = walls.get(name, 0.0) + time.perf_counter() - t0
        launches[name] = launches.get(name, 0) + CudaFbank.total_launches
        if rc not in rc_ok:
            raise AssertionError(f"{name}: rc {rc}")
        calls.append(name)
        return (out.getvalue(), rc) if len(rc_ok) > 1 else out.getvalue()

    def held(name, ok, detail):
        checks.append((name, bool(ok), detail))

    tm, _ = read_mdl(f"{src}/tri3b.mdl", device="cpu")
    P = tm.num_pdfs
    stages = {}

    def stage(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(T, held, d, src, dv, dev, rep, *a)
        stages[name] = time.perf_counter() - t0
        return out

    train, valid, jobs = stage("23a data directory", n2t_datadir)
    stage("23b long audio", n2t_long_audio)
    fb, waves = stage("23c features", n2t_features, train, valid, jobs)
    stage("23d egs", n2t_egs, train)
    final = stage("23e training", n2t_train, jobs, P)
    pri = stage("23f decode", n2t_decode, final, tm)
    stage("23g realignment", n2t_realign, pri, tm)
    stage("23h other trainers", n2t_trainers)
    stage("23i sequence training", n2t_sequence, pri, train)
    rep["fbank_err"] = check_path_fbank(fb, waves[:4], "nnet2 train: 23j")
    with open(f"{src}/meta.json") as f:
        rep["ladder_wers"] = json.load(f)["wers"]
    with open(f"{d}/report.json", "w") as f:
        json.dump({"walls": walls, "stages": stages, "checks": checks,
                   "calls": len(calls), "tools": sorted(set(calls)),
                   "launches": launches,
                   "total": time.perf_counter() - t_start, **rep}, f,
                  default=float)
    bad = [c for c in checks if not c[1]]
    if bad:
        print(f"nnet2 train: {len(bad)} checks failed: {bad[:5]}",
              file=sys.stderr)
        return 1
    return 0


def nnet2_train_finish(started, tag: str):
    """23, joined before the kernels line: the worker's exit, its checks,
    each tool's wall and fbank launches, the cross-entropy a iteration,
    the combination's weights, the WERs before and after sequence
    training beside 10b's, the realignment, card = CPU and tool =
    library for each trainer, the worker's wall and the main process's
    wait here.  → (fbank launches, the fbank kernel's max |diff| from its
    plain version at 40 bins, 8 kHz)."""
    proc, d, t0 = started
    t_wait = time.perf_counter()
    proc.wait(timeout=N2T_JOIN)
    wait = time.perf_counter() - t_wait
    wall = time.perf_counter() - t0
    with open(f"{d}/worker.err") as f:
        err = f.read()
    # a worker whose checks failed still writes its report: print it
    if not os.path.exists(f"{d}/report.json"):
        raise AssertionError(f"nnet2 train failed ({proc.returncode}):\n"
                             f"{err[-3000:]}")
    with open(f"{d}/report.json") as f:
        rep = json.load(f)
    fb = rep["launches"].get("compute-fbank-feats", 0)
    a, v, t = rep["utts"]
    print(f"nnet2 train: {rep['calls']} tool calls of {len(rep['tools'])} "
          f"tools in one background process on 10b's {a} + {v} training "
          f"(validation) and {t} test utterances, {rep['frames']} frames, "
          f"{rep['egs'][0]} egs: {wall:.1f} s to the join "
          f"({rep['total']:.1f} s of work after its imports); the main "
          f"process waited {wait:.1f} s here {tag}")
    for name, ok, detail in rep["checks"]:
        print(f"nnet2 train:   {name}: {'held' if ok else 'FAILED'}"
              + (f" ({detail})" if detail else ""))
    print("nnet2 train: stages " + ", ".join(
        f"{n} {s:.1f} s" for n, s in rep["stages"].items()))
    print("nnet2 train: tool walls " + ", ".join(
        f"{n} {s:.2f} s" for n, s in sorted(rep["walls"].items(),
                                            key=lambda x: -x[1])))
    print("nnet2 train: cross-entropy (train / valid subsets) a iteration "
          + " → ".join(f"{x:.4f}/{y:.4f}" for x, y in rep["xent"]))
    print(f"nnet2 train: nnet-combine-fast weights "
          f"{np.round(rep['combine']['weights'], 4).tolist()}, valid "
          f"log-prob {rep['combine']['valid']:.4f}")
    wers = rep["ladder_wers"]
    print(f"nnet2 train: the nnet2 hybrid {rep['wer']}; after sMBR + MMI "
          f"on {rep['degs']} utterances {rep['wer_seq']} (objectives "
          + ", ".join(f"{k} -objf {v:.4f}" for k, v in rep["seq_objf"].items())
          + "; 10b: " + ", ".join(f"{k} {v:.2f}" for k, v in wers.items())
          + f") {tag}")
    print(f"nnet2 train: nnet-align-compiled agrees with 10b's tri3b "
          f"alignment on {100 * rep['agree']:.2f}% of the frames' pdfs; "
          f"nnet-relabel-egs relabelled {rep['relabelled'][0]} of "
          f"{rep['relabelled'][1]} frames; segment-long-utterances "
          f"{rep['segments'][0]} segments for {rep['segments'][1]} "
          f"utterances")
    print("nnet2 train: card = CPU, leaves " + ", ".join(
        f"{n} {e:.2e}" for n, e in rep["card_cpu"].items())
        + f" (bar {N2T_TOL:g} but the Adam trainers'); of the update "
        + ", ".join(f"{n} {e:.2e}" for n, e in rep["card_cpu_step"].items())
        + f" (bar {N2T_STEP_TOL:g}, the Adam trainers {N2T_ADAM_STEP_TOL:g} "
        f"where |g| ≥ {N2T_NOISE:g} of its leaf's largest); the Adam "
        "trainers' objective / gradient at the start " + ", ".join(
            f"{n} {f:.2e} / {g:.2e}"
            for n, (f, g, _s, _r) in rep["card_cpu_grad"].items())
        + f" (bar {N2T_GRAD_TOL:g}); tool = library " + ", ".join(
        f"{n} {e:.2e}" for n, e in rep["lib"].items())
        + f" (bar {N2T_LIB_TOL:g})")
    with open(f"{d}/worker.out") as f:      # 23j's kernel check
        print("".join(ln for ln in f if ln.startswith("nnet2 train: 23")),
              end="")
    print(f"nnet2 train: fbank kernel launches {fb} (compute-fbank-feats); "
          f"23j fbank kernel vs plain max |diff| {rep['fbank_err']:.3e} "
          f"{tag}")
    bad = [c for c in rep["checks"] if not c[1]]
    if bad or proc.returncode != 0:
        raise AssertionError(f"23: {len(bad)} checks failed: {bad[:3]} "
                             f"(worker exit {proc.returncode})")
    if fb <= 0:
        raise AssertionError(f"23: fbank launches {rep['launches']}")
    return fb, rep["fbank_err"]


def _stop(proc) -> None:
    """Kill ``proc`` if it still runs (phase 17's and 18's workers, at
    exit)."""
    if proc.poll() is None:
        proc.kill()
        proc.wait()


if __name__ == "__main__":
    if sys.argv[1:2] == ["--pod-worker"]:
        sys.exit(pod_worker(sys.argv[2:]))
    if sys.argv[1:2] == ["--tri-tools"]:
        sys.exit(tri_tools_worker(sys.argv[2:]))
    if sys.argv[1:2] == ["--seq-tools"]:
        sys.exit(seq_tools_worker(sys.argv[2:]))
    if sys.argv[1:2] == ["--serve-tools"]:
        sys.exit(serve_tools_worker(sys.argv[2:]))
    if sys.argv[1:2] == ["--nnet2-tools"]:
        sys.exit(nnet2_tools_worker(sys.argv[2:]))
    if sys.argv[1:2] == ["--chain-loop"]:
        sys.exit(chain_loop_worker(sys.argv[2:]))
    if sys.argv[1:2] == ["--nnet-loop"]:
        sys.exit(nnet_loop_worker(sys.argv[2:]))
    if sys.argv[1:2] == ["--nnet2-train"]:
        sys.exit(nnet2_train_worker(sys.argv[2:]))
    sys.exit(main())
