"""i-vectors on the card: port of kaldi_tpu/am/ivector.py (total-variability
modeling, VAD, PLDA; parity targets src/ivector/ivector-extractor.h
IvectorExtractor and OnlineIvectorEstimationStats,
voice-activity-detection.h ComputeVadEnergy, plda.h Plda).

The extractor is the standard total-variability model over a diagonal
UBM:  supervector offset  m_g(w) = M_g + T_g · w ,  w ~ N(0, I).
Everything the original computes in numpy float64 runs here as float64
tensors on the extractor's device (default the card): UBM posteriors
(two products and a softmax), Baum-Welch stats, the K×K posterior
precision solves and the per-Gaussian M-step solves.  The original's
host loops over utterances, period checkpoints, frames and Gaussians
become batched tensor work, each a few launches:

  * ``em_stats``: the (U, K, K) precisions of every utterance from the
    per-Gaussian ``TᵀΣ⁻¹T`` (G, K, K) (cached with T), one batched
    inverse, and the A and B sums as products;
  * ``em_update``: one batched solve over G; Gaussians with
    ``tot_gamma < 1e-3`` keep their T;
  * ``online_ivectors``: period-block sums of the posteriors and
    first-order stats, their cumulative sums, the ``max_count`` scaling
    per checkpoint, and one batched solve over every checkpoint;
  * ``OnlineIvectorEstimator``: one posterior pass per ``accept_frames``
    call; its frames and posteriors stay on the device, so
    ``update_frame_weights`` is one product over the revised frames (the
    original's delta update).

These equal the original's loops to float64 rounding.  Random draws are
the original's: one ``np.random.default_rng(seed)`` per function, drawn
in the same order (the UBM's frame choice and initial means, T's
``0.1·N(0, 1)``), and then moved to the device.

``OnlineSilenceWeighting``, ``Plda``, the clustering, diarization and
PLDA I/O are the original's host numpy, copied (each names its
original).  The extractor's file is the original's layout byte for byte
(read back through core/io.py, which returns float32 arrays, as the
original's reader does).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from kaldi_tpu_torch.core.logging import KaldiError, get_logger
from kaldi_tpu_torch.device import resolve_device

log = get_logger(__name__)

F64 = torch.float64


def _f64(x, device: torch.device) -> torch.Tensor:
    """``x`` (numpy, list or tensor) as a float64 tensor on ``device``."""
    return torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor)
                           else x).to(device=device, dtype=F64)


def _post_from_logp(logp: torch.Tensor) -> torch.Tensor:
    """Row-normalised exp of (T, G) log-probabilities, as the original:
    subtract the row max, exponentiate, divide by the row sum."""
    p = torch.exp(logp - logp.max(dim=1, keepdim=True).values)
    return p / p.sum(dim=1, keepdim=True)


# ---------------------------------------------------------------------------
# Energy VAD
# ---------------------------------------------------------------------------

# Copied from kaldi_tpu/am/ivector.py VadEnergyOptions.
@dataclasses.dataclass
class VadEnergyOptions:
    vad_energy_threshold: float = 5.0
    vad_energy_mean_scale: float = 0.5
    vad_frames_context: int = 0
    vad_proportion_threshold: float = 0.6


# Port of kaldi_tpu/am/ivector.py compute_vad_energy.
def compute_vad_energy(feats, opts: VadEnergyOptions = VadEnergyOptions(),
                       device: torch.device | str = "cuda") -> torch.Tensor:
    """feats: (T, D) with C0 energy in column 0 → (T,) 0/1 float32
    decisions on ``device`` (voice-activity-detection.cc
    ComputeVadEnergy).  The context window's voiced share is a
    difference of prefix sums, where the original loops over frames."""
    device = resolve_device(device)
    log_energy = _f64(feats, device)[:, 0]
    T = log_energy.shape[0]
    threshold = torch.full((), opts.vad_energy_threshold, dtype=F64,
                           device=device)
    if opts.vad_energy_mean_scale != 0.0:
        threshold = threshold + opts.vad_energy_mean_scale \
            * log_energy.mean()
    voiced = log_energy > threshold
    if opts.vad_frames_context == 0:
        return voiced.to(torch.float32)
    ctx = opts.vad_frames_context
    cs = torch.cat([voiced.new_zeros(1, dtype=torch.int64),
                    voiced.to(torch.int64).cumsum(0)])
    t = torch.arange(T, device=device)
    lo = (t - ctx).clamp_min(0)
    hi = (t + ctx + 1).clamp_max(T)
    prop = (cs[hi] - cs[lo]).to(F64) / (hi - lo).to(F64)
    return (prop >= opts.vad_proportion_threshold).to(torch.float32)


# ---------------------------------------------------------------------------
# Total-variability i-vector extractor
# ---------------------------------------------------------------------------

# Port of kaldi_tpu/am/ivector.py IvectorExtractor.
class IvectorExtractor:
    """UBM (flattened single-pdf diag GMM) + T matrices (G, D, K), all
    float64 tensors on ``device``."""

    def __init__(self, ubm_means, ubm_vars, ubm_weights, ivector_dim: int,
                 seed: int = 0, device: torch.device | str = "cuda"):
        self.device = resolve_device(device)
        G, D = ubm_means.shape
        rng = np.random.default_rng(seed)
        self.means = _f64(ubm_means, self.device)
        self.inv_vars = 1.0 / _f64(ubm_vars, self.device)
        self.weights = _f64(ubm_weights, self.device)
        self.ivector_dim = ivector_dim
        self.T = 0.1 * rng.standard_normal((G, D, ivector_dim))

    @property
    def T(self) -> torch.Tensor:
        return self._T

    @T.setter
    def T(self, value) -> None:
        """Set T (numpy or tensor) and the tables that follow from it:
        Σ⁻¹T (G, D, K) and TᵀΣ⁻¹T (G, K, K)."""
        self._T = _f64(value, self.device)
        self._TtSi = self._T * self.inv_vars[:, :, None]
        self._TtSiT = torch.einsum("gdk,gdl->gkl", self._TtSi, self._T)

    # Port of kaldi_tpu/am/ivector.py IvectorExtractor.from_am.
    @staticmethod
    def from_am(am, ivector_dim: int,
                device: Optional[torch.device | str] = None
                ) -> "IvectorExtractor":
        """Use a trained diag GMM ('diag UBM', the port's ``AmDiagGmm``)
        as the base distribution, on ``device`` (default the model's)."""
        G = am.num_pdfs * am.max_mix
        w = am.weights.reshape(G) / am.num_pdfs
        keep = w > 0
        return IvectorExtractor(am.means.reshape(G, -1)[keep],
                                am.vars.reshape(G, -1)[keep], w[keep],
                                ivector_dim, device=device or am.device)

    def _gconst(self) -> torch.Tensor:
        return (torch.log(self.weights)
                - 0.5 * (torch.log(2 * np.pi / self.inv_vars).sum(1)
                         + (self.means ** 2 * self.inv_vars).sum(1)))

    def posteriors(self, x: torch.Tensor) -> torch.Tensor:
        """UBM posteriors (T, G) of float64 frames x (T, D) on the
        device."""
        quad = (x ** 2) @ (-0.5 * self.inv_vars).T \
            + x @ (self.means * self.inv_vars).T
        return _post_from_logp(quad + self._gconst())

    # -- Baum-Welch stats --------------------------------------------------
    def acc_stats(self, feats, weights=None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        """→ (gamma (G,), X (G, D)): zeroth/first-order stats under the
        UBM posteriors; optional per-frame weights (the silence-
        weighting hook)."""
        x = _f64(feats, self.device)
        post = self.posteriors(x)
        if weights is not None:
            post = post * _f64(weights, self.device)[:, None]
        return post.sum(dim=0), post.T @ x

    # -- extraction --------------------------------------------------------
    def _solve(self, gamma: torch.Tensor, X: torch.Tensor, inverse=False):
        """Batched MAP point estimates: gamma (N, G), X (N, G, D) →
        w (N, K) (and the posterior covariances (N, K, K) with
        ``inverse``)."""
        N, G = gamma.shape
        K = self.ivector_dim
        precision = torch.eye(K, dtype=F64, device=self.device) + (
            gamma @ self._TtSiT.reshape(G, K * K)).reshape(N, K, K)
        centred = X - gamma[:, :, None] * self.means
        lin = centred.reshape(N, G * X.shape[2]) @ self._TtSi.reshape(-1, K)
        if not inverse:
            return torch.linalg.solve(precision, lin)
        cov = torch.linalg.inv(precision)
        return (cov @ lin[:, :, None])[:, :, 0], cov, centred

    def extract(self, gamma, X) -> torch.Tensor:
        """MAP point estimate of w (K,) given stats."""
        return self._solve(_f64(gamma, self.device)[None],
                           _f64(X, self.device)[None])[0]

    def extract_from_feats(self, feats) -> torch.Tensor:
        return self.extract(*self.acc_stats(feats))

    # -- EM training -------------------------------------------------------
    def em_stats(self, utt_stats: Sequence[Tuple[torch.Tensor, torch.Tensor]]
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """One E-step pass over per-utterance (gamma, X) stats →
        (A (G,K,K), B (G,D,K), tot_gamma (G,)): the accumulator the
        reference's IvectorExtractorStats carries between the per-job acc
        binaries and the single est binary.  All utterances at once."""
        G, D, K = self._T.shape
        if not utt_stats:
            return (torch.zeros((G, K, K), dtype=F64, device=self.device),
                    torch.zeros((G, D, K), dtype=F64, device=self.device),
                    torch.zeros(G, dtype=F64, device=self.device))
        gamma = torch.stack([_f64(g, self.device) for g, _ in utt_stats])
        X = torch.stack([_f64(x, self.device) for _, x in utt_stats])
        U = gamma.shape[0]
        w, cov, centred = self._solve(gamma, X, inverse=True)
        Eww = cov + w[:, :, None] * w[:, None, :]
        A = (gamma.T @ Eww.reshape(U, K * K)).reshape(G, K, K)
        B = (centred.reshape(U, G * D).T @ w).reshape(G, D, K)
        return A, B, gamma.sum(dim=0)

    def em_update(self, A, B, tot_gamma) -> None:
        """M-step: every Gaussian's row solve for T in one batched solve
        (IvectorExtractorStats::Update); Gaussians with tot_gamma < 1e-3
        keep their T."""
        A = _f64(A, self.device)
        B = _f64(B, self.device)
        live = _f64(tot_gamma, self.device) >= 1e-3
        K = self.ivector_dim
        eye = torch.eye(K, dtype=F64, device=self.device)
        # a skipped Gaussian's system is replaced by I: its solve is
        # thrown away, and must not fail on an empty accumulator
        sys_ = torch.where(live[:, None, None], A + 1e-8 * eye, eye)
        new = torch.linalg.solve(sys_, B.transpose(1, 2)).transpose(1, 2)
        self.T = torch.where(live[:, None, None], new, self._T)

    def train(self, utt_stats, num_iters: int = 5) -> None:
        """EM over per-utterance (gamma, X) stats
        (ivector-extractor.cc IvectorExtractorStats::Update)."""
        for it in range(num_iters):
            A, B, tot_gamma = self.em_stats(utt_stats)
            self.em_update(A, B, tot_gamma)
            log.info("ivector EM iter %d: total gamma %.0f", it,
                     float(tot_gamma.sum()))


# Port of kaldi_tpu/am/ivector.py train_diag_ubm.
def train_diag_ubm(feats_list, num_gauss: int = 64, num_iters: int = 4,
                   max_frames: int = 50000, seed: int = 0,
                   var_floor: float = 1e-3,
                   device: torch.device | str = "cuda"):
    """Flat diagonal UBM from pooled frames — the gmm-global-init-from-
    feats + gmm-global-est role (steps/online/nnet2/train_diag_ubm.sh)
    that seeds the i-vector extractor.  The frame and initial-mean
    choices are the original's draws on the host; the EM runs in float64
    on ``device``.  Returns (means (G, D), vars (G, D), weights (G,))
    tensors there."""
    device = resolve_device(device)
    X = torch.cat([_f64(f, device) for f in feats_list])
    rng = np.random.default_rng(seed)
    if len(X) > max_frames:
        X = X[torch.as_tensor(rng.choice(len(X), max_frames, replace=False),
                              device=device)]
    m = X[torch.as_tensor(rng.choice(len(X), num_gauss, replace=False),
                          device=device)]
    gv = X.var(dim=0, correction=0) + var_floor
    v = gv.repeat(num_gauss, 1)
    w = torch.full((num_gauss,), 1.0 / num_gauss, dtype=F64, device=device)
    for _ in range(num_iters):
        quad = (X ** 2) @ (-0.5 / v).T + X @ (m / v).T
        gconst = torch.log(w) - 0.5 * (torch.log(2 * np.pi * v).sum(1)
                                       + (m * m / v).sum(1))
        p = _post_from_logp(quad + gconst)
        g = p.sum(dim=0) + 1e-8
        m = (p.T @ X) / g[:, None]
        v = torch.clamp_min((p.T @ (X * X)) / g[:, None] - m * m, var_floor)
        w = g / g.sum()
    return m, v, w


# Port of kaldi_tpu/am/ivector.py online_ivectors.
def online_ivectors(extractor: IvectorExtractor, feats, period: int = 10,
                    max_count: float = 100.0) -> torch.Tensor:
    """(T, D) features → (T, K) piecewise-constant ONLINE i-vectors on the
    extractor's device: the value at frame t is the MAP estimate from
    frames [0, t₀) where t₀ is the last period boundary ≤ t
    (ivector-extract-online2's most-recent-estimate semantics); the
    first block is zeros.  Posteriors of all frames in one pass, the
    blocks' stats as cumulative sums, and every checkpoint's K×K solve
    in one batch.  ``max_count`` caps each checkpoint's stats mass on
    its own (--max-count)."""
    dev = extractor.device
    x = _f64(feats, dev)
    T = x.shape[0]
    K = extractor.ivector_dim
    if T == 0:
        return torch.zeros((0, K), dtype=F64, device=dev)
    post = extractor.posteriors(x)
    G, D = extractor.means.shape
    nb = -(-T // period)
    pad = nb * period - T
    if pad:
        post = torch.cat([post, post.new_zeros((pad, G))])
        x = torch.cat([x, x.new_zeros((pad, D))])
    pb = post.reshape(nb, period, G)
    gamma = pb.sum(dim=1).cumsum(dim=0)                          # (nb, G)
    X = torch.bmm(pb.transpose(1, 2), x.reshape(nb, period, D)).cumsum(0)
    # the last checkpoint's estimate is read by no frame
    gamma, X = gamma[:-1], X[:-1]
    if max_count > 0:
        tot = gamma.sum(dim=1)
        s = torch.where(tot > max_count, max_count / tot,
                        torch.ones_like(tot))
        gamma, X = gamma * s[:, None], X * s[:, None, None]
    iv = torch.cat([torch.zeros((1, K), dtype=F64, device=dev),
                    extractor._solve(gamma, X)])
    return iv.repeat_interleave(period, dim=0)[:T]


# Port of kaldi_tpu/am/ivector.py OnlineIvectorEstimator.
class OnlineIvectorEstimator:
    """Streaming i-vector estimation: stats accumulate per chunk, the
    current estimate is available at any time
    (OnlineIvectorEstimationStats).

    Frame weights may be REVISED after the fact (the silence-weighting
    protocol: the decoder's partial traceback reclassifies earlier
    frames as silence as it advances).  The frames and their posteriors
    stay on the device, so a weight change is one product over the
    revised frames (a delta update, as in OnlineIvectorFeature::
    UpdateFrameWeights)."""

    def __init__(self, extractor: IvectorExtractor, max_count: float = 0.0):
        self.ex = extractor
        dev = extractor.device
        G, D = extractor.means.shape
        self.gamma = torch.zeros(G, dtype=F64, device=dev)
        self.X = torch.zeros((G, D), dtype=F64, device=dev)
        self.max_count = max_count
        # per-chunk frames (n, D), posteriors (n, G) and weights (n,)
        self._frames: List[torch.Tensor] = []
        self._post: List[torch.Tensor] = []
        self._weights: List[torch.Tensor] = []
        self._n = 0

    @property
    def num_frames(self) -> int:
        return self._n

    def accept_frames(self, feats, weights=None) -> None:
        x = _f64(feats, self.ex.device)
        if x.ndim == 1:
            x = x[None]
        post = self.ex.posteriors(x)
        w = (torch.ones(x.shape[0], dtype=F64, device=x.device)
             if weights is None else _f64(weights, x.device))
        wp = post * w[:, None]
        self.gamma += wp.sum(dim=0)
        self.X += wp.T @ x
        self._frames.append(x)
        self._post.append(post)
        self._weights.append(w)
        self._n += x.shape[0]

    def _joined(self, parts: List[torch.Tensor]) -> torch.Tensor:
        if len(parts) > 1:
            parts[:] = [torch.cat(parts)]
        return parts[0]

    def update_frame_weights(self, weights) -> None:
        """Revise weights for frames [0, len(weights)); delta-update."""
        n = min(len(weights), self._n)
        if n == 0:
            return
        old = self._joined(self._weights)
        new = _f64(weights, old.device)[:n]
        d = new - old[:n]
        dp = self._joined(self._post)[:n] * d[:, None]
        self.gamma += dp.sum(dim=0)
        self.X += dp.T @ self._joined(self._frames)[:n]
        old[:n] = new

    def ivector(self) -> torch.Tensor:
        gamma, X = self.gamma, self.X
        if self.max_count > 0:
            tot = gamma.sum()
            scale = torch.where(tot > self.max_count, self.max_count / tot,
                                torch.ones_like(tot))
            gamma, X = gamma * scale, X * scale
        return self.ex.extract(gamma, X)


# Copied from kaldi_tpu/am/ivector.py OnlineSilenceWeighting.
class OnlineSilenceWeighting:
    """Frame weights from the decoder's partial traceback
    (online-ivector-feature.h OnlineSilenceWeighting): frames whose
    best-path tid maps to a silence phone get `silence_weight`, others
    1.0; undecoded frames default to 1.0."""

    def __init__(self, tm, silence_phones, silence_weight: float = 0.0):
        self.tm = tm
        self.sil = set(silence_phones)
        self.silence_weight = silence_weight

    def compute_weights(self, tid_traceback: Sequence[int],
                        num_frames: int) -> np.ndarray:
        w = np.ones(num_frames)
        for t, tid in enumerate(tid_traceback[:num_frames]):
            if self.tm.transition_id_to_phone(tid) in self.sil:
                w[t] = self.silence_weight
        return w


# ---------------------------------------------------------------------------
# PLDA
# ---------------------------------------------------------------------------

# Copied from kaldi_tpu/am/ivector.py Plda.
class Plda:
    """Two-covariance PLDA (plda.h): between/within class Gaussians.

    Trained from per-speaker collections of i-vectors; scoring gives the
    LLR  log P(same) − log P(different)  for a (train, test) pair.
    """

    def __init__(self, mean: np.ndarray, between: np.ndarray,
                 within: np.ndarray):
        self.mean = mean
        self.between = between
        self.within = within
        D = len(mean)
        # simultaneous diagonalization: within → I, between → diag(psi)
        w_evals, w_evecs = np.linalg.eigh(within)
        W = w_evecs @ np.diag(1.0 / np.sqrt(np.maximum(w_evals, 1e-10)))
        Bt = W.T @ between @ W
        b_evals, b_evecs = np.linalg.eigh(Bt)
        self.transform = (W @ b_evecs).T           # (D, D)
        self.psi = np.maximum(b_evals, 1e-12)

    @staticmethod
    def train(spk2ivectors: Dict[str, np.ndarray]) -> "Plda":
        all_iv = np.concatenate(list(spk2ivectors.values()))
        mean = all_iv.mean(axis=0)
        D = all_iv.shape[1]
        between = np.zeros((D, D))
        within = np.zeros((D, D))
        n_spk = 0
        for spk, ivs in spk2ivectors.items():
            m = ivs.mean(axis=0) - mean
            between += np.outer(m, m)
            c = ivs - ivs.mean(axis=0) - 0 * mean
            within += c.T @ c / max(len(ivs), 1)
            n_spk += 1
        between /= max(n_spk, 1)
        within /= max(n_spk, 1)
        within += 1e-6 * np.eye(D)
        between += 1e-6 * np.eye(D)
        return Plda(mean, between, within)

    def score(self, train_iv: np.ndarray, test_iv: np.ndarray,
              n_train: int = 1) -> float:
        """LLR same-vs-different speaker (plda.cc LogLikelihoodRatio)."""
        u = self.transform @ (np.asarray(train_iv) - self.mean)
        v = self.transform @ (np.asarray(test_iv) - self.mean)
        n = n_train
        psi = self.psi
        # given class mean distribution for same-speaker hypothesis
        mean_same = (n * psi / (n * psi + 1.0)) * u
        var_same = 1.0 + psi / (n * psi + 1.0)
        var_diff = 1.0 + psi
        ll_same = -0.5 * (np.log(2 * np.pi * var_same)
                          + (v - mean_same) ** 2 / var_same).sum()
        ll_diff = -0.5 * (np.log(2 * np.pi * var_diff)
                          + v ** 2 / var_diff).sum()
        return float(ll_same - ll_diff)


# ---------------------------------------------------------------------------
# Agglomerative clustering (speaker diarization)
# ---------------------------------------------------------------------------

# Copied from kaldi_tpu/am/ivector.py agglomerative_cluster.
def agglomerative_cluster(scores: np.ndarray, threshold: float,
                          min_clusters: int = 1,
                          max_clusters: Optional[int] = None) -> np.ndarray:
    """Average-linkage agglomerative clustering over a pairwise
    similarity matrix (higher = more similar).

    The src/ivector/agglomerative-clustering.h role: each segment starts
    as its own cluster; the most-similar cluster pair merges while its
    linkage score exceeds `threshold` (or while more than `max_clusters`
    remain, which forces merges below threshold).  Stops at
    `min_clusters`.  Returns int labels (0..C-1) in first-appearance
    order — the ivectorbin/agglomerative-cluster.cc contract with
    spk2utt output.
    """
    scores = np.asarray(scores, np.float64)
    N = scores.shape[0]
    if N == 0:
        return np.zeros(0, np.int32)
    clusters: Dict[int, List[int]] = {i: [i] for i in range(N)}
    # linkage[a,b] = mean pairwise score between members of a and b
    while len(clusters) > max(min_clusters, 1):
        keys = sorted(clusters)
        best, pair = -np.inf, None
        for ai in range(len(keys)):
            for bi in range(ai + 1, len(keys)):
                a, b = keys[ai], keys[bi]
                s = float(np.mean(scores[np.ix_(clusters[a], clusters[b])]))
                if s > best:
                    best, pair = s, (a, b)
        forced = max_clusters is not None and len(clusters) > max_clusters
        if pair is None or (best <= threshold and not forced):
            break
        a, b = pair
        clusters[a] = clusters[a] + clusters[b]
        del clusters[b]
    labels = np.full(N, -1, np.int32)
    next_id = 0
    order = sorted(clusters.values(), key=min)
    for members in order:
        for m in members:
            labels[m] = next_id
        next_id += 1
    return labels


# Copied from kaldi_tpu/am/ivector.py plda_score_matrix.
def plda_score_matrix(plda: "Plda", ivectors: np.ndarray) -> np.ndarray:
    """Symmetric pairwise PLDA LLR matrix for diarization."""
    ivectors = np.asarray(ivectors)
    N = len(ivectors)
    S = np.zeros((N, N))
    for i in range(N):
        for j in range(i + 1, N):
            s = 0.5 * (plda.score(ivectors[i], ivectors[j])
                       + plda.score(ivectors[j], ivectors[i]))
            S[i, j] = S[j, i] = s
    return S


# Copied from kaldi_tpu/am/ivector.py diarize.
def diarize(plda: "Plda", segment_ivectors: np.ndarray, threshold: float = 0.0,
            min_clusters: int = 1,
            max_clusters: Optional[int] = None) -> np.ndarray:
    """Cluster per-segment i-vectors into speaker labels (the
    egs/callhome_diarization pipeline role: PLDA scoring +
    agglomerative-cluster)."""
    S = plda_score_matrix(plda, segment_ivectors)
    return agglomerative_cluster(S, threshold, min_clusters=min_clusters,
                                 max_clusters=max_clusters)


# ---------------------------------------------------------------------------
# Serialization (ivector-extractor / plda files)
# ---------------------------------------------------------------------------

# Port of kaldi_tpu/am/ivector.py write_ivector_extractor (the same bytes).
def write_ivector_extractor(path: str, ex: IvectorExtractor) -> None:
    """Kaldi-style token-framed binary (the IvectorExtractor Write role;
    layout is the original's own)."""
    from kaldi_tpu_torch.core.io import write_matrix, write_token, \
        write_vector
    G, D, K = ex.T.shape

    def host(t):
        return t.detach().cpu().numpy().astype(np.float64)
    with open(path, "wb") as f:
        f.write(b"\0B")
        write_token(f, "<IvectorExtractor>")
        write_matrix(f, host(ex.means), dtype="float64")
        write_matrix(f, host(1.0 / ex.inv_vars), dtype="float64")
        write_vector(f, host(ex.weights), dtype="float64")
        write_matrix(f, host(ex.T).reshape(G, D * K), dtype="float64")
        write_vector(f, np.array([K], np.float64), dtype="float64")
        write_token(f, "</IvectorExtractor>")


# Port of kaldi_tpu/am/ivector.py read_ivector_extractor (+ device).
def read_ivector_extractor(path: str, device: torch.device | str = "cuda"
                           ) -> IvectorExtractor:
    from kaldi_tpu_torch.core.io import expect_token, read_matrix, \
        read_vector
    device = resolve_device(device)
    with open(path, "rb") as f:
        if f.read(2) != b"\0B":
            raise KaldiError(f"{path}: not binary kaldi")
        expect_token(f, "<IvectorExtractor>")
        means = read_matrix(f)
        variances = read_matrix(f)
        weights = read_vector(f)
        Tflat = read_matrix(f)
        K = int(read_vector(f)[0])
        expect_token(f, "</IvectorExtractor>")
    G, D = means.shape
    ex = IvectorExtractor(means, variances, weights, K, device=device)
    ex.T = Tflat.reshape(G, D, K).astype(np.float64)
    return ex


# Copied from kaldi_tpu/am/ivector.py write_plda.
def write_plda(path: str, plda: "Plda") -> None:
    from kaldi_tpu_torch.core.io import write_matrix, write_token, \
        write_vector
    with open(path, "wb") as f:
        f.write(b"\0B")
        write_token(f, "<Plda>")
        write_vector(f, plda.mean.astype(np.float64), dtype="float64")
        write_matrix(f, plda.between.astype(np.float64), dtype="float64")
        write_matrix(f, plda.within.astype(np.float64), dtype="float64")
        write_token(f, "</Plda>")


# Copied from kaldi_tpu/am/ivector.py read_plda.
def read_plda(path: str) -> "Plda":
    from kaldi_tpu_torch.core.io import expect_token, read_matrix, \
        read_vector
    with open(path, "rb") as f:
        if f.read(2) != b"\0B":
            raise KaldiError(f"{path}: not binary kaldi")
        expect_token(f, "<Plda>")
        mean = read_vector(f)
        between = read_matrix(f)
        within = read_matrix(f)
        expect_token(f, "</Plda>")
    return Plda(mean.astype(np.float64), between.astype(np.float64),
                within.astype(np.float64))
