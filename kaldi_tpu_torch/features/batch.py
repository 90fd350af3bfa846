"""The batched frontend: waveforms (B, L) on the device → features (B, T, D).

Port of ``BatchedFrontend``, ``_batched_deltas`` and
``GmmDecodableProvider`` from kaldi_tpu/features/batch.py (the JAX
package's one-program batched frontend, its counterpart of the
reference's src/cudafeat/).  Framing is one device gather of every
utterance's frames; DC removal, raw log-energy and pre-emphasis run as
tensor ops over the (B·T, window) frames; then ONE launch of the fbank
kernel (ops/fbank.py ``CudaFbank``) covers every frame of the batch; for
MFCC the DCT product and the lifter follow, then per-utterance CMN and
deltas over (B, T, ·) tensors, with no loop over utterances.  The
provider chains the frontend into ONE launch of the GMM kernel over the
(B·T, D) features.  The frame count comes from L on the host, so a call
makes no host sync.

What the original does, kept as it is: no dither; the MFCC energy
column is the unfloored raw log-energy; the ``fbank`` type has no
energy column and takes the log of the power; T = ``num_frames(L)`` and
frame t reads samples t·shift + j whatever ``snip_edges`` says.  With
``snip_edges=False`` those indices can pass L - 1: the original's gather
clamps them to the last sample, and so does this one.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from kaldi_tpu_torch.core.logging import KaldiError
from kaldi_tpu_torch.features.compute import (MfccOptions,
                                              compute_dct_matrix,
                                              compute_lifter_coeffs)
from kaldi_tpu_torch.features.functions import (DeltaFeaturesOptions,
                                                delta_scales)
from kaldi_tpu_torch.features.window import num_frames, preprocess_frames
from kaldi_tpu_torch.ops.fbank import CudaFbank


class BatchedFrontend:
    """waves (B, L) → features (B, T, D) on one device, with one fbank
    launch a call; optionally per-utterance CMN and deltas.  ``opts`` is
    an ``MfccOptions`` (or, for ``feature_type="fbank"``, anything with
    ``frame_opts`` and ``mel_opts``)."""

    def __init__(self, opts: Optional[MfccOptions] = None,
                 feature_type: str = "mfcc",
                 deltas: Optional[DeltaFeaturesOptions] = None,
                 cmn: bool = False, device: torch.device | str = "cuda"):
        if feature_type not in ("mfcc", "fbank"):
            raise ValueError(feature_type)
        self.feature_type = feature_type
        self.opts = opts = opts or MfccOptions()
        self.frame_opts = opts.frame_opts
        self.kernel = CudaFbank(opts.frame_opts, opts.mel_opts, device)
        self.device = self.kernel.device
        self.dct = self.lifter = None
        if feature_type == "mfcc":
            self.dct = torch.from_numpy(np.ascontiguousarray(
                compute_dct_matrix(opts.num_ceps, opts.mel_opts.num_bins).T)
            ).to(self.device)
            if opts.cepstral_lifter != 0:
                self.lifter = torch.from_numpy(compute_lifter_coeffs(
                    opts.cepstral_lifter, opts.num_ceps)).to(self.device)
            base_dim = opts.num_ceps
        else:
            base_dim = opts.mel_opts.num_bins
        self.deltas = deltas
        self.cmn = cmn
        self.dim = base_dim * ((deltas.order + 1) if deltas else 1)

    def num_frames(self, num_samples: int) -> int:
        return num_frames(num_samples, self.frame_opts)

    def __call__(self, waves) -> torch.Tensor:
        """waves (B, L) float32 (numpy, or a tensor on the frontend's
        device; padded: the frames of trailing padding are computed too,
        mask them downstream by frame count) → (B, T, dim) float32."""
        waves = torch.as_tensor(waves, dtype=torch.float32)
        if waves.device != self.device:
            waves = waves.to(self.device)
        if waves.dim() != 2:
            raise ValueError(f"waves must be (B, L), got {tuple(waves.shape)}")
        fo = self.frame_opts
        B, L = waves.shape
        T = num_frames(L, fo)
        idx = (torch.arange(T, device=self.device)[:, None] * fo.window_shift
               + torch.arange(fo.window_size, device=self.device)[None, :])
        frames = waves[:, idx.clamp_(max=L - 1)]              # (B, T, size)
        x, log_energy = preprocess_frames(frames.reshape(B * T, -1), fo)
        feats = self.kernel(x.contiguous())                   # (B·T, n_mel)
        if self.feature_type == "mfcc":
            feats = feats @ self.dct
            if self.lifter is not None:
                feats = feats * self.lifter[None, :]
            if self.opts.use_energy:
                feats[:, 0] = log_energy
        feats = feats.reshape(B, T, -1)
        if self.cmn:
            feats = feats - feats.mean(dim=1, keepdim=True)
        if self.deltas is not None:
            feats = _batched_deltas(feats, self.deltas)
        return feats


def _batched_deltas(feats: torch.Tensor,
                    opts: DeltaFeaturesOptions) -> torch.Tensor:
    """(B, T, D) → (B, T, D·(order + 1)), edge frames replicated per
    utterance, summed in the original's order."""
    scales = delta_scales(opts)
    max_off = (len(scales[-1]) - 1) // 2
    T = feats.shape[1]
    padded = torch.cat([feats[:, :1].expand(-1, max_off, -1), feats,
                        feats[:, -1:].expand(-1, max_off, -1)], dim=1)
    outs = []
    for s in scales:
        off = (len(s) - 1) // 2
        acc = torch.zeros_like(feats)
        for j, c in enumerate(s):
            if c == 0.0:
                continue
            start = max_off - off + j
            acc = acc + float(c) * padded[:, start:start + T]
        outs.append(acc)
    return torch.cat(outs, dim=2)


class GmmDecodableProvider:
    """waves (B, L) → per-pdf log-likelihoods (B, T, P): the frontend,
    then one launch of the acoustic model's GMM kernel over all B·T
    frames (the decode-time analogue of the reference's feature +
    posterior GPU stage in BatchedThreadedNnet3CudaPipeline)."""

    def __init__(self, frontend: BatchedFrontend, am):
        if am.device_params().device != frontend.device:
            raise KaldiError(f"frontend on {frontend.device}, acoustic "
                             f"model on {am.device}")
        self.frontend = frontend
        self.am = am

    def __call__(self, waves) -> torch.Tensor:
        x = self.frontend(waves)
        B, T, D = x.shape
        ll = self.am.device_params()(x.reshape(B * T, D).contiguous())
        return ll.reshape(B, T, -1)
