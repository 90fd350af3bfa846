"""The 3xTF32 split of the kernels' operands (csrc/tf32x3.cuh), and the
mma.sync fragment order of the fbank kernel's B operand, on the host.

A float32 value v is taken as hi + lo, hi = tf32(v) and lo = tf32(v − hi),
with tf32 rounding to nearest, ties away from zero (``cvt.rna``), and the
low 13 bits cleared.  The fbank kernel reads each k-step of each
8-column n-tile of a (K × N) operand as 32 lanes × (b0 hi, b1 hi, b0 lo,
b1 lo), with b0 = B[8s + t, 8j + g] and b1 = B[8s + t + 4, 8j + g] for
lane = 4g + t.  (The GMM kernel's wgmma layout is ops/gmm.py's.)
"""

from __future__ import annotations

import torch


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 → the nearest TF32 value (ties away from zero), as
    float32."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_tf32(x: torch.Tensor):
    """(hi, lo) with hi + lo ≈ x to about 22 bits."""
    hi = round_tf32(x)
    return hi, round_tf32(x.to(torch.float32) - hi)


def fragment_order(b: torch.Tensor) -> torch.Tensor:
    """(..., K, N) float32 with K and N multiples of 8 → (..., K/8, N/8,
    32, 4): per k-step s and n-tile j, each lane's (b0 hi, b1 hi, b0 lo,
    b1 lo)."""
    *lead, K, N = b.shape
    hi, lo = split_tf32(b)

    def lanes(t):
        # (.., s, h, t, j, g) → (.., s, j, g, t, h): row 8s + 4h + t,
        # column 8j + g, lane 4g + t
        t = t.reshape(*lead, K // 8, 2, 4, N // 8, 8)
        n = len(lead)
        return t.permute(*range(n), n, n + 3, n + 4, n + 2, n + 1)

    out = torch.stack([lanes(hi), lanes(lo)], dim=-2)   # (.., t, 2, h)
    return out.reshape(*lead, K // 8, N // 8, 32, 4).contiguous()


def from_fragment_order(f: torch.Tensor):
    """Inverse of ``fragment_order``: (..., K/8, N/8, 32, 4) → the
    (hi, lo) halves, each (..., K, N)."""
    *lead, KS, NT, _, _ = f.shape
    t = f.reshape(*lead, KS, NT, 8, 4, 2, 2)      # (s, j, g, t, hl, h)
    n = len(lead)

    def unlanes(u):                               # (s, j, g, t, h)
        return u.permute(*range(n), n, n + 4, n + 3, n + 1, n + 2) \
            .reshape(*lead, KS * 8, NT * 8)

    return unlanes(t[..., 0, :]), unlanes(t[..., 1, :])
