# Port of kaldi_tpu/am/cnn.py (flax) to torch.nn.
"""Time-height convolution (the nnet3 CNN component family).

Port of kaldi_tpu/am/cnn.py (``TimeHeightConv``,
``ConvReluBatchnormLayer``; parity target:
src/nnet3/nnet-convolutional-component.h): each frame's feature vector
is a (height, filters) image column, convolved over (time-offset,
height-offset) taps, with time taps zero-padded at the utterance's
edges and height taps padded so that height-out is exact.  The layer is
one ``conv2d`` on a (B, filters, T, height) image; the weight is flax's
HWIO kernel (kt, kh, cin, cout) as torch's (cout, cin, kt, kh).  cuDNN
runs it, forward and backward, in float32 without TF32 whatever
``torch.backends.cudnn.allow_tf32`` says (``cudnn_f32_call``).
"""

from __future__ import annotations

import contextlib
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from kaldi_tpu_torch.am.tdnn import BatchNorm


def cudnn_f32():
    """cuDNN in float32 without TF32, the other cuDNN settings as they
    are (a no-op on the CPU)."""
    c = torch.backends.cudnn
    return c.flags(enabled=True, benchmark=c.benchmark,
                   deterministic=c.deterministic, allow_tf32=False) \
        if torch.cuda.is_available() else contextlib.nullcontext()


class _CudnnF32(torch.autograd.Function):
    """Runs ``fn`` and, in the backward pass, its gradient under
    ``cudnn_f32``: cuDNN reads its TF32 flag when each pass runs, so a
    ``with`` block around the forward alone would leave the backward to
    the global flag."""

    @staticmethod
    def forward(ctx, fn, *args):
        leaves = [a.detach().requires_grad_(a.requires_grad)
                  if isinstance(a, torch.Tensor) else a for a in args]
        with torch.enable_grad(), cudnn_f32():
            outs = fn(*leaves)
        single = isinstance(outs, torch.Tensor)
        outs = (outs,) if single else tuple(outs)
        ctx.leaves, ctx.outs = leaves, outs
        return outs[0].detach() if single else \
            tuple(o.detach() for o in outs)

    @staticmethod
    def backward(ctx, *grads):
        need = [i for i, a in enumerate(ctx.leaves)
                if isinstance(a, torch.Tensor) and a.requires_grad]
        pairs = [(o, g) for o, g in zip(ctx.outs, grads)
                 if o.requires_grad]
        got = [None] * len(need)
        if need and pairs:
            with cudnn_f32():
                got = torch.autograd.grad(
                    [o for o, _ in pairs], [ctx.leaves[i] for i in need],
                    [g for _, g in pairs], allow_unused=True)
        out = [None] * len(ctx.leaves)
        for i, g in zip(need, got):
            out[i] = g
        return (None, *out)


def cudnn_f32_call(fn, *args):
    """``fn(*args)`` with cuDNN in float32 without TF32 in its forward
    and backward passes when a card is present; as it is on a host
    without one."""
    if not torch.cuda.is_available():
        return fn(*args)
    if not torch.is_grad_enabled():
        with cudnn_f32():
            return fn(*args)
    return _CudnnF32.apply(fn, *args)


# Copied from kaldi_tpu/am/cnn.py _contiguous.
def _contiguous(offsets: Sequence[int], what: str) -> Tuple[int, int]:
    """Validate an offset list is a contiguous range (the reference
    supports arbitrary offset sets, but every shipped recipe uses
    contiguous taps, which is what a dense conv kernel expresses)."""
    off = sorted(int(o) for o in offsets)
    if not off or off != list(range(off[0], off[-1] + 1)):
        raise ValueError(
            f"{what} offsets must be a contiguous range, got {offsets}")
    return off[0], off[-1]


# Port of kaldi_tpu/am/cnn.py TimeHeightConv.
class TimeHeightConv(nn.Module):
    """(B, T, height_in · filters_in) → (B, T, height_out · filters_out).

    ``time_offsets`` / ``height_offsets`` are the taps relative to the
    output position; ``height_subsample`` strides the height axis
    (height_out = (height_in − 1) // subsample + 1).  ``in_dim`` is the
    input width, height_in · filters_in."""

    def __init__(self, height_in: int, in_dim: int, num_filters_out: int,
                 time_offsets: Tuple[int, ...] = (-1, 0, 1),
                 height_offsets: Tuple[int, ...] = (-1, 0, 1),
                 height_subsample: int = 1):
        super().__init__()
        if in_dim % height_in:
            raise ValueError(f"feature dim {in_dim} not divisible by "
                             f"height_in {height_in}")
        self.height_in, self.cin = height_in, in_dim // height_in
        self.num_filters_out = num_filters_out
        self.t0, t1 = _contiguous(time_offsets, "time")
        self.h0, h1 = _contiguous(height_offsets, "height")
        self.pad = (-self.h0, h1, -self.t0, t1)
        self.height_subsample = height_subsample
        self.height_out = (height_in - 1) // height_subsample + 1
        self.weight = nn.Parameter(torch.zeros(
            num_filters_out, self.cin, t1 - self.t0 + 1, h1 - self.h0 + 1))
        self.bias = nn.Parameter(torch.zeros(num_filters_out))

    def forward(self, x):
        B, T, D = x.shape
        img = x.reshape(B, T, self.height_in, self.cin).permute(0, 3, 1, 2)
        # the padding lets output index t read input taps t+t0..t+t1 (and
        # likewise for height), zeros outside
        out = cudnn_f32_call(
            lambda i, w, b: F.conv2d(F.pad(i, self.pad), w, b,
                                     stride=(1, self.height_subsample)),
            img, self.weight, self.bias)
        return out.permute(0, 2, 3, 1).reshape(
            B, T, self.height_out * self.num_filters_out)


# Port of kaldi_tpu/am/cnn.py ConvReluBatchnormLayer.
class ConvReluBatchnormLayer(nn.Module):
    """conv-relu-batchnorm-layer: TimeHeightConv → ReLU → BatchNorm."""

    def __init__(self, height_in: int, in_dim: int, num_filters_out: int,
                 time_offsets: Tuple[int, ...] = (-1, 0, 1),
                 height_offsets: Tuple[int, ...] = (-1, 0, 1),
                 height_subsample: int = 1):
        super().__init__()
        self.conv = TimeHeightConv(height_in, in_dim, num_filters_out,
                                   time_offsets, height_offsets,
                                   height_subsample)
        self.out_dim = self.conv.height_out * num_filters_out
        self.batchnorm = BatchNorm(self.out_dim)

    def forward(self, x):
        return self.batchnorm(torch.relu(self.conv(x)))
