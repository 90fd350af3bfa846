"""Card identity, CUDA-event timing and the kernels' bounds."""

from __future__ import annotations

import math
import subprocess
import time

import torch

# the H100 SXM's memory rate, and its float32-equivalent rate through
# 3xTF32: the H100 SXM's 495 TFLOP/s of dense TF32 over the 3 products,
# the least-time route that keeps float32 accuracy
HBM_BYTES_PER_S = 3.35e12
F32_VIA_3XTF32_FLOP_PER_S = 495e12 / 3
# the H100 SXM's float32 rate outside the tensor cores (sparse work that
# no matrix product carries)
F32_FLOP_PER_S = 67e12
# cycles per second of torch.cuda._sleep's spin on an H100 (its SM clock
# runs at up to 1.98 GHz); a longer spin than needed only costs time
_SLEEP_HZ = 2.0e9


def card_info() -> str:
    """The first card's "name, power limit" as nvidia-smi reports it."""
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int) -> float:
    """Mean milliseconds per call of ``fn`` over ``iters`` calls issued
    back to back, by CUDA events (after one warm call).  Where the host
    takes longer to issue a call than the card to run it, this is the
    host's issue time."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


class LaunchQueueOverflow(RuntimeError):
    """``device_ms`` could not queue its calls behind the spin: the
    host was still issuing them when the spin ended."""


def device_ms(fn, iters: int) -> float:
    """Mean milliseconds per call of ``fn`` on the card alone: the calls
    are queued behind a spin kernel long enough for the host to issue
    all of them, so the events time only the card's work (warm L2, as
    for a model's tables that stay resident).  The launch queue holds
    about a thousand launches: past that the host waits for the card and
    the events would time its gaps.  So if the spin has ended before the
    last call is queued (checked by an event recorded after the spin;
    once more with a spin four times as long), this raises
    ``LaunchQueueOverflow``: time such work by ``graph_ms`` or
    ``kernel_ms``."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    issue = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    spun = torch.cuda.Event()
    for spin_s in (min(2.0 * issue * iters + 1e-3, 2.0),
                   min(8.0 * issue * iters + 4e-3, 8.0)):
        torch.cuda._sleep(int(spin_s * _SLEEP_HZ))
        spun.record()
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        queued = not spun.query()
        torch.cuda.synchronize()
        if queued:
            return start.elapsed_time(end) / iters
    raise LaunchQueueOverflow(
        f"device_ms: {iters} calls were not all queued within a "
        f"{spin_s:.3f} s spin (more launches than the launch queue holds, "
        f"or a host that slow): time them by graph_ms or kernel_ms")


def kernel_ms(fn, iters: int) -> float:
    """Mean milliseconds per call of ``fn`` on the card, as the sum of
    its kernels' durations that CUPTI records (torch.profiler) over
    ``iters`` calls after one warm call: the card's busy time, whatever
    the host's gaps and however many launches.  Raises if the profile
    holds no kernels (one taken after earlier profiles in the same
    process has come back empty)."""
    fn()
    torch.cuda.synchronize()

    def calls():
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()

    _, n, dev_ms, _ = profiled(calls)
    if n == 0:
        raise RuntimeError("kernel_ms: the profile holds no kernels")
    return dev_ms / iters


def graph_ms(fn) -> float:
    """Milliseconds the card takes for the work ``fn`` queues, with no
    host in its way: ``fn`` (warm, and free of host synchronisation) is
    captured once into a CUDA graph, and the graph is launched once
    between two CUDA events, so the card runs its kernels back to back.
    For work of more launches than the launch queue holds (about a
    thousand), which ``device_ms`` cannot queue whole behind its spin
    (the host then waits for the card, and the events time its gaps).
    ``fn``'s outputs are dropped with the graph."""
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end)
    del graph
    return ms


def profiled(fn, cpu_ops: bool = True):
    """Run ``fn`` (which ends in a device synchronisation) under
    torch.profiler → (wall ms, CUDA kernels launched, their device ms,
    the profile).  ``cpu_ops=False`` records the card's activity alone:
    for windows of many thousand launches, whose host operator events
    take the profiler seconds to record and parse."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CUDA] + (
        [ProfilerActivity.CPU] if cpu_ops else [])
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        wall = (time.perf_counter() - t0) * 1e3
    # device work only: an optimizer's step also shows on the device as
    # a user-annotation range spanning its kernels
    kernels = [e for e in prof.events() if e.device_type.name == "CUDA"
               and not getattr(e, "is_user_annotation", False)]
    return wall, len(kernels), sum(e.device_time for e in kernels) / 1e3, prof


def bound_ms(flop: float, nbytes: float):
    """(least ms the card could take for this work, "operations" or
    "bytes": whichever bounds it)."""
    t_ops = flop / F32_VIA_3XTF32_FLOP_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def fbank_bound(k, n: int):
    """The fbank function's own bound at n frames on CudaFbank k, not
    that of the kernel's algorithm: frames, window and the mel filters'
    nonzero weights read once, output written once; per frame a real FFT
    of n_fft points (2.5·n_fft·log2 n_fft operations), the window
    multiply, the power (3 a bin), the nonzero mel weights (2 each) and
    the log.  The kernel's dense DFT product does ~35× the FFT's
    operations; its tables are the design's, not the function's."""
    n_fft = 2 * (k.n_bins - 1)
    nnz = k.melw.numel()
    flop = n * (2.5 * n_fft * math.log2(n_fft) + k.win_size
                + 3.0 * k.n_bins + 2.0 * nnz + k.n_mel)
    nbytes = 4.0 * (n * k.win_size + k.win_size + nnz + n * k.n_mel)
    return bound_ms(flop, nbytes)


def chain_den_bound(k, active_frames: int, B: int, T: int, P: int):
    """The chain denominator's bound on CudaChainDen k for scores (B, T,
    P) with ``active_frames`` (b, t) pairs not masked: per active frame
    and arc one multiply-add of α·w·e forward (3 operations) and
    w·e·γ, its sum into β and its occupancy into the gradient backward
    (5), per state the leak and the normalization each way (8), one exp
    per pdf each way (2); float32 outside the tensor cores (67 TFLOP/s,
    the H100 SXM's).  Bytes: scores and mask read once, the gradient
    and log Z written once, the graph (per arc two states, a pdf and a
    weight; per state four values) read once."""
    A = k.num_arcs
    S = k.num_states
    flop = active_frames * (8.0 * A + 8.0 * S + 2.0 * P)
    nbytes = 8.0 * B * T * P + B * T + 4.0 * B + 16.0 * (A + S)
    t_ops = flop / F32_FLOP_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def gmm_bound(k, T: int):
    """The GMM's bound at T frames on CudaGmm k: 4·D operations per
    (frame, live Gaussian) (padded slots carry the sentinel gconst and
    are no work the function needs); features, live parameters and
    output moved once."""
    live = int((k.gconst > -1e29).sum())
    flop = 4.0 * T * live * k.dim
    nbytes = 4.0 * (T * k.dim + live * (2 * k.dim + 1) + T * k.num_pdfs)
    return bound_ms(flop, nbytes)
