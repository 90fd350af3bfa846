# Copied from kaldi_tpu/native/__init__.py; imports rewritten to
# kaldi_tpu_torch.  The library builds into build/kaldi_tpu_torch/ at the
# repository root (git-ignored) under a temporary name of its own per
# process, so that processes building at once do not race.
"""Native (C++) host-runtime components.

The reference implements its host runtime — decoders' lattice passes,
table I/O, graph build — in C++; the TPU build keeps the COMPUTE path
in XLA/Pallas but implements the per-utterance host hot loops natively
too.  Components are plain C-linkage shared objects loaded via ctypes
(no pybind11 in this environment); each has a numpy reference
implementation that serves as both oracle (tests compare them) and
fallback when no compiler is available.

Build-on-demand: the .so is compiled with g++ -O3 on first use and
cached in build/kaldi_tpu_torch/; set KALDI_TPU_NO_NATIVE=1 to force the
numpy fallbacks.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

from kaldi_tpu_torch.core.logging import get_logger

log = get_logger(__name__)

_DIR = os.path.dirname(os.path.abspath(__file__))
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build",
                          "kaldi_tpu_torch")
_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


_SOURCES = ["lattice_build.cpp", "lattice_det.cpp"]


def _build_and_load() -> Optional[ctypes.CDLL]:
    srcs = [os.path.join(_DIR, s) for s in _SOURCES]
    so = os.path.join(_BUILD_DIR, "libkt_native.so")
    if (not os.path.exists(so)
            or os.path.getmtime(so) < max(os.path.getmtime(s)
                                          for s in srcs)):
        tmp = f"{so}.{os.getpid()}.tmp"
        try:
            os.makedirs(_BUILD_DIR, exist_ok=True)
            subprocess.run(
                ["g++", "-O3", "-shared", "-fPIC", *srcs, "-o", tmp],
                check=True, capture_output=True, timeout=180)
            os.replace(tmp, so)
            log.info("native: compiled %s", os.path.basename(so))
        except Exception as e:
            log.warning("native: build failed (%s); using numpy fallback",
                        e)
            return None
    try:
        return ctypes.CDLL(so)
    except OSError as e:
        log.warning("native: load failed (%s); using numpy fallback", e)
        return None


def get_lib() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if os.environ.get("KALDI_TPU_NO_NATIVE"):
        return None
    with _LOCK:
        if not _TRIED:
            _TRIED = True
            _LIB = _build_and_load()
            if _LIB is not None:
                _bind(_LIB)
    return _LIB


def _bind(lib: ctypes.CDLL) -> None:
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.kt_build_lattice.restype = ctypes.c_int64
    lib.kt_build_lattice.argtypes = [
        ctypes.c_int64, ctypes.c_int64,
        i32p, i32p, i32p, i32p, i32p, f32p, f32p,
        i32p, f32p, i32p, ctypes.c_int64,
        f32p, ctypes.c_float, ctypes.c_int64,
        i32p, i32p, i32p, i32p, f32p, f32p,
        i32p, f32p, i64p, i64p,
    ]
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    i64ap = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    i32sp = ctypes.POINTER(ctypes.c_int32)
    lib.kt_determinize_lattice.restype = ctypes.c_int64
    lib.kt_determinize_lattice.argtypes = [
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
        i32p, i32p, i32p, i32p, f32p, f32p,
        i32p, f32p, f32p, ctypes.c_int64,
        ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        i32p, i32p, i32p, f64p, f64p,
        i32p, i64ap,
        i32p, f64p, f64p, i64ap,
        i64p, i64p, i64p, i32sp,
    ]


def build_lattice_native(counts, prev, dst, tid, ol, gw, ac,
                         init_slots, init_costs, init_ols, tok_final,
                         lattice_beam: float):
    """Run the native raw-lattice assembly + pruning over PACKED
    records (counts (T,), flat fields of sum(counts)).  Returns
    (src, dst, il, ol, gw, ac, final_states, final_w, n_states) or
    None if the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    T = counts.shape[0]
    K = tok_final.shape[0]
    cap = int(prev.shape[0] + len(init_slots) + 1)
    o_src = np.empty(cap, np.int32)
    o_dst = np.empty(cap, np.int32)
    o_il = np.empty(cap, np.int32)
    o_ol = np.empty(cap, np.int32)
    o_gw = np.empty(cap, np.float32)
    o_ac = np.empty(cap, np.float32)
    o_fs = np.empty(K + 1, np.int32)
    o_fw = np.empty(K + 1, np.float32)
    n_fin = ctypes.c_int64(0)
    n_states = ctypes.c_int64(0)

    na = _call_build(lib, T, K, counts, prev, dst, tid, ol, gw, ac,
                     init_slots, init_costs, init_ols, tok_final,
                     lattice_beam,
                     cap, o_src, o_dst, o_il, o_ol, o_gw, o_ac,
                     o_fs, o_fw, n_fin, n_states)
    if na < 0:
        return None
    na = int(na)
    return (o_src[:na], o_dst[:na], o_il[:na], o_ol[:na],
            o_gw[:na], o_ac[:na],
            o_fs[:n_fin.value], o_fw[:n_fin.value], int(n_states.value))


def _call_build(lib, T, K, counts, prev, dst, tid, ol, gw, ac,
                init_slots, init_costs, init_ols, tok_final,
                lattice_beam, cap,
                o_src, o_dst, o_il, o_ol, o_gw, o_ac,
                o_fs, o_fw, n_fin, n_states):

    def c(a, dt):
        return np.ascontiguousarray(a, dt)

    if init_ols is None:
        init_ols = np.zeros(len(init_slots), np.int32)
    return lib.kt_build_lattice(
        T, K,
        c(counts, np.int32),
        c(prev, np.int32), c(dst, np.int32), c(tid, np.int32),
        c(ol, np.int32), c(gw, np.float32), c(ac, np.float32),
        c(init_slots, np.int32), c(init_costs, np.float32),
        c(init_ols, np.int32),
        len(init_slots),
        c(tok_final, np.float32), float(lattice_beam), cap,
        o_src, o_dst, o_il, o_ol, o_gw, o_ac,
        o_fs, o_fw, ctypes.byref(n_fin), ctypes.byref(n_states))


def determinize_lattice_native(n_states: int, start: int,
                               src, dst, il, ol, gw, ac,
                               fin_states, fin_gc, fin_ac,
                               max_states: int = 200000):
    """Native lattice determinization over raw arc arrays.  Returns
    (arc_src, arc_word, arc_next, arc_gc, arc_ac, tids_flat,
    arc_tid_off, fin_state, fin_gc, fin_ac, fin_off, n_out_states,
    out_start) or None if the native library is unavailable.  Raises
    KaldiError on det-state blowup (mirroring the Python oracle)."""
    lib = get_lib()
    if lib is None:
        return None
    n_arcs = int(len(src))

    def c(a, dt):
        return np.ascontiguousarray(a, dt)

    a_src = c(src, np.int32)
    a_dst = c(dst, np.int32)
    a_il = c(il, np.int32)
    a_ol = c(ol, np.int32)
    a_gw = c(gw, np.float32)
    a_ac = c(ac, np.float32)
    f_st = c(fin_states, np.int32)
    f_gc = c(fin_gc, np.float32)
    f_ac = c(fin_ac, np.float32)
    # det output is bounded by the input size in practice (pruned raw
    # lattices); grow on overflow up to a hard cap
    cap_a = max(4 * n_arcs + 64, 1024)
    cap_t = max(16 * n_arcs + 64, 4096)
    for _attempt in range(3):
        cap_s = cap_a + 2
        o_src = np.empty(cap_a, np.int32)
        o_word = np.empty(cap_a, np.int32)
        o_next = np.empty(cap_a, np.int32)
        o_gc = np.empty(cap_a, np.float64)
        o_ac = np.empty(cap_a, np.float64)
        o_tids = np.empty(cap_t, np.int32)
        o_toff = np.empty(cap_a + 1, np.int64)
        o_fst = np.empty(cap_s, np.int32)
        o_fgc = np.empty(cap_s, np.float64)
        o_fac = np.empty(cap_s, np.float64)
        o_foff = np.empty(cap_s + 1, np.int64)
        noa = ctypes.c_int64(0)
        nof = ctypes.c_int64(0)
        nos = ctypes.c_int64(0)
        ost = ctypes.c_int32(-1)
        rc = lib.kt_determinize_lattice(
            int(n_states), n_arcs, int(start),
            a_src, a_dst, a_il, a_ol, a_gw, a_ac,
            f_st, f_gc, f_ac, len(f_st),
            int(max_states), cap_a, cap_t, cap_s,
            o_src, o_word, o_next, o_gc, o_ac, o_tids, o_toff,
            o_fst, o_fgc, o_fac, o_foff,
            ctypes.byref(noa), ctypes.byref(nof), ctypes.byref(nos),
            ctypes.byref(ost))
        if rc == 0:
            na, nf = int(noa.value), int(nof.value)
            return (o_src[:na], o_word[:na], o_next[:na],
                    o_gc[:na], o_ac[:na], o_tids, o_toff[:na + 1],
                    o_fst[:nf], o_fgc[:nf], o_fac[:nf], o_foff[:nf + 1],
                    int(nos.value), int(ost.value))
        if rc == -3:
            from kaldi_tpu_torch.core.logging import KaldiError
            raise KaldiError("determinize_lattice: state blowup")
        cap_a *= 4
        cap_t *= 4
    return None
