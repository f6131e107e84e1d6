"""ctypes wrapper for the native CPU pruning+gradient baseline.

This is bench.py's honest BEAGLE-CPU stand-in (the reference's L0 backend,
src/fat_beagle.cpp:50-70,119-175): an -O3 -march=native vectorized,
OpenMP-threaded host implementation of the exact bench workload (JC69 +
constant sites, log-likelihood + linear-time two-pass branch gradient),
built from native/cpu_baseline.cpp on the host that runs it.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from ..io import native

_LIB = None


def _load():
    global _LIB
    if _LIB is not None:
        return _LIB
    if not native.build_native("cpu_baseline"):
        raise RuntimeError("building native/libsbn_cpu_baseline.so failed")
    lib = ctypes.CDLL(os.path.join(native._NATIVE_DIR, "libsbn_cpu_baseline.so"))
    i32p = ctypes.POINTER(ctypes.c_int32)
    f64p = ctypes.POINTER(ctypes.c_double)
    lib.lsbn_cpu_baseline_eval.argtypes = [
        i32p, i32p, i32p, i32p, f64p, f64p, f64p,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, f64p, f64p,
    ]
    lib.lsbn_cpu_baseline_eval.restype = None
    lib.lsbn_cpu_baseline_eval_pk.argtypes = [
        i32p, f64p, f64p, f64p, f64p, f64p,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, f64p,
    ]
    lib.lsbn_cpu_baseline_eval_pk.restype = None
    lib.lsbn_cpu_baseline_threads.argtypes = []
    lib.lsbn_cpu_baseline_threads.restype = ctypes.c_int32
    _LIB = lib
    return lib


def threads() -> int:
    """Host threads the baseline's batch loops use (1 when it was built
    without the OpenMP runtime)."""
    return int(_load().lsbn_cpu_baseline_threads())


def eval_batch(post_children, up_node, up_parent, up_sibs, bl, tips,
               weights, leaf_count, threads=0, dtype_bits=64,
               ll_only=False):
    """LLs + branch gradients for a batch of trees on the host.

    post_children: (T, n_internal, 3); up_*: (T, n_up[, 2]); bl: (T, N+1)
    by node id (ones slot zero); tips: (L, 4, S); weights: (S,).
    Returns (lls (T,), grads (T, N)); with ll_only=True the gradient pass
    is skipped and grads is None (the LL-only bench denominator)."""
    lib = _load()
    post_children = np.ascontiguousarray(post_children, np.int32)
    up_node = np.ascontiguousarray(up_node, np.int32)
    up_parent = np.ascontiguousarray(up_parent, np.int32)
    up_sibs = np.ascontiguousarray(up_sibs, np.int32)
    bl = np.ascontiguousarray(bl, np.float64)
    tips = np.ascontiguousarray(tips, np.float64)
    weights = np.ascontiguousarray(weights, np.float64)
    T, n_internal, _ = post_children.shape
    L = int(leaf_count)
    N = L + n_internal
    n_up = up_node.shape[1]
    S = weights.shape[0]
    assert bl.shape == (T, N + 1), (bl.shape, T, N)
    assert tips.shape == (L, 4, S)
    out_ll = np.empty(T, np.float64)
    out_grad = None if ll_only else np.empty((T, N), np.float64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    f64p = ctypes.POINTER(ctypes.c_double)
    as_i = lambda a: a.ctypes.data_as(i32p)  # noqa: E731
    as_f = lambda a: a.ctypes.data_as(f64p)  # noqa: E731
    lib.lsbn_cpu_baseline_eval(
        as_i(post_children), as_i(up_node), as_i(up_parent), as_i(up_sibs),
        as_f(bl), as_f(tips), as_f(weights),
        T, L, N, n_up, S, int(threads), int(dtype_bits),
        as_f(out_ll),
        ctypes.cast(None, f64p) if ll_only else as_f(out_grad),
    )
    return out_ll, out_grad


def eval_batch_ll_pk(post_children, P, tips, weights, props, freqs,
                     leaf_count, threads=0):
    """K-category LL-only with precomputed per-node transition matrices:
    the native denominator for the batched GTR/Weibull likelihood config.

    post_children: (T, n_internal, 3); P: (T, N+1, K, 4, 4); tips:
    (L, 4, S); props: (K,); freqs: (4,). Returns lls (T,)."""
    lib = _load()
    post_children = np.ascontiguousarray(post_children, np.int32)
    P = np.ascontiguousarray(P, np.float64)
    tips = np.ascontiguousarray(tips, np.float64)
    weights = np.ascontiguousarray(weights, np.float64)
    props = np.ascontiguousarray(props, np.float64)
    freqs = np.ascontiguousarray(freqs, np.float64)
    T, n_internal, _ = post_children.shape
    L = int(leaf_count)
    N = L + n_internal
    K = P.shape[2]
    S = weights.shape[0]
    assert P.shape == (T, N + 1, K, 4, 4), P.shape
    assert tips.shape == (L, 4, S)
    out_ll = np.empty(T, np.float64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    f64p = ctypes.POINTER(ctypes.c_double)
    as_i = lambda a: a.ctypes.data_as(i32p)  # noqa: E731
    as_f = lambda a: a.ctypes.data_as(f64p)  # noqa: E731
    lib.lsbn_cpu_baseline_eval_pk(
        as_i(post_children), as_f(P), as_f(tips), as_f(weights),
        as_f(props), as_f(freqs), T, L, N, K, S, int(threads),
        as_f(out_ll),
    )
    return out_ll
