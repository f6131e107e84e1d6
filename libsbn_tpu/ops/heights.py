"""Time-tree height-ratio transform as differentiable scans.

Reference semantics: rooted_tree.cpp InitializeTimeTreeUsingHeightRatios and
fat_beagle.cpp LogDeterminantJacobian. The reference computes gradients of
this transform with hand-derived BEAST recursions
(rooted_gradient_transforms.cpp); here the transform is a jax.lax.scan over a
preorder schedule, so the ratio/root-height and clock gradients are exact AD.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def node_heights_from_ratios(
    ratios, node_bounds, leaf_count, pre_internal_node, pre_internal_parent,
    n_iters=None, method="sweeps",
):
    """height_ratios (leaf_count-1, last entry = root height) -> node heights.

    node_bounds: (N,) max tip date below each node; leaf entries are the tip
    dates themselves. Returns heights (N,).

    Computed by DENSE fixed-point iteration instead of a per-node scan:
    h[v] = b_v + r_v (h[parent] - b_v) propagates one tree level per sweep
    and is exact (and idempotent) once every level has been reached, so
    internal-count sweeps always suffice — and each sweep is one dense
    gather + FMA over all nodes, which reverse-differentiates as dense ops
    instead of a per-node scan whose VJP is one serial step per node.
    Pass n_iters (>=
    max internal depth, e.g. from BatchedSchedule heights) to shorten the
    loop when the caller knows the depth statically."""
    ratios = jnp.asarray(ratios)
    node_bounds = jnp.asarray(node_bounds)
    n = node_bounds.shape[0]
    n_internal = n - leaf_count - 1
    if n_iters is None:
        n_iters = max(1, n_internal)
    dtype = ratios.dtype
    b = node_bounds.astype(dtype)

    # Per-node update operands, aligned to node ids (leaves and root are
    # fixed points: r = 1 keeps h[v] = its initial value... leaves use
    # r = 0 so h = b; the root uses its own slot as "parent" with r = 1).
    r_full = jnp.zeros((n,), dtype)
    r_full = r_full.at[leaf_count:n - 1].set(ratios[:n_internal])
    r_full = r_full.at[n - 1].set(1.0)
    parent_full = jnp.arange(n)
    parent_full = parent_full.at[pre_internal_node].set(pre_internal_parent)

    h0 = b.at[n - 1].set(ratios[-1])

    # Parent lookup as a one-hot matvec rather than a batched gather: the
    # one-hot contraction is bit-exact (each row holds a single 1.0, and
    # adding exact zeros changes nothing) and reverse-differentiates as
    # the transposed matvec.
    P = jax.nn.one_hot(parent_full, n, dtype=dtype)

    if method == "squaring":
        # The sweep is affine: h' = A h + c with A = diag(r) P and
        # c = (1 - r) * b; compose it with itself log2(n_iters) times
        # ((A, c) -> (A^2, A c + c)) — exact for any count >= max depth
        # (extra applications fix the converged point). Trades the
        # sequential matvec chain for a handful of matmuls.
        import math

        A = r_full[:, None] * P
        c = b - r_full * b
        for _ in range(max(1, math.ceil(math.log2(max(n_iters, 2))))):
            c = A @ c + c
            A = A @ A
        return A @ h0 + c

    def sweep(_, h):
        return b + r_full * (P @ h - b)

    return jax.lax.fori_loop(0, n_iters, sweep, h0)


def branch_lengths_from_heights(heights, parent):
    """bl[i] = heights[parent[i]] - heights[i] for non-root nodes i."""
    return heights[parent] - heights[:-1]


def ratio_and_rate_gradients_from_branch_gradient(
    g_bl_scaled, ratios, node_bounds, rates, leaf_count,
    pre_internal_node, pre_internal_parent, parent, n_iters,
    include_jacobian=True, heights=None, method="sweeps",
):
    """Hand chain rule: fused-kernel branch gradient -> (d obj/d ratios,
    d obj/d rates, heights), obj = LL (+ the height-ratio log-det-Jacobian).

    The reference computes this with BEAST's per-node recursions
    (rooted_gradient_transforms.cpp:17-37 HeightGradient, :132-162
    RatioGradientOfHeightGradient); here both directions are dense one-hot
    sweeps so ONE fused LL+gradient kernel pass replaces the fwd+bwd
    custom-VJP kernel pair. The adjoint of the fixed-point transform is
    evaluated at the converged heights (implicit-function form): iterate
    w <- A^T w with A = d sweep/d heights and accumulate W = sum_j w_j;
    rows of d sweep/d ratios vanish at the root, so only W's non-root
    components matter and they converge within max-depth sweeps.

    g_bl_scaled: (N-1,) gradient w.r.t. rate-scaled branch lengths.
    Returns (dratios (L-1,), drates (N-1,), heights (N,))."""
    n = node_bounds.shape[0]
    dtype = g_bl_scaled.dtype
    b = jnp.asarray(node_bounds).astype(dtype)
    h = heights
    if h is None:
        h = node_heights_from_ratios(
            ratios, node_bounds, leaf_count, pre_internal_node,
            pre_internal_parent, n_iters=n_iters, method=method,
        )
    bl = branch_lengths_from_heights(h, parent)
    g_rates = g_bl_scaled * bl
    g_bl = g_bl_scaled * rates

    # Branch gradient -> height gradient: bl_i = h[parent_i] - h_i.
    E = jax.nn.one_hot(parent, n, dtype=dtype)  # (N-1, N)
    g_h = E.T @ g_bl
    g_h = g_h - jnp.pad(g_bl, (0, 1))
    if include_jacobian:
        # d/dh of sum over internal non-root i of log(h[parent_i] - b_i):
        # +1/(h_par - b_i) at the parent (b_i is constant). Guard the
        # division on the MASKED (leaf) rows: a leaf whose height equals
        # its parent's (ratio 0 / f32 underflow) would otherwise produce
        # 0 * inf = NaN and poison the whole tree's gradient — the AD
        # path slices to internal rows before the log and stays finite.
        diff = h[parent] - b[:-1]
        mask = jnp.zeros((n - 1,), dtype).at[leaf_count:].set(1.0)
        inv = mask / jnp.where(mask > 0, diff, 1.0)
        g_h = g_h + E.T @ inv

    # Adjoint of the fixed-point transform. Two lowerings of the same
    # series W = sum_j (A^T)^j g_h, w_final = (A^T)^K g_h with
    # A = diag(r) P (exact for any K >= max depth: A^j is zero off the
    # root column beyond the depth, and the root rows of dS/dr vanish):
    #  * "sweeps": K sequential one-hot matvecs — latency-bound;
    #  * "squaring": log2(K) matrix squarings of (S_k, M_k) with
    #    S_{k+1} = S_k + M_k S_k, M_{k+1} = M_k^2 — matmuls, ~4x
    #    fewer sequential steps.
    n_internal = n - leaf_count - 1
    r_full = jnp.zeros((n,), dtype)
    r_full = r_full.at[leaf_count:n - 1].set(
        jnp.asarray(ratios[:n_internal], dtype)
    )
    r_full = r_full.at[n - 1].set(1.0)
    parent_full = jnp.arange(n)
    parent_full = parent_full.at[pre_internal_node].set(pre_internal_parent)
    P = jax.nn.one_hot(parent_full, n, dtype=dtype)

    if method == "squaring":
        import math

        At = (r_full[:, None] * P).T
        S = jnp.eye(n, dtype=dtype)
        M = At
        for _ in range(max(1, math.ceil(math.log2(max(n_iters, 2))))):
            S = S + M @ S
            M = M @ M
        W = S @ g_h
        w_final = M @ g_h
    else:

        def sweep(_, carry):
            w, W = carry
            w = P.T @ (r_full * w)
            return w, W + w

        w_final, W = jax.lax.fori_loop(0, n_iters, sweep, (g_h, g_h))

    # d sweep/d r_v = (h[parent_v] - b_v) at internal non-root v; the root
    # slot of the ratio vector is the initial condition h0_root.
    hp_minus_b = (P @ h) - b
    dratios = (W * hp_minus_b)[leaf_count:n - 1]
    dratios = jnp.concatenate([dratios, w_final[n - 1][None]])
    return dratios, g_rates, h


def log_det_jacobian(heights, node_bounds, parent, leaf_count):
    """log |det d(heights)/d(ratios)| = sum over internal non-root nodes of
    log(h_parent - bound_node) (fat_beagle.cpp LogDeterminantJacobian)."""
    n = heights.shape[0]
    internal = jnp.arange(leaf_count, n - 1)
    return jnp.sum(
        jnp.log(heights[parent[internal]] - node_bounds[internal])
    )
