"""Felsenstein pruning: batched scans over dense schedules.

This module replaces BEAGLE (the reference's L0 compute backend,
fat_beagle.cpp) with a JAX/XLA engine:

  * the postorder pass (beagleUpdatePartials analog) is a lax.scan over the
    schedule's combine steps, writing partials M and per-edge evolved
    partials E into device buffers;
  * the preorder pass (beagleUpdatePrePartials analog) is a second scan
    computing upper partials U;
  * per-edge branch-length derivatives (beagleCalculateEdgeDerivatives
    analog) are ONE batched contraction over all edges — the linear-time
    gradient of Ji & Suchard, with dP/db = (r Q) P;
  * the whole log-likelihood is wrapped in a custom_vjp whose backward pass
    is that linear-time scheme, so ALL model gradients (branch lengths, GTR,
    Weibull shape, clock rates, node heights) flow by ordinary JAX AD through
    exact derivatives — no finite differences anywhere (contrast
    fat_beagle.cpp:400-465).

Rescaling: after each combine the partial is divided by its per-pattern max
(across rate categories and states) and the log accumulates; backward-pass
quantities are per-edge ratios in which the scale factors cancel, so the
gradient path never needs absolute scale bookkeeping (contrast BEAGLE's
scale-buffer machinery, beagle_accessories.hpp).

Shapes: K = rate categories, P = site patterns, N = node count; buffers have
N+1 slots, the last being the all-ones padding slot (see ops/schedule.py).

Because schedules are *traced* int32 arrays (not static), one compilation
serves every topology with the same (leaf_count, rootedness) — thousands of
sampled topologies per jitted launch via vmap over the leading batch axis.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


# -- transition matrices ----------------------------------------------------
def node_transition_matrices(evec, ivec, evals, branch_lengths, rates):
    """P = V exp(Λ · b · r) V⁻¹ for every node slot and rate category.

    branch_lengths: (N+1,) with 0 at root and ones slot; rates: (K,).
    Returns (N+1, K, 4, 4).

    The scalar exponential runs in f64 regardless of the working dtype: a
    few ulp of f32 exp error amplify through ~L levels of partial products
    toward the pybeagle/physher parity gates (atol 0.5; see BASELINE.md
    precision policy). The (N+1,K,4) exp tensor is tiny next to the
    pruning work, so its f64 cost is noise."""
    dt = jnp.result_type(evec, branch_lengths)
    t = branch_lengths.astype(jnp.float64)[..., :, None] * rates.astype(
        jnp.float64
    )  # (..., N+1, K)
    expo = jnp.exp(t[..., None] * evals.astype(jnp.float64))  # (..., N+1, K, 4)
    return jnp.einsum("ij,...nkj,jl->...nkil", evec, expo.astype(dt), ivec)


# -- forward (postorder) pass ----------------------------------------------
def _postorder_m(post_node, post_children, P, tips, rescale: bool):
    """Compute node partials only. Returns (M, logscale):
    M: (N+1, K, 4, Pp); logscale: (Pp,).

    Step s always writes node L+s (internal ids are postorder-linear by
    construction — asserted at schedule build), so the buffer update is a
    loop-linear dynamic-update-slice (in-place under XLA) instead of a
    scatter; post_node is accepted for API compatibility but not consulted.
    The scan carries just M — per-edge evolved partials E are recomputed
    afterwards in one batched einsum (_evolved_of)."""
    del post_node
    n_slots, K = P.shape[0], P.shape[1]
    L, _, n_pat = tips.shape
    dtype = P.dtype

    M = jnp.ones((n_slots, K, 4, n_pat), dtype=dtype)
    M = M.at[:L].set(tips[:, None, :, :].astype(dtype))
    logscale = jnp.zeros((n_pat,), dtype=dtype)

    def step(carry, children):
        M, logscale, s = carry
        cm = M[children]  # (3, K, 4, Pp)
        cp = P[children]  # (3, K, 4, 4)
        ev = jnp.einsum("ckij,ckjp->ckip", cp, cm)
        prod = ev[0] * ev[1] * ev[2]
        if rescale:
            scale = jnp.max(prod, axis=(0, 1))  # (Pp,)
            scale = jnp.where(scale > 0, scale, jnp.ones_like(scale))
            prod = prod / scale
            logscale = logscale + jnp.log(scale)
        M = jax.lax.dynamic_update_slice(M, prod[None], (L + s, 0, 0, 0))
        return (M, logscale, s + 1), None

    (M, logscale, _), _ = jax.lax.scan(step, (M, logscale, 0), post_children)
    return M, logscale


def _evolved_of(P, M):
    """E[n] = P_n M_n for every slot, one batched contraction."""
    return jnp.einsum("nkij,nkjp->nkip", P, M)


def _postorder(post_node, post_children, P, tips, rescale: bool):
    """(M, E, logscale) — forward pass plus per-edge evolved partials."""
    M, logscale = _postorder_m(post_node, post_children, P, tips, rescale)
    return M, _evolved_of(P, M), logscale


# -- preorder (upper partial) pass -----------------------------------------
def _preorder(up_node, up_parent, up_sibs, P, E, freqs, root_id, rescale: bool):
    """Upper partials U: U[root] = freqs; U[c] = (P_par^T U[par]) ⊙ Π E[sib].

    Reference implementation, one step per non-root node; the production
    path is _preorder_pernode below (identical results up to per-pattern
    scale factors, which cancel in the gradient ratios)."""
    n_slots, K, _, n_pat = E.shape
    dtype = E.dtype
    U = jnp.zeros((n_slots, K, 4, n_pat), dtype=dtype)
    U = U.at[root_id].set(freqs[None, :, None].astype(dtype))

    def step(U, xs):
        node, parent, sibs = xs
        pu = U[parent]  # (K, 4, Pp)
        pp = P[parent]  # (K, 4, 4)
        evolved_up = jnp.einsum("kij,kip->kjp", pp, pu)
        se = E[sibs]  # (2, K, 4, Pp)
        u = evolved_up * se[0] * se[1]
        if rescale:
            scale = jnp.max(u, axis=(0, 1))
            scale = jnp.where(scale > 0, scale, jnp.ones_like(scale))
            u = u / scale
        return U.at[node].set(u), None

    U, _ = jax.lax.scan(step, U, (up_node, up_parent, up_sibs))
    return U


def _preorder_pernode(post_children, P, E, freqs, root_id, rescale: bool):
    """Production upper-partial pass: one scan step per INTERNAL node in
    reverse postorder (node root_id - i, a loop-linear read), computing the
    shared evolved-up vector once and emitting all of that node's children
    in one 3-row write — about half the sequential steps of _preorder.
    Padded ones-slot children receive garbage rows that are never read (the
    ones slot is outside every edge range)."""
    n_slots, K, _, n_pat = E.shape
    dtype = E.dtype
    U = jnp.zeros((n_slots, K, 4, n_pat), dtype=dtype)
    U = U.at[root_id].set(freqs[None, :, None].astype(dtype))
    rev_children = post_children[::-1]  # step i handles node root_id - i

    def step(carry, kids):
        U, i = carry
        node = root_id - i
        pu = jax.lax.dynamic_index_in_dim(U, node, keepdims=False)  # (K,4,Pp)
        pp = jax.lax.dynamic_index_in_dim(P, node, keepdims=False)  # (K,4,4)
        evolved_up = jnp.einsum("kij,kip->kjp", pp, pu)
        se = E[kids]  # (3, K, 4, Pp)
        u0 = evolved_up * se[1] * se[2]
        u1 = evolved_up * se[0] * se[2]
        u2 = evolved_up * se[0] * se[1]
        u = jnp.stack([u0, u1, u2])  # (3, K, 4, Pp)
        if rescale:
            scale = jnp.max(u, axis=(1, 2))  # (3, Pp)
            scale = jnp.where(scale > 0, scale, jnp.ones_like(scale))
            u = u / scale[:, None, None, :]
        return (U.at[kids].set(u), i + 1), None

    (U, _), _ = jax.lax.scan(step, (U, 0), rev_children)
    return U


def _root_site_likelihoods(M, root_id, freqs, props):
    """Scaled per-pattern site likelihoods at the root: (Pp,)."""
    return jnp.einsum("k,i,kip->p", props, freqs, M[root_id])


# -- public API -------------------------------------------------------------
class Sched(NamedTuple):
    """The schedule fields log_likelihood_and_branch_gradient reads."""

    root_id: int
    post_children: jnp.ndarray


def _sched_tuple(sched):
    """The five index arrays of a (batched or single) schedule."""
    return (
        jnp.asarray(sched.post_node),
        jnp.asarray(sched.post_children),
        jnp.asarray(sched.up_node),
        jnp.asarray(sched.up_parent),
        jnp.asarray(sched.up_sibs),
    )


@functools.partial(jax.custom_vjp, nondiff_argnums=(0, 1))
def _log_likelihood(
    rescale: bool, root_id: int, sched5, P, tips, freqs, props, weights
):
    post_node, post_children, _, _, _ = sched5
    M, logscale = _postorder_m(post_node, post_children, P, tips, rescale)
    site = _root_site_likelihoods(M, root_id, freqs, props)
    return jnp.sum(weights * (jnp.log(site) + logscale))


def _ll_fwd(rescale, root_id, sched5, P, tips, freqs, props, weights):
    post_node, post_children, up_node, up_parent, up_sibs = sched5
    M, logscale = _postorder_m(post_node, post_children, P, tips, rescale)
    E = _evolved_of(P, M)
    site = _root_site_likelihoods(M, root_id, freqs, props)
    ll = jnp.sum(weights * (jnp.log(site) + logscale))
    return ll, (sched5, P, tips, freqs, props, weights, M, E, logscale, site)


def _ll_bwd(rescale, root_id, res, g):
    sched5, P, tips, freqs, props, weights, M, E, logscale, site = res
    post_node, post_children, up_node, up_parent, up_sibs = sched5
    n_slots = P.shape[0]
    L = tips.shape[0]
    n_edges = root_id  # root has the largest id; every other node has an edge

    U = _preorder_pernode(post_children, P, E, freqs, root_id, rescale)

    Ue = U[:n_edges]  # (Ne, K, 4, Pp)
    Ee = E[:n_edges]
    Me = M[:n_edges]
    # Per-edge scaled site likelihoods; scale factors cancel in the ratios.
    denom = jnp.einsum("k,ekip,ekip->ep", props, Ue, Ee)
    wden = weights[None, :] / denom  # (Ne, Pp)

    # d ll / dP[e,k,i,j] = sum_p w_p prop_k U[e,k,i,p] M[e,k,j,p] / denom[e,p]
    dP_edges = jnp.einsum("k,ekip,ep,ekjp->ekij", props, Ue, wden, Me)
    dP = jnp.zeros_like(P).at[:n_edges].set(dP_edges)

    # d ll / d tips[l,i,p] = w_p/denom[l,p] * sum_k prop_k (P_l^T U[l])[k,i,p]
    PtU = jnp.einsum("lkij,lkip->lkjp", P[:L], U[:L])
    dtips = jnp.einsum("k,lkjp,lp->ljp", props, PtU, wden[:L]).astype(tips.dtype)

    # Root-based quantities for freqs/props/weights.
    root_M = M[root_id]  # (K, 4, Pp)
    w_over_site = weights / site
    dfreqs = jnp.einsum("k,kip,p->i", props, root_M, w_over_site)
    dprops = jnp.einsum("i,kip,p->k", freqs, root_M, w_over_site)
    dweights = jnp.log(site) + logscale

    zero_sched = tuple(
        np.zeros(np.shape(a), dtype=jax.dtypes.float0)
        for a in (post_node, post_children, up_node, up_parent, up_sibs)
    )
    return (zero_sched, g * dP, g * dtips, g * dfreqs, g * dprops, g * dweights)


_log_likelihood.defvjp(_ll_fwd, _ll_bwd)


def log_likelihood(sched, P, tips, freqs, props, weights, rescale: bool = True):
    """Log likelihood of one tree. P: (N+1,K,4,4) node transition matrices,
    tips: (L,4,Pp), freqs: (4,), props: (K,), weights: (Pp,)."""
    assert P.shape[-4] == sched.root_id + 2, (
        f"P must cover N+1 = root_id+2 slots (root + ones slot); got "
        f"{P.shape[-4]} for root_id {sched.root_id}"
    )
    return _log_likelihood(
        rescale, sched.root_id, _sched_tuple(sched), P, tips, freqs, props, weights
    )


def log_likelihood_and_branch_gradient(
    sched, P, Q_scaled, tips, freqs, props, weights, rescale: bool = True
):
    """Linear-time (ll, branch gradient) in one pass.

    Q_scaled: (K,4,4), the rate matrix scaled by each category rate
    (BuildDifferentialMatrices analog, fat_beagle.cpp:107-117). Returns
    gradient over node ids 0..root_id-1 (every non-root node's edge)."""
    assert P.shape[-4] == sched.root_id + 2, (
        f"P must cover N+1 = root_id+2 slots (root + ones slot); got "
        f"{P.shape[-4]} for root_id {sched.root_id}"
    )
    post_children = jnp.asarray(sched.post_children)
    root_id = sched.root_id
    M, logscale = _postorder_m(None, post_children, P, tips, rescale)
    E = _evolved_of(P, M)
    site = _root_site_likelihoods(M, root_id, freqs, props)
    ll = jnp.sum(weights * (jnp.log(site) + logscale))

    U = _preorder_pernode(post_children, P, E, freqs, root_id, rescale)
    n_edges = root_id
    Ue, Ee = U[:n_edges], E[:n_edges]
    denom = jnp.einsum("k,ekip,ekip->ep", props, Ue, Ee)
    # dP/db · M = (r_k Q) P M = Q_scaled · E
    QE = jnp.einsum("kij,ekjp->ekip", Q_scaled, Ee)
    num = jnp.einsum("k,ekip,ekip->ep", props, Ue, QE)
    grad = jnp.sum(weights[None, :] * num / denom, axis=-1)
    return ll, grad
