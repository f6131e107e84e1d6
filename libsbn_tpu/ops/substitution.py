"""Substitution models: JC69 and GTR, as JAX-differentiable functions.

Reference semantics: /root/reference/src/substitution_model.{hpp,cpp}.

A substitution model provides (frequencies, eigenvectors V, inverse
eigenvectors V^-1, eigenvalues) of the rate matrix Q, normalized to unit
expected substitution rate. Transition matrices are P(t) = V e^{Λt} V^{-1}.

GTR eigendecomposition follows Felsenstein p.206: symmetrize with
diag(sqrt(pi)); eigh is differentiable in JAX, so GTR gradients flow by AD —
replacing the reference's central-finite-difference scheme
(fat_beagle.cpp:400-465) with exact derivatives.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def jc69_eigen(dtype=jnp.float64):
    """Hardcoded JC69 eigendecomposition (substitution_model.hpp:59-74)."""
    freqs = jnp.full((4,), 0.25, dtype=dtype)
    evec = jnp.array(
        [
            [1.0, 2.0, 0.0, 0.5],
            [1.0, -2.0, 0.5, 0.0],
            [1.0, 2.0, 0.0, -0.5],
            [1.0, -2.0, -0.5, 0.0],
        ],
        dtype=dtype,
    )
    ivec = jnp.array(
        [
            [0.25, 0.25, 0.25, 0.25],
            [0.125, -0.125, 0.125, -0.125],
            [0.0, 1.0, 0.0, -1.0],
            [1.0, 0.0, -1.0, 0.0],
        ],
        dtype=dtype,
    )
    evals = jnp.array([0.0, -4.0 / 3.0, -4.0 / 3.0, -4.0 / 3.0], dtype=dtype)
    return freqs, evec, ivec, evals


def jc69_q(dtype=jnp.float64):
    q = jnp.full((4, 4), 1.0 / 3.0, dtype=dtype)
    return q - jnp.eye(4, dtype=dtype) * (4.0 / 3.0)


def gtr_q(rates, freqs):
    """Build the unit-rate GTR rate matrix (substitution_model.cpp
    UpdateQMatrix). rates: 6 upper-triangle exchangeabilities (AC, AG, AT,
    CG, CT, GT); freqs: stationary frequencies."""
    rates = jnp.asarray(rates)
    freqs = jnp.asarray(freqs)
    iu = jnp.triu_indices(4, k=1)
    S = jnp.zeros((4, 4), dtype=rates.dtype)
    S = S.at[iu].set(rates)
    S = S + S.T
    Q = S * freqs[None, :]
    rowsum = jnp.sum(Q, axis=1)
    Q = Q - jnp.diag(rowsum)
    total_rate = jnp.sum(rowsum * freqs)
    return Q / total_rate


def gtr_eigen(rates, freqs):
    """Differentiable GTR eigendecomposition via the symmetrized matrix.

    Returns (freqs, eigenvectors, inverse eigenvectors, eigenvalues) matching
    the reference's convention (substitution_model.cpp Update)."""
    freqs = jnp.asarray(freqs)
    Q = gtr_q(rates, freqs)
    sqrt_f = jnp.sqrt(freqs)
    S = sqrt_f[:, None] * Q / sqrt_f[None, :]
    # Symmetrize explicitly to keep eigh stable under roundoff.
    S = 0.5 * (S + S.T)
    evals, U = jnp.linalg.eigh(S)
    evec = U / sqrt_f[:, None]
    ivec = U.T * sqrt_f[None, :]
    return freqs, evec, ivec, evals


def transition_matrices(evec, ivec, evals, edge_lengths):
    """P(t) = V diag(e^{Λ t}) V^{-1} batched over edge_lengths.

    edge_lengths: (...,) array of (rate-scaled) branch lengths.
    Returns (..., 4, 4). This is the matrix-exponential kernel used by
    every likelihood engine in the framework (replaces BEAGLE's
    beagleUpdateTransitionMatrices and the GP engine's per-op 4x4 exps)."""
    t = jnp.asarray(edge_lengths)
    # f64 exp regardless of working dtype: a few ulp of f32 exp error
    # amplify through the pruning recursion toward the parity gates (see
    # pruning.node_transition_matrices / BASELINE.md precision policy).
    expo = jnp.exp(
        t.astype(jnp.float64)[..., None] * evals.astype(jnp.float64)
    ).astype(t.dtype)  # (..., 4)
    return jnp.einsum("ij,...j,jk->...ik", evec, expo, ivec)


def q_from_eigen(evec, ivec, evals):
    return jnp.einsum("ij,j,jk->ik", evec, evals, ivec)


def _eigen_of_q(Q, freqs):
    """(evals, V, V^-1) of a reversible Q via the symmetrized form.
    freqs enters only as a numerical device (similarity transform)."""
    sqrt_f = jnp.sqrt(freqs)
    S = sqrt_f[:, None] * Q / sqrt_f[None, :]
    S = 0.5 * (S + S.T)
    lam, U = jnp.linalg.eigh(S)
    return lam, U / sqrt_f[:, None], U.T * sqrt_f[None, :]


@jax.custom_jvp
def expm_transition(Q, freqs, ts):
    """P(t) = expm(Q t) batched over ts, degenerate-eigenvalue-safe AD.

    Q: (4, 4) reversible rate matrix; freqs: its stationary frequencies
    (used ONLY to symmetrize the eigenproblem — P is a function of Q
    alone, so freqs' tangent is correctly zero; differentiate through the
    Q = gtr_q(rates, freqs) construction for frequency gradients);
    ts: (...,) rate-scaled times. Returns (..., 4, 4).

    Plain AD through jnp.linalg.eigh is undefined at repeated eigenvalues
    (e.g. the uniform-rates GTR point, where Q is JC-like) because dV/dQ
    blows up. dP itself stays smooth: by the Daleckii-Krein theorem,
      dP = V [ (V^-1 dQ V) o Phi ] V^-1,
      Phi_ij = (e^{t li} - e^{t lj}) / (li - lj),  Phi_ii = t e^{t li},
    which is basis-independent within degenerate eigenspaces (Phi is
    constant there), so any eigh basis works. The divided difference is
    evaluated in the cancellation-stable sinhc form. This replaces the
    reference's central-finite-difference fallback
    (/root/reference/src/fat_beagle.cpp:400-465) with exact derivatives
    that remain exact AT the degenerate point. Inner math in f64
    (BASELINE.md precision policy)."""
    dt = jnp.result_type(Q, ts)
    lam, V, Vi = _eigen_of_q(
        Q.astype(jnp.float64), jnp.asarray(freqs, jnp.float64)
    )
    expo = jnp.exp(jnp.asarray(ts, jnp.float64)[..., None] * lam)
    return jnp.einsum("ij,...j,jk->...ik", V, expo, Vi).astype(dt)


@expm_transition.defjvp
def _expm_transition_jvp(primals, tangents):
    Q, freqs, ts = primals
    dQ, _dfreqs, dts = tangents  # dfreqs: zero contribution by construction
    dt = jnp.result_type(Q, ts)
    f64 = jnp.float64
    lam64, V, Vi = _eigen_of_q(
        jax.lax.stop_gradient(Q).astype(f64),
        jax.lax.stop_gradient(jnp.asarray(freqs, f64)),
    )
    t64 = jnp.asarray(ts, f64)
    expo = jnp.exp(t64[..., None] * lam64)  # (..., 4)
    P = jnp.einsum("ij,...j,jk->...ik", V, expo, Vi).astype(dt)

    # Phi in sinhc form: t * e^{t(li+lj)/2} * sinhc(t(li-lj)/2).
    mean = 0.5 * (lam64[:, None] + lam64[None, :])
    diff = 0.5 * (lam64[:, None] - lam64[None, :])
    a = t64[..., None, None] * mean
    d = t64[..., None, None] * diff
    small = jnp.abs(d) < 1e-6
    d_safe = jnp.where(small, 1.0, d)
    sinhc = jnp.where(small, 1.0 + d * d / 6.0, jnp.sinh(d_safe) / d_safe)
    phi = t64[..., None, None] * jnp.exp(a) * sinhc  # (..., 4, 4)

    A = Vi @ jnp.asarray(dQ, f64) @ V  # symmetrized-space tangent
    dP_q = jnp.einsum("ij,...jk,kl->...il", V, A * phi, Vi)
    # time tangent: dP/dt = V diag(lam e^{lam t}) Vi.
    dP_t = (
        jnp.einsum("ij,...j,jk->...ik", V, lam64 * expo, Vi)
        * jnp.asarray(dts, f64)[..., None, None]
    )
    return P, (dP_q + dP_t).astype(dt)


DEFAULT_GTR_RATES = np.full(6, 1.0 / 6.0)
DEFAULT_FREQS = np.full(4, 0.25)
