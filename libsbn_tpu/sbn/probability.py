"""SBN probability: simple-average and EM training, probability evaluation.

Reference: /root/reference/src/sbn_probability.cpp (NeurIPS 2018 Algorithm 1).

Dense formulation: indexer representations are dense int32 arrays
(T topologies, E rootings, R indices per rooting); sbn_parameters carries an
extra slot at index G holding -inf, so out-of-support indices (sentinel G)
contribute zero probability with no branching. The EM inner loop is ONE
jitted program of gathers, segment-logsumexp normalizations, and
scatter-adds — replacing the reference's per-topology per-rooting loops
(sbn_probability.cpp:214-329).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

NEG_INF = -np.inf


def with_sentinel(params, sentinel_value=NEG_INF):
    """Append the out-of-support slot: (G,) -> (G+1,)."""
    return jnp.concatenate([params, jnp.full((1,), sentinel_value, params.dtype)])


def segment_logsumexp(values, segment_ids, num_segments):
    """Per-segment logsumexp via scatter-max + scatter-add."""
    seg_max = jnp.full((num_segments,), NEG_INF, values.dtype)
    seg_max = seg_max.at[segment_ids].max(values)
    # Guard fully -inf segments.
    safe_max = jnp.where(jnp.isfinite(seg_max), seg_max, 0.0)
    shifted = jnp.exp(values - safe_max[segment_ids])
    seg_sum = jnp.zeros((num_segments,), values.dtype).at[segment_ids].add(shifted)
    return safe_max + jnp.log(seg_sum)


def probability_normalize_in_log(params, segment_ids, num_segments):
    """Normalize each block to log-probabilities (ProbabilityNormalizeParamsInLog)."""
    logz = segment_logsumexp(params, segment_ids, num_segments)
    return params - logz[segment_ids]


def log_counts_of_representations(reps, counts, gpcsp_count):
    """log of the scatter-added topology counts (SetLogCounts analog).

    reps: (T, ..., R) int32 with sentinel G allowed; counts: (T,)."""
    reps = jnp.asarray(reps)
    counts = jnp.asarray(counts, jnp.float64)
    flat = reps.reshape(reps.shape[0], -1)
    acc = jnp.zeros((gpcsp_count + 1,), jnp.float64)
    acc = acc.at[flat].add(
        jnp.broadcast_to(counts[:, None], flat.shape)
    )
    return jnp.log(acc[:gpcsp_count])


def simple_average(reps, counts, gpcsp_count):
    """SA estimator: sbn_parameters = log counts (SimpleAverage).

    Note the reference does NOT normalize here; evaluation normalizes on the
    fly."""
    return log_counts_of_representations(reps, counts, gpcsp_count)


def _em_step(params, reps, counts, log_m_tilde_alpha, m_tilde_pos, segment_ids,
             num_segments, alpha_positive: bool):
    """One EM iteration. params must be normalized log-probabilities.

    reps: (T, E, R); counts: (T,). Returns (new params, score)."""
    G = segment_ids.shape[0]
    ext = with_sentinel(params)
    # log q(rooting) = sum of log-probabilities along each rooted rep.
    logq = jnp.sum(ext[reps], axis=-1)  # (T, E)
    logp = jax.scipy.special.logsumexp(logq, axis=-1)  # (T,)
    score = jnp.sum(counts * logp)
    # E-step weights, scaled by topology counts.
    w = jnp.exp(logq - logp[:, None]) * counts[:, None]  # (T, E)
    # M-step: scatter the weights onto every index of every rooted rep.
    flat_idx = reps.reshape(-1)
    flat_w = jnp.broadcast_to(w[:, :, None], reps.shape).reshape(-1)
    m_bar = jnp.zeros((G + 1,), params.dtype).at[flat_idx].add(flat_w)[:G]
    log_m_bar = jnp.log(m_bar)
    if alpha_positive:
        new = jnp.logaddexp(log_m_bar, log_m_tilde_alpha)
    else:
        new = log_m_bar
    new = probability_normalize_in_log(new, segment_ids, num_segments)
    if alpha_positive:
        score = score + jnp.sum(m_tilde_pos * new)
    # Underflow telemetry (the reference traps FE exceptions per rooting,
    # clamps to DOUBLE_MINIMUM and reports: sbn_probability.cpp:278-281,
    # numerical_utils.hpp:65-75). The log-space equivalent worth flagging
    # is an E-step weight that underflows to exactly 0 for an in-support
    # rooting — its contribution is silently dropped from the M-step.
    underflowed = jnp.sum(
        jnp.logical_and(jnp.isfinite(logq), w <= 0.0), dtype=jnp.int32
    )
    return new, score, underflowed


def expectation_maximization(
    reps, counts, segment_ids, gpcsp_count, alpha=0.0, max_iter=100,
    score_epsilon=0.0, progress=False,
):
    """EM training (ExpectationMaximization). Returns (params, score_history).

    reps: (T, E, R) dense unrooted representations; counts: (T,) topology
    counts. The score is the marginal log-likelihood of the training trees
    (+ regularization term when alpha > 0); monotonicity is asserted as in
    the reference."""
    reps = jnp.asarray(reps)
    counts = jnp.asarray(counts, jnp.float64)
    segment_ids = jnp.asarray(segment_ids)
    num_segments = int(np.asarray(segment_ids).max()) + 1
    edge_count = reps.shape[1]

    log_m_tilde = log_counts_of_representations(reps, counts, gpcsp_count)
    log_m_tilde = log_m_tilde - jnp.log(float(edge_count))
    params = probability_normalize_in_log(log_m_tilde, segment_ids, num_segments)

    alpha_positive = alpha > 0.0
    if alpha_positive:
        log_m_tilde_alpha = log_m_tilde + jnp.log(alpha)
        m_tilde_pos = jnp.exp(log_m_tilde_alpha)
    else:
        log_m_tilde_alpha = jnp.zeros_like(log_m_tilde)
        m_tilde_pos = jnp.zeros_like(log_m_tilde)

    step = jax.jit(
        lambda p: _em_step(
            p, reps, counts, log_m_tilde_alpha, m_tilde_pos, segment_ids,
            num_segments, alpha_positive,
        )
    )

    score_history = []
    max_underflowed = 0
    underflow_iters = 0
    for em_idx in range(max_iter):
        params, score, underflowed = step(params)
        score = float(score)
        underflowed = int(underflowed)
        if underflowed:
            underflow_iters += 1
            max_underflowed = max(max_underflowed, underflowed)
        if progress:
            # The reference renders a ProgressBar over max_iter
            # (sbn_probability.cpp:256); one status line per iteration.
            print(
                f"EM [{em_idx + 1}/{max_iter}] score {score:.10f}",
                flush=True,
            )
        if not np.isfinite(score):
            import warnings

            warnings.warn(
                f"EM iteration {em_idx}: non-finite score {score} "
                "(ReportFloatingPointEnvironmentExceptions analog)",
                RuntimeWarning,
                stacklevel=2,
            )
        score_history.append(score)
        if em_idx > 0:
            prev = score_history[-2]
            # Degenerate supports (e.g. a single 3-taxon tree) reach score 0
            # exactly; fall back to the absolute improvement there.
            scaled = (score - prev) / abs(prev) if prev != 0.0 else score - prev
            assert scaled > -1e-10, "EM score function decreased."
            if abs(scaled) < score_epsilon:
                break
    if underflow_iters:
        import warnings

        warnings.warn(
            f"EM: up to {max_underflowed} in-support rooting weights "
            f"underflowed to 0 (affected {underflow_iters} of "
            f"{len(score_history)} iterations); their M-step contributions "
            "were dropped (reference clamps these to DOUBLE_MINIMUM and "
            "reports the FE exception, sbn_probability.cpp:278-281)",
            RuntimeWarning,
            stacklevel=2,
        )
    return params, np.asarray(score_history)


# -- probability evaluation --------------------------------------------------
def probability_of_rooted_collection(params_normalized, reps):
    """reps: (T, R) rooted representations -> (T,) probabilities; out-of-
    support trees get 0 (ProbabilityOfSingle semantics via -inf sentinel)."""
    ext = with_sentinel(jnp.asarray(params_normalized))
    return jnp.exp(jnp.sum(ext[jnp.asarray(reps)], axis=-1))


def probability_of_unrooted_collection(params_normalized, reps):
    """reps: (T, E, R) unrooted representations -> (T,) probabilities summed
    over rootings."""
    ext = with_sentinel(jnp.asarray(params_normalized))
    logq = jnp.sum(ext[jnp.asarray(reps)], axis=-1)  # (T, E)
    return jnp.exp(jax.scipy.special.logsumexp(logq, axis=-1))
