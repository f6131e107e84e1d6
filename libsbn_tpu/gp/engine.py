"""The generalized-pruning engine: batched passes over the subsplit DAG.

The reference interprets a 10-op ISA one op at a time over disk-mmapped PLVs
(gp_engine.cpp ProcessOperations). Here the ISA is *compiled away*: the DAG
lowers to per-level edge groups (subsplit_dag.level_schedules) and each GP
computation is a handful of batched einsum/scatter passes over device-resident
PLV tensors (N, 4, patterns):

  * rootward pass: phat accumulation q(s|t)·P(b)·p(t) per level, p = phat∘phat~;
  * leafward pass: rhat accumulation, r = rhat∘phat~, r~ = rhat∘phat;
  * likelihood rows for ALL edges in one batched contraction;
  * branch optimization: a vectorized safeguarded Newton–bisection on the
    analytic derivative over every edge simultaneously (Jacobi sweeps,
    convergence-terminated per edge) instead of the reference's sequential
    per-edge Brent inside a tidy traversal — the instance loop iterates
    sweeps to convergence, and parity is gated on the resulting marginal
    likelihood, not the optimization path.

Numerics: float64 with one scalar log-scale per (PLV kind, node) — the
continuous analog of the reference's integer rescaling counts
(gp_engine.cpp:288-324); PLVs renormalize by their max after each combine,
and likelihood assembly adds the log-scales back.

Substitution model: JC69, matching gp_engine.hpp:144-155.
"""

from __future__ import annotations

from typing import Dict

import jax
import jax.numpy as jnp
import numpy as np

from ..core.site_pattern import SitePattern
from ..ops import substitution

MIN_LOG_BL = -13.9
MAX_LOG_BL = 1.1
DEFAULT_BRANCH_LENGTH = 0.1


def _jc69_evolve(bl, v):
    """Matrix-free JC69 transition apply: P(bl) v = e v + (1-e)/4 sum_i v_i
    per edge, with e = exp(-4 bl / 3) in f64 (BASELINE.md precision
    policy). bl: (E,); v: (E, 4, S). Replaces building (E, 4, 4) matrices
    + einsum — fewer ops, and no matrix product whose precision a backend
    default could lower."""
    e = jnp.exp(
        jnp.asarray(-4.0 / 3.0, jnp.float64) * bl.astype(jnp.float64)
    ).astype(v.dtype)
    return e[:, None, None] * v + (0.25 * (1.0 - e))[:, None, None] * jnp.sum(
        v, axis=1, keepdims=True
    )


def _jc69_transition(bl):
    """(E,) branch lengths -> (E, 4, 4) JC69 transition matrices."""
    freqs, evec, ivec, evals = substitution.jc69_eigen(bl.dtype)
    # f64 exp (cast back): a few ulp of f32 exp error amplify through the
    # DAG recursion (BASELINE.md precision policy).
    expo = jnp.exp(
        bl.astype(jnp.float64)[..., None] * evals.astype(jnp.float64)
    ).astype(bl.dtype)
    return jnp.einsum("ij,...j,jk->...ik", evec, expo, ivec)


class GPEngine:
    def __init__(
        self,
        site_pattern: SitePattern,
        dag,
        sbn_prior: np.ndarray,
        unconditional_node_probabilities: np.ndarray,
        inverted_sbn_prior: np.ndarray,
        rescaling_threshold: float = 1e-40,  # kept for API parity; unused
        dtype=np.float64,
        mesh=None,
    ):
        self.dag = dag
        self.dtype = dtype
        self.site_pattern = site_pattern
        self.weights = np.asarray(site_pattern.weights)
        self.tips = np.asarray(site_pattern.tip_partials())  # (L, 4, S)
        self.mesh = mesh
        if mesh is not None and "sp" in mesh.axis_names:
            # Multi-device GP: shard the pattern axis of tips (and, by XLA
            # sharding propagation, of every PLV tensor) over the "sp" mesh
            # axis. Pad patterns to a shardable multiple with zero-weight
            # all-ones columns — numerically inert (inert padding protocol
            # of ops/schedule.py; every pattern reduction is weighted by w).
            from jax.sharding import NamedSharding, PartitionSpec as P

            sp_size = mesh.shape["sp"]
            S = self.tips.shape[-1]
            target = -(-S // sp_size) * sp_size
            if target != S:
                self.tips = np.concatenate(
                    [
                        self.tips,
                        np.ones(
                            (*self.tips.shape[:-1], target - S),
                            self.tips.dtype,
                        ),
                    ],
                    axis=-1,
                )
                self.weights = np.concatenate(
                    [self.weights, np.zeros(target - S, self.weights.dtype)]
                )
            self.tips = jax.device_put(
                jnp.asarray(self.tips, dtype),
                NamedSharding(mesh, P(None, None, "sp")),
            )
        self.patterns = self.tips.shape[-1]
        self.q = np.asarray(sbn_prior, dtype=np.float64).copy()
        self.unconditional_node_probabilities = np.asarray(
            unconditional_node_probabilities
        )
        self.inverted_sbn_prior = np.asarray(inverted_sbn_prior)
        E = dag.gpcsp_count_with_fake()
        self.branch_lengths = np.full(E, DEFAULT_BRANCH_LENGTH)
        self.log_likelihood_rows = np.full((E, self.patterns), -np.inf)
        self.log_marginal_per_site = np.full(self.patterns, -np.inf)
        self.hybrid_marginal_log_likelihoods = np.full(E, -np.inf)
        self._hybrid_chunk_jit = None

        self.rootward_levels, self.leafward_levels = dag.level_schedules()
        self.root_ids = np.asarray(dag.rootsplit_node_ids(), dtype=np.int32)
        self.root_gpcsps = np.asarray(
            [dag.rootsplit_index_of_id(int(r)) for r in self.root_ids],
            dtype=np.int32,
        )
        # All non-self-loop edges in one flat listing.
        edges = dag.edge_list()
        self.e_parent = np.asarray([e[0] for e in edges], dtype=np.int32)
        self.e_child = np.asarray([e[1] for e in edges], dtype=np.int32)
        self.e_rot = np.asarray([e[2] for e in edges], dtype=bool)
        self.e_gpcsp = np.asarray([e[3] for e in edges], dtype=np.int32)
        self.plvs: Dict[str, np.ndarray] = {}
        self.logscale: Dict[str, np.ndarray] = {}
        self._build_level_tensors()
        self._populate_jit = jax.jit(self._populate_impl)
        self._rows_jit = jax.jit(self._likelihood_rows_impl)
        self._optimize_jit = jax.jit(self._optimize_impl)
        self._ascent_jit = None

    # -- PLV population ------------------------------------------------------
    def _build_level_tensors(self):
        """Pad the per-level edge groups to uniform widths so PLV population
        compiles as TWO lax.scan bodies instead of an unrolled per-level
        graph (the unrolled form takes minutes of XLA compile for deep
        DAGs). Padding protocol: parent/child pad to the trash node N,
        gpcsp pads to the sentinel index E (q_ext[E] = 0, so padded edges
        contribute exactly zero); node lists pad to N."""
        N = self.dag.node_count()
        E = self.dag.gpcsp_count_with_fake()
        trash, sent = N, E

        def pack(rows, pad_val):
            width = max((len(r) for r in rows), default=0) or 1
            out = np.full((len(rows), width), pad_val, dtype=np.int32)
            for i, r in enumerate(rows):
                out[i, : len(r)] = r
            return out

        rw = self.rootward_levels
        tensors = []
        for rot in (False, True):
            sels = [level["rotated"] == rot for level in rw]
            tensors.append(pack(
                [l["parent"][s] for l, s in zip(rw, sels)], trash))
            tensors.append(pack(
                [l["child"][s] for l, s in zip(rw, sels)], trash))
            tensors.append(pack(
                [l["gpcsp"][s] for l, s in zip(rw, sels)], sent))
        tensors.append(pack([np.unique(l["parent"]) for l in rw], trash))
        self._rw_xs = tuple(jnp.asarray(t) for t in tensors)

        lw = self.leafward_levels
        self._lw_xs = (
            jnp.asarray(pack([l["parent"] for l in lw], trash)),
            jnp.asarray(pack([l["child"] for l in lw], trash)),
            jnp.asarray(pack([l["gpcsp"] for l in lw], sent)),
            jnp.asarray(pack(
                [l["rotated"].astype(np.int32) for l in lw], 0).astype(bool)),
            jnp.asarray(pack([np.unique(l["child"]) for l in lw], trash)),
        )

    def _populate_impl(self, bl, q):
        return self._populate_core(bl, q, jnp.asarray(self.tips, bl.dtype))

    def _populate_core(self, bl, q, tips):
        N = self.dag.node_count()
        L = self.dag.taxon_count
        S = tips.shape[-1]
        # One trash row (index N) absorbs padded-edge scatters; one sentinel
        # q/bl slot (index E) zeroes padded-edge contributions.
        q_ext = jnp.concatenate([q, jnp.zeros((1,), q.dtype)])
        bl_ext = jnp.concatenate([bl, jnp.zeros((1,), bl.dtype)])

        p = jnp.zeros((N + 1, 4, S), bl.dtype).at[:L].set(tips)
        ls_p = jnp.zeros(N + 1, bl.dtype)
        phat = jnp.zeros((N + 1, 4, S), bl.dtype)
        phattilde = jnp.zeros((N + 1, 4, S), bl.dtype)
        ls_phat = jnp.zeros(N + 1, bl.dtype)
        ls_phattilde = jnp.zeros(N + 1, bl.dtype)

        # Scatter-free level updates: the per-level accumulations are
        # one-hot contractions and the per-level node finishes are dense
        # masked selects, which kept the compile of deep DAGs short where a
        # scatter lowering did not. Exactness:
        # every node is finished in exactly ONE level, so "+ onehot^T @
        # contrib" == scatter-add and the dense where == scatter-set.
        iota_n = jnp.arange(N + 1, dtype=jnp.int32)

        def _mask_of(idx):
            return jnp.any(idx[:, None] == iota_n[None, :], axis=0)  # (N+1,)

        def side(pa, ch, g, buf, ls_buf, p, ls_p):
            """One rot-group of one rootward level: evolve children along
            their edges, align scales (dest scale = min over in-edge child
            scales) and accumulate into the parent's phat buffer."""
            contrib = q_ext[g][:, None, None] * _jc69_evolve(
                bl_ext[g], p[ch]
            )
            oh = (pa[:, None] == iota_n[None, :]).astype(bl.dtype)  # (W, N+1)
            lsch = ls_p[ch]
            m = jnp.min(
                jnp.where(oh > 0, lsch[:, None], jnp.asarray(np.inf, bl.dtype)),
                axis=0,
            )  # (N+1,)
            factor = jnp.exp(lsch - m[pa])
            buf = buf + jnp.einsum(
                "wn,wis->nis", oh, contrib * factor[:, None, None]
            )
            # A level with no edges of this orientation leaves the parents'
            # scale untouched (m is +inf there).
            ls_buf = jnp.where(jnp.isfinite(m), m, ls_buf)
            return buf, ls_buf

        def rw_body(carry, xs):
            p, ls_p, phat, phattilde, ls_phat, ls_phattilde = carry
            pa0, ch0, g0, pa1, ch1, g1, nh = xs
            phat, ls_phat = side(pa0, ch0, g0, phat, ls_phat, p, ls_p)
            phattilde, ls_phattilde = side(
                pa1, ch1, g1, phattilde, ls_phattilde, p, ls_p
            )
            mask = _mask_of(nh)
            new_p = phat * phattilde
            mx = jnp.max(new_p, axis=(1, 2))
            mx = jnp.where(mx > 0, mx, 1.0)
            p = jnp.where(mask[:, None, None], new_p / mx[:, None, None], p)
            ls_p = jnp.where(
                mask, ls_phat + ls_phattilde + jnp.log(mx), ls_p
            )
            return (p, ls_p, phat, phattilde, ls_phat, ls_phattilde), None

        if len(self.rootward_levels):
            (p, ls_p, phat, phattilde, ls_phat, ls_phattilde), _ = (
                jax.lax.scan(
                    rw_body,
                    (p, ls_p, phat, phattilde, ls_phat, ls_phattilde),
                    self._rw_xs,
                )
            )

        # Leafward: rhat at rootsplits = q * stationary; descend by level.
        rhat = jnp.zeros((N + 1, 4, S), bl.dtype)
        ls_rhat = jnp.zeros(N + 1, bl.dtype)
        rhat = rhat.at[jnp.asarray(self.root_ids)].set(
            0.25 * q[jnp.asarray(self.root_gpcsps)][:, None, None]
            * jnp.ones((len(self.root_ids), 4, S), bl.dtype)
        )
        r = jnp.zeros((N + 1, 4, S), bl.dtype)
        rtilde = jnp.zeros((N + 1, 4, S), bl.dtype)
        ls_r = jnp.zeros(N + 1, bl.dtype)
        ls_rtilde = jnp.zeros(N + 1, bl.dtype)

        def finish_r(nh, rhat, ls_rhat, r, rtilde, ls_r, ls_rtilde):
            new_r = rhat[nh] * phattilde[nh]
            new_rt = rhat[nh] * phat[nh]
            mx_r = jnp.max(new_r, axis=(1, 2))
            mx_rt = jnp.max(new_rt, axis=(1, 2))
            mx_r = jnp.where(mx_r > 0, mx_r, 1.0)
            mx_rt = jnp.where(mx_rt > 0, mx_rt, 1.0)
            r = r.at[nh].set(new_r / mx_r[:, None, None])
            rtilde = rtilde.at[nh].set(new_rt / mx_rt[:, None, None])
            ls_r = ls_r.at[nh].set(
                ls_rhat[nh] + ls_phattilde[nh] + jnp.log(mx_r)
            )
            ls_rtilde = ls_rtilde.at[nh].set(
                ls_rhat[nh] + ls_phat[nh] + jnp.log(mx_rt)
            )
            return r, rtilde, ls_r, ls_rtilde

        r, rtilde, ls_r, ls_rtilde = finish_r(
            jnp.asarray(self.root_ids), rhat, ls_rhat, r, rtilde, ls_r,
            ls_rtilde,
        )

        def lw_body(carry, xs):
            rhat, ls_rhat, r, rtilde, ls_r, ls_rtilde = carry
            pa, ch, g, rot, nh = xs
            src = jnp.where(rot[:, None, None], rtilde[pa], r[pa])
            ls_src = jnp.where(rot, ls_rtilde[pa], ls_r[pa])
            contrib = q_ext[g][:, None, None] * _jc69_evolve(bl_ext[g], src)
            # Scatter-free (see rootward pass): one-hot accumulate + dense
            # masked finishes.
            oh = (ch[:, None] == iota_n[None, :]).astype(bl.dtype)
            m = jnp.min(
                jnp.where(
                    oh > 0, ls_src[:, None], jnp.asarray(np.inf, bl.dtype)
                ),
                axis=0,
            )
            factor = jnp.exp(ls_src - m[ch])
            rhat = rhat + jnp.einsum(
                "wn,wis->nis", oh, contrib * factor[:, None, None]
            )
            ls_rhat = jnp.where(jnp.isfinite(m), m, ls_rhat)
            mask = _mask_of(nh)
            new_r = rhat * phattilde
            new_rt = rhat * phat
            mx_r = jnp.max(new_r, axis=(1, 2))
            mx_rt = jnp.max(new_rt, axis=(1, 2))
            mx_r = jnp.where(mx_r > 0, mx_r, 1.0)
            mx_rt = jnp.where(mx_rt > 0, mx_rt, 1.0)
            m3 = mask[:, None, None]
            r = jnp.where(m3, new_r / mx_r[:, None, None], r)
            rtilde = jnp.where(m3, new_rt / mx_rt[:, None, None], rtilde)
            ls_r = jnp.where(
                mask, ls_rhat + ls_phattilde + jnp.log(mx_r), ls_r
            )
            ls_rtilde = jnp.where(
                mask, ls_rhat + ls_phat + jnp.log(mx_rt), ls_rtilde
            )
            return (rhat, ls_rhat, r, rtilde, ls_r, ls_rtilde), None

        if len(self.leafward_levels):
            (rhat, ls_rhat, r, rtilde, ls_r, ls_rtilde), _ = jax.lax.scan(
                lw_body,
                (rhat, ls_rhat, r, rtilde, ls_r, ls_rtilde),
                self._lw_xs,
            )

        out = {
            "p": p, "phat": phat, "phattilde": phattilde, "rhat": rhat,
            "r": r, "rtilde": rtilde, "ls_p": ls_p, "ls_phat": ls_phat,
            "ls_phattilde": ls_phattilde, "ls_rhat": ls_rhat, "ls_r": ls_r,
            "ls_rtilde": ls_rtilde,
        }
        # Trim the trash row: downstream consumers index real nodes only.
        return {k: v[:N] for k, v in out.items()}

    def populate_plvs(self):
        out = self._populate_jit(
            jnp.asarray(self.branch_lengths, self.dtype),
            jnp.asarray(self.q, self.dtype),
        )
        # PLVs stay DEVICE-RESIDENT: the coordinate-ascent loop re-feeds them
        # to the likelihood/optimize programs, and shipping the full dict to
        # host every sweep dominated wall time (hundreds of MB per sweep on
        # large DAGs). Host consumers index them transparently; numpy ops
        # transfer lazily on the rare cold paths (hybrids, derivatives).
        self.plvs = out
        # PLV sanitization (the reference asserts finiteness per op,
        # gp_engine.cpp:298-300) — one fused device-side check, one scalar
        # transfer.
        finite = bool(
            jnp.isfinite(out["p"]).all()
            & jnp.isfinite(out["r"]).all()
            & jnp.isfinite(out["rtilde"]).all()
        )
        if not finite:
            raise FloatingPointError(
                "Non-finite values in GP PLVs; check branch lengths and "
                "SBN parameters."
            )

    # -- likelihoods ---------------------------------------------------------
    def _likelihood_rows_impl(self, plvs, bl, q):
        """(E_total, S) log-likelihood rows + per-site log marginal.

        Log-scales broadcast from either form: per-node scalars (N,) from
        populate or per-(node, pattern) rows (N, S)."""
        _b = lambda x: x[:, None] if x.ndim == 1 else x  # noqa: E731
        pa = jnp.asarray(self.e_parent)
        ch = jnp.asarray(self.e_child)
        g = jnp.asarray(self.e_gpcsp)
        rot = jnp.asarray(self.e_rot)
        rot_s = rot if plvs["ls_r"].ndim == 1 else rot[:, None]
        r_plv = jnp.where(rot[:, None, None], plvs["rtilde"][pa], plvs["r"][pa])
        ls_rsrc = jnp.where(rot_s, plvs["ls_rtilde"][pa], plvs["ls_r"][pa])
        lik = jnp.sum(r_plv * _jc69_evolve(bl[g], plvs["p"][ch]), axis=1)
        rows_edges = (
            jnp.log(lik) + _b(ls_rsrc) + _b(plvs["ls_p"][ch])
        )
        # Rootsplit rows: log(q * 0.25 * sum_i p_i) + log-scale of p.
        rp = plvs["p"][jnp.asarray(self.root_ids)]
        root_rows = (
            jnp.log(
                0.25 * q[jnp.asarray(self.root_gpcsps)][:, None]
                * jnp.sum(rp, axis=1)
            )
            + _b(plvs["ls_p"][jnp.asarray(self.root_ids)])
        )
        log_marginal = jax.scipy.special.logsumexp(root_rows, axis=0)
        # Conditional per-rootsplit rows (log-divide by rootsplit prob).
        root_rows = root_rows - jnp.log(q[jnp.asarray(self.root_gpcsps)])[:, None]

        E = self.dag.gpcsp_count_with_fake()
        rows = jnp.full((E, self.patterns), -jnp.inf, bl.dtype)
        rows = rows.at[g].set(rows_edges)
        rows = rows.at[jnp.asarray(self.root_gpcsps)].set(root_rows)
        return rows, log_marginal

    def compute_likelihoods(self):
        rows, log_marginal = self._rows_jit(
            {k: jnp.asarray(v, self.dtype) for k, v in self.plvs.items()},
            jnp.asarray(self.branch_lengths, self.dtype),
            jnp.asarray(self.q, self.dtype),
        )
        # Rows stay on device ((E, patterns) — large); the per-site marginal
        # is small and is what the convergence loop polls.
        self.log_likelihood_rows = rows
        self.log_marginal_per_site = np.asarray(log_marginal)

    def get_log_marginal_likelihood(self) -> float:
        return float(np.sum(self.log_marginal_per_site * self.weights))

    def get_per_gpcsp_log_likelihoods(self) -> np.ndarray:
        return np.asarray(self.log_likelihood_rows @ self.weights)

    def get_per_gpcsp_components_of_full_log_marginal(self) -> np.ndarray:
        return (
            self.get_per_gpcsp_log_likelihoods()
            + self.site_pattern.site_count() * np.log(self.q)
        )

    # -- device-resident coordinate ascent ------------------------------------
    def _marginal_of_plvs(self, plvs, q):
        """Marginal log likelihood from populated PLVs (root rows only —
        skips the full (E, S) likelihood-rows contraction)."""
        _b = lambda x: x[:, None] if x.ndim == 1 else x  # noqa: E731
        ri = jnp.asarray(self.root_ids)
        rg = jnp.asarray(self.root_gpcsps)
        rp = plvs["p"][ri]
        root_rows = (
            jnp.log(0.25 * q[rg][:, None] * jnp.sum(rp, axis=1))
            + _b(plvs["ls_p"][ri])
        )
        per_site = jax.scipy.special.logsumexp(root_rows, axis=0)
        w = jnp.asarray(self.weights, per_site.dtype)
        return jnp.sum(per_site * w)

    def _ascent_impl(self, bl0, q, tol, max_iter, rtol):
        """The WHOLE coordinate ascent (EstimateBranchLengths) as one XLA
        program: populate -> vectorized sweep -> damped line search ->
        convergence check, looped with lax.while_loop. The host-orchestrated
        loop pays a dispatch and a host sync per device call (4+ calls per
        sweep); this pays ONE dispatch for the whole fit. Semantics match
        GPInstance.estimate_branch_lengths's host loop (same damping,
        reject-if-worse, and stopping rules)."""
        dt = bl0.dtype
        populate = lambda bl: self._populate_impl(bl, q)  # noqa: E731
        optimize = self._optimize_impl
        floor = 1e-300 if dt == jnp.float64 else 1e-30

        plvs0 = populate(bl0)
        cur0 = self._marginal_of_plvs(plvs0, q)

        def outer_cond(st):
            i, bl, plvs, cur, done = st
            return (i < max_iter) & (~done)

        def outer_body(st):
            i, bl, plvs, cur, done = st
            proposed = optimize(plvs, bl)
            log_prev = jnp.log(jnp.maximum(bl, floor))
            log_prop = jnp.log(jnp.maximum(proposed, floor))
            plvs_p = populate(proposed)
            m0 = self._marginal_of_plvs(plvs_p, q)

            def in_cond(s):
                alpha, trial, plvs_t, m = s
                return (m < cur) & (alpha > 1.0 / 64)

            def in_body(s):
                alpha, trial, plvs_t, m = s
                alpha = alpha / 2
                trial = jnp.exp((1 - alpha) * log_prev + alpha * log_prop)
                plvs_t = populate(trial)
                return alpha, trial, plvs_t, self._marginal_of_plvs(plvs_t, q)

            alpha, trial, plvs_t, m = jax.lax.while_loop(
                in_cond, in_body,
                (jnp.asarray(1.0, dt), proposed, plvs_p, m0),
            )
            improved = m >= cur
            bl_n = jnp.where(improved, trial, bl)
            plvs_n = jax.tree.map(
                lambda a, b: jnp.where(improved, a, b), plvs_t, plvs
            )
            cur_n = jnp.where(improved, m, cur)
            done_n = (~improved) | (
                jnp.abs(m - cur) < tol + rtol * jnp.abs(cur)
            )
            return i + 1, bl_n, plvs_n, cur_n, done_n

        i, bl, plvs, cur, done = jax.lax.while_loop(
            outer_cond, outer_body,
            (jnp.asarray(0, jnp.int32), bl0, plvs0, cur0,
             jnp.asarray(False)),
        )
        # `done` distinguishes tolerance-met from cap-hit: i == max_iter
        # alone cannot (a fit can converge on exactly the last sweep).
        return bl, plvs, cur, i, done

    # -- streamed (beyond-HBM) coordinate ascent -------------------------------
    def run_branch_ascent_streamed(
        self, tol: float, max_iter: int, pattern_chunk: int,
        memmap_dir: str | None = None, finalize: bool = True,
        rtol: float = 0.0,
    ):
        """EstimateBranchLengths with PLVs that never fully materialize on
        device: the pattern axis streams through in chunks of
        ``pattern_chunk``, so device memory is O(nodes x chunk) instead of
        O(nodes x patterns). This is the capacity role of the reference's
        disk-mmapped PLV arena (mmapped_plv.hpp:19-47, gp_instance.cpp:32),
        lifted to the device: its memory holds one chunk's PLVs; the per-edge Newton
        statistics (A, B) live in host RAM — or in disk-backed np.memmap
        files when memmap_dir is given, matching the reference's
        beyond-RAM capacity exactly.

        Exactness: populate is independent per pattern (per-node log-scales
        make renormalization chunk-invariant), the Newton derivative
        phi = sum_s w B/(A+uB) is scale-invariant per pattern, and
        reject-if-worse compares chunk-accumulated objectives whose
        per-chunk scale constants cancel. Streamed fits therefore match
        the fused in-memory ascent to float tolerance (tests/test_gp.py).
        Returns (marginal, sweeps)."""
        import tempfile

        dt = self.dtype
        S = self.patterns
        C = -(-S // pattern_chunk)
        Sp = C * pattern_chunk
        tips = np.asarray(self.tips, dt)
        w = np.asarray(self.weights, dt)
        if Sp != S:
            tips = np.concatenate(
                [tips, np.ones((*tips.shape[:-1], Sp - S), dt)], axis=-1
            )
            w = np.concatenate([w, np.zeros(Sp - S, dt)])
        tips_c = np.moveaxis(
            tips.reshape(*tips.shape[:-1], C, pattern_chunk), -2, 0
        )  # (C, L, 4, chunk)
        w_c = w.reshape(C, pattern_chunk)
        E = len(self.e_gpcsp)

        if memmap_dir is not None:
            tmp = tempfile.NamedTemporaryFile(
                dir=memmap_dir, suffix=".gp_ab", delete=False
            )
            AB = np.memmap(tmp.name, dtype=dt, mode="w+", shape=(2, E, Sp))
        else:
            AB = np.empty((2, E, Sp), dt)

        @jax.jit
        def chunk_stats(bl, q, tips_chunk, w_chunk):
            plvs = self._populate_core(bl, q, tips_chunk)
            pa = jnp.asarray(self.e_parent)
            ch = jnp.asarray(self.e_child)
            rot = jnp.asarray(self.e_rot)
            r_plv = jnp.where(
                rot[:, None, None], plvs["rtilde"][pa], plvs["r"][pa]
            )
            p_plv = plvs["p"][ch]
            D = jnp.einsum("eis,eis->es", r_plv, p_plv)
            A = 0.25 * jnp.sum(r_plv, axis=1) * jnp.sum(p_plv, axis=1)
            ri = jnp.asarray(self.root_ids)
            rg = jnp.asarray(self.root_gpcsps)
            root_rows = (
                jnp.log(0.25 * q[rg][:, None] * jnp.sum(plvs["p"][ri], axis=1))
                + plvs["ls_p"][ri][:, None]
            )
            per_site = jax.scipy.special.logsumexp(root_rows, axis=0)
            return A, D - A, jnp.sum(per_site * w_chunk)

        @jax.jit
        def chunk_marginal(bl, q, tips_chunk, w_chunk):
            plvs = self._populate_core(bl, q, tips_chunk)
            ri = jnp.asarray(self.root_ids)
            rg = jnp.asarray(self.root_gpcsps)
            root_rows = (
                jnp.log(0.25 * q[rg][:, None] * jnp.sum(plvs["p"][ri], axis=1))
                + plvs["ls_p"][ri][:, None]
            )
            per_site = jax.scipy.special.logsumexp(root_rows, axis=0)
            return jnp.sum(per_site * w_chunk)

        @jax.jit
        def chunk_phi(u, A, B, w_chunk):
            denom = A + u[:, None] * B
            ratio = jnp.where(denom > 0, B / denom, 0.0)
            phi = jnp.sum(w_chunk[None, :] * ratio, axis=-1)
            dphi = -jnp.sum(w_chunk[None, :] * ratio * ratio, axis=-1)
            return phi, dphi

        @jax.jit
        def chunk_obj(u, A, B, w_chunk):
            lik = A + u[:, None] * B
            return -jnp.sum(
                jnp.where(w_chunk[None, :] > 0, jnp.log(lik), 0.0)
                * w_chunk[None, :],
                axis=-1,
            )

        q = jnp.asarray(self.q, dt)

        def marginal_of(bl_np):
            blj = jnp.asarray(bl_np, dt)
            return float(
                sum(
                    float(chunk_marginal(blj, q, jnp.asarray(tips_c[c]),
                                         jnp.asarray(w_c[c])))
                    for c in range(C)
                )
            )

        def refresh_ab(bl_np):
            blj = jnp.asarray(bl_np, dt)
            total = 0.0
            for c in range(C):
                A, B, m = chunk_stats(
                    blj, q, jnp.asarray(tips_c[c]), jnp.asarray(w_c[c])
                )
                sl = slice(c * pattern_chunk, (c + 1) * pattern_chunk)
                AB[0, :, sl] = np.asarray(A)
                AB[1, :, sl] = np.asarray(B)
                total += float(m)
            return total

        def acc_phi(u):
            phi = np.zeros(E, dt)
            dphi = np.zeros(E, dt)
            uj = jnp.asarray(u, dt)
            for c in range(C):
                sl = slice(c * pattern_chunk, (c + 1) * pattern_chunk)
                p_, d_ = chunk_phi(
                    uj, jnp.asarray(AB[0, :, sl]), jnp.asarray(AB[1, :, sl]),
                    jnp.asarray(w_c[c]),
                )
                phi += np.asarray(p_)
                dphi += np.asarray(d_)
            return phi, dphi

        def acc_obj(u):
            obj = np.zeros(E, dt)
            uj = jnp.asarray(u, dt)
            for c in range(C):
                sl = slice(c * pattern_chunk, (c + 1) * pattern_chunk)
                obj += np.asarray(
                    chunk_obj(
                        uj, jnp.asarray(AB[0, :, sl]),
                        jnp.asarray(AB[1, :, sl]), jnp.asarray(w_c[c]),
                    )
                )
            return obj

        c_jc = 4.0 / 3.0
        u_of = lambda log_bl: np.exp(-c_jc * np.exp(log_bl))  # noqa: E731
        ulo = u_of(MAX_LOG_BL)
        uhi = u_of(MIN_LOG_BL)
        tol_u = 1e-12 if dt == np.float64 else 1e-7

        def newton_sweep(bl_np):
            g = np.asarray(self.e_gpcsp)
            phi_lo, _ = acc_phi(np.full(E, ulo))
            phi_hi, _ = acc_phi(np.full(E, uhi))
            at_max = phi_lo <= 0
            at_min = phi_hi >= 0
            u = np.clip(u_of(np.log(bl_np[g])), ulo, uhi)
            lo = np.full(E, ulo)
            hi = np.full(E, uhi)
            active = ~(at_max | at_min)
            for _ in range(64):
                if not active.any():
                    break
                phi, dphi = acc_phi(u)
                lo = np.where(phi > 0, u, lo)
                hi = np.where(phi < 0, u, hi)
                step = np.where(dphi < 0, phi / np.where(dphi < 0, dphi, 1), 0)
                u_newton = u - step
                inside = (u_newton > lo) & (u_newton < hi)
                u_next = np.where(inside, u_newton, 0.5 * (lo + hi))
                moved = np.abs(u_next - u)
                u = np.where(active, u_next, u)
                active = active & (moved > tol_u * np.maximum(u, tol_u))
            u_best = np.where(at_max, ulo, np.where(at_min, uhi, u))
            best_log = np.clip(
                np.log(-np.log(u_best) / c_jc), MIN_LOG_BL, MAX_LOG_BL
            )
            current_log = np.log(bl_np[g])
            keep = acc_obj(u_of(best_log)) < acc_obj(u_of(current_log))
            new_log = np.where(keep, best_log, current_log)
            out = bl_np.copy()
            out[g] = np.exp(new_log)
            return out

        bl = np.asarray(self.branch_lengths, np.float64)
        cur = refresh_ab(bl)
        sweeps = 0
        for _ in range(max_iter):
            proposed = newton_sweep(bl)
            sweeps += 1
            m = refresh_ab(proposed)
            alpha, trial = 1.0, proposed
            while m < cur and alpha > 1.0 / 64:
                alpha /= 2.0
                trial = np.exp(
                    (1 - alpha) * np.log(np.maximum(bl, 1e-300))
                    + alpha * np.log(np.maximum(proposed, 1e-300))
                )
                m = refresh_ab(trial)
            if m < cur:
                refresh_ab(bl)  # restore A/B for the current bl
                break
            improved_enough = abs(m - cur) >= tol + rtol * abs(cur)
            bl, cur = trial, m
            if not improved_enough:
                break
        self.branch_lengths = bl
        if memmap_dir is not None:
            import os

            del AB
            os.unlink(tmp.name)
        if finalize:
            # Materialize full-width PLVs/rows for downstream consumers;
            # skip (finalize=False) when the arena genuinely exceeds HBM.
            self.populate_plvs()
            self.compute_likelihoods()
        return float(cur), sweeps

    def run_branch_ascent(self, tol: float, max_iter: int, rtol: float = 0.0):
        """Device-resident EstimateBranchLengths; returns (marginal, iters).

        Stops when the per-sweep marginal gain falls below
        ``tol + rtol*|marginal|``. The reference's stopping rule
        (gp_instance.cpp:129-175) is the absolute ``tol`` alone; ``rtol``
        is an extension for near-flat objectives (noise data) where the
        absolute tolerance can be unreachable before ``max_iter`` —
        see ROADMAP.md, findings kept, "GP flat-surface convergence"."""
        if self._ascent_jit is None:
            self._ascent_jit = jax.jit(self._ascent_impl)
        bl, plvs, cur, iters, done = self._ascent_jit(
            jnp.asarray(self.branch_lengths, self.dtype),
            jnp.asarray(self.q, self.dtype),
            jnp.asarray(tol, self.dtype),
            jnp.asarray(max_iter, jnp.int32),
            jnp.asarray(rtol, self.dtype),
        )
        self.branch_lengths = np.asarray(bl)
        self.plvs = plvs
        self.last_ascent_converged = bool(done) or int(iters) < int(max_iter)
        self.compute_likelihoods()
        return float(cur), int(iters)

    # -- branch optimization -------------------------------------------------
    def _optimize_impl(self, plvs, bl):
        """One vectorized derivative-driven sweep over all edges.

        For JC69, r·P(b)·p collapses to A + u·B with u = e^(-4b/3), per-edge
        A = ¼(Σᵢrᵢ)(Σⱼpⱼ) and B = Σᵢrᵢpᵢ − A, so the PLV gathers and the
        (E,4,4) contractions hoist out of the solver loop entirely.

        The per-edge objective f(u) = Σₛ wₛ log(Aₛ + u·Bₛ) is CONCAVE in u
        (sum of logs of affine functions), so its derivative
        φ(u) = Σ w·B/(A+uB) is monotone decreasing and the maximizer is
        either a boundary or the unique root of φ. The sweep solves φ = 0
        with a safeguarded Newton–bisection (bracket maintained by the sign
        of φ; Newton step rejected outside it), terminated by a masked
        convergence test — the analytic-derivative, tolerance-terminated
        analog of the reference's Brent (gp_engine.cpp:244-266, 326-361;
        optimization.hpp:10-115), replacing the earlier fixed-70-iteration
        golden section (which left f32 visibly short of the f64 optimum).
        Reject-if-worse per edge is kept, as in BrentOptimization."""
        pa = jnp.asarray(self.e_parent)
        ch = jnp.asarray(self.e_child)
        rot = jnp.asarray(self.e_rot)
        g = jnp.asarray(self.e_gpcsp)
        r_plv = jnp.where(rot[:, None, None], plvs["rtilde"][pa], plvs["r"][pa])
        p_plv = plvs["p"][ch]
        D = jnp.einsum("eis,eis->es", r_plv, p_plv)
        A = 0.25 * jnp.sum(r_plv, axis=1) * jnp.sum(p_plv, axis=1)
        Bc = D - A
        w = jnp.asarray(self.weights, bl.dtype)
        c_jc = jnp.asarray(4.0 / 3.0, bl.dtype)

        def obj(u):  # (E,) -> (E,) negative log likelihood
            lik = A + u[:, None] * Bc
            return -jnp.sum(jnp.log(lik) * w[None, :], axis=-1)

        def phi_and_dphi(u):  # df/du and d²f/du² per edge
            denom = A + u[:, None] * Bc
            ratio = jnp.where(denom > 0, Bc / denom, 0.0)
            phi = jnp.sum(w[None, :] * ratio, axis=-1)
            dphi = -jnp.sum(w[None, :] * ratio * ratio, axis=-1)
            return phi, dphi

        u_of = lambda log_bl: jnp.exp(-c_jc * jnp.exp(log_bl))  # noqa: E731
        ulo = u_of(jnp.asarray(MAX_LOG_BL, bl.dtype))
        uhi = u_of(jnp.asarray(MIN_LOG_BL, bl.dtype))
        phi_lo, _ = phi_and_dphi(jnp.full_like(g, ulo, dtype=bl.dtype))
        phi_hi, _ = phi_and_dphi(jnp.full_like(g, uhi, dtype=bl.dtype))
        at_max = phi_lo <= 0  # f decreasing everywhere: b at MAX_LOG_BL
        at_min = phi_hi >= 0  # f increasing everywhere: b at MIN_LOG_BL
        interior = ~(at_max | at_min)

        tol_u = jnp.asarray(
            1e-12 if bl.dtype == jnp.float64 else 1e-7, bl.dtype
        )
        u0 = jnp.clip(u_of(jnp.log(bl[g])), ulo, uhi)

        def cond(state):
            _, _, _, active, it = state
            return jnp.any(active) & (it < 64)

        def body(state):
            u, lo, hi, active, it = state
            phi, dphi = phi_and_dphi(u)
            lo = jnp.where(phi > 0, u, lo)  # root is above u where φ>0
            hi = jnp.where(phi < 0, u, hi)
            step = jnp.where(dphi < 0, phi / dphi, 0.0)
            u_newton = u - step
            inside = (u_newton > lo) & (u_newton < hi)
            u_next = jnp.where(inside, u_newton, 0.5 * (lo + hi))
            moved = jnp.abs(u_next - u)
            still = active & (moved > tol_u * jnp.maximum(u, tol_u))
            u = jnp.where(active, u_next, u)
            return u, lo, hi, still, it + 1

        u_root, _, _, _, iters = jax.lax.while_loop(
            cond,
            body,
            (
                u0,
                jnp.full_like(u0, ulo),
                jnp.full_like(u0, uhi),
                interior,
                jnp.asarray(0, jnp.int32),
            ),
        )
        u_best = jnp.where(at_max, ulo, jnp.where(at_min, uhi, u_root))
        best_log = jnp.clip(
            jnp.log(-jnp.log(u_best) / c_jc), MIN_LOG_BL, MAX_LOG_BL
        )
        current_log = jnp.log(bl[g])
        # Reject-if-worse, as in gp_engine.cpp BrentOptimization.
        keep = obj(u_of(best_log)) < obj(u_of(current_log))
        new_log = jnp.where(keep, best_log, current_log)
        return bl.at[g].set(jnp.exp(new_log))

    def optimize_branch_lengths_sweep(self):
        self.branch_lengths = np.asarray(
            self._optimize_jit(
                {k: jnp.asarray(v, self.dtype) for k, v in self.plvs.items()},
                jnp.asarray(self.branch_lengths, self.dtype),
            )
        )

    def log_likelihood_and_derivative(self, parent_id, child_id):
        """Analytic (LL, dLL/db) for one edge (LogLikelihoodAndDerivative)."""
        rot = None
        for (p_, c_, rot_, g_) in self.dag.edge_list():
            if p_ == parent_id and c_ == child_id:
                rot = rot_
                gpcsp = g_
                break
        assert rot is not None
        bl = self.branch_lengths[gpcsp]
        r_plv = (self.plvs["rtilde"] if rot else self.plvs["r"])[parent_id]
        ls_r = (self.plvs["ls_rtilde"] if rot else self.plvs["ls_r"])[parent_id]
        p_plv = self.plvs["p"][child_id]
        ls_p = self.plvs["ls_p"][child_id]
        freqs, evec, ivec, evals = substitution.jc69_eigen()
        P = np.asarray(_jc69_transition(jnp.asarray([bl]))[0])
        Q = np.asarray(substitution.jc69_q())
        dP = Q @ P
        lik = np.einsum("is,ij,js->s", r_plv, P, p_plv)
        dlik = np.einsum("is,ij,js->s", r_plv, dP, p_plv)
        ll = float(np.sum((np.log(lik) + ls_r + ls_p) * self.weights))
        dll = float(np.sum(dlik / lik * self.weights))
        return ll, dll

    # -- SBN parameter estimation --------------------------------------------
    def update_sbn_probabilities(self):
        """q over each sibling range = softmax(per-gpcsp LL + log prior),
        using hybrid marginals when available (UpdateSBNProbabilities)."""
        per_gpcsp = self.get_per_gpcsp_log_likelihoods()
        ranges = []
        seen = set()
        for node_id in self.dag.leafward_pass_traversal():
            node = self.dag.nodes[node_id]
            for subsplit in (node.subsplit, node.subsplit.rotate_subsplit()):
                rng = self.dag.parent_to_range.get(subsplit)
                if rng and rng not in seen:
                    seen.add(rng)
                    ranges.append(rng)
        ranges.append((0, self.dag.rootsplit_count()))
        for start, stop in ranges:
            if stop - start == 1:
                self.q[start] = 1.0
                continue
            hybrid = self.hybrid_marginal_log_likelihoods[start:stop]
            lls = hybrid if np.min(hybrid) > -np.inf else per_gpcsp[start:stop]
            log_post = lls + np.log(self.q[start:stop])
            log_post -= np.max(log_post)
            post = np.exp(log_post)
            self.q[start:stop] = post / post.sum()

    # -- quartet hybrid marginals --------------------------------------------
    def process_quartet_hybrid_request(self, request):
        """Port of CalculateQuartetHybridLikelihoods (gp_engine.cpp:396-460)."""
        if not request.is_fully_formed():
            return
        plvs = self.plvs
        results = []
        bl = self.branch_lengths
        for rootward in request.rootward_tips:
            r_plv = (
                plvs["rtilde"] if rootward.rotated else plvs["r"]
            )[rootward.node_id]
            ls_root = (
                plvs["ls_rtilde"] if rootward.rotated else plvs["ls_r"]
            )[rootward.node_id]
            log_prior = np.log(
                self.unconditional_node_probabilities[rootward.node_id]
            )
            P = np.asarray(_jc69_transition(jnp.asarray([bl[rootward.gpcsp_idx]]))[0])
            quartet_root = P @ r_plv
            for sister in request.sister_tips:
                P = np.asarray(
                    _jc69_transition(jnp.asarray([bl[sister.gpcsp_idx]]))[0]
                )
                r_s = quartet_root * (P @ plvs["p"][sister.node_id])
                P = np.asarray(
                    _jc69_transition(jnp.asarray([bl[request.central_gpcsp_idx]]))[0]
                )
                q_s = P @ r_s
                for rotated_tip in request.rotated_tips:
                    P = np.asarray(
                        _jc69_transition(
                            jnp.asarray([bl[rotated_tip.gpcsp_idx]])
                        )[0]
                    )
                    r_sorted = q_s * (P @ plvs["p"][rotated_tip.node_id])
                    for sorted_tip in request.sorted_tips:
                        non_seq = np.log(
                            self.inverted_sbn_prior[rootward.gpcsp_idx]
                            * self.q[sister.gpcsp_idx]
                            * self.q[rotated_tip.gpcsp_idx]
                            * self.q[sorted_tip.gpcsp_idx]
                        )
                        P = np.asarray(
                            _jc69_transition(
                                jnp.asarray([bl[sorted_tip.gpcsp_idx]])
                            )[0]
                        )
                        per_pattern = np.log(
                            np.einsum(
                                "is,ij,js->s", r_sorted, P,
                                plvs["p"][sorted_tip.node_id],
                            )
                        )
                        # Add back the PLV log-scales dropped by
                        # renormalization (the reference asserts zero
                        # rescaling here instead, gp_engine.cpp:398-400).
                        per_pattern += (
                            ls_root
                            + plvs["ls_p"][sister.node_id]
                            + plvs["ls_p"][rotated_tip.node_id]
                            + plvs["ls_p"][sorted_tip.node_id]
                        )
                        per_pattern -= log_prior
                        results.append(
                            non_seq + float(np.dot(per_pattern, self.weights))
                        )
        from scipy.special import logsumexp

        self.hybrid_marginal_log_likelihoods[request.central_gpcsp_idx] = logsumexp(
            results
        )

    def process_quartet_hybrid_requests(self, requests, chunk: int = 4096):
        """Batched form of process_quartet_hybrid_request: flattens every
        quartet combination (rootward x sister x rotated x sorted) across ALL
        requests into index arrays and evaluates them in one vectorized
        device program per chunk, replacing the reference's 4-level nested
        per-edge loop (gp_engine.cpp:396-460) with (C,4,4)x(C,4,S) einsums
        and a final per-central-edge logsumexp."""
        from scipy.special import logsumexp

        reqs = [r for r in requests if r.is_fully_formed()]
        if not reqs:
            return
        rows = []
        segs = []
        centrals = []
        for seg, req in enumerate(reqs):
            centrals.append(req.central_gpcsp_idx)
            for rw in req.rootward_tips:
                for si in req.sister_tips:
                    for rt in req.rotated_tips:
                        for so in req.sorted_tips:
                            rows.append(
                                (
                                    rw.node_id, int(rw.rotated), rw.gpcsp_idx,
                                    si.node_id, si.gpcsp_idx,
                                    req.central_gpcsp_idx,
                                    rt.node_id, rt.gpcsp_idx,
                                    so.node_id, so.gpcsp_idx,
                                )
                            )
                            segs.append(seg)
        idx = np.asarray(rows, np.int32)
        segs = np.asarray(segs, np.int64)
        C = idx.shape[0]

        if self._hybrid_chunk_jit is None:
            def _chunk(plvs, bl, qv, log_inv_prior, log_node_prob, w, ix):
                (rn, rrot, rg, sn, sg, cg, tn, tg, un, ug) = (
                    ix[:, k] for k in range(10)
                )
                r_plv = jnp.where(
                    rrot[:, None, None].astype(bool),
                    plvs["rtilde"][rn], plvs["r"][rn],
                )
                ls_root = jnp.where(
                    rrot.astype(bool), plvs["ls_rtilde"][rn], plvs["ls_r"][rn]
                )
                quartet_root = _jc69_evolve(bl[rg], r_plv)
                r_s = quartet_root * _jc69_evolve(bl[sg], plvs["p"][sn])
                q_s = _jc69_evolve(bl[cg], r_s)
                r_sorted = q_s * _jc69_evolve(bl[tg], plvs["p"][tn])
                lik = jnp.sum(
                    r_sorted * _jc69_evolve(bl[ug], plvs["p"][un]), axis=1
                )
                # ls_* are per-PLV log-scales; the reference instead asserts
                # zero rescaling here (gp_engine.cpp:398-400).
                per_pattern = (
                    jnp.log(lik)
                    + (
                        ls_root + plvs["ls_p"][sn] + plvs["ls_p"][tn]
                        + plvs["ls_p"][un] - log_node_prob[rn]
                    )[:, None]
                )
                non_seq = (
                    log_inv_prior[rg] + jnp.log(qv[sg]) + jnp.log(qv[tg])
                    + jnp.log(qv[ug])
                )
                return non_seq + per_pattern @ w

            import jax

            self._hybrid_chunk_jit = jax.jit(_chunk)

        plvs = {k: jnp.asarray(v) for k, v in self.plvs.items()}
        bl = jnp.asarray(self.branch_lengths, plvs["p"].dtype)
        qv = jnp.asarray(self.q, plvs["p"].dtype)
        log_inv_prior = jnp.log(
            jnp.asarray(self.inverted_sbn_prior, plvs["p"].dtype)
        )
        log_node_prob = jnp.log(
            jnp.asarray(self.unconditional_node_probabilities, plvs["p"].dtype)
        )
        w = jnp.asarray(self.weights, plvs["p"].dtype)
        vals = np.empty(C)
        for start in range(0, C, chunk):
            ix = idx[start : start + chunk]
            pad = chunk - ix.shape[0] if C > chunk else 0
            if pad:
                ix = np.pad(ix, ((0, pad), (0, 0)))
            out = np.asarray(
                self._hybrid_chunk_jit(
                    plvs, bl, qv, log_inv_prior, log_node_prob, w,
                    jnp.asarray(ix),
                )
            )
            vals[start : start + chunk] = out[: chunk - pad if pad else None]
        for seg, central in enumerate(centrals):
            self.hybrid_marginal_log_likelihoods[central] = logsumexp(
                vals[segs == seg]
            )

    # -- hot start ------------------------------------------------------------
    def hot_start_branch_lengths(self, tree_collection, indexer):
        """Mean observed branch length per PCSP (HotStartBranchLengths)."""
        from ..sbn import maps as sbn_maps

        default_index = self.branch_lengths.size
        totals = np.zeros(self.branch_lengths.size)
        counts = np.zeros(self.branch_lengths.size, dtype=np.int64)
        for tree in tree_collection.trees:
            leaf_count = tree.leaf_count()

            def visit(sister, focal, child0, child1):
                gpcsp_bitset = sbn_maps.pcsp_bitset_of(
                    leaf_count, sister, False, focal, False,
                    child0, False, child1, False,
                )
                idx = indexer.get(gpcsp_bitset, default_index)
                if idx != default_index:
                    totals[idx] += tree.branch_lengths[focal.id]
                    counts[idx] += 1

            sbn_maps.rooted_pcsp_preorder(tree.topology, visit)
        self.branch_lengths = np.where(
            counts == 0, DEFAULT_BRANCH_LENGTH, totals / np.maximum(counts, 1)
        )
