"""The likelihood engine: batched, jitted likelihoods and gradients.

This is the JAX replacement for the reference's Engine + FatBeagle
stack (engine.cpp, fat_beagle.cpp): where the reference fans N BEAGLE
instances over M trees with a thread pool (fat_beagle.hpp:119-149), here the
whole tree collection is ONE vmapped, jitted XLA program; schedules are
traced index arrays, so every topology with the same (taxa, rootedness)
shape reuses one compilation.

Gradient conventions (PhyloGradient parity, tree_gradient.hpp):
  * "branch_lengths": d LL / d b_e over non-root node ids 0..root_id-1. For
    unrooted trees this is the trifurcating layout with 2n-3 real edges; the
    reference's detrifurcated vector additionally carries two structural
    zeros (root + fixed child, fat_beagle.cpp:498-499).
  * "substitution_model": gradient in stick-breaking-unconstrained space,
    rates block then frequencies block (fat_beagle.cpp:440-466) — computed
    by AD through expm_transition's Daleckii-Krein JVP
    (ops/substitution.py), which is exact and stays defined at repeated
    eigenvalues, including the uniform-rates default (JC-like Q) —
    strictly stronger than both plain AD-through-eigh (undefined there)
    and the reference's central finite differences (O(eps^2) error).
  * "site_model": d LL / d Weibull shape (exact, via AD of the discretized
    rates).
  * "ratios_root_height": d (LL + log|Jacobian|) / d (height ratios, root
    height) (rooted_gradient_transforms.cpp) — AD through the height scan.
  * "clock_model": d LL / d clock rate(s).

Path selection follows what the engine can observe. JC69 branch
gradients without per-tree parameters go through ops/pruning_jc.py (the
fused kernel on a GPU in float32, the scan engine otherwise); float32
JC69 rooted gradients take the hand chain rule on top of it. Every other
case runs the scan engine of ops/pruning.py, with AD for the chain rules.
"""

from __future__ import annotations

from typing import Dict

import jax
import jax.numpy as jnp

from ..ops import heights as heights_ops
from ..ops import pruning, pruning_jc, transforms
from ..ops.schedule import BatchedSchedule
from .phylo_model import PhyloModelSpec, model_tensors


class LikelihoodEngine:
    """Likelihoods/gradients for collections of trees over one alignment."""

    def __init__(
        self,
        site_pattern,
        spec: PhyloModelSpec,
        rescale: bool = True,
        dtype=jnp.float64,
        use_tip_states: bool = False,
    ):
        self.spec = spec
        self.rescale = rescale
        self.dtype = dtype
        # Tip-states mode (fat_beagle.cpp:207-256 use_tip_states): keep
        # 1-byte symbol codes resident and expand one-hot/gap partials on
        # the fly inside the jitted programs — 16x less persistent tip
        # memory, identical numerics (the expansion is exact).
        self.use_tip_states = use_tip_states
        if use_tip_states:
            codes, decode = site_pattern.tip_states()
            self._tip_codes = jnp.asarray(codes, jnp.int32)
            self._tip_decode = jnp.asarray(decode, dtype)
            self._tips = None
        else:
            self._tips = jnp.asarray(site_pattern.tip_partials(), dtype=dtype)
        self.weights = jnp.asarray(site_pattern.weights, dtype=dtype)
        # Heights fixed-point lowering for the hand-chain path: "sweeps"
        # (sequential one-hot matvecs) or "squaring" (log-depth affine-map
        # matrix squarings; exact — see ops/heights.py).
        self.heights_method = "sweeps"
        self._jit_cache: Dict = {}

    @property
    def tips(self):
        """(L, 4, patterns) tip partials; in tip-states mode built on the
        fly from the 1-byte codes (traced away inside jit)."""
        if self._tips is not None:
            return self._tips
        return jnp.swapaxes(self._tip_decode[self._tip_codes], 1, 2)

    # -- shared pieces ------------------------------------------------------
    def _model_tensors(self, params):
        """Model tensors cast to the engine dtype (f64 for parity, f32 for
        throughput)."""
        freqs, evec, ivec, evals, rates, props, Q = model_tensors(self.spec, params)
        c = lambda x: x.astype(self.dtype)  # noqa: E731
        return c(freqs), c(evec), c(ivec), c(evals), c(rates), c(props), c(Q)

    def _node_P(self, mt, bl_padded):
        """Node transition matrices (..., N+1, K, 4, 4) from padded branch
        lengths with any leading batch dims.

        GTR differentiates through expm_transition's Daleckii-Krein JVP —
        defined at repeated eigenvalues (the uniform-rates point), where AD
        through eigh is not (ops/substitution.py; contrast the reference's
        finite differences, fat_beagle.cpp:400-465). JC69's eigensystem is
        a constant, so the eigen form is already degenerate-safe there."""
        freqs, evec, ivec, evals, rates, props, Q = mt
        if self.spec.substitution == "GTR":
            from ..ops import substitution

            ts = bl_padded.astype(self.dtype)[..., :, None] * rates[None, :]
            return substitution.expm_transition(Q, freqs, ts)
        return pruning.node_transition_matrices(
            evec, ivec, evals, bl_padded.astype(self.dtype), rates
        )

    def _tree_ll(self, sched5, root_id, bl_padded, params):
        """LL of one tree from padded branch lengths (N+1,)."""
        mt = self._model_tensors(params)
        freqs, props = mt[0], mt[5]
        P = self._node_P(mt, bl_padded)
        return pruning._log_likelihood(
            self.rescale, root_id, sched5, P, self.tips, freqs, props, self.weights,
        )

    @staticmethod
    def _pad(bl):
        """Append the ones-slot zero branch length along the last axis."""
        pad = [(0, 0)] * (bl.ndim - 1) + [(0, 1)]
        return jnp.pad(bl, pad)

    @staticmethod
    def _pad2(bl):
        """Append the root and ones-slot zeros: rooted branch vectors cover
        only the N-1 non-root nodes; the PLV buffers have N+1 slots."""
        pad = [(0, 0)] * (bl.ndim - 1) + [(0, 2)]
        return jnp.pad(bl, pad)

    def _cached(self, key, builder):
        if key not in self._jit_cache:
            self._jit_cache[key] = builder()
        return self._jit_cache[key]

    @staticmethod
    def _sched_dev(sched, name: str):
        """Device-resident copy of a schedule index array, cached ON the
        schedule object (so the cache dies with it — an id()-keyed dict
        would serve stale arrays once Python recycles the address, and
        pinning schedules would leak across VI steps). Repeated calls on
        one schedule then upload its index arrays once instead of once per
        call."""
        cache = getattr(sched, "_dev_cache", None)
        if cache is None:
            cache = {}
            object.__setattr__(sched, "_dev_cache", cache)
        # Key by backend as well: a schedule can outlive a platform switch
        # (a CPU parity engine and a GPU engine sharing one schedule), and
        # the committed arrays of the first backend must not serve the
        # second.
        key = (name, jax.default_backend())
        if key not in cache:
            cache[key] = jnp.asarray(getattr(sched, name))
        return cache[key]

    def _height_iters(self, sched) -> int:
        """Max internal-node depth across the batch: the exact number of
        dense fixed-point sweeps node_heights_from_ratios needs (static —
        schedules are host numpy)."""
        cached = getattr(sched, "_height_iters_cache", None)
        if cached is None:
            import numpy as _np

            pn = _np.asarray(sched.pre_internal_node)
            pp = _np.asarray(sched.pre_internal_parent)
            if pn.ndim == 1:
                pn, pp = pn[None], pp[None]
            cached = 1
            for row_n, row_p in zip(pn, pp):
                depth = _np.zeros(sched.node_count, _np.int32)
                for v, par in zip(row_n, row_p):
                    depth[v] = depth[par] + 1
                cached = max(cached, int(depth.max()))
            object.__setattr__(sched, "_height_iters_cache", cached)
        return cached

    def _sched5_b(self, sched: BatchedSchedule):
        return (
            self._sched_dev(sched, "post_node"),
            self._sched_dev(sched, "post_children"),
            self._sched_dev(sched, "up_node"),
            self._sched_dev(sched, "up_parent"),
            self._sched_dev(sched, "up_sibs"),
        )

    # -- unrooted/plain likelihoods ----------------------------------------
    def log_likelihoods(
        self, sched: BatchedSchedule, branch_lengths, params, per_tree=False
    ):
        """(B,) log likelihoods; branch_lengths: (B, N). With per_tree=True
        every leaf of the params pytree carries a leading tree axis (the
        reference's per-tree parameter matrix rows, fat_beagle.hpp:144)."""
        root_id = sched.root_id

        def build():
            def one(sched5, bl, params):
                return self._tree_ll(sched5, root_id, self._pad(bl), params)

            return jax.jit(
                jax.vmap(
                    one,
                    in_axes=((0, 0, 0, 0, 0), 0, 0 if per_tree else None),
                )
            )

        fn = self._cached(("ll", root_id, per_tree), build)
        return fn(
            self._sched5_b(sched), jnp.asarray(branch_lengths, self.dtype), params
        )

    def branch_gradients(
        self, sched: BatchedSchedule, branch_lengths, params, per_tree=False
    ):
        """(lls (B,), grads (B, N-1)) — the linear-time two-pass scheme.
        per_tree=True: params leaves carry a leading tree axis (the
        reference's per-tree parameter matrix rows, fat_beagle.hpp:144) and
        the whole batch still runs as one vmapped program."""
        root_id = sched.root_id
        if self.spec.substitution == "JC69" and not per_tree:

            def build_jc():
                def fn(post_children, bl, params):
                    mt = self._model_tensors(params)
                    return pruning_jc.log_likelihood_and_branch_gradient_jc69(
                        post_children, self._pad(bl), self.tips,
                        self.weights, root_id=root_id, rates=mt[4],
                        props=mt[5], rescale=self.rescale,
                    )

                return jax.jit(fn)

            fn = self._cached(("bgrad_jc", root_id), build_jc)
            return fn(
                self._sched_dev(sched, "post_children"),
                jnp.asarray(branch_lengths, self.dtype),
                params,
            )

        def build():
            def one(sched5, bl, params):
                mt = self._model_tensors(params)
                freqs, rates, props, Q = mt[0], mt[4], mt[5], mt[6]
                P = self._node_P(mt, self._pad(bl))
                Qs = Q[None] * rates[:, None, None]
                s = pruning.Sched(root_id, sched5[1])
                return pruning.log_likelihood_and_branch_gradient(
                    s, P, Qs, self.tips, freqs, props.astype(self.dtype),
                    self.weights, self.rescale,
                )

            return jax.jit(
                jax.vmap(
                    one, in_axes=((0, 0, 0, 0, 0), 0, 0 if per_tree else None)
                )
            )

        fn = self._cached(("bgrad", root_id, per_tree), build)
        return fn(
            self._sched5_b(sched), jnp.asarray(branch_lengths, self.dtype), params
        )

    def phylo_gradients(
        self, sched: BatchedSchedule, branch_lengths, params, per_tree=False
    ):
        """Gradient dict in reference conventions (unrooted trees)."""
        lls, bgrads = self.branch_gradients(
            sched, branch_lengths, params, per_tree=per_tree
        )
        out = {"log_likelihood": lls, "branch_lengths": bgrads}
        extra = self._model_param_gradients(
            lambda p: self.log_likelihoods(
                sched, branch_lengths, p, per_tree=per_tree
            ),
            params,
            per_tree=per_tree,
        )
        out.update(extra)
        return out

    def _rooted_phylo_gradients_hand(
        self, sched, bounds, ratios, rates, params, strict_clock
    ):
        """JC69 rooted gradients via the hand chain rule: ONE LL+branch-
        gradient pass (pruning_jc: the fused kernel or the scan engine),
        then the BEAST height/ratio recursions
        (rooted_gradient_transforms.cpp:17-162) as dense one-hot sweeps
        (ops/heights.py), instead of AD through the pruning pass and the
        heights tape."""
        leaf_count = sched.leaf_count
        root_id = sched.root_id
        n_height_iters = self._height_iters(sched)

        def build():
            def fn(post_children, pre_node, pre_parent, parent, bounds,
                   ratios, rates, params):
                mt = self._model_tensors(params)
                site_rates, props = mt[4], mt[5]

                method = self.heights_method

                def hfwd(pre_n, pre_p, bounds1, ratios1):
                    return heights_ops.node_heights_from_ratios(
                        ratios1, bounds1, leaf_count, pre_n, pre_p,
                        n_iters=n_height_iters, method=method,
                    )

                h = jax.vmap(hfwd)(pre_node, pre_parent, bounds, ratios)
                bl = jax.vmap(heights_ops.branch_lengths_from_heights)(
                    h, parent
                )
                lls, g_scaled = (
                    pruning_jc.log_likelihood_and_branch_gradient_jc69(
                        post_children, self._pad2(bl * rates),
                        self.tips, self.weights, root_id=root_id,
                        rates=site_rates, props=props, rescale=self.rescale,
                    )
                )

                def back(g1, ratios1, bounds1, rates1, pre_n, pre_p, par, h1):
                    return heights_ops.\
                        ratio_and_rate_gradients_from_branch_gradient(
                            g1, ratios1, bounds1, rates1, leaf_count,
                            pre_n, pre_p, par, n_height_iters, heights=h1,
                            method=method,
                        )

                dratios, drates, _ = jax.vmap(back)(
                    g_scaled[:, : root_id], ratios, bounds, rates,
                    pre_node, pre_parent, parent, h,
                )
                return lls, dratios, drates

            return jax.jit(fn)

        fn = self._cached(
            ("rooted_grad_hand", root_id, n_height_iters,
             self.heights_method),
            build,
        )
        lls, dratios, drates = fn(
            self._sched_dev(sched, "post_children"),
            self._sched_dev(sched, "pre_internal_node"),
            self._sched_dev(sched, "pre_internal_parent"),
            self._sched_dev(sched, "parent"),
            jnp.asarray(bounds, self.dtype),
            jnp.asarray(ratios, self.dtype),
            jnp.asarray(rates, self.dtype),
            params,
        )
        out = {
            "log_likelihood": lls,
            "ratios_root_height": dratios,
            "clock_model": jnp.sum(drates, axis=-1, keepdims=True)
            if strict_clock
            else drates,
        }
        out.update(
            self._model_param_gradients(
                lambda p: self.rooted_log_likelihoods(
                    sched, bounds, ratios, rates, p
                ),
                params,
            )
        )
        return out

    def _model_param_gradients(self, ll_fn, params, per_tree=False):
        """Per-tree substitution/site gradients by AD (stick space for GTR).

        Shared params: jacrev of the (B,) LL vector, rows are per-tree
        gradients w.r.t. the shared parameters. per_tree: trees decouple, so
        grad of the summed LL w.r.t. the stacked (B, ...) parameters IS the
        matrix of per-tree-own-row gradients — still one batched program."""
        out = {}
        row_grad = lambda f, x: (  # noqa: E731
            jax.grad(lambda x_: jnp.sum(f(x_)))(x) if per_tree else jax.jacrev(f)(x)
        )
        if self.spec.substitution == "GTR":
            p = params["substitution"]
            inverse = transforms.stick_breaking_inverse
            forward = transforms.stick_breaking
            if per_tree:
                inverse, forward = jax.vmap(inverse), jax.vmap(forward)
            y_rates = inverse(p["rates"])
            y_freqs = inverse(p["frequencies"])

            def f(y):
                yr, yf = y[..., :5], y[..., 5:]
                new = dict(params)
                new["substitution"] = {
                    "rates": forward(yr),
                    "frequencies": forward(yf),
                }
                return ll_fn(new)

            out["substitution_model"] = row_grad(
                f, jnp.concatenate([y_rates, y_freqs], axis=-1)
            )
        if self.spec.site.startswith("weibull"):

            def g(shape):
                new = dict(params)
                new["site"] = {"shape": shape}
                return ll_fn(new)

            out["site_model"] = row_grad(g, params["site"]["shape"])
        return out

    # -- rooted time-tree likelihoods --------------------------------------
    def rooted_log_likelihoods(
        self, sched: BatchedSchedule, bounds, ratios, rates, params,
        return_parts: bool = False, per_tree: bool = False,
    ):
        """LL + log-det-Jacobian for rooted time trees (fat_beagle.cpp:96-104).

        bounds: (B, N) node bounds; ratios: (B, L-1) height ratios with root
        height last; rates: (B, N-1) per-branch clock rates. per_tree=True:
        params leaves carry a leading tree axis (heterogeneous parameter
        matrix rows) — one vmapped program, not a per-tree loop."""
        leaf_count = sched.leaf_count
        root_id = sched.root_id
        n_height_iters = self._height_iters(sched)

        def build():
            def one(
                sched5, pre_node, pre_parent, parent, bounds, ratios,
                rates, params,
            ):
                h = heights_ops.node_heights_from_ratios(
                    ratios, bounds, leaf_count, pre_node, pre_parent,
                    n_iters=n_height_iters,
                )
                bl = heights_ops.branch_lengths_from_heights(h, parent)
                ll = self._tree_ll(sched5, root_id, self._pad2(bl * rates), params)
                ldj = heights_ops.log_det_jacobian(h, bounds, parent, leaf_count)
                return ll, ldj

            return jax.jit(
                jax.vmap(
                    one,
                    in_axes=(
                        (0, 0, 0, 0, 0), 0, 0, 0, 0, 0, 0,
                        0 if per_tree else None,
                    ),
                )
            )

        fn = self._cached(("rooted_ll", root_id, per_tree, n_height_iters), build)
        lls, ldjs = fn(
            self._sched5_b(sched),
            jnp.asarray(sched.pre_internal_node),
            jnp.asarray(sched.pre_internal_parent),
            jnp.asarray(sched.parent),
            jnp.asarray(bounds, self.dtype),
            jnp.asarray(ratios, self.dtype),
            jnp.asarray(rates, self.dtype),
            params,
        )
        if return_parts:
            return lls, ldjs
        return lls + ldjs

    def rooted_phylo_gradients(
        self, sched: BatchedSchedule, bounds, ratios, rates, params,
        strict_clock: bool = True, per_tree: bool = False,
    ):
        """Gradient dict for rooted time trees: the hand chain rule for
        float32 JC69 without per-tree parameters, AD otherwise (f64 parity
        engines included)."""
        if (
            self.spec.substitution == "JC69"
            and not per_tree
            and jnp.dtype(self.dtype) == jnp.dtype(jnp.float32)
        ):
            return self._rooted_phylo_gradients_hand(
                sched, bounds, ratios, rates, params, strict_clock
            )
        return self._rooted_phylo_gradients_ad(
            sched, bounds, ratios, rates, params, strict_clock, per_tree
        )

    def _rooted_phylo_gradients_ad(
        self, sched, bounds, ratios, rates, params, strict_clock, per_tree
    ):
        """Rooted gradient dict by AD through the scan engine and the
        heights transform."""
        leaf_count = sched.leaf_count
        root_id = sched.root_id
        n_height_iters = self._height_iters(sched)

        def build():
            def one(
                sched5, pre_node, pre_parent, parent, bounds, ratios,
                rates, params,
            ):
                def objective(ratios_, rates_, params_):
                    h = heights_ops.node_heights_from_ratios(
                        ratios_, bounds, leaf_count, pre_node, pre_parent,
                        n_iters=n_height_iters,
                    )
                    bl = heights_ops.branch_lengths_from_heights(h, parent)
                    ll = self._tree_ll(
                        sched5, root_id, self._pad2(bl * rates_), params_
                    )
                    ldj = heights_ops.log_det_jacobian(
                        h, bounds, parent, leaf_count
                    )
                    return ll + ldj, ll

                (obj, ll), (dratios, drates) = jax.value_and_grad(
                    objective, argnums=(0, 1), has_aux=True
                )(ratios, rates, params)
                # Clock gradient excludes the Jacobian term (it does not
                # depend on the rates), and equals AD of ll wrt rates since
                # d ldj/d rates = 0.
                return obj, ll, dratios, drates

            return jax.jit(
                jax.vmap(
                    one,
                    in_axes=(
                        (0, 0, 0, 0, 0), 0, 0, 0, 0, 0, 0,
                        0 if per_tree else None,
                    ),
                )
            )

        fn = self._cached(("rooted_grad", root_id, per_tree, n_height_iters), build)
        obj, lls, dratios, drates = fn(
            self._sched5_b(sched),
            jnp.asarray(sched.pre_internal_node),
            jnp.asarray(sched.pre_internal_parent),
            jnp.asarray(sched.parent),
            jnp.asarray(bounds, self.dtype),
            jnp.asarray(ratios, self.dtype),
            jnp.asarray(rates, self.dtype),
            params,
        )
        # Reference convention: the gradient result reports the pruning LL
        # WITHOUT the Jacobian (rooted_sbn_instance.hpp gradient tests),
        # while LogLikelihoods() reports LL + log|J|.
        out = {
            "log_likelihood": lls,
            "ratios_root_height": dratios,
            "clock_model": jnp.sum(drates, axis=-1, keepdims=True)
            if strict_clock
            else drates,
        }
        extra = self._model_param_gradients(
            lambda p: self.rooted_log_likelihoods(
                sched, bounds, ratios, rates, p, per_tree=per_tree
            ),
            params,
            per_tree=per_tree,
        )
        out.update(extra)
        return out
