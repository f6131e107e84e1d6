"""Device-resident VBPI training step: the whole gradient step as ONE jitted
XLA program, shardable over a device mesh.

This is the production fast path corresponding to Burrito.gradient_step
(burrito.py:84-117): the host samples topologies (combinatorial) and standard
normals; everything else — reparameterized branch sampling, batched pruning
likelihood + linear-time branch gradients, eq:dLdPsi scalar gradients, VIMCO
topology gradients, and the optax update — runs on device. Under a Mesh, the
particle axis shards data-parallel ("dp") and XLA inserts the gradient psums
(SURVEY.md §2.9).

Branch models: split-lognormal (one variable per split, the benchmark
default) and PSP (three summed component variables per branch, ICLR 2019),
selected with ``branch_model=`` — both run the same jitted program with
C = 1 or 3 component rows in branch_rep.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import optax

from ..ops import pruning, pruning_jc, substitution
from ..sbn import gradients as sbn_gradients
from ..sbn import probability as sbn_probability

PRIOR_RATE = 10.0


class VBPIState(NamedTuple):
    q_params: jnp.ndarray  # (V, 2) lognormal (mu, sigma) per split
    sbn_params: jnp.ndarray  # (G,)
    opt_state: optax.OptState


class VBPIStatics(NamedTuple):
    """Static (shape-defining) configuration for one support."""

    root_id: int
    num_segments: int
    rescale: bool
    use_vimco: bool
    # PSP branch model: branch_rep carries 3 component rows per branch whose
    # lognormal parameters sum (ICLR 2019); the last q_params row is the
    # zeroed sentinel for absent components (branch_models.py PSPModel).
    psp: bool = False
    # False keeps the pruning pass on the scan engine (JitVBPI sets it when
    # a mesh splits the particle batch); ops/pruning_jc.py chooses.
    allow_kernel: bool = True


def make_optimizer(scalar_lr=1e-3, sbn_lr=1e-3):
    return optax.multi_transform(
        {
            "q_params": optax.adam(scalar_lr),
            "sbn_params": optax.adam(sbn_lr),
        },
        ("q_params", "sbn_params"),
    )


def init_state(q_params, sbn_params, optimizer) -> VBPIState:
    q_params = jnp.asarray(q_params)
    sbn_params = jnp.asarray(sbn_params)
    opt_state = optimizer.init((q_params, sbn_params))
    return VBPIState(q_params, sbn_params, opt_state)


@functools.partial(
    jax.jit,
    static_argnames=("statics", "optimizer"),
)
def vbpi_train_step(
    state: VBPIState,
    statics: VBPIStatics,
    optimizer,
    # Per-step host-sampled inputs:
    sched5,  # tuple of 5 (P, ...) int32 schedule arrays
    branch_rep,  # (P, C, B) int32 variable indices per branch (C=1 split, 3 psp)
    reps,  # (P, E, R) int32 unrooted indexer representations
    touched,  # (P, E, Sm) int32 touched segments
    eps,  # (P, B) standard normals
    beta,  # annealing scalar
    # Constant model data:
    tips,  # (L, 4, patterns)
    weights,  # (patterns,)
    segment_ids,  # (G,)
):
    """One full VBPI gradient step. Returns (new_state, metrics)."""
    q_params, sbn_params, opt_state = state
    P_count, C, B = branch_rep.shape

    # 1. Reparameterized branch lengths: theta = exp(mu + sigma * eps),
    # (mu, sigma) summed over the branch's C component variables (for the
    # split model C = 1; for PSP the zeroed sentinel row absorbs absent
    # components).
    mu = q_params[branch_rep, 0].sum(axis=1)  # (P, B)
    sigma = q_params[branch_rep, 1].sum(axis=1)
    theta = jnp.exp(mu + sigma * eps)  # (P, B)

    # 2. Batched pruning: likelihoods + linear-time branch gradients. The
    # VBPI model is JC69 + constant sites by construction (JitVBPI).
    bl_padded = jnp.pad(theta, ((0, 0), (0, 2)))  # root + ones slots
    lls, bgrads = pruning_jc.log_likelihood_and_branch_gradient_jc69(
        sched5[1], bl_padded, tips, weights, root_id=statics.root_id,
        rescale=statics.rescale, allow_kernel=statics.allow_kernel,
    )

    # 3. Scalar lognormal gradient, eq:dLdPsi: each branch's per-occurrence
    # contribution scatters onto all C of its component variables
    # (branch_models.py scalar_grad).
    dlogp = bgrads - PRIOR_RATE  # + d log prior / d theta
    g0 = dlogp * theta - (-1.0)
    g1 = dlogp * theta * eps - (-eps - 1.0 / sigma)
    V = q_params.shape[0]
    occ = jnp.broadcast_to(branch_rep, (P_count, C, B)).reshape(-1)
    g0_occ = jnp.broadcast_to(g0[:, None, :], (P_count, C, B)).reshape(-1)
    g1_occ = jnp.broadcast_to(g1[:, None, :], (P_count, C, B)).reshape(-1)
    scalar_grad = (
        jnp.zeros((V, 2), q_params.dtype)
        .at[occ, 0].add(g0_occ)
        .at[occ, 1].add(g1_occ)
    )
    if statics.psp:
        # The sentinel (last) row stays zero (branch_models.py:200).
        scalar_grad = scalar_grad.at[V - 1].set(0.0)

    # 4. log f = beta*loglike + log prior - log q_sbn - log q_branch.
    log_prior = B * jnp.log(PRIOR_RATE) - PRIOR_RATE * jnp.sum(theta, axis=1)
    normalized = sbn_probability.probability_normalize_in_log(
        sbn_params, segment_ids, statics.num_segments
    )
    ext = sbn_probability.with_sentinel(normalized)
    log_rho = jnp.sum(ext[reps], axis=-1)  # (P, E)
    log_q_sbn = jax.scipy.special.logsumexp(log_rho, axis=-1)
    log_q_branch = jnp.sum(
        -jnp.log(theta) - jnp.log(sigma) - 0.5 * jnp.log(2.0 * jnp.pi)
        - (jnp.log(theta) - mu) ** 2 / (2.0 * sigma**2),
        axis=1,
    )
    log_f = beta * lls + log_prior - log_q_sbn - log_q_branch

    # 5. VIMCO topology gradient.
    sbn_grad = sbn_gradients.topology_gradients(
        sbn_params, segment_ids, statics.num_segments, reps, touched, log_f,
        use_vimco=statics.use_vimco,
    )

    # 6. Ascent step (optax minimizes, so negate).
    grads = (-scalar_grad, -sbn_grad)
    updates, opt_state = optimizer.update(grads, opt_state, (q_params, sbn_params))
    q_params, sbn_params = optax.apply_updates((q_params, sbn_params), updates)

    metrics = {
        "mean_ll": jnp.mean(lls),
        "elbo_like": jnp.mean(log_f),
    }
    return VBPIState(q_params, sbn_params, opt_state), metrics


@functools.partial(
    jax.jit,
    static_argnames=("statics", "optimizer", "shapes"),
)
def vbpi_train_step_packed(
    state, statics, optimizer,
    packed,  # (P, K) int32: the 8 schedule/representation arrays, flattened
    eps, beta, shapes,  # static tuple of per-array trailing shapes
    tips, weights, segment_ids,
):
    """vbpi_train_step with the int32 inputs packed into ONE buffer: two
    host-to-device transfers per step (ints + eps) instead of nine.
    Unpacking is free inside XLA (static slices/reshapes)."""
    arrays = []
    offset = 0
    for shp in shapes:
        n = 1
        for d in shp:
            n *= d
        arrays.append(
            packed[:, offset : offset + n].reshape((packed.shape[0],) + shp)
        )
        offset += n
    sched5 = tuple(arrays[:5])
    branch_rep, reps, touched = arrays[5], arrays[6], arrays[7]
    return vbpi_train_step(
        state, statics, optimizer, sched5, branch_rep, reps, touched, eps,
        beta, tips, weights, segment_ids,
    )


@functools.partial(jax.jit, static_argnames=("statics", "shapes"))
def vbpi_log_f_packed(
    state, statics, packed, eps, shapes,
    tips, weights, segment_ids,
):
    """Per-particle log f = loglike + log prior - log q_sbn - log q_branch
    at beta = 1, with NO parameter update — the evaluation half of
    vbpi_train_step, for ELBO / importance-sampled marginal estimates
    (Burrito.estimate_elbo / marginal_likelihood_estimate analogs,
    vip burrito.py:127-183)."""
    arrays = []
    offset = 0
    for shp in shapes:
        n = 1
        for d in shp:
            n *= d
        arrays.append(
            packed[:, offset : offset + n].reshape((packed.shape[0],) + shp)
        )
        offset += n
    sched5 = tuple(arrays[:5])
    branch_rep, reps, touched = arrays[5], arrays[6], arrays[7]
    del touched
    q_params, sbn_params, _ = state
    P_count, C, B = branch_rep.shape

    mu = q_params[branch_rep, 0].sum(axis=1)
    sigma = q_params[branch_rep, 1].sum(axis=1)
    theta = jnp.exp(mu + sigma * eps)
    bl_padded = jnp.pad(theta, ((0, 0), (0, 2)))
    freqs, evec, ivec, evals = substitution.jc69_eigen(theta.dtype)
    ones = jnp.ones((1,), theta.dtype)  # one rate category, weight 1

    def one(sched5_one, bl):
        Pm = pruning.node_transition_matrices(evec, ivec, evals, bl, ones)
        return pruning._log_likelihood(
            statics.rescale, statics.root_id, sched5_one, Pm, tips, freqs,
            ones, weights,
        )

    lls = jax.vmap(one, in_axes=((0, 0, 0, 0, 0), 0))(sched5, bl_padded)

    log_prior = B * jnp.log(PRIOR_RATE) - PRIOR_RATE * jnp.sum(theta, axis=1)
    normalized = sbn_probability.probability_normalize_in_log(
        sbn_params, segment_ids, statics.num_segments
    )
    ext = sbn_probability.with_sentinel(normalized)
    log_rho = jnp.sum(ext[reps], axis=-1)
    log_q_sbn = jax.scipy.special.logsumexp(log_rho, axis=-1)
    log_q_branch = jnp.sum(
        -jnp.log(theta) - jnp.log(sigma) - 0.5 * jnp.log(2.0 * jnp.pi)
        - (jnp.log(theta) - mu) ** 2 / (2.0 * sigma**2),
        axis=1,
    )
    return lls + log_prior - log_q_sbn - log_q_branch


@functools.partial(
    jax.jit,
    static_argnames=("statics", "optimizer", "shapes"),
)
def vbpi_train_steps_packed(
    state, statics, optimizer,
    packed_k,  # (K, P, W) int32
    eps_k,  # (K, P, B)
    betas,  # (K,)
    shapes,
    tips, weights, segment_ids,
):
    """K training steps in ONE dispatch (lax.scan over steps). Topologies
    for all K steps were sampled from the SBN as of the dispatch — within
    the window the sampler is up to K-1 updates stale, which the MC
    gradient tolerates; branch sampling and all updates use live params."""

    def body(state, xs):
        packed, eps, beta = xs
        new_state, metrics = vbpi_train_step_packed(
            state, statics, optimizer, packed, eps, beta, shapes,
            tips, weights, segment_ids,
        )
        return new_state, metrics

    state, metrics = jax.lax.scan(body, state, (packed_k, eps_k, betas))
    return state, metrics


class JitVBPI:
    """Host driver around vbpi_train_step for an UnrootedInstance with a
    split-lognormal or PSP branch model. Optionally shards the particle axis
    over a mesh ("dp") with replicated model constants.

    Multi-host: pass a GLOBAL mesh (parallel.distributed.global_mesh) from
    every process; particle_count is the global batch, each process samples
    its particle_count / process_count local rows and the step assembles
    them into one dp-sharded global array
    (jax.make_array_from_process_local_data). Gradients allreduce through
    XLA's inserted psums.

    The pruning pass runs the fused JC69 kernel where
    pruning_jc.use_kernel(dtype) holds and no mesh shards the batch, and
    the scan engine otherwise."""

    def __init__(self, inst, particle_count: int, mesh=None, use_vimco=True,
                 scalar_lr=1e-3, sbn_lr=1e-3, dtype=None, seed=0, rescale=True,
                 branch_model: str = "split"):
        import numpy as np

        self.inst = inst
        self.particle_count = particle_count
        self.local_particle_count = particle_count
        if jax.process_count() > 1:
            assert mesh is not None, "multi-host runs need a global mesh"
            assert particle_count % jax.process_count() == 0
            self.local_particle_count = particle_count // jax.process_count()
        self.mesh = mesh
        # Decorrelate per-host sampling streams.
        self.rng = np.random.default_rng(seed + 7919 * jax.process_index())
        self._artifact_cache = {}
        dtype = dtype or jnp.float64
        self.dtype = dtype

        segment_ids = inst.sbn_support.segment_ids()
        self.segment_ids = jnp.asarray(segment_ids)
        num_segments = int(segment_ids.max(initial=0)) + 1
        sp = inst.engine
        self.tips = sp.tips.astype(dtype)
        self.weights = sp.weights.astype(dtype)

        assert branch_model in ("split", "psp")
        self.branch_model = branch_model
        details = inst.psp_indexer.details()
        if branch_model == "split":
            V = details["after_rootsplits_index"]
            q0 = np.full((V, 2), [-2.0, 0.5])
        else:
            # PSP: one variable per rootsplit/down/up component plus the
            # zeroed sentinel row (branch_models.py PSPModel).
            V = details["first_empty_index"] + 1
            q0 = np.full((V, 2), [-2.0 / 3.0, 0.5 / 3.0])
            q0[-1] = 0.0
        self.optimizer = make_optimizer(scalar_lr, sbn_lr)
        self.state = init_state(
            jnp.asarray(q0, dtype), jnp.asarray(inst.sbn_parameters, dtype),
            self.optimizer,
        )
        self.statics = VBPIStatics(
            root_id=2 * inst.sbn_support.taxon_count() - 3,
            num_segments=num_segments,
            rescale=rescale,
            use_vimco=use_vimco,
            psp=(branch_model == "psp"),
            allow_kernel=mesh is None,
        )

    def mode_match(self, split_modes):
        """Mode-matched lognormal initialization from per-split branch-length
        modes (scalar_model.py:95-101 / branch_model.py PSPModel.mode_match),
        e.g. the last MCMC sample's split lengths (benchmark.py:61). Resets
        the optimizer state."""
        import numpy as np

        split_modes = np.asarray(split_modes)
        q = np.zeros(np.asarray(self.state.q_params).shape)
        log_modes = np.log(np.clip(split_modes, 1e-6, None))
        biclipped = np.log(np.clip(split_modes, 1e-6, 1 - 1e-6))
        n_split = split_modes.size
        if self.branch_model == "split":
            assert n_split == q.shape[0]
        q[:n_split, 1] = -0.1 * biclipped
        q[:n_split, 0] = np.square(q[:n_split, 1]) + log_modes
        if self.branch_model == "psp":
            q[-1] = 0.0  # sentinel row
        self.state = init_state(
            jnp.asarray(q, self.dtype), self.state.sbn_params, self.optimizer
        )

    def _topology_artifacts(self, key, top=None):
        """Per-topology dense artifacts, cached: sampled topologies repeat
        heavily once the SBN concentrates, so the lowering (schedule rows,
        indexer representations, touched segments) is paid once per distinct
        topology. Returns the 8-tuple (post_node, post_children, up_node,
        up_parent, up_sibs, branch_rep, rep, touched) of per-tree arrays.

        ``key`` is either the Topology itself (Python-sampler path) or the
        tuple of its canonical parent-id vector. On the tuple path with the
        native core available, the whole miss is C++-side (schedule builder
        + indexer representations) and never constructs a Python Topology;
        branch_rep falls out as rep[:, 0] (the PSP rootsplit row equals the
        split-index column by construction, psp_indexer.cpp:31-48)."""
        import numpy as np

        from ..core.topology import Topology
        from ..io import native
        from ..ops import schedule as schedule_ops
        from ..sbn import gradients as sbn_gradients_mod

        cached = self._artifact_cache.get(key)
        if cached is not None:
            return cached
        support = self.inst.sbn_support
        psp = self.statics.psp
        rep = None
        if top is None and not isinstance(key, Topology):
            pv = np.asarray(key, dtype=np.int32)
            reps = support.dense_representations_of_parent_vectors(pv[None])
            sched_dict = native.build_schedules(
                pv[None], support.taxon_count()
            )
            branch_rep = None
            if reps is not None and sched_dict is not None:
                if psp:
                    # Native PSP rows (lsbn_psp_representations).
                    prep = self.inst.psp_indexer.\
                        dense_representations_of_parent_vectors(pv[None])
                    if prep is not None:
                        branch_rep = np.ascontiguousarray(prep[0])
                else:
                    branch_rep = np.ascontiguousarray(reps[0][None, :, 0])
            if branch_rep is not None:
                rep = reps[0]
                sched5_one = (
                    sched_dict["post_node"][0], sched_dict["post_children"][0],
                    sched_dict["up_node"][0], sched_dict["up_parent"][0],
                    sched_dict["up_sibs"][0],
                )
        if rep is None:
            if top is None:
                top = key if isinstance(key, Topology) else (
                    Topology.of_parent_id_vector(list(key))
                )
            sched = schedule_ops.schedule_of_topology(top)
            sched5_one = (
                sched.post_node, sched.post_children, sched.up_node,
                sched.up_parent, sched.up_sibs,
            )
            psp_rep = np.asarray(
                self.inst.psp_indexer.representation_of(top),
                dtype=np.int32,
            )  # (3, B)
            branch_rep = psp_rep if psp else psp_rep[:1]
            rep = support.dense_representations([top])[0]
        touched = sbn_gradients_mod.touched_segments_of(
            support, rep[None], pad_to=4 * support.taxon_count()
        )[0]
        artifacts = sched5_one + (branch_rep, rep, touched)
        self._artifact_cache[key] = artifacts
        return artifacts

    def _get_native_sampler(self):
        if not hasattr(self, "_native_sampler"):
            from ..sbn.sampling import NativeSBNSampler

            self._native_sampler = NativeSBNSampler(
                self.inst.sbn_support, self.state.sbn_params,
                seed=int(self.rng.integers(2**31)),
            )
        return self._native_sampler

    def _host_sample(self, count=None):
        """Sample topologies and lower them to dense step inputs (from the
        CURRENT device state; blocks until it is available)."""
        import numpy as np

        return self._host_sample_from(
            np.asarray(self.state.sbn_params), count
        )

    def _host_sample_from(self, sbn_params_np, count=None):
        """Sample topologies from an explicit host-side SBN parameter
        vector — the overlap path feeds the last COMPLETED step's
        parameters here so sampling never waits on the in-flight step."""
        import numpy as np

        count = self.local_particle_count if count is None else count
        # Refresh the sampler. Prefer the native bulk sampler: it emits
        # canonical parent-id vectors that key the artifact cache directly
        # (sbn/sampling.py NativeSBNSampler).
        self.inst.sbn_parameters = np.asarray(sbn_params_np)
        native_sampler = self._get_native_sampler()
        native_sampler.refresh_parameters(self.inst.sbn_parameters)
        pvs = native_sampler.sample_parent_vectors(count, rooted=False)
        if pvs is not None:
            artifacts = [
                self._topology_artifacts(tuple(map(int, row))) for row in pvs
            ]
        else:
            self.inst._sampler = None
            sampler = self.inst._get_sampler()
            tops = [
                sampler.sample_topology(rooted=False) for _ in range(count)
            ]
            artifacts = [self._topology_artifacts(t) for t in tops]
        stacked = [np.stack(column) for column in zip(*artifacts)]
        sched5 = tuple(stacked[:5])
        branch_rep, reps, touched = stacked[5], stacked[6], stacked[7]
        eps = self.rng.standard_normal(
            (branch_rep.shape[0], branch_rep.shape[-1])
        )
        return sched5, branch_rep, reps, touched, eps

    def _device_put(self, sched5, branch_rep, reps, touched, eps):
        """Pack the 8 int32 arrays into one (P, K) buffer + eps: two
        transfers per step instead of nine (vbpi_train_step_packed)."""
        import numpy as np

        ints = sched5 + (branch_rep, reps, touched)
        shapes = tuple(a.shape[1:] for a in ints)
        P = ints[0].shape[0]
        packed = np.concatenate(
            [np.ascontiguousarray(a, dtype=np.int32).reshape(P, -1)
             for a in ints],
            axis=1,
        )
        eps = np.asarray(eps.astype(self.dtype))
        if self.mesh is not None:
            from ..parallel.distributed import from_process_local
            from ..parallel.sharding import particle_sharding

            sh = particle_sharding(self.mesh)
            packed = from_process_local(sh, packed, self.particle_count)
            eps = from_process_local(sh, eps, self.particle_count)
        else:
            packed = jnp.asarray(packed)
            eps = jnp.asarray(eps)
        return packed, eps, shapes

    def step_many(self, n_steps: int, beta=1.0):
        """n_steps gradient steps in ONE device dispatch.

        At small particle counts the per-step dispatch and host sync can
        dominate; this queues K steps as a device-side lax.scan. Topologies
        for the whole window are sampled from the SBN as of dispatch (up
        to K-1 updates stale; branch sampling and all parameter updates
        stay live). beta may be a scalar or a (K,)
        annealing schedule. Returns metrics stacked over steps ((K,)
        arrays). Single-host only."""
        import numpy as np

        assert jax.process_count() == 1, "step_many is single-host"
        # A batch pre-sampled by step_overlapped would be arbitrarily stale
        # by the time a later step_overlapped call consumed it; drop it so
        # staleness stays bounded at one dispatch.
        self._pending_sample = None
        K, P = int(n_steps), self.local_particle_count
        self.inst.sbn_parameters = np.asarray(self.state.sbn_params)
        native_sampler = self._get_native_sampler()
        native_sampler.refresh_parameters(self.inst.sbn_parameters)
        pvs = native_sampler.sample_parent_vectors(K * P, rooted=False)
        if pvs is not None:
            artifacts = [
                self._topology_artifacts(tuple(map(int, row))) for row in pvs
            ]
        else:
            self.inst._sampler = None
            sampler = self.inst._get_sampler()
            artifacts = [
                self._topology_artifacts(sampler.sample_topology(rooted=False))
                for _ in range(K * P)
            ]
        stacked = [np.stack(column) for column in zip(*artifacts)]
        ints = tuple(stacked[:8])
        shapes = tuple(a.shape[1:] for a in ints)
        packed = np.concatenate(
            [np.ascontiguousarray(a, dtype=np.int32).reshape(K * P, -1)
             for a in ints],
            axis=1,
        )
        packed_k = packed.reshape(K, P, packed.shape[1])
        n_branches = stacked[5].shape[-1]
        eps_k = self.rng.standard_normal((K, P, n_branches)).astype(self.dtype)
        betas = np.broadcast_to(
            np.asarray(beta, dtype=self.dtype), (K,)
        ).astype(self.dtype)
        if self.mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as Pspec

            sh = NamedSharding(self.mesh, Pspec(None, "dp"))
            packed_k = jax.device_put(packed_k, sh)
            eps_k = jax.device_put(eps_k, sh)
        self.state, metrics = vbpi_train_steps_packed(
            self.state, self.statics, self.optimizer,
            jnp.asarray(packed_k), jnp.asarray(eps_k), jnp.asarray(betas),
            shapes, self.tips, self.weights, self.segment_ids,
        )
        try:
            self.state.sbn_params.copy_to_host_async()
        except AttributeError:  # pragma: no cover
            pass
        return metrics

    def step_overlapped(self, beta: float = 1.0):
        """One gradient step with host sampling overlapped against the
        in-flight device step (double buffering).

        step() is strictly alternating — sample, dispatch, (implicitly)
        wait — so the host sampling cost sits on the critical path (under
        multi-device dp it becomes the Amdahl ceiling). Here batch t+1 is
        lowered on the host WHILE the device runs step t, so its topologies
        come from the parameters of step t-1: one dispatch of staleness,
        strictly less than the up-to-K-1 staleness step_many already gates
        (tail-mean ELBO gap an order inside the between-seed MC spread;
        ROADMAP.md, findings kept, "step_many staleness"). The first call
        primes the pipeline synchronously, so
        call #1 is bit-identical to step(). The reference has no analog
        (single-process alternating loop, burrito.py:84-117). Single-host.
        """
        import numpy as np

        assert jax.process_count() == 1, "step_overlapped is single-host"
        if getattr(self, "_pending_sample", None) is None:
            self._pending_sample = self._host_sample()  # pipeline fill
        sched5, branch_rep, reps, touched, eps = self._pending_sample
        packed, eps_d, shapes = self._device_put(
            sched5, branch_rep, reps, touched, eps
        )
        prev_params = self.state.sbn_params  # completed (or completing)
        self.state, metrics = vbpi_train_step_packed(
            self.state, self.statics, self.optimizer,
            packed, eps_d, jnp.asarray(beta, self.dtype), shapes,
            self.tips, self.weights, self.segment_ids,
        )
        try:
            self.state.sbn_params.copy_to_host_async()
        except AttributeError:  # pragma: no cover
            pass
        # Overlap: lower the NEXT batch from the last completed step's
        # parameters while the device runs this one. np.asarray(prev) is a
        # local fetch — its device->host copy was started last call.
        self._pending_sample = self._host_sample_from(
            np.asarray(prev_params)
        )
        return metrics

    def step(self, beta: float = 1.0):
        self._pending_sample = None  # see step_many: bound overlap staleness
        sched5, branch_rep, reps, touched, eps = self._host_sample()
        packed, eps, shapes = self._device_put(
            sched5, branch_rep, reps, touched, eps
        )
        self.state, metrics = vbpi_train_step_packed(
            self.state, self.statics, self.optimizer,
            packed, eps, jnp.asarray(beta, self.dtype), shapes,
            self.tips, self.weights, self.segment_ids,
        )
        # Warm the next step's host-side parameter read: the sampler needs
        # sbn_params on host, so start the device->host copy now instead
        # of blocking on it at the next sample.
        try:
            self.state.sbn_params.copy_to_host_async()
        except AttributeError:  # pragma: no cover - backend without async copy
            pass
        return metrics

    def log_f_values(self, particle_count: int):
        """(particle_count,) per-particle log f at the current parameters
        (no update)."""
        import numpy as np

        sched5, branch_rep, reps, touched, eps = self._host_sample(
            count=particle_count
        )
        packed, eps, shapes = self._device_put(
            sched5, branch_rep, reps, touched, eps
        )
        return np.asarray(
            vbpi_log_f_packed(
                self.state, self.statics, packed, eps, shapes,
                self.tips, self.weights, self.segment_ids,
            )
        )

    def estimate_elbo(self, particle_count: int) -> float:
        """Naive Monte Carlo ELBO (Burrito.estimate_elbo analog)."""
        return float(self.log_f_values(particle_count).mean())

    def marginal_likelihood_estimate(self, particle_count: int) -> float:
        """Importance-sampling marginal log likelihood: logsumexp(log f)
        - log n (Burrito.marginal_likelihood_estimate analog)."""
        import numpy as np
        from scipy.special import logsumexp

        logf = self.log_f_values(particle_count)
        return float(logsumexp(logf) - np.log(len(logf)))
