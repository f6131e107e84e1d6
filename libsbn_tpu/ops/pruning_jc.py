"""JC69 log-likelihood + branch gradient: a fused GPU kernel and the
choice between it and the scan engine.

Under JC69 the transition matrix has the closed form

    P(t) = e I + (1 - e)/4 J,   e = exp(-4t/3),  J = all-ones,

and the two-pass linear-time gradient collapses algebraically:

  * apply: P v = e v + (1-e)/4 (sum_i v_i) — one 4-row sum and two
    broadcast FMAs instead of a 4x4 contraction; P^T = P, so the upward
    pass uses the same form;
  * P is doubly stochastic, so the row sum of an evolved partial equals
    the row sum of the partial it came from;
  * the rate-matrix apply disappears: with Q = (4/3)(J/4 - I),
      num_k = u_k . (r_k Q E_k) = r_k [ (1/3) S_u,k S_E,k - (4/3) d_k ],
    where d_k = u_k . E_k is the per-category denominator term;
  * the root contraction is (1/4) sum_k props_k S_E,k[root];
  * no 4x4 matrices are built: the caller passes the scalar e per (node,
    category), computed in f64 (exp_factors).

The kernel (Pallas, Triton route) runs one program per block of work
items, an item being one (tree, pattern block). A program walks the
tree's whole postorder and upward schedule in an in-kernel loop, loading
its schedule rows itself. The Triton route has no scratch memory, so the
evolved partials E and upper partials U of the program's current item
live in two extra global-memory outputs, one slab per program, reused
across the program's items so that the live slabs stay small enough for
the L2 cache. Every partial is rescaled by its per-pattern row sum (any
positive per-(tree, pattern) factor is a valid scale; the sums come
free), and scale factors cancel in every gradient ratio.

`log_likelihood_and_branch_gradient_jc69` is the one place that chooses:
it runs the kernel when the platform is a GPU and the dtype float32 (and
the caller allows it), and the scan engine of
ops/pruning.py otherwise. Both return the same values to f32 tolerance.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from . import pruning, substitution

# Pattern block width of one work item; a power of two (Triton block
# shapes must be). Tile 64 with two warps per program is the setting
# checked against the reference on an H100.
DEFAULT_TILE = 64
NUM_WARPS = 2
# Programs to keep in flight: enough to fill the card several times over,
# few enough that their live E/U slabs stay near the size of the L2 cache.
DEFAULT_PROGRAMS = 1024


def use_kernel(dtype) -> bool:
    """True where the fused kernel serves the JC69 LL+gradient: a GPU
    platform and float32 (the kernel computes in f32 only)."""
    return (
        jax.default_backend() == "gpu"
        and jnp.dtype(dtype) == jnp.dtype(jnp.float32)
    )


def pad_patterns(tips, weights, tile):
    """Pad the pattern axis to a multiple of ``tile`` with all-ones tip
    columns of zero weight (numerically inert: P keeps an all-ones vector
    all-ones, and every pattern reduction is weighted)."""
    n = weights.shape[-1]
    target = -(-n // tile) * tile
    if target == n:
        return tips, weights
    tips = jnp.concatenate(
        [tips, jnp.ones(tips.shape[:-1] + (target - n,), tips.dtype)], axis=-1
    )
    weights = jnp.concatenate(
        [weights, jnp.zeros((target - n,), weights.dtype)]
    )
    return tips, weights


def programs_for(n_items: int, target: int = DEFAULT_PROGRAMS) -> int:
    """Number of programs: the smallest divisor of n_items that is at
    least ``target`` (all items when there are fewer), so that every
    program handles the same number of items."""
    if n_items <= target:
        return n_items
    for g in range(target, n_items + 1):
        if n_items % g == 0:
            return g
    return n_items


def exp_factors(bl_padded, rates):
    """e = exp(-4 b r / 3) per (tree, node, category), exp in f64.
    bl_padded: (B, N+1); rates: (K,). Returns (B, (N+1)*K) f32."""
    t = (
        jnp.asarray(bl_padded, jnp.float64)[:, :, None]
        * jnp.asarray(rates, jnp.float64)[None, None, :]
    )
    e = jnp.exp(-4.0 / 3.0 * t).astype(jnp.float32)
    return e.reshape(e.shape[0], -1)


def _kernel(
    sched_ref,  # (B, S, 3) int32 postorder children
    ea_ref,  # (B, N1*K) f32: e per node*K + k
    rates_ref,  # (K,) category rates
    props_ref,  # (K,) category proportions
    tips_ref,  # (L, 4, PT) tip partials
    w_ref,  # (PT,) pattern weights
    ll_ref,  # out (n_items,)
    grad_ref,  # out (n_items, N1)
    E,  # out slab (G, N1, K, 4, tile): evolved partials
    U,  # out slab (G, N1, K, 4, tile): upper partials (props folded)
    *,
    leaf_count: int,
    root_id: int,
    K: int,
    tile: int,
    n_tiles: int,
    items_per_program: int,
    rescale: bool,
    interpret: bool,
):
    L = leaf_count
    n_steps = root_id + 1 - L
    ones_slot = root_id + 1
    dt = jnp.float32
    quarter = jnp.float32(0.25)
    third = jnp.float32(1.0 / 3.0)
    four_thirds = jnp.float32(4.0 / 3.0)
    tiny = jnp.float32(1e-30)
    pid = pl.program_id(0)
    n_programs = pl.num_programs(0)

    def sync():
        # Slab rows written by one thread are read by others in the next
        # step; the interpreter runs one program at a time.
        if not interpret:
            pl_triton.debug_barrier()

    def rowsum(x):  # (4, tile) -> (1, tile)
        return jnp.sum(x, axis=0, keepdims=True)

    def item_body(j, carry):
        item = j * n_programs + pid
        b = item // n_tiles
        cols = pl.ds((item % n_tiles) * tile, tile)
        w = w_ref[cols][None, :]  # (1, tile)

        def ea(node, k):
            return ea_ref[b, node * K + k]

        def evolve(node, k, v, s):  # P_node v, s = rowsum(v)
            e = ea(node, k)
            return e * v + ((1.0 - e) * quarter) * s

        # -- postorder: leaves, the ones slot, then the combine steps.
        def leaf_body(leaf, c):
            tip = tips_ref[leaf, :, cols]
            s = rowsum(tip)
            for k in range(K):
                E[pid, leaf, k, :, :] = evolve(leaf, k, tip, s)
            return c

        jax.lax.fori_loop(0, L, leaf_body, 0)
        for k in range(K):
            E[pid, ones_slot, k, :, :] = jnp.ones((4, tile), dt)
        sync()

        def post_body(s, logscale):
            kids = [sched_ref[b, s, c] for c in range(3)]
            node = L + s
            prods = [
                E[pid, kids[0], k, :, :]
                * E[pid, kids[1], k, :, :]
                * E[pid, kids[2], k, :, :]
                for k in range(K)
            ]
            sums = [rowsum(p) for p in prods]
            if rescale:
                scale = functools.reduce(jnp.add, sums)
                scale = jnp.where(scale > 0, scale, jnp.ones_like(scale))
                inv = 1.0 / scale
                prods = [p * inv for p in prods]
                sums = [s_ * inv for s_ in sums]
                logscale = logscale + jnp.log(scale)
            for k in range(K):
                E[pid, node, k, :, :] = evolve(node, k, prods[k], sums[k])
            sync()
            return logscale

        logscale = jax.lax.fori_loop(
            0, n_steps, post_body, jnp.zeros((1, tile), dt)
        )
        # The root's own branch length is zero (e = 1), so E[root] is the
        # root partial itself.
        site = functools.reduce(
            jnp.add,
            [
                (props_ref[k] * quarter) * rowsum(E[pid, root_id, k, :, :])
                for k in range(K)
            ],
        )
        ll_ref[item] = jnp.sum(w * (jnp.log(jnp.maximum(site, tiny)) + logscale))

        # -- upward pass with the fused edge derivatives.
        for k in range(K):
            U[pid, root_id, k, :, :] = jnp.full(
                (4, tile), props_ref[k] * quarter, dt
            )
        sync()

        def up_body(t, c):
            node = root_id - t
            s = node - L
            kids = [sched_ref[b, s, c_] for c_ in range(3)]
            ev_up, ek, d = [], [], []
            for k in range(K):
                un = U[pid, node, k, :, :]
                ev_up.append(evolve(node, k, un, rowsum(un)))
                ek.append([E[pid, kid, k, :, :] for kid in kids])
                # u_c . E_c is the same product for every child c.
                d.append(rowsum(ev_up[k] * ek[k][0] * ek[k][1] * ek[k][2]))
            denom = functools.reduce(jnp.add, d)
            winv = w / jnp.maximum(denom, tiny)
            for i, kid in enumerate(kids):
                a, b_ = [x for x in range(3) if x != i]
                us, num, su = [], None, None
                for k in range(K):
                    u = ev_up[k] * ek[k][a] * ek[k][b_]
                    su_k = rowsum(u)
                    term = rates_ref[k] * (
                        third * su_k * rowsum(ek[k][i]) - four_thirds * d[k]
                    )
                    num = term if num is None else num + term
                    su = su_k if su is None else su + su_k
                    us.append(u)
                grad_ref[item, kid] = jnp.sum(winv * num)
                inv = 1.0 / jnp.where(su > 0, su, jnp.ones_like(su))
                for k in range(K):
                    U[pid, kid, k, :, :] = us[k] * inv
            sync()
            return c

        jax.lax.fori_loop(0, n_steps, up_body, 0)
        return carry

    jax.lax.fori_loop(0, items_per_program, item_body, 0)


@functools.partial(
    jax.jit,
    static_argnames=(
        "leaf_count", "root_id", "tile", "programs", "rescale",
        "interpret",
    ),
)
def _fused_call(
    post_children, ea, rates, props, tips, weights, *, leaf_count, root_id,
    tile, programs, rescale, interpret,
):
    """ea: (B, N1*K) f32; tips: (L, 4, PT); weights: (PT,), PT a multiple
    of tile. Returns (ll (B,), grad (B, N1))."""
    B = post_children.shape[0]
    K = rates.shape[0]
    N1 = ea.shape[1] // K
    n_tiles = weights.shape[0] // tile
    n_items = B * n_tiles
    G = programs_for(n_items, programs)
    kernel = functools.partial(
        _kernel, leaf_count=leaf_count, root_id=root_id, K=K, tile=tile,
        n_tiles=n_tiles, items_per_program=n_items // G, rescale=rescale,
        interpret=interpret,
    )
    slab = jax.ShapeDtypeStruct((G, N1, K, 4, tile), jnp.float32)
    with jax.enable_x64(False):
        ll, grad, _, _ = pl.pallas_call(
            kernel,
            grid=(G,),
            out_shape=[
                jax.ShapeDtypeStruct((n_items,), jnp.float32),
                jax.ShapeDtypeStruct((n_items, N1), jnp.float32),
                slab,
                slab,
            ],
            backend="triton",
            compiler_params=pl_triton.CompilerParams(
                num_warps=NUM_WARPS, num_stages=1
            ),
            interpret=interpret,
            name="jc69_ll_grad",
        )(post_children, ea, rates, props, tips, weights)
    ll = ll.reshape(B, n_tiles).sum(axis=1)
    grad = grad.reshape(B, n_tiles, N1).sum(axis=1)
    return ll, grad


def fused_jc69(
    post_children, bl_padded, tips, weights, *, root_id, rates=None,
    props=None, rescale=True, tile=DEFAULT_TILE, programs=DEFAULT_PROGRAMS,
    interpret=False,
):
    """The fused kernel. post_children: (B, S, 3) int32; bl_padded:
    (B, N+1) with the ones-slot zero appended (root slot 0); tips:
    (L, 4, P); weights: (P,); rates/props: (K,) category rates and
    proportions (default: one category). Returns (ll (B,), grad (B,
    root_id)), computed in float32. ``interpret=True`` runs the Pallas
    interpreter (CPU tests)."""
    if rates is None:
        rates = jnp.ones((1,), jnp.float32)
    if props is None:
        props = jnp.full((rates.shape[0],), 1.0 / rates.shape[0], jnp.float32)
    rates = jnp.asarray(rates, jnp.float32)
    props = jnp.asarray(props, jnp.float32)
    tips_p, w_p = pad_patterns(
        jnp.asarray(tips, jnp.float32), jnp.asarray(weights, jnp.float32), tile
    )
    ll, grad = _fused_call(
        jnp.asarray(post_children, jnp.int32),
        exp_factors(bl_padded, rates),
        rates,
        props,
        tips_p,
        w_p,
        leaf_count=tips_p.shape[0],
        root_id=root_id,
        tile=tile,
        programs=programs,
        rescale=rescale,
        interpret=interpret,
    )
    return ll, grad[:, :root_id]


def scan_jc69(
    post_children, bl_padded, tips, weights, *, root_id, rates=None,
    props=None, rescale=True,
):
    """The same (ll (B,), grad (B, root_id)) on the scan engine
    (ops/pruning.py), vmapped over trees, in the dtype of bl_padded."""
    dt = jnp.result_type(bl_padded)
    if rates is None:
        rates = jnp.ones((1,), dt)
    if props is None:
        props = jnp.full((rates.shape[0],), 1.0 / rates.shape[0], dt)
    rates = jnp.asarray(rates, dt)
    props = jnp.asarray(props, dt)
    freqs, evec, ivec, evals = substitution.jc69_eigen(dt)
    Qs = substitution.jc69_q(dt)[None] * rates[:, None, None]
    tips = jnp.asarray(tips, dt)
    weights = jnp.asarray(weights, dt)

    def one(pc, bl):
        P = pruning.node_transition_matrices(evec, ivec, evals, bl, rates)
        sched = pruning.Sched(root_id, pc)
        return pruning.log_likelihood_and_branch_gradient(
            sched, P, Qs, tips, freqs, props, weights, rescale
        )

    return jax.vmap(one)(
        jnp.asarray(post_children, jnp.int32), jnp.asarray(bl_padded, dt)
    )


def log_likelihood_and_branch_gradient_jc69(
    post_children, bl_padded, tips, weights, *, root_id, rates=None,
    props=None, rescale=True, allow_kernel=True,
):
    """JC69 (ll (B,), branch gradient (B, root_id)) from padded branch
    lengths: the fused kernel where use_kernel(dtype of bl_padded), the
    scan engine otherwise. allow_kernel=False keeps the scan engine: a
    caller whose jit splits the batch over a mesh passes it, since XLA
    partitions the scan engine but not the kernel (a per-device custom
    call)."""
    fused = allow_kernel and use_kernel(jnp.result_type(bl_padded))
    impl = fused_jc69 if fused else scan_jc69
    return impl(
        post_children, bl_padded, tips, weights, root_id=root_id,
        rates=rates, props=props, rescale=rescale,
    )


def log_likelihood_and_branch_gradient_jc69_sharded(
    mesh, post_children, bl_padded, tips, weights, *, root_id,
):
    """Mesh-parallel JC69 LL+gradient (one rate category): the tree batch
    split over the mesh's "dp" axis with shard_map (a Pallas custom call
    is a per-device program, so the batch split is explicit), each device
    running the selected implementation on its rows."""
    from jax.sharding import PartitionSpec as PSpec

    def local(pc, bl_loc):
        return log_likelihood_and_branch_gradient_jc69(
            pc, bl_loc, tips, weights, root_id=root_id
        )

    f = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(PSpec("dp"), PSpec("dp")),
        out_specs=(PSpec("dp"), PSpec("dp")),
        check_vma=False,
    )
    return f(jnp.asarray(post_children, jnp.int32), jnp.asarray(bl_padded))
