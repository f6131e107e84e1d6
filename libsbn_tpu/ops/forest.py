"""Forest evaluation: cross-tree subtree sharing for tree collections.

The reference evaluates a collection tree-by-tree (one BEAGLE instance per
tree, fat_beagle.hpp:119-149); our classic kernels batch trees but still do
every tree's full node chain. When branch lengths are keyed by *split* (the
clade below an edge) — the regime of GP hot starts (gp_engine.cpp:363-394),
split-based VBPI branch models (vip/branch_model.py SplitModel), and any
fixed-support analysis — trees in a collection share identical subtree
partials, and the whole collection collapses to a DAG of unique structures:

  * a unique *down node* per distinct subtree (structure + split-keyed
    branch lengths below it determine the partial exactly);
  * a unique *up node* per distinct rootward context (the structure outside
    a node determines its upper partial);
  * a unique *edge* per distinct (up, down) pair. The per-edge gradient
    num/denom ratio cancels all rescale factors (see ops/pruning.py), so a
    tree edge's branch gradient IS its unique edge's value — per-tree
    outputs are gathers, no per-tree renormalization.

On DS1.100_topologies this dedupes 2,500 internal combines to 292, 5,100
upper partials to 2,424, and 5,100 edge contractions to 2,805. The deeper
win is structural: the per-tree engines pay a ~52-step serial chain per
tree, while the forest
runs ONE chain of ~2×depth wide *levels*, each a batched gather + einsum —
so the whole collection costs about as much serial latency as two trees.

Everything here is host-compiled to dense index arrays once per collection
(shapes are static per forest; resampling topologies means recompiling — use
the classic vmapped kernels for per-step VBPI sampling).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core.topology import Topology
from . import pruning


@dataclass(frozen=True)
class ForestSchedule:
    """Dense schedules for a deduplicated tree collection.

    Down nodes: ids 0..L-1 are the leaves; internals L..n_down-1 are sorted
    by level (leaves = level 0) so every level is a contiguous id range;
    id n_down is the all-ones padding slot. Up nodes: id 0 is the shared
    root context (U = freqs), the rest sorted by level. Edges are unique
    (up, down) pairs. Branch lengths are indexed by split id; split id
    n_splits is the zero-length slot (root / padding edges)."""

    leaf_count: int
    tree_count: int
    node_count: int  # per-tree node count (for output shapes)
    n_down: int
    n_up: int
    n_edges: int
    n_splits: int
    # Per internal down node (ids L..n_down-1, level-sorted):
    down_kids: np.ndarray  # (n_down - L, 3) child down ids, ones-padded
    down_bl: np.ndarray  # (n_down,) split id of the edge above each down node
    # Contiguous (start, mid, end) per level: [start, mid) are binary nodes,
    # [mid, end) trifurcating (tree roots) — the kernels skip the ones-slot
    # multiply for the binary majority.
    down_levels: Tuple[Tuple[int, int, int], ...]
    # Per up node (id 0 = root context, level-sorted):
    up_parent: np.ndarray  # (n_up,) parent up id
    up_pbl: np.ndarray  # (n_up,) split id of the edge above the parent
    up_sibs: np.ndarray  # (n_up, 2) sibling down ids, ones-padded
    # (start, mid, end) per level: [start, mid) have one sibling,
    # [mid, end) two (children of trifurcating roots).
    up_levels: Tuple[Tuple[int, int, int], ...]
    # Unique edges:
    edge_up: np.ndarray  # (n_edges,)
    edge_down: np.ndarray  # (n_edges,)
    edge_bl: np.ndarray  # (n_edges,) split id of the edge itself
    # Per-tree output maps:
    tree_root: np.ndarray  # (T,) down id of each tree's root
    tree_edge: np.ndarray  # (T, node_count - 1) edge id per non-root node
    # Split table (clade bitmask -> id), for building bl vectors:
    split_of_clade: Dict[int, int]

    @property
    def ones_slot(self) -> int:
        return self.n_down

    def split_count_with_zero(self) -> int:
        return self.n_splits + 1

    def branch_lengths_from_tree(self, top: Topology, bl) -> np.ndarray:
        """Split-keyed bl vector taking each split's length from `bl`
        (node-id indexed) wherever `top` contains that split; unseen splits
        keep 0.1. Handy for tests and hot starts."""
        out = np.full((self.n_splits,), 0.1)
        bl = np.asarray(bl)
        for node in top.postorder():
            if node.id == top.id:
                continue
            key = _clade_mask(node)
            idx = self.split_of_clade.get(key)
            if idx is not None:
                out[idx] = bl[node.id]
        return out

    def tree_branch_lengths(self, top: Topology, bl_splits) -> np.ndarray:
        """Node-id-indexed branch lengths of `top` gathered from a
        split-keyed vector (root slot 0)."""
        bl_splits = np.asarray(bl_splits)
        out = np.zeros((top.id + 1,))
        for node in top.postorder():
            if node.id == top.id:
                continue
            out[node.id] = bl_splits[self.split_of_clade[_clade_mask(node)]]
        return out


def _clade_mask(node: Topology) -> int:
    mask = 0
    for n in node.postorder():
        if n.is_leaf():
            mask |= 1 << n.leaf_id
    return mask


def build_forest(tops: Sequence[Topology]) -> ForestSchedule:
    """Host compiler: hash-cons subtrees, rootward contexts, and edges of a
    polished topology collection into level-sorted dense schedules."""
    tops = list(tops)
    assert tops, "empty collection"
    for t in tops:
        if t.id < 0:
            t.polish()
    leaf_count = tops[0].leaf_count
    node_count = tops[0].id + 1
    for t in tops:
        assert t.leaf_count == leaf_count and t.id + 1 == node_count, (
            "all trees in a forest must share a taxon set and rootedness"
        )

    splits: Dict[int, int] = {}
    full_mask = (1 << leaf_count) - 1
    # Unrooted collections (trifurcating roots) key splits by the canonical
    # UNORDERED bipartition min(mask, ~mask): the same branch in
    # inconsistently-rooted MCMC samples has complementary clade-below masks
    # depending on orientation, and the reference's split semantics
    # (SplitModel branch lengths, HotStartBranchLengths) treat those as ONE
    # optimization variable. Rooted (binary-root) collections keep the raw
    # clade mask — rooted splits ARE clades there.
    unrooted = len(tops[0].children) == 3

    def canon(mask: int) -> int:
        if not unrooted or mask == full_mask:
            return mask
        comp = full_mask ^ mask
        return mask if mask <= comp else comp

    def split_id(mask: int) -> int:
        mask = canon(mask)
        if mask not in splits:
            splits[mask] = len(splits)
        return splits[mask]

    # --- down pass: unique subtrees ---------------------------------------
    # key -> uid; per uid: (kids tuple or None for leaf, level, clade mask)
    down_ids: Dict[tuple, int] = {}
    down_kids: List[Tuple[int, ...]] = []
    down_level: List[int] = []
    down_clade: List[int] = []
    for i in range(leaf_count):
        down_ids[("L", i)] = i
        down_kids.append(())
        down_level.append(0)
        down_clade.append(1 << i)

    def down(node: Topology) -> int:
        if node.is_leaf():
            return node.leaf_id
        kids = tuple(sorted(down(c) for c in node.children))
        key = ("I",) + kids
        uid = down_ids.get(key)
        if uid is None:
            uid = len(down_kids)
            down_ids[key] = uid
            down_kids.append(kids)
            down_level.append(1 + max(down_level[k] for k in kids))
            mask = 0
            for k in kids:
                mask |= down_clade[k]
            down_clade.append(mask)
        return uid

    tree_root = np.array([down(t) for t in tops], dtype=np.int32)

    # Level-sort internals (binary before trifurcating within a level):
    # old uid -> new id (leaves keep 0..L-1).
    internal = sorted(range(leaf_count, len(down_kids)),
                      key=lambda u: (down_level[u], len(down_kids[u]) > 2))
    remap = np.empty((len(down_kids),), dtype=np.int32)
    remap[:leaf_count] = np.arange(leaf_count)
    for new, old in enumerate(internal):
        remap[old] = leaf_count + new
    n_down = len(down_kids)
    ones = n_down

    kids_arr = np.full((n_down - leaf_count, 3), ones, dtype=np.int32)
    down_bl = np.full((n_down,), len(splits), dtype=np.int32)  # filled below
    levels_of = np.zeros((n_down,), dtype=np.int32)
    # Python ints: a 64+-taxon clade mask overflows any fixed-width dtype.
    clade_of = np.zeros((n_down,), dtype=object)
    for old in range(n_down):
        new = remap[old]
        levels_of[new] = down_level[old]
        clade_of[new] = down_clade[old]
        if old >= leaf_count:
            ks = [remap[k] for k in down_kids[old]]
            kids_arr[new - leaf_count, : len(ks)] = ks
    tree_root = remap[tree_root]

    down_levels: List[Tuple[int, int, int]] = []
    start = leaf_count
    for lvl in range(1, int(levels_of.max()) + 1):
        end = start + int(np.sum(levels_of[leaf_count:] == lvl))
        n_tri = int(np.sum(
            kids_arr[start - leaf_count:end - leaf_count, 2] != ones
        ))
        down_levels.append((start, end - n_tri, end))
        assert np.all(levels_of[start:end] == lvl), "ids must be level-sorted"
        assert np.all(
            kids_arr[start - leaf_count:end - n_tri - leaf_count, 2] == ones
        )
        start = end
    assert start == n_down

    # Split ids (edge above each down node; tree roots get the zero slot).
    root_set = set(int(r) for r in tree_root)
    down_bl_list = np.empty((n_down,), dtype=np.int32)
    for uid in range(n_down):
        down_bl_list[uid] = split_id(int(clade_of[uid]))
    n_splits = len(splits)
    zero_slot = n_splits
    down_bl = down_bl_list
    # (Roots also have a clade entry — harmless; their "edge" is never used
    # in the down pass because Ed[root] is never read... actually Ed is
    # computed for every row; root rows evolve through their clade's split,
    # which is unused garbage unless that same uid is ALSO an inner node of
    # another tree — in which case the split-keyed bl is exactly right.)

    # --- up pass: unique rootward contexts --------------------------------
    up_ids: Dict[tuple, int] = {("R",): 0}
    up_parent: List[int] = [0]
    up_pbl: List[int] = [zero_slot]
    up_sibs: List[Tuple[int, int]] = [(ones, ones)]
    up_level: List[int] = [0]
    # edge (up,down) -> edge id
    edge_ids: Dict[Tuple[int, int], int] = {}
    edge_up: List[int] = []
    edge_down: List[int] = []
    edge_bl: List[int] = []
    tree_edge = np.full((len(tops), node_count - 1), -1, dtype=np.int32)

    def up_of(parent_up: int, parent_pbl: int, sibs: Tuple[int, ...]) -> int:
        sibs = tuple(sorted(sibs))
        key = ("U", parent_up, parent_pbl, sibs)
        uid = up_ids.get(key)
        if uid is None:
            uid = len(up_parent)
            up_ids[key] = uid
            up_parent.append(parent_up)
            up_pbl.append(parent_pbl)
            padded = sibs + (ones,) * (2 - len(sibs))
            up_sibs.append(padded[:2])
            up_level.append(1 + up_level[parent_up])
        return uid

    def edge_of(u: int, d: int) -> int:
        key = (u, d)
        eid = edge_ids.get(key)
        if eid is None:
            eid = len(edge_up)
            edge_ids[key] = eid
            edge_up.append(u)
            edge_down.append(d)
            edge_bl.append(int(down_bl[d]))
        return eid

    def walk(ti: int, node: Topology, my_up: int, my_down: int,
             my_pbl: int) -> None:
        if node.is_leaf():
            return
        kid_down = [int(remap[down(c)]) for c in node.children]
        for i, c in enumerate(node.children):
            sibs = tuple(kid_down[j] for j in range(len(kid_down)) if j != i)
            u = up_of(my_up, my_pbl, sibs)
            tree_edge[ti, c.id] = edge_of(u, kid_down[i])
            walk(ti, c, u, kid_down[i], int(down_bl[kid_down[i]]))

    for ti, t in enumerate(tops):
        walk(ti, t, 0, int(tree_root[ti]), zero_slot)
    assert np.all(tree_edge >= 0)

    # Level-sort up nodes, one-sibling before two within a level (id 0
    # stays put: it is the unique level-0 node).
    order = sorted(range(len(up_parent)),
                   key=lambda u: (up_level[u], up_sibs[u][1] != ones))
    assert order[0] == 0
    up_remap = np.empty((len(up_parent),), dtype=np.int32)
    for new, old in enumerate(order):
        up_remap[old] = new
    n_up = len(up_parent)
    up_parent_arr = np.empty((n_up,), dtype=np.int32)
    up_pbl_arr = np.empty((n_up,), dtype=np.int32)
    up_sibs_arr = np.empty((n_up, 2), dtype=np.int32)
    up_lvl_arr = np.empty((n_up,), dtype=np.int32)
    for old in range(n_up):
        new = up_remap[old]
        up_parent_arr[new] = up_remap[up_parent[old]]
        up_pbl_arr[new] = up_pbl[old]
        up_sibs_arr[new] = up_sibs[old]
        up_lvl_arr[new] = up_level[old]
    up_levels: List[Tuple[int, int, int]] = []
    start = 1
    for lvl in range(1, int(up_lvl_arr.max()) + 1):
        end = start + int(np.sum(up_lvl_arr == lvl))
        n_two = int(np.sum(up_sibs_arr[start:end, 1] != ones))
        up_levels.append((start, end - n_two, end))
        assert np.all(up_lvl_arr[start:end] == lvl)
        assert np.all(up_sibs_arr[start:end - n_two, 1] == ones)
        start = end
    assert start == n_up
    edge_up_arr = up_remap[np.asarray(edge_up, dtype=np.int32)]

    # Export BOTH orientations of each canonical split so consumers can keep
    # looking up by raw clade-below mask (bench.py, tree_branch_lengths).
    split_table = dict(splits)
    if unrooted:
        for mask, idx in list(splits.items()):
            if mask != full_mask:
                split_table.setdefault(full_mask ^ mask, idx)

    return ForestSchedule(
        leaf_count=leaf_count,
        tree_count=len(tops),
        node_count=node_count,
        n_down=n_down,
        n_up=n_up,
        n_edges=len(edge_up),
        n_splits=n_splits,
        down_kids=kids_arr,
        down_bl=down_bl,
        down_levels=tuple(down_levels),
        up_parent=up_parent_arr,
        up_pbl=up_pbl_arr,
        up_sibs=up_sibs_arr,
        up_levels=tuple(up_levels),
        edge_up=edge_up_arr,
        edge_down=np.asarray(edge_down, dtype=np.int32),
        edge_bl=np.asarray(edge_bl, dtype=np.int32),
        tree_root=tree_root,
        tree_edge=tree_edge,
        split_of_clade=split_table,
    )


def forest_log_likelihoods_and_gradients(
    fs: ForestSchedule,
    bl_splits,
    evec, ivec, evals,
    Q_scaled,
    tips,
    freqs,
    rates,
    props,
    weights,
    rescale: bool = True,
):
    """(ll (T,), grad (T, node_count-1)) for every tree in the forest under
    split-keyed branch lengths bl_splits (n_splits,). Jit over this with
    fs/static args closed over; vmap over bl_splits for multiple sets.

    Same math as pruning.log_likelihood_and_branch_gradient per tree — the
    difference is purely the shared-evaluation order."""
    K = props.shape[0]
    n_pat = tips.shape[-1]
    dtype = jnp.result_type(tips, bl_splits)

    bl = jnp.concatenate([jnp.asarray(bl_splits),
                          jnp.zeros((1,), bl_splits.dtype)])  # zero slot
    Pmat = pruning.node_transition_matrices(evec, ivec, evals, bl, rates)
    # (n_splits+1, K, 4, 4)

    L = fs.leaf_count
    ones = fs.ones_slot

    # Down pass.
    Md = jnp.ones((fs.n_down + 1, K, 4, n_pat), dtype=dtype)
    Md = Md.at[:L].set(jnp.asarray(tips)[:, None].astype(dtype))
    Ed = jnp.ones((fs.n_down + 1, K, 4, n_pat), dtype=dtype)
    Ed = Ed.at[:L].set(
        jnp.einsum("nkij,nkjp->nkip", Pmat[fs.down_bl[:L]],
                   Md[:L])
    )
    ls_d = jnp.zeros((fs.n_down + 1, n_pat), dtype=dtype)

    for (a, _, b) in fs.down_levels:
        kids = fs.down_kids[a - L:b - L]  # (n, 3)
        ke = Ed[kids]  # (n, 3, K, 4, Pp)
        prod = ke[:, 0] * ke[:, 1] * ke[:, 2]
        ls = ls_d[kids].sum(axis=1)  # (n, Pp)
        if rescale:
            scale = jnp.max(prod, axis=(1, 2))  # (n, Pp)
            scale = jnp.where(scale > 0, scale, jnp.ones_like(scale))
            prod = prod / scale[:, None, None, :]
            ls = ls + jnp.log(scale)
        Md = jax.lax.dynamic_update_slice(Md, prod, (a, 0, 0, 0))
        ev = jnp.einsum("nkij,nkjp->nkip", Pmat[fs.down_bl[a:b]], prod)
        Ed = jax.lax.dynamic_update_slice(Ed, ev, (a, 0, 0, 0))
        ls_d = jax.lax.dynamic_update_slice(ls_d, ls, (a, 0))
        Md, Ed, ls_d = _level_barrier((Md, Ed, ls_d))

    # Up pass.
    U = jnp.zeros((fs.n_up, K, 4, n_pat), dtype=dtype)
    U = U.at[0].set(jnp.asarray(freqs)[None, :, None].astype(dtype))
    for (a, _, b) in fs.up_levels:
        par = fs.up_parent[a:b]
        pu = U[par]  # (n, K, 4, Pp)
        pp = Pmat[fs.up_pbl[a:b]]  # (n, K, 4, 4)
        evolved = jnp.einsum("nkij,nkip->nkjp", pp, pu)
        se = Ed[fs.up_sibs[a:b]]  # (n, 2, K, 4, Pp)
        u = evolved * se[:, 0] * se[:, 1]
        if rescale:
            scale = jnp.max(u, axis=(1, 2))
            scale = jnp.where(scale > 0, scale, jnp.ones_like(scale))
            u = u / scale[:, None, None, :]
        U = _level_barrier(jax.lax.dynamic_update_slice(U, u, (a, 0, 0, 0)))

    # Per-tree log likelihoods.
    Mroot = Md[fs.tree_root]  # (T, K, 4, Pp)
    site = jnp.einsum("k,i,tkip->tp", jnp.asarray(props),
                      jnp.asarray(freqs).astype(dtype), Mroot)
    ll = jnp.sum(
        jnp.asarray(weights)[None, :] * (jnp.log(site) + ls_d[fs.tree_root]),
        axis=-1,
    )

    # Unique-edge gradients; scale factors cancel in num/denom.
    Ue = U[fs.edge_up]  # (E, K, 4, Pp)
    Ee = Ed[fs.edge_down]
    denom = jnp.einsum("k,ekip,ekip->ep", jnp.asarray(props), Ue, Ee)
    QE = jnp.einsum("kij,ekjp->ekip", jnp.asarray(Q_scaled), Ee)
    num = jnp.einsum("k,ekip,ekip->ep", jnp.asarray(props), Ue, QE)
    edge_grad = jnp.sum(jnp.asarray(weights)[None, :] * num / denom, axis=-1)

    grad = edge_grad[fs.tree_edge]  # (T, node_count - 1)
    return ll, grad


def _level_barrier(x):
    """Materialize a level's buffers before the next level gathers from
    them. Without it XLA's GPU fusion merges the unrolled levels' gathers
    with their producers into kernels that take minutes to compile: on an
    H100, DS1.100's JC69 forest took ~150 s for one branch-length set and
    over 5 min vmapped over 8 sets, against 10-18 s with the barriers
    (same results)."""
    return jax.lax.optimization_barrier(x)


def _jc_coeffs(bl):
    """JC69 closed form P(t) = b·I + a·J/4 with b = exp(-4t/3), a = 1-b,
    so evolve(v) = b·v + (a/4)·Σ_states v — matrix-free, 2 FLOPs/element
    (gp_engine.hpp:144-155 hardcodes the same eigensystem; we skip the
    matrices entirely). The exponential runs in f64 (BASELINE.md precision
    policy) and is symmetric, so the up pass reuses it un-transposed."""
    t64 = jnp.asarray(bl).astype(jnp.float64)
    b = jnp.exp(-4.0 * t64 / 3.0)
    a = 1.0 - b
    return a, b


def _fused_up_plan(fs: ForestSchedule):
    """Host-side plan for the fused rolling-block up pass (cached on fs).

    Exploits two schedule invariants: (a) an up node's parent context is
    always in the PREVIOUS level (up_level[u] == 1 + up_level[parent], by
    construction in build_forest), so the up pass only ever reads the
    level just produced — the full (n_up, 4, S) HBM buffer, its writes,
    and the final (E, 4, S) Ue re-gather all disappear; (b) no edge's up
    node is the root context, so every edge gradient can be emitted at
    the level where its up row is materialized. Edges are re-sorted by up
    level on host so the per-level outputs concatenate without scatters;
    tree_edge is pre-permuted to match."""
    cached = getattr(fs, "_fused_plan_cache", None)
    if cached is not None:
        return cached
    lvl = np.zeros(fs.n_up, np.int32)
    for li, (a, _, b) in enumerate(fs.up_levels):
        lvl[a:b] = li + 1
    elvl = lvl[fs.edge_up]
    assert np.all(elvl > 0), "edges never hang off the root context"
    perm = np.argsort(elvl, kind="stable")
    pos = np.empty((fs.n_edges,), np.int64)
    pos[perm] = np.arange(fs.n_edges)
    tree_edge_pos = pos[fs.tree_edge]
    plan = []
    prev_start = 0  # the level-0 block is the single root-context row
    ei = 0
    for li, (a, m, b) in enumerate(fs.up_levels):
        n_e = int(np.sum(elvl == li + 1))
        sel = perm[ei:ei + n_e]
        plan.append((
            a, m, b,
            (fs.up_parent[a:b] - prev_start).astype(np.int32),
            fs.edge_down[sel].astype(np.int32),
            (fs.edge_up[sel] - a).astype(np.int32),
        ))
        prev_start = a
        ei += n_e
    assert ei == fs.n_edges
    cached = (tuple(plan), tree_edge_pos)
    object.__setattr__(fs, "_fused_plan_cache", cached)
    return cached


def forest_jc_log_likelihoods_and_gradients(
    fs: ForestSchedule,
    bl_splits,
    tips,
    weights,
    rescale: bool = True,
    ll_only: bool = False,
    dtype=jnp.float32,
    fused: bool = True,
    gather_dtype=None,
):
    """Matrix-free JC69 forest evaluation — the production bench path.

    Identical results to forest_log_likelihoods_and_gradients with the
    JC69 eigensystem (tested); cheaper because every 4x4
    contraction collapses to a broadcast-FMA and the gradient numerator
    needs only state sums: the normalized JC69 rate matrix is
    Q = (4/3)(J/4 − I), so
        num = Σ_x U_x (QE)_x = (4/3)((Σ E)(Σ U)/4 − Σ_x U_x E_x),
    and grad_e = (4/3)·Σ_s w_s ((See·Sue)/(4·denom) − 1).
    Returns (ll (T,), grad (T, node_count-1)) — grad is None if ll_only."""
    S = tips.shape[-1]
    L = fs.leaf_count
    a_all, b_all = _jc_coeffs(
        jnp.concatenate([jnp.asarray(bl_splits),
                         jnp.zeros((1,), jnp.asarray(bl_splits).dtype)])
    )
    a_all = a_all.astype(dtype)
    b_all = b_all.astype(dtype)

    def evolve(idx, V):
        a = a_all[idx][:, None, None]
        b = b_all[idx][:, None, None]
        return b * V + (a * 0.25) * jnp.sum(V, axis=1, keepdims=True)

    tips = jnp.asarray(tips).astype(dtype)
    Md = jnp.ones((fs.n_down + 1, 4, S), dtype)
    Md = Md.at[:L].set(tips)
    Ed = jnp.ones((fs.n_down + 1, 4, S), dtype)
    Ed = Ed.at[:L].set(evolve(fs.down_bl[:L], tips))
    ls_d = jnp.zeros((fs.n_down + 1, S), dtype)
    w = jnp.asarray(weights).astype(dtype)

    for (a0, mid, b0) in fs.down_levels:
        parts, lss = [], []
        if mid > a0:  # binary nodes: skip the ones-slot multiply
            k = fs.down_kids[a0 - L:mid - L]
            parts.append(Ed[k[:, 0]] * Ed[k[:, 1]])
            lss.append(ls_d[k[:, 0]] + ls_d[k[:, 1]])
        if b0 > mid:  # trifurcating tree roots
            k = fs.down_kids[mid - L:b0 - L]
            parts.append(Ed[k[:, 0]] * Ed[k[:, 1]] * Ed[k[:, 2]])
            lss.append(ls_d[k[:, 0]] + ls_d[k[:, 1]] + ls_d[k[:, 2]])
        prod = parts[0] if len(parts) == 1 else jnp.concatenate(parts)
        ls = lss[0] if len(lss) == 1 else jnp.concatenate(lss)
        if rescale:
            scale = jnp.max(prod, axis=1)
            scale = jnp.where(scale > 0, scale, jnp.ones_like(scale))
            prod = prod / scale[:, None, :]
            ls = ls + jnp.log(scale)
        Md = jax.lax.dynamic_update_slice(Md, prod, (a0, 0, 0))
        Ed = jax.lax.dynamic_update_slice(
            Ed, evolve(fs.down_bl[a0:b0], prod), (a0, 0, 0)
        )
        ls_d = jax.lax.dynamic_update_slice(ls_d, ls, (a0, 0))
        Md, Ed, ls_d = _level_barrier((Md, Ed, ls_d))

    site = 0.25 * jnp.sum(Md[fs.tree_root], axis=1)  # (T, S)
    ll = jnp.sum(w[None, :] * (jnp.log(site) + ls_d[fs.tree_root]), axis=-1)
    if ll_only:
        return ll, None

    if fused:
        # Rolling-block up pass with the edge gradients fused in (see
        # _fused_up_plan). Per-row rescaling of u cancels in each edge's
        # num/denom ratio, exactly as in the buffered form.
        #
        # gather_dtype (default: working dtype) stores the Ed buffer and
        # the rolling block for the gradient phase only — the phase is
        # gather-bandwidth-bound, so bfloat16 halves its traffic (measured
        # 146k -> 245k evals/s on DS1.100x8); arithmetic upcasts to the
        # working dtype and the LL (from the down pass) is untouched. Max
        # observed relative gradient error vs f32: 2e-3 — an order inside
        # the 2e-2 physher-gradient parity gate (bench.py).
        gdt = dtype if gather_dtype is None else gather_dtype
        plan, tree_edge_pos = _fused_up_plan(fs)
        Edg = Ed if gdt == dtype else Ed.astype(gdt)
        prev = jnp.full((1, 4, S), 0.25, dtype)
        grad_parts = []
        for (a0, mid, b0, par_local, e_down, e_up_local) in plan:
            evolved = evolve(fs.up_pbl[a0:b0], prev[par_local].astype(dtype))
            parts = []
            if mid > a0:  # one sibling
                parts.append(
                    evolved[:mid - a0]
                    * Edg[fs.up_sibs[a0:mid, 0]].astype(dtype)
                )
            if b0 > mid:  # two siblings (children of trifurcating roots)
                sib = fs.up_sibs[mid:b0]
                parts.append(
                    evolved[mid - a0:]
                    * (Edg[sib[:, 0]].astype(dtype)
                       * Edg[sib[:, 1]].astype(dtype))
                )
            u = parts[0] if len(parts) == 1 else jnp.concatenate(parts)
            if rescale:
                scale = jnp.max(u, axis=1)
                scale = jnp.where(scale > 0, scale, jnp.ones_like(scale))
                u = u / scale[:, None, :]
            if len(e_down):
                Ue = u[e_up_local]
                Ee = Edg[e_down].astype(dtype)
                denom = jnp.sum(Ue * Ee, axis=1)  # (e, S)
                Sue = jnp.sum(Ue, axis=1)
                See = jnp.sum(Ee, axis=1)
                grad_parts.append(_level_barrier((4.0 / 3.0) * jnp.sum(
                    w[None, :] * (0.25 * See * Sue / denom - 1.0), axis=-1
                )))
            prev = _level_barrier(u if gdt == dtype else u.astype(gdt))
        edge_grad = _level_barrier(jnp.concatenate(grad_parts))
        return ll, edge_grad[tree_edge_pos]

    U = jnp.zeros((fs.n_up, 4, S), dtype)
    U = U.at[0].set(0.25)
    for (a0, mid, b0) in fs.up_levels:
        evolved = evolve(fs.up_pbl[a0:b0], U[fs.up_parent[a0:b0]])
        parts = []
        if mid > a0:  # one sibling
            parts.append(evolved[:mid - a0] * Ed[fs.up_sibs[a0:mid, 0]])
        if b0 > mid:  # two siblings (children of trifurcating roots)
            sib = fs.up_sibs[mid:b0]
            parts.append(evolved[mid - a0:] * Ed[sib[:, 0]] * Ed[sib[:, 1]])
        u = parts[0] if len(parts) == 1 else jnp.concatenate(parts)
        if rescale:
            scale = jnp.max(u, axis=1)
            scale = jnp.where(scale > 0, scale, jnp.ones_like(scale))
            u = u / scale[:, None, :]
        U = _level_barrier(jax.lax.dynamic_update_slice(U, u, (a0, 0, 0)))

    Ue = U[fs.edge_up]
    Ee = Ed[fs.edge_down]
    denom = jnp.sum(Ue * Ee, axis=1)  # (E, S)
    Sue = jnp.sum(Ue, axis=1)
    See = jnp.sum(Ee, axis=1)
    edge_grad = (4.0 / 3.0) * jnp.sum(
        w[None, :] * (0.25 * See * Sue / denom - 1.0), axis=-1
    )
    return ll, edge_grad[fs.tree_edge]


def forest_jc_weighted_ll_and_split_gradient(
    fs: ForestSchedule, bl_splits, tips, weights, lam=None,
    dtype=jnp.float32,
):
    """(per-tree lls (T,), d(Σ_τ lam_τ ll_τ)/d bl_splits (n_splits,)) in ONE
    forward + ONE reverse pass through the shared down DAG.

    This is the split-keyed *optimization* surface (GP-style branch-length
    ascent over a fixed support, MAP fitting): when only the aggregated
    gradient is needed, reverse-mode AD through the LL-only forest skips
    the per-tree up/edge machinery entirely — measured 330k tree-evals/s
    on DS1.100 (3.6x the per-tree-gradient mode, 69x the native per-tree
    path). Verified equal to aggregating the per-tree edge gradients
    (tests/test_forest.py)."""
    if lam is None:
        lam = jnp.ones((fs.tree_count,), dtype)

    def weighted(b):
        ll, _ = forest_jc_log_likelihoods_and_gradients(
            fs, b, tips, weights, ll_only=True, dtype=dtype
        )
        return jnp.sum(jnp.asarray(lam, dtype) * ll), ll

    (_, ll), g = jax.value_and_grad(weighted, has_aux=True)(
        jnp.asarray(bl_splits)
    )
    return ll, g


def forest_branch_ascent(
    fs: ForestSchedule, bl0, tips, weights, lam=None, steps: int = 200,
    lr: float = 0.05, dtype=jnp.float32,
):
    """Maximize Σ_τ lam_τ LL_τ over split-keyed branch lengths — the
    collection analog of GPInstance.EstimateBranchLengths
    (gp_instance.cpp:129-175), driven by the one-reverse-pass aggregated
    gradient. Adam in log-branch-length space (positivity for free, the
    reference optimizes log-space too, gp_engine.cpp:326-345), fixed step
    count, one jitted lax.scan.

    Returns (bl (n_splits,), per-tree lls at the optimum (T,), objective
    trace (steps,))."""
    lam_v = (jnp.ones((fs.tree_count,), dtype) if lam is None
             else jnp.asarray(lam, dtype))
    tips = jnp.asarray(tips)
    weights = jnp.asarray(weights)

    def objective(log_bl):
        ll, _ = forest_jc_log_likelihoods_and_gradients(
            fs, jnp.exp(log_bl), tips, weights, ll_only=True, dtype=dtype
        )
        return jnp.sum(lam_v * ll), ll

    grad_fn = jax.value_and_grad(objective, has_aux=True)
    b1, b2, eps = 0.9, 0.999, 1e-8

    def step(carry, i):
        log_bl, m, v = carry
        (obj, _), g = grad_fn(log_bl)
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        mhat = m / (1 - b1 ** (i + 1.0))
        vhat = v / (1 - b2 ** (i + 1.0))
        log_bl = log_bl + lr * mhat / (jnp.sqrt(vhat) + eps)
        return (log_bl, m, v), obj

    log0 = jnp.log(jnp.clip(jnp.asarray(bl0, dtype), 1e-6, None))
    zeros = jnp.zeros_like(log0)
    (log_bl, _, _), trace = jax.lax.scan(
        step, (log0, zeros, zeros), jnp.arange(steps, dtype=dtype)
    )
    bl = jnp.exp(log_bl)
    _, ll = objective(log_bl)
    return bl, ll, trace


def forest_stats(fs: ForestSchedule) -> Dict[str, float]:
    """Sharing diagnostics (for logs and the bench's honest accounting)."""
    per_tree_internal = fs.node_count - fs.leaf_count
    per_tree_edges = fs.node_count - 1
    T = fs.tree_count
    return {
        "trees": T,
        "down_internal_unique": fs.n_down - fs.leaf_count,
        "down_internal_total": per_tree_internal * T,
        "up_unique": fs.n_up - 1,
        "up_total": per_tree_edges * T,
        "edges_unique": fs.n_edges,
        "edges_total": per_tree_edges * T,
        "down_levels": len(fs.down_levels),
        "up_levels": len(fs.up_levels),
        "op_sharing": (per_tree_internal + 2 * per_tree_edges) * T / max(
            1, (fs.n_down - fs.leaf_count) + (fs.n_up - 1) + fs.n_edges
        ),
    }
