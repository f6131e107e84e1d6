"""Benchmark harness: every BASELINE.json config, one JSON line.

Headline (top-level value): DS1 (27 taxa)
log-likelihood + branch-gradient evaluations per second on one chip —
batched Felsenstein pruning with the linear-time two-pass branch gradient,
JC69 + constant sites, DS1.subsampled_10 topologies with perturbed branch
lengths, float32, rescaling on, one jitted launch per batch.

`configs` covers the five BASELINE.json workloads plus the forest
(cross-tree-sharing) mode, each with a live, shape-matched native CPU
denominator where one is expressible (native/cpu_baseline.cpp — the
BEAGLE-CPU stand-in, golden-verified; BEAGLE itself is unavailable here,
BASELINE.md provenance note):

  1 hello_jc69_ll           single-tree JC69 LL (hello), LL-only both sides
  2 gtr_weibull4_ll_ds1_100 batched GTR+Weibull-4 LL over DS1.100_topologies
                            (native side: K-category LL with precomputed P)
  3 ds1_jc69_ll_grad        the headline (also top-level)
  4 flua_rooted_gradients   strict-clock ratios/root-height gradient pipeline
                            on fluA (native side: JC69 LL+branch-grad at the
                            same shape — no native height-transform exists,
                            so the ratio understates the device side)
  5 vbpi_step_ds1           JitVBPI step time, ms (reference publishes no
                            counterpart number: vs_baseline null)
  6 forest_shared_ds1_100   split-keyed forest evaluation of the 100-topology
                            collection (LL+grad and LL-only), vs the native
                            baseline evaluating the same trees one by one —
                            the reference's mechanism (fat_beagle.hpp:119-149)

Parity gates run on the SAME engines being timed (f32) before any
throughput is printed; a red gate withholds the headline and exits nonzero,
and so does a config that raises.

`python bench.py --parity` runs only the gate. `--configs a,b` limits the
config list ("headline" = none). `--dp N` runs the dp-sharded JC69
LL+gradient over an N-device mesh and reports scaling efficiency vs the
same path on one device (the >=80% BASELINE.json clause). JAX_PLATFORMS=cpu
with XLA_FLAGS=--xla_force_host_platform_device_count=N runs it on virtual
CPU devices.
"""

import argparse
import json
import os
import sys
import time

import jax
import numpy as np


PYBEAGLE_LIKELIHOODS = np.array([
    -14582.995273982739, -6911.294207416366, -6916.880235529542,
    -6904.016888831189, -6915.055570693576, -6915.50496696512,
    -6910.958836661867, -6909.02639968063, -6912.967861935749,
    -6910.7871105783515,
])

PHYSHER_GRADIENTS = np.array([
    -904.18956, -607.70500, -562.36274, -553.63315, -542.26058, -539.64210,
    -463.36511, -445.32555, -414.27197, -412.84218, -399.15359, -342.68038,
    -306.23644, -277.05392, -258.73681, -175.07391, -171.59627, -168.57646,
    -150.57623, -145.38176, -115.15798, -94.86412, -83.02880, -80.09165,
    -69.00574, -51.93337, 0.00000, 0.00000, 16.17497, 20.47784,
    58.06984, 131.18998, 137.10799, 225.73617, 233.92172, 253.49785,
    255.52967, 259.90378, 394.00504, 394.96619, 396.98933, 429.83873,
    450.71566, 462.75827, 471.57364, 472.83161, 514.59289, 650.72575,
    888.87834, 913.96566, 927.14730, 959.10746, 2296.55028,
])

PHYSHER_WEIBULL_LIKELIHOODS = np.array([
    -9456.1201098061, -6624.4110704332, -6623.4474776131, -6617.25658038029,
    -6627.5385571548, -6621.6155048722, -6622.3314942713, -6618.7695717585,
    -6616.3837517370, -6623.8295828648,
])

HELLO_LL = -84.852358  # unrooted_sbn_instance.hpp:206-214

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


# -- timing helper -----------------------------------------------------------
def timed_evals_per_sec(run, n_evals, windows=3, target_s=2.0):
    """Best-of-N-windows throughput: each window queues a fixed number of
    launches and ends in jax.block_until_ready on the last result."""
    jax.block_until_ready(run())  # compile + warmup (never timed)
    t0 = time.perf_counter()
    jax.block_until_ready(run())
    per = time.perf_counter() - t0
    iters = max(8, min(400, int(target_s / max(per, 1e-4))))
    best = 0.0
    for _ in range(windows):
        t0 = time.perf_counter()
        out = None
        for _ in range(iters):
            out = run()
        jax.block_until_ready(out)
        dt = time.perf_counter() - t0
        best = max(best, n_evals * iters / dt)
    return best


def tile_to(a, B):
    reps = B // a.shape[0] + 1
    return np.tile(a, (reps,) + (1,) * (a.ndim - 1))[:B]


# -- data loading ------------------------------------------------------------
def load_newick(newick_name, fasta_name):
    from libsbn_tpu.core.site_pattern import SitePattern
    from libsbn_tpu.io import newick
    from libsbn_tpu.io.fasta import Alignment

    path = f"{DATA}/{newick_name}"
    if newick_name.endswith(".t"):
        tops, bls, ttm = newick.parse_nexus_file(path)
    else:
        tops, bls, ttm = newick.parse_newick_file(path)
    sp = SitePattern(Alignment.read_fasta(f"{DATA}/{fasta_name}"), ttm)
    return tops, bls, sp


# -- parity gate (headline engine) ------------------------------------------
def check_parity(ge, sched, bl, sp):
    """Golden-number asserts on the JC69 LL+gradient bench.py times (f32,
    the implementation ops/pruning_jc.py selects)."""
    import jax.numpy as jnp

    from libsbn_tpu.models.phylo_model import (
        PhyloModelSpec, default_parameters, model_tensors,
    )
    from libsbn_tpu.ops import pruning_jc

    bl_p = np.pad(bl, ((0, 0), (0, 1))).astype(np.float32)
    fn, _ = ge.entry()
    ll, grad = jax.jit(fn)(np.asarray(sched.post_children), jnp.asarray(bl_p))
    ll = np.asarray(ll)
    grad = np.asarray(grad)
    np.testing.assert_allclose(
        ll, PYBEAGLE_LIKELIHOODS, rtol=1e-5, atol=0.5,
        err_msg="DS1 LLs vs pybeagle",
    )
    mine = np.sort(
        np.concatenate([np.asarray(grad[-1][: sched.node_count - 1]), [0.0, 0.0]])
    )
    np.testing.assert_allclose(
        mine, PHYSHER_GRADIENTS, rtol=2e-2, atol=0.5,
        err_msg="DS1 last-tree branch gradient vs physher",
    )

    # K-category path: Weibull+4 (shape 0.1) LLs vs physher.
    spec = PhyloModelSpec("JC69", "weibull+4", "strict")
    params = default_parameters(spec)
    params["site"] = {"shape": jnp.asarray(0.1, jnp.float32)}
    _, _, _, _, rates, props, _ = model_tensors(spec, params)
    ll_w, _ = pruning_jc.log_likelihood_and_branch_gradient_jc69(
        np.asarray(sched.post_children), jnp.asarray(bl_p),
        sp.tip_partials(np.float32), sp.weights.astype(np.float32),
        root_id=sched.root_id, rates=jnp.asarray(rates, jnp.float32),
        props=jnp.asarray(props, jnp.float32),
    )
    np.testing.assert_allclose(
        np.asarray(ll_w), PHYSHER_WEIBULL_LIKELIHOODS, rtol=1e-5, atol=0.5,
        err_msg="DS1 Weibull+4 LLs vs physher (K-category path)",
    )


# -- native baselines --------------------------------------------------------
def native_baseline_ll_grad(schd, bl_node, tips, weights, ll_only=False):
    """evals/s of the native BEAGLE-grade CPU path at this exact shape
    (f32, all cores)."""
    from libsbn_tpu.utils import cpu_baseline

    run = lambda: cpu_baseline.eval_batch(  # noqa: E731
        schd["post_children"], schd["up_node"], schd["up_parent"],
        schd["up_sibs"], bl_node, tips, weights, schd["leaf_count"],
        threads=0, dtype_bits=32, ll_only=ll_only,
    )
    run()  # warmup
    B = bl_node.shape[0]
    best = 0.0
    for _ in range(4):
        t0 = time.time()
        iters = 0
        while time.time() - t0 < 1.0:
            run()
            iters += 1
        best = max(best, B * iters / (time.time() - t0))
    return best


def native_baseline_ll_pk(post_children, P, tips, weights, props, freqs,
                          leaf_count):
    from libsbn_tpu.utils import cpu_baseline

    run = lambda: cpu_baseline.eval_batch_ll_pk(  # noqa: E731
        post_children, P, tips, weights, props, freqs, leaf_count
    )
    run()
    B = post_children.shape[0]
    best = 0.0
    for _ in range(4):
        t0 = time.time()
        iters = 0
        while time.time() - t0 < 1.0:
            run()
            iters += 1
        best = max(best, B * iters / (time.time() - t0))
    return best


def batched_sched_dicts(sch, B):
    return {
        "post_children": tile_to(np.asarray(sch.post_children), B),
        "up_node": tile_to(np.asarray(sch.up_node), B),
        "up_parent": tile_to(np.asarray(sch.up_parent), B),
        "up_sibs": tile_to(np.asarray(sch.up_sibs), B),
        "leaf_count": sch.leaf_count,
    }


# -- configs -----------------------------------------------------------------
def config_hello_ll():
    """BASELINE config 1: single-tree JC69 LL on hello, LL-only both sides."""
    import jax
    import jax.numpy as jnp

    from libsbn_tpu.ops import pruning, schedule, substitution

    tops, bls, sp = load_newick("hello.nwk", "hello.fasta")
    sch = schedule.schedules_of_topologies(tops)
    B = 32768  # a 3-taxon eval is ~1k FLOPs: huge batches amortize dispatch
    rng = np.random.default_rng(0)
    bl0 = np.pad(np.stack(bls), ((0, 0), (0, 1)))
    blp = tile_to(bl0, B) * rng.uniform(0.8, 1.2, (B, bl0.shape[1]))
    blp[:, -1] = 0.0
    blp = blp.astype(np.float32)

    freqs, evec, ivec, evals = substitution.jc69_eigen(jnp.float32)
    tips = jnp.asarray(sp.tip_partials(np.float32))
    w = jnp.asarray(sp.weights, jnp.float32)
    rates = jnp.ones((1,), jnp.float32)
    props = jnp.ones((1,), jnp.float32)
    sched5 = tuple(
        jnp.asarray(tile_to(np.asarray(a), B))
        for a in (sch.post_node, sch.post_children, sch.up_node,
                  sch.up_parent, sch.up_sibs)
    )

    def one(s5, b):
        P = pruning.node_transition_matrices(evec, ivec, evals, b, rates)
        return pruning._log_likelihood(
            True, sch.root_id, s5, P, tips, freqs, props, w
        )

    fn = jax.jit(jax.vmap(one, in_axes=((0,) * 5, 0)))
    # Parity on the unperturbed tree (hello golden, f32 tolerance).
    bl1 = jnp.asarray(tile_to(bl0, B).astype(np.float32))
    ll1 = float(np.asarray(fn(sched5, bl1))[0])
    assert abs(ll1 - HELLO_LL) < 1e-3, (ll1, HELLO_LL)
    bl_d = jax.device_put(jnp.asarray(blp))
    evals_s = timed_evals_per_sec(lambda: fn(sched5, bl_d), B)
    base = native_baseline_ll_grad(
        batched_sched_dicts(sch, 512), tile_to(bl0, 512).astype(np.float64),
        sp.tip_partials(), sp.weights, ll_only=True,
    )
    return {
        "value": round(evals_s, 1), "unit": "LL evals/sec",
        "vs_baseline": round(evals_s / base, 2),
        "baseline_evals_per_sec": round(base, 1),
        "note": f"hello {sch.leaf_count} taxa, {sp.weights.shape[0]} patterns"
                "; LL-only both sides; parity: hello golden @1e-3 (f32); "
                "dispatch-bound microworkload (a 3-taxon eval is ~1k FLOPs) "
                "— the ratio reflects per-eval overhead, not kernel "
                "throughput; see ds1/forest configs for compute-bound rates",
    }


def config_gtr_weibull4_ll():
    """BASELINE config 2: batched GTR+4-category likelihood over
    DS1.100_topologies (site family: discretized Weibull, the reference's
    4-category model, site_model.hpp:84-108)."""
    import jax
    import jax.numpy as jnp

    from libsbn_tpu.models.phylo_model import (
        PhyloModelSpec, default_parameters, model_tensors,
    )
    from libsbn_tpu.ops import pruning, schedule

    tops, bls, sp = load_newick("DS1.100_topologies.nwk", "DS1.fasta")
    sch = schedule.schedules_of_topologies(tops)
    B = 256
    bl0 = np.pad(np.stack(bls), ((0, 0), (0, 1)))
    blp = tile_to(bl0, B).astype(np.float32)

    spec = PhyloModelSpec("GTR", "weibull+4", "strict")
    params = default_parameters(spec)
    params["site"] = {"shape": jnp.asarray(0.5, jnp.float64)}
    freqs, evec, ivec, evals, rates, props, Q = model_tensors(spec, params)
    f32 = lambda a: jnp.asarray(a, jnp.float32)  # noqa: E731
    freqs32, evec32, ivec32, evals32, rates32, props32 = map(
        f32, (freqs, evec, ivec, evals, rates, props)
    )
    tips = jnp.asarray(sp.tip_partials(np.float32))
    w = jnp.asarray(sp.weights, jnp.float32)
    post_children = jnp.asarray(tile_to(np.asarray(sch.post_children), B))
    post_node = jnp.asarray(tile_to(np.asarray(sch.post_node), B))

    def one(pn, pc, b):
        P = pruning.node_transition_matrices(
            evec32, ivec32, evals32, b, rates32
        )
        M, logscale = pruning._postorder_m(pn, pc, P, tips, True)
        site = pruning._root_site_likelihoods(
            M, sch.root_id, freqs32, props32
        )
        return jnp.sum(w * (jnp.log(site) + logscale))

    fn = jax.jit(jax.vmap(one))
    bl_d = jax.device_put(jnp.asarray(blp))
    ll = np.asarray(fn(post_node, post_children, bl_d))
    evals_s = timed_evals_per_sec(
        lambda: fn(post_node, post_children, bl_d), B
    )

    # Native denominator: same model via precomputed P tensors (f64).
    Bn = 100
    P_host = np.stack([
        np.asarray(pruning.node_transition_matrices(
            jnp.asarray(evec), jnp.asarray(ivec), jnp.asarray(evals),
            jnp.asarray(b), jnp.asarray(rates),
        ))
        for b in tile_to(bl0, Bn)
    ])
    pk_args = (
        tile_to(np.asarray(sch.post_children), Bn), P_host,
        sp.tip_partials(), sp.weights, np.asarray(props, np.float64),
        np.asarray(freqs, np.float64), sch.leaf_count,
    )
    base = native_baseline_ll_pk(*pk_args)
    # Parity: f32 device LLs vs the f64 native LLs on the same inputs.
    from libsbn_tpu.utils import cpu_baseline

    ll64 = cpu_baseline.eval_batch_ll_pk(*pk_args)
    np.testing.assert_allclose(ll[:Bn], ll64, rtol=1e-5, atol=0.5)
    return {
        "value": round(evals_s, 1), "unit": "LL evals/sec",
        "vs_baseline": round(evals_s / base, 2),
        "baseline_evals_per_sec": round(base, 1),
        "note": "GTR+Weibull-4 over 100 distinct topologies (tiled to 256);"
                " LL-only scan engine, shape-matched to the LL-only native"
                " denominator; parity: f32 device vs f64 native @0.5/1e-5",
    }


def _batched_like(sch, B):
    from libsbn_tpu.ops.schedule import BatchedSchedule

    return BatchedSchedule(
        node_count=sch.node_count,
        leaf_count=sch.leaf_count,
        root_id=sch.root_id,
        post_node=tile_to(np.asarray(sch.post_node), B),
        post_children=tile_to(np.asarray(sch.post_children), B),
        up_node=tile_to(np.asarray(sch.up_node), B),
        up_parent=tile_to(np.asarray(sch.up_parent), B),
        up_sibs=tile_to(np.asarray(sch.up_sibs), B),
        parent=tile_to(np.asarray(sch.parent), B),
        node_sibs=tile_to(np.asarray(sch.node_sibs), B),
        pre_internal_node=tile_to(np.asarray(sch.pre_internal_node), B),
        pre_internal_parent=tile_to(np.asarray(sch.pre_internal_parent), B),
    )


def config_flua_rooted_gradients():
    """BASELINE config 4: rooted strict-clock node-height gradients on fluA
    (ratios/root-height + clock + Jacobian chain, the
    rooted_gradient_transforms pipeline)."""
    import jax

    from libsbn_tpu.core.site_pattern import SitePattern
    from libsbn_tpu.core.tree import RootedTreeCollection
    from libsbn_tpu.io import newick
    from libsbn_tpu.io.fasta import Alignment
    from libsbn_tpu.models.engine import LikelihoodEngine
    from libsbn_tpu.models.phylo_model import (
        PhyloModelSpec, default_parameters,
    )
    from libsbn_tpu.ops import schedule

    tops, bls, ttm = newick.parse_newick_file(f"{DATA}/fluA.tree")
    from libsbn_tpu.core.tree import RootedTree

    coll = RootedTreeCollection(
        [RootedTree(t, b) for t, b in zip(tops, bls)], ttm
    )
    coll.parse_dates_from_taxon_names(True)
    sp = SitePattern(Alignment.read_fasta(f"{DATA}/fluA.fa"), ttm)
    sch = schedule.schedules_of_topologies([t.topology for t in coll.trees])
    B = 256
    bounds = tile_to(np.stack([t.node_bounds for t in coll.trees]), B)
    ratios = tile_to(
        np.stack([t.height_ratios for t in coll.trees]), B
    ).copy()
    n_edges = coll.trees[0].node_count() - 1
    rates = np.full((B, n_edges), 0.001)
    rng = np.random.default_rng(0)
    ratios[:, :-1] = np.clip(
        ratios[:, :-1] * rng.uniform(0.95, 1.05, ratios[:, :-1].shape),
        1e-4, 1 - 1e-4,
    )

    spec = PhyloModelSpec("JC69", "constant", "strict")
    import jax.numpy as jnp

    engine = LikelihoodEngine(sp, spec, dtype=jnp.float32)
    sch_b = _batched_like(sch, B)
    params = default_parameters(spec)

    import jax

    bounds_d = jax.device_put(bounds.astype(np.float32))
    ratios_d = jax.device_put(ratios.astype(np.float32))
    rates_d = jax.device_put(rates.astype(np.float32))
    params = jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.float32), params
    )
    run = lambda: engine.rooted_phylo_gradients(  # noqa: E731
        sch_b, bounds_d, ratios_d, rates_d, params,
    )["ratios_root_height"]
    out = np.asarray(run())
    assert np.all(np.isfinite(out)), "non-finite rooted gradients"
    evals_s = timed_evals_per_sec(run, B)
    # Native denominator at this shape: JC69 LL + branch gradient (the
    # dominant compute; no native height-transform exists).
    bl_node = np.pad(
        np.stack([t.branch_lengths for t in coll.trees]), ((0, 0), (0, 1))
    )
    base = native_baseline_ll_grad(
        batched_sched_dicts(sch, 64), tile_to(bl_node, 64),
        sp.tip_partials(), sp.weights,
    )
    return {
        "value": round(evals_s, 1), "unit": "gradient evals/sec",
        "vs_baseline": round(evals_s / base, 2),
        "baseline_evals_per_sec": round(base, 1),
        "note": "fluA 69 taxa strict clock; ours includes the full "
                "height-ratio/clock/Jacobian chain, the native denominator "
                "is LL+branch-grad only (no native transform exists) — the "
                "ratio understates the device side",
    }


def config_vbpi_step():
    """BASELINE config 5: full VBPI training step on DS1 (SBN + split
    lognormal branch model, VIMCO, 10 particles)."""
    from libsbn_tpu import UnrootedInstance
    from libsbn_tpu.models.phylo_model import PhyloModelSpec
    from libsbn_tpu.vi.jit_step import JitVBPI

    inst = UnrootedInstance("bench")
    inst.read_nexus_file(f"{DATA}/DS1.subsampled_10.t")
    inst.process_loaded_trees()
    inst.train_simple_average()
    inst.read_fasta_file(f"{DATA}/DS1.fasta")
    inst.prepare_for_phylo_likelihood(
        PhyloModelSpec("JC69", "constant", "strict")
    )
    import jax.numpy as jnp

    jv = JitVBPI(inst, particle_count=10, seed=0, dtype=jnp.float32)
    jv.step_many(16)  # warmup/compile (the K=16 window program)
    jax.block_until_ready(jv.state)
    t0 = time.perf_counter()
    for _ in range(4):
        jv.step_many(16)
    jax.block_until_ready(jv.state)
    ms = (time.perf_counter() - t0) / 64 * 1e3
    return {
        "value": round(ms, 2), "unit": "ms/step",
        "vs_baseline": None,
        "note": "10 particles, K=16-window dispatch, VIMCO; the reference "
                "publishes no counterpart (gradient_time is runtime-only, "
                "vip/benchmark.py:63-65)",
    }


def config_gp_ascent_flua():
    """GP coordinate ascent on fluA (69 taxa): the whole branch-length
    ascent — populate, damped Newton sweeps, marginal — as one fused XLA
    program (GPDAG/GPEngine analog, gp_instance.cpp:129-175). Value =
    warm ms per full ascent; no native counterpart is expressible here
    (the reference's Brent-per-edge interpreter has no comparable
    batch form), so vs_baseline is null and the correctness anchor is
    the brute-force-pinned marginal tests (tests/test_gp.py)."""
    import jax

    from libsbn_tpu.gp.instance import GPInstance

    inst = GPInstance("bench-gp")
    inst.read_fasta_file(f"{DATA}/fluA.fa")
    inst.read_newick_file(f"{DATA}/fluA.tree")
    inst.make_engine(dtype=np.float32)
    eng = inst.get_engine()
    bl0 = np.asarray(eng.branch_lengths).copy()
    marginal, iters = eng.run_branch_ascent(1e-2, 10)  # warmup/compile
    assert np.isfinite(marginal)
    t0 = time.time()
    n = 5
    for _ in range(n):
        # Reset to the hot-start lengths so each timed run is a FULL
        # ascent, not a 1-sweep touch-up of converged state.
        eng.branch_lengths = bl0.copy()
        marginal, iters = eng.run_branch_ascent(1e-2, 10)
    ms = (time.time() - t0) / n * 1e3
    del jax
    return {
        "value": round(ms, 1), "unit": "ms/ascent",
        "vs_baseline": None,
        "note": f"fluA 69 taxa, f32, fused device ascent ({int(iters)} "
                "sweeps, tol 1e-2, warm); marginal "
                f"{float(marginal):.3f}; correctness: brute-force-pinned "
                "GP tests",
    }


def config_forest():
    """Forest (cross-tree sharing) on DS1.100_topologies: split-keyed branch
    lengths (the GP-hot-start regime), vs the native baseline evaluating the
    same trees one at a time (the reference's per-tree mechanism)."""
    import jax
    import jax.numpy as jnp

    from libsbn_tpu.ops import forest, schedule
    from libsbn_tpu.ops.forest import _clade_mask

    tops, bls, sp = load_newick("DS1.100_topologies.nwk", "DS1.fasta")
    for t in tops:
        t.polish()
    t0 = time.time()
    fs = forest.build_forest(tops)
    build_s = time.time() - t0
    stats = forest.forest_stats(fs)

    # Split-keyed lengths: per-split mean of the observed per-tree lengths
    # (exactly HotStartBranchLengths, gp_engine.cpp:363-394).
    sums = np.zeros(fs.n_splits)
    counts = np.zeros(fs.n_splits)
    for top, bl in zip(tops, bls):
        for node in top.postorder():
            if node.id == top.id:
                continue
            idx = fs.split_of_clade[_clade_mask(node)]
            sums[idx] += bl[node.id]
            counts[idx] += 1
    bl_splits = sums / np.maximum(counts, 1)

    R = 8
    rng = np.random.default_rng(0)
    bl_sets = (
        bl_splits[None, :] * rng.uniform(0.8, 1.2, (R, fs.n_splits))
    ).astype(np.float32)
    tips = jnp.asarray(sp.tip_partials(np.float32))
    w = jnp.asarray(sp.weights, jnp.float32)

    # Timed full-gradient path: bf16 gathers in the (bandwidth-bound)
    # up/edge phase; the parity gate below runs on THIS path.
    fn_full = jax.jit(jax.vmap(
        lambda b: forest.forest_jc_log_likelihoods_and_gradients(
            fs, b, tips, w, gather_dtype=jnp.bfloat16
        )
    ))
    fn_ll = jax.jit(jax.vmap(
        lambda b: forest.forest_jc_log_likelihoods_and_gradients(
            fs, b, tips, w, ll_only=True
        )[0]
    ))
    bl_d = jax.device_put(jnp.asarray(bl_sets))
    ll_f, grad_f = fn_full(bl_d)
    ll_f, grad_f = np.asarray(ll_f), np.asarray(grad_f)

    # Native per-tree workload: the same T*R evaluations.
    sch = schedule.schedules_of_topologies(tops)
    T = len(tops)
    bl_node = np.zeros((R * T, sch.node_count + 1))
    for r in range(R):
        for ti, top in enumerate(tops):
            bl_node[r * T + ti, :-1] = fs.tree_branch_lengths(top, bl_sets[r])
    schd = batched_sched_dicts(sch, R * T)
    base_full = native_baseline_ll_grad(
        schd, bl_node, sp.tip_partials(), sp.weights
    )
    base_ll = native_baseline_ll_grad(
        schd, bl_node, sp.tip_partials(), sp.weights, ll_only=True
    )

    # Parity: forest f32 on-device vs the f64 native path, same inputs.
    from libsbn_tpu.utils import cpu_baseline

    ll64, grad64 = cpu_baseline.eval_batch(
        schd["post_children"][:T], schd["up_node"][:T], schd["up_parent"][:T],
        schd["up_sibs"][:T], bl_node[:T], sp.tip_partials(), sp.weights,
        sch.leaf_count,
    )
    np.testing.assert_allclose(ll_f[0], ll64, rtol=1e-5, atol=0.5)
    np.testing.assert_allclose(
        grad_f[0], grad64[:, : sch.node_count - 1], rtol=2e-2, atol=0.5
    )

    full = timed_evals_per_sec(lambda: fn_full(bl_d), R * T)
    ll_only = timed_evals_per_sec(lambda: fn_ll(bl_d), R * T)
    # Split-keyed optimization surface: one reverse pass aggregates the
    # whole collection's gradient onto the split vector.
    fn_opt = jax.jit(jax.vmap(
        lambda b: forest.forest_jc_weighted_ll_and_split_gradient(
            fs, b, tips, w
        )
    ))
    opt = timed_evals_per_sec(lambda: fn_opt(bl_d), R * T)

    # SBN-sampled 1000-tree support: the regime fixed-support consumers
    # actually see (sampled topologies concentrate, so subtree sharing
    # GROWS with the collection — 7.2x down sharing at T=100 -> ~18x at
    # T=1000). The native per-eval rate is shape-invariant, so the same
    # denominators apply.
    from libsbn_tpu import UnrootedInstance

    inst_s = UnrootedInstance("forest-sampled")
    inst_s.read_newick_file(f"{DATA}/DS1.100_topologies.nwk")
    inst_s.process_loaded_trees()
    inst_s.train_simple_average()
    inst_s.sample_trees(1000)
    tops_s = [t.topology for t in inst_s.tree_collection.trees]
    for t in tops_s:
        if t.id < 0:
            t.polish()
    fs_s = forest.build_forest(tops_s)
    bl_s = jax.device_put(jnp.asarray(
        np.random.default_rng(1).uniform(
            0.02, 0.2, (R, fs_s.n_splits)
        ).astype(np.float32)
    ))
    fn_ll_s = jax.jit(jax.vmap(
        lambda b: forest.forest_jc_log_likelihoods_and_gradients(
            fs_s, b, tips, w, ll_only=True
        )[0]
    ))
    fn_opt_s = jax.jit(jax.vmap(
        lambda b: forest.forest_jc_weighted_ll_and_split_gradient(
            fs_s, b, tips, w
        )
    ))
    n_ev_s = R * len(tops_s)
    ll_only_s = timed_evals_per_sec(lambda: fn_ll_s(bl_s), n_ev_s)
    opt_s = timed_evals_per_sec(lambda: fn_opt_s(bl_s), n_ev_s)
    down_sharing = (
        1000 * (fs_s.node_count - fs_s.leaf_count)
        / (fs_s.n_down - fs_s.leaf_count)
    )
    return {
        "value": round(full, 1), "unit": "LL+grad evals/sec",
        "vs_baseline": round(full / base_full, 2),
        "baseline_evals_per_sec": round(base_full, 1),
        "ll_only_evals_per_sec": round(ll_only, 1),
        "ll_only_vs_baseline": round(ll_only / base_ll, 2),
        "ll_only_baseline_evals_per_sec": round(base_ll, 1),
        "ll_plus_split_grad_evals_per_sec": round(opt, 1),
        "ll_plus_split_grad_vs_baseline": round(opt / base_full, 2),
        "sampled1000_ll_only_evals_per_sec": round(ll_only_s, 1),
        "sampled1000_ll_only_vs_baseline": round(ll_only_s / base_ll, 2),
        "sampled1000_split_grad_evals_per_sec": round(opt_s, 1),
        "sampled1000_split_grad_vs_baseline": round(opt_s / base_full, 2),
        "sampled1000_down_sharing": round(down_sharing, 1),
        "schedule_build_seconds": round(build_s, 3),
        "op_sharing": round(stats["op_sharing"], 2),
        "note": "100 distinct MCMC topologies x 8 split-keyed bl sets; "
                "fused rolling-block up pass, bf16 gradient-phase gathers; "
                "parity: timed engine vs f64 native @0.5/1e-5 (LL), 2e-2 "
                "(grad); the one-off schedule build "
                f"({build_s * 1e3:.0f} ms) amortizes over launches. "
                "sampled1000_*: the same surfaces over 1000 SBN-sampled "
                "topologies (subtree sharing grows with support "
                "concentration; native per-eval rate is shape-invariant)",
    }


# -- dp-sharded mode ---------------------------------------------------------
def run_dp(n_devices, B=512):
    """DP-sharded DS1 JC69 LL+gradient over an n-device mesh + scaling
    efficiency vs one device of the same platform (the BASELINE.json >=80%
    clause), on the implementation ops/pruning_jc.py selects."""
    from libsbn_tpu.ops import pruning_jc, schedule
    from libsbn_tpu.parallel.sharding import make_mesh

    devs = jax.devices()
    if len(devs) < n_devices:
        raise SystemExit(
            f"--dp {n_devices} needs {n_devices} devices; this process sees "
            f"{len(devs)} ({devs[0].platform}). For a virtual mesh run with "
            "JAX_PLATFORMS=cpu XLA_FLAGS="
            "--xla_force_host_platform_device_count=N."
        )
    tops, bls, sp = load_newick("DS1.subsampled_10.t", "DS1.fasta")
    sch = schedule.schedules_of_topologies(tops)
    rng = np.random.default_rng(0)
    bl0 = np.pad(np.stack(bls), ((0, 0), (0, 1)))
    pc = tile_to(np.asarray(sch.post_children), B).astype(np.int32)
    blp = (tile_to(bl0, B) * rng.uniform(0.8, 1.2, (B, bl0.shape[1]))).astype(
        np.float32
    )
    blp[:, -1] = 0.0
    tips = sp.tip_partials(np.float32)
    w = sp.weights.astype(np.float32)

    def throughput(dp):
        mesh = make_mesh(dp, dp=dp, sp=1)
        run = lambda: (  # noqa: E731
            pruning_jc.log_likelihood_and_branch_gradient_jc69_sharded(
                mesh, pc, blp, tips, w, root_id=sch.root_id
            )
        )
        return timed_evals_per_sec(run, B, windows=2)

    one = throughput(1)
    n = throughput(n_devices)
    eff = n / (n_devices * one)
    print(json.dumps({
        "metric": f"DS1 loglik+gradient evals/sec, dp={n_devices} "
                  f"({devs[0].platform}, {devs[0].device_kind})",
        "value": round(n, 1),
        "unit": "evals/sec",
        "vs_baseline": round(eff, 3),
        "dp1_evals_per_sec": round(one, 1),
        "scaling_efficiency": round(eff, 3),
        "note": "vs_baseline = scaling efficiency vs 1 device x N "
                "(BASELINE.json >=80% clause)",
    }))


# -- headline ----------------------------------------------------------------
def measure_cpu_baseline(sched, bl_p, sp):
    """Throughput of the native CPU path on this host (f32, all cores), on
    the exact bench workload (bl_p: the (B, N+1) padded branch lengths)."""
    B = bl_p.shape[0]
    rng = np.random.default_rng(0)
    blb = bl_p.astype(np.float64) * rng.uniform(0.8, 1.2, bl_p.shape)
    blb[:, -1] = 0.0
    blb[:, sched.root_id] = 0.0  # root slot
    return native_baseline_ll_grad(
        batched_sched_dicts(sched, B), blb, sp.tip_partials(), sp.weights
    )


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--parity", action="store_true")
    parser.add_argument("--dp", type=int, default=0)
    parser.add_argument("--configs", default="all")
    opts = parser.parse_args()

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import __graft_entry__ as ge

    if opts.dp:
        run_dp(opts.dp)
        return

    fn, (post_children, bl0) = ge.entry()
    sched, bl, sp = ge._load_ds1()
    B = 512  # topologies per launch
    rng = np.random.default_rng(0)
    post_children = tile_to(post_children, B)
    bl0 = tile_to(bl0, B)
    blp = (bl0 * rng.uniform(0.8, 1.2, bl0.shape)).astype(np.float32)

    # Parity gate on the path being timed (f32 golden asserts).
    try:
        check_parity(ge, sched, np.asarray(bl), sp)
        parity = "pass"
    except AssertionError as exc:
        parity = "fail: " + " ".join(str(exc).split())[:160]
    if opts.parity:
        print(json.dumps({"metric": "parity", "value": parity}))
        sys.exit(0 if parity == "pass" else 1)

    if parity != "pass":
        # Hard gate: a red parity check must never ship as a perf headline.
        # No throughput number, nonzero exit.
        print(
            json.dumps(
                {
                    "metric": "PARITY FAILURE — throughput withheld",
                    "value": 0.0,
                    "unit": "evals/sec",
                    "vs_baseline": 0.0,
                    "parity": parity,
                }
            )
        )
        sys.exit(1)

    # Device-resident inputs: in production (VI loops) branch lengths and
    # schedules live on the device.
    jfn = jax.jit(fn)
    pc_d, bl_d = jax.device_put(post_children), jax.device_put(blp)
    evals_per_sec = timed_evals_per_sec(lambda: jfn(pc_d, bl_d), B,
                                        target_s=4.0)

    # Baseline: the native CPU stand-in for BEAGLE on this host.
    cpu = measure_cpu_baseline(sched, bl0, sp)

    wanted = opts.configs.split(",") if opts.configs != "all" else [
        "hello_jc69_ll", "gtr_weibull4_ll_ds1_100", "flua_rooted_gradients",
        "vbpi_step_ds1", "forest_shared_ds1_100", "gp_ascent_flua",
    ]
    runners = {
        "hello_jc69_ll": config_hello_ll,
        "gtr_weibull4_ll_ds1_100": config_gtr_weibull4_ll,
        "flua_rooted_gradients": config_flua_rooted_gradients,
        "vbpi_step_ds1": config_vbpi_step,
        "forest_shared_ds1_100": config_forest,
        "gp_ascent_flua": config_gp_ascent_flua,
    }
    configs = {
        "ds1_jc69_ll_grad": {
            "value": round(evals_per_sec, 1), "unit": "evals/sec",
            "vs_baseline": round(evals_per_sec / cpu, 2),
            "baseline_evals_per_sec": round(cpu, 1),
            "note": "the headline (BASELINE config 3)",
        }
    }
    failed = []
    for name in wanted:
        if name in ("headline", "none", ""):
            continue
        try:
            configs[name] = runners[name]()
        except Exception as exc:  # noqa: BLE001 - reported, then exit 1
            configs[name] = {"error": f"{type(exc).__name__}: {exc}"[:200]}
            failed.append(name)

    from libsbn_tpu.utils import cpu_baseline

    dev = jax.devices()[0]
    print(
        json.dumps(
            {
                "metric": (
                    "DS1 loglik+gradient evals/sec "
                    "(27 taxa, 934 patterns, f32)"
                ),
                "value": round(evals_per_sec, 1),
                "unit": "evals/sec",
                "vs_baseline": round(evals_per_sec / cpu, 2),
                "baseline_evals_per_sec": round(cpu, 1),
                "baseline_provenance": (
                    "native/cpu_baseline.cpp f32, -O3 -march=native, "
                    f"{cpu_baseline.threads()} host threads, "
                    "golden-verified; measured this run"
                ),
                "device": {
                    "platform": dev.platform, "kind": dev.device_kind,
                    "count": len(jax.devices()),
                },
                "parity": parity,
                "configs": configs,
            }
        )
    )
    if failed:
        sys.exit(1)


if __name__ == "__main__":
    main()
