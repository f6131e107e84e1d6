#!/usr/bin/env python3
"""Smoke run of the main paths on the GPU, checked against goldens and the
plain f64 reference.

    python chip_smoke.py               # one card: every phase below
    python chip_smoke.py --devices 4   # four cards: the multi-device paths

One card, each phase through the instance / JitVBPI / GPInstance API in
float32, at the full width of the data sets the reference tests with:

  ds1        UnrootedInstance, DS1 (27 taxa, 934 patterns), JC69: LLs vs
             the pybeagle goldens, last-tree branch gradient vs physher;
             then the bench shape (512 perturbed trees)
  weibull    JC69+Weibull-4 LLs vs the physher goldens, GTR+Weibull-4 LLs
             over DS1.100_topologies
  flua       RootedInstance, fluA (69 taxa) strict clock: LL + log-det-
             Jacobian and the 67 ratio/root-height gradients (hand chain
             rule) vs physher; then 64 trees; GTR and Weibull-4 goldens
  vbpi       JitVBPI on DS1, 10 particles: 20 step() calls, then step_many
  forest     split-keyed forest over DS1.100_topologies vs the per-tree
             engine
  gp         GPInstance: hello marginal golden; fluA Newton branch
             ascent to convergence
  gpu_tests  the tests marked gpu (tests/test_pallas.py)
  hello_f64  the hello LL in float64 on the card, vs the golden at 1e-6

The plain reference is the float64 scan engine (ops/pruning.py) run in
this process on the CPU device. Four cards (--devices 4): the VBPI step on
a dp=2 x sp=2 mesh, the GP engine sharded sp=4, the dp-sharded rooted fluA
chain, the dp-sharded JC69 kernel wrapper, and the forest (DS1.100) over
dp-sharded branch-length sets, each against the same computation on one
card.

The script needs a GPU and exits nonzero without one. Its last line is
one JSON object; every earlier line reports a set-up step or a phase. A
failed check raises, and the script exits nonzero.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(HERE, "data")

# -- tolerances ---------------------------------------------------------------
# Goldens (pybeagle / physher, computed in f64 by other programs): f32
# carries ~7 significant digits, and an LL of ~1e4 sums ~1e3 per-pattern
# logs, so LLs are held to atol 0.5 (about 5e-5 relative, BASELINE.md
# policy) and gradients to rtol 2e-2 plus atol 0.5 (the goldens' own
# finite-difference and rounding error).
GOLDEN_LL_ATOL = 0.5
GOLDEN_GRAD_RTOL = 2e-2
GOLDEN_GRAD_ATOL = 0.5
# The same computation in f64 on the CPU: the card's f32 result differs by
# f32 rounding accumulated over ~50 levels of partial products and ~1e3
# patterns. Each bound is relative to the largest magnitude compared and
# sits 4-10x above the larger of two readings on an H100 (in brackets:
# max|err| / max|reference| of those runs).
# LLs, one rate category, unrooted [DS1 9.5e-8, B=512 1.9e-7, VBPI 3.9e-8,
# forest 9.0e-8].
REF_LL_RTOL = 1e-6
# LLs summed over four rate categories or with the rooted log|J| [JC69 and
# GTR Weibull-4 1.6e-6 and 2.4e-7, fluA 1.9e-6, fluA B=64 1.2e-6].
REF_LL_LONG_RTOL = 1e-5
# JC69 branch gradients [DS1 3.0e-5, B=512 4.8e-5, Weibull-4 1.5e-5].
REF_GRAD_RTOL = 2e-4
# Forest branch gradients: one shared pass per unique edge [2.0e-7]; the
# bound leaves room for a changed fusion order.
FOREST_GRAD_RTOL = 5e-6
# Weibull shape gradient: a sum over every pattern and category [7.3e-5].
SHAPE_GRAD_RTOL = 5e-4
# Rooted ratio/root-height gradients: the heights chain rule runs in f32 on
# differences of node heights, so f32 cancellation dominates [fluA 1.1e-4,
# fluA B=64 with perturbed ratios 2.6e-3; the same on the CPU in f32].
ROOTED_GRAD_RTOL = 1e-3
ROOTED_B64_GRAD_RTOL = 1e-2
# The strict-clock rate gradient [fluA 1.1e-5, fluA B=64 1.5e-5].
CLOCK_GRAD_RTOL = 1e-4
# GP: f32 and f64 Newton ascents stop after different sweep counts (8 vs 12
# on fluA) [converged marginals 3.8e-7].
GP_MARGINAL_RTOL = 2e-6
# hello in f64 on the card: the reference's own 1e-6 golden tolerance.
HELLO_F64_ATOL = 1e-6
# Several cards vs one: identical inputs, only the reduction order of the
# pattern-axis psums and the batch split differ [four H100s, one run: VBPI
# 1.2e-7, GP 2.3e-7].
SHARD_RTOL = 1e-5

BENCH_TREES = 512  # the bench shape of the DS1 headline
FLUA_TREES = 64  # the bench shape of the rooted-gradient cell

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


def log(msg):
    print(msg, flush=True)


def check(name, got, want, atol=0.0, rtol=0.0):
    """Assert max|got - want| <= atol + rtol * max|want|, and print it."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, f"{name}: shape {got.shape} != {want.shape}"
    assert np.all(np.isfinite(got)), f"{name}: non-finite values"
    err = float(np.max(np.abs(got - want)))
    bound = atol + rtol * float(np.max(np.abs(want)))
    log(f"  {name}: max|err| {err:.3e} (bound {bound:.3e})")
    assert err <= bound, f"{name}: max|err| {err:.3e} > bound {bound:.3e}"


def cpu_device():
    import jax

    return jax.devices("cpu")[0]


def f32_params(params):
    import jax
    import jax.numpy as jnp

    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32), params)


def f32_engine(inst, spec):
    """An f32 LikelihoodEngine over the instance's alignment and taxa; the
    instance API then runs on it."""
    import jax.numpy as jnp

    from libsbn_tpu.core.site_pattern import SitePattern
    from libsbn_tpu.models.engine import LikelihoodEngine

    sp = SitePattern(inst.alignment, inst.tree_collection.tag_taxon_map)
    return LikelihoodEngine(sp, spec, dtype=jnp.float32)


def unrooted_instance(newick_name, fasta_name="DS1.fasta"):
    from libsbn_tpu import UnrootedInstance

    inst = UnrootedInstance("smoke")
    if newick_name.endswith(".t"):
        inst.read_nexus_file(f"{DATA}/{newick_name}")
    else:
        inst.read_newick_file(f"{DATA}/{newick_name}")
    inst.read_fasta_file(f"{DATA}/{fasta_name}")
    return inst


def tile_rows(a, n):
    reps = n // a.shape[0] + 1
    return np.tile(a, (reps,) + (1,) * (a.ndim - 1))[:n]


def batched_like(sch, n):
    from libsbn_tpu.ops.schedule import BatchedSchedule

    fields = (
        "post_node", "post_children", "up_node", "up_parent", "up_sibs",
        "parent", "node_sibs", "pre_internal_node", "pre_internal_parent",
    )
    return BatchedSchedule(
        node_count=sch.node_count, leaf_count=sch.leaf_count,
        root_id=sch.root_id,
        **{f: tile_rows(np.asarray(getattr(sch, f)), n) for f in fields},
    )


# -- one-card phases ------------------------------------------------------------
def phase_ds1():
    import jax
    import jax.numpy as jnp

    from libsbn_tpu.models.engine import LikelihoodEngine
    from libsbn_tpu.models.phylo_model import PhyloModelSpec, default_parameters

    spec = PhyloModelSpec("JC69", "constant", "strict")
    inst = unrooted_instance("DS1.subsampled_10.t")
    inst.prepare_for_phylo_likelihood(spec)
    with jax.default_device(cpu_device()):
        ref_ll = inst.log_likelihoods()
        ref_g = np.asarray(inst.phylo_gradients()["branch_lengths"])
    inst.engine = f32_engine(inst, spec)
    ll = inst.log_likelihoods()
    g = np.asarray(inst.phylo_gradients()["branch_lengths"])
    check("DS1 LLs vs pybeagle", ll, PYBEAGLE_LIKELIHOODS, atol=GOLDEN_LL_ATOL)
    check("DS1 LLs vs f64 reference", ll, ref_ll, rtol=REF_LL_RTOL)
    n = inst.tree_collection.trees[-1].node_count()
    mine = np.sort(np.concatenate([g[-1][: n - 1], [0.0, 0.0]]))
    check(
        "DS1 last-tree gradient vs physher", mine, PHYSHER_GRADIENTS,
        atol=GOLDEN_GRAD_ATOL, rtol=GOLDEN_GRAD_RTOL,
    )
    check("DS1 gradients vs f64 reference", g, ref_g, rtol=REF_GRAD_RTOL)

    # The bench shape: 512 perturbed trees in one launch.
    sch = batched_like(inst._batched_schedule(), BENCH_TREES)
    rng = np.random.default_rng(0)
    bl = tile_rows(inst.branch_length_matrix(), BENCH_TREES)
    bl = bl * rng.uniform(0.8, 1.2, bl.shape)
    params = default_parameters(spec)
    eng = inst.engine
    t0 = time.perf_counter()
    ll_b, g_b = jax.block_until_ready(
        eng.branch_gradients(sch, bl.astype(np.float32), f32_params(params))
    )
    log(f"  bench shape B={BENCH_TREES}: first call (compile) "
        f"{time.perf_counter() - t0:.2f} s")
    with jax.default_device(cpu_device()):
        ref = LikelihoodEngine(eng_site_pattern(inst), spec, dtype=jnp.float64)
        rl, rg = ref.branch_gradients(
            batched_like(inst._batched_schedule(), BENCH_TREES), bl, params
        )
    check(f"DS1 B={BENCH_TREES} LLs vs f64 reference", ll_b, rl,
          rtol=REF_LL_RTOL)
    check(f"DS1 B={BENCH_TREES} gradients vs f64 reference", g_b, rg,
          rtol=REF_GRAD_RTOL)


def eng_site_pattern(inst):
    from libsbn_tpu.core.site_pattern import SitePattern

    return SitePattern(inst.alignment, inst.tree_collection.tag_taxon_map)


def phase_weibull():
    import jax
    import jax.numpy as jnp

    from libsbn_tpu.models.phylo_model import PhyloModelSpec

    # JC69 + Weibull-4 (shape 0.1) on DS1.subsampled_10: physher goldens.
    spec = PhyloModelSpec("JC69", "weibull+4", "strict")
    inst = unrooted_instance("DS1.subsampled_10.t")
    inst.prepare_for_phylo_likelihood(spec)
    inst.phylo_model_params["site"] = {"shape": jnp.asarray(0.1)}
    with jax.default_device(cpu_device()):
        ref_g = inst.phylo_gradients()
    inst.engine = f32_engine(inst, spec)
    ll = inst.log_likelihoods()
    g = inst.phylo_gradients()
    check("JC69+Weibull-4 LLs vs physher", ll, PHYSHER_WEIBULL_LIKELIHOODS,
          atol=GOLDEN_LL_ATOL)
    check("JC69+Weibull-4 LLs vs f64 reference", ll,
          ref_g["log_likelihood"], rtol=REF_LL_LONG_RTOL)
    check("JC69+Weibull-4 branch_lengths gradient vs f64 reference",
          g["branch_lengths"], ref_g["branch_lengths"], rtol=REF_GRAD_RTOL)
    check("JC69+Weibull-4 site_model gradient vs f64 reference",
          g["site_model"], ref_g["site_model"], rtol=SHAPE_GRAD_RTOL)

    # GTR + Weibull-4 (shape 0.5) over the 100 DS1 topologies: LL only.
    spec = PhyloModelSpec("GTR", "weibull+4", "strict")
    inst = unrooted_instance("DS1.100_topologies.nwk")
    inst.prepare_for_phylo_likelihood(spec)
    inst.phylo_model_params["site"] = {"shape": jnp.asarray(0.5)}
    with jax.default_device(cpu_device()):
        ref_ll = inst.log_likelihoods()
    inst.engine = f32_engine(inst, spec)
    ll = inst.log_likelihoods()
    check("GTR+Weibull-4 DS1.100 LLs vs f64 reference", ll, ref_ll,
          rtol=REF_LL_LONG_RTOL)


def flua_instance(spec):
    from libsbn_tpu import RootedInstance

    inst = RootedInstance("smoke-fluA")
    inst.read_newick_file(f"{DATA}/fluA.tree")
    inst.read_fasta_file(f"{DATA}/fluA.fa")
    inst.parse_dates_from_taxon_names(True)
    inst.set_clock_rates(0.001)  # the physher goldens' strict clock rate
    inst.prepare_for_phylo_likelihood(spec)
    return inst


def phase_flua():
    import jax

    import importlib.util

    from libsbn_tpu.models.phylo_model import PhyloModelSpec

    # The physher fluA goldens live with the rooted parity tests.
    path = os.path.join(HERE, "tests", "test_rooted_likelihood.py")
    spec_ = importlib.util.spec_from_file_location("rooted_goldens", path)
    goldens = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(goldens)

    spec = PhyloModelSpec("JC69", "constant", "strict")
    inst = flua_instance(spec)
    with jax.default_device(cpu_device()):
        ref_ll = inst.log_likelihoods()
        ref_g = inst.phylo_gradients()
    inst.engine = f32_engine(inst, spec)
    ll = inst.log_likelihoods()
    g = inst.phylo_gradients()
    check("fluA LL + log|J| vs physher", ll[0],
          goldens.PHYSHER_LL + goldens.PHYSHER_JACOBIAN,
          atol=GOLDEN_LL_ATOL)
    check("fluA LL + log|J| vs f64 reference", ll, ref_ll,
          rtol=REF_LL_LONG_RTOL)
    check("fluA ratio/root-height gradient vs physher",
          np.asarray(g["ratios_root_height"])[0],
          goldens.PHYSHER_RATIO_GRADIENTS,
          atol=GOLDEN_GRAD_ATOL, rtol=GOLDEN_GRAD_RTOL)
    check("fluA hand-chain LLs vs f64 AD reference", g["log_likelihood"],
          ref_g["log_likelihood"], rtol=REF_LL_LONG_RTOL)
    check("fluA hand-chain ratios_root_height vs f64 AD reference",
          g["ratios_root_height"], ref_g["ratios_root_height"],
          rtol=ROOTED_GRAD_RTOL)
    check("fluA hand-chain clock_model vs f64 AD reference",
          g["clock_model"], ref_g["clock_model"], rtol=CLOCK_GRAD_RTOL)

    # The bench shape: 64 trees with perturbed height ratios.
    sched = batched_like(inst._batched_schedule(), FLUA_TREES)
    bounds, ratios, rates = (
        tile_rows(a, FLUA_TREES) for a in inst._time_tree_arrays()
    )
    rng = np.random.default_rng(0)
    ratios = ratios.copy()
    ratios[:, :-1] = np.clip(
        ratios[:, :-1] * rng.uniform(0.95, 1.05, ratios[:, :-1].shape),
        1e-4, 1 - 1e-4,
    )
    params, _ = inst._compute_params()
    out = inst.engine.rooted_phylo_gradients(
        sched, bounds, ratios, rates, f32_params(params)
    )
    ref_inst = flua_instance(spec)
    with jax.default_device(cpu_device()):
        ref = ref_inst.engine.rooted_phylo_gradients(
            batched_like(inst._batched_schedule(), FLUA_TREES), bounds,
            ratios, rates, params,
        )
    check(f"fluA B={FLUA_TREES} LLs vs f64 AD reference",
          out["log_likelihood"], ref["log_likelihood"],
          rtol=REF_LL_LONG_RTOL)
    check(f"fluA B={FLUA_TREES} ratios_root_height vs f64 AD reference",
          out["ratios_root_height"], ref["ratios_root_height"],
          rtol=ROOTED_B64_GRAD_RTOL)
    check(f"fluA B={FLUA_TREES} clock_model vs f64 AD reference",
          out["clock_model"], ref["clock_model"], rtol=CLOCK_GRAD_RTOL)

    # GTR and Weibull-4 on fluA: phylotorch / physher goldens
    # (rooted_sbn_instance.hpp:340-377), LLs without the Jacobian.
    import jax.numpy as jnp

    spec = PhyloModelSpec("GTR", "constant", "strict")
    inst = flua_instance(spec)
    inst.phylo_model_params["substitution"] = {
        "rates": jnp.asarray([0.05, 0.1, 0.15, 0.20, 0.25, 0.25]),
        "frequencies": jnp.asarray([0.1, 0.2, 0.3, 0.4]),
    }
    inst.engine = f32_engine(inst, spec)
    g = inst.phylo_gradients()
    check("fluA GTR LL vs phylotorch", g["log_likelihood"][0],
          -5221.438941335706, atol=GOLDEN_LL_ATOL)
    check("fluA GTR substitution gradient vs phylotorch",
          g["substitution_model"][0],
          [49.06451538, 151.83105912, 26.40235659, -8.25135661,
           75.29759338, 352.56545247, 90.07046995, 30.12301652],
          atol=GOLDEN_GRAD_ATOL, rtol=GOLDEN_GRAD_RTOL)
    spec = PhyloModelSpec("JC69", "weibull+4", "strict")
    inst = flua_instance(spec)
    inst.phylo_model_params["site"] = {"shape": jnp.asarray(0.1)}
    inst.engine = f32_engine(inst, spec)
    g = inst.phylo_gradients()
    check("fluA Weibull-4 LL vs physher", g["log_likelihood"][0],
          -4618.2062529058, atol=GOLDEN_LL_ATOL)
    # The shape gradient is ~5, so its bound is the relative one alone.
    check("fluA Weibull-4 shape gradient vs physher",
          np.asarray(g["site_model"])[0], -5.231329, rtol=GOLDEN_GRAD_RTOL)


def vbpi_instance():
    from libsbn_tpu import UnrootedInstance
    from libsbn_tpu.models.phylo_model import PhyloModelSpec

    inst = UnrootedInstance("smoke-vbpi")
    inst.read_nexus_file(f"{DATA}/DS1.subsampled_10.t")
    inst.process_loaded_trees()
    inst.train_simple_average()
    inst.read_fasta_file(f"{DATA}/DS1.fasta")
    inst.prepare_for_phylo_likelihood(
        PhyloModelSpec("JC69", "constant", "strict")
    )
    return inst


def phase_vbpi():
    import jax
    import jax.numpy as jnp

    from libsbn_tpu.vi.jit_step import JitVBPI, vbpi_train_step_packed

    jv = JitVBPI(vbpi_instance(), particle_count=10, seed=0,
                 dtype=jnp.float32)
    from libsbn_tpu.ops import pruning_jc

    log("  fused JC69 kernel selected: "
        f"{jv.statics.allow_kernel and pruning_jc.use_kernel(jv.dtype)}")
    with jax.default_device(cpu_device()):
        jv_ref = JitVBPI(vbpi_instance(), particle_count=10, seed=0,
                         dtype=jnp.float64)
        ref = float(jv_ref.step()["mean_ll"])
    first = jv.step()
    check("VBPI first-step mean_ll vs f64 reference", first["mean_ll"], ref,
          rtol=REF_LL_RTOL)

    # Device memory of the compiled step, at the shapes step() feeds it.
    sample = jv._host_sample()
    packed, eps, shapes = jv._device_put(*sample)
    compiled = vbpi_train_step_packed.lower(
        jv.state, jv.statics, jv.optimizer, packed, eps,
        jnp.asarray(1.0, jv.dtype), shapes, jv.tips, jv.weights,
        jv.segment_ids,
    ).compile()
    log(f"  VBPI step memory_analysis: {compiled.memory_analysis()}")

    elbos = [float(first["elbo_like"])]
    for _ in range(19):
        elbos.append(float(jv.step()["elbo_like"]))
    many = jv.step_many(16)
    elbos += [float(x) for x in np.asarray(many["elbo_like"])]
    assert np.all(np.isfinite(elbos)), "non-finite ELBO"
    log(f"  ELBO-like over {len(elbos)} steps: first {elbos[0]:.2f}, "
        f"last {elbos[-1]:.2f}, all finite")


def phase_forest():
    import jax
    import jax.numpy as jnp

    from libsbn_tpu.io import newick
    from libsbn_tpu.ops import forest, pruning_jc, schedule

    inst = unrooted_instance("DS1.100_topologies.nwk")
    sp = eng_site_pattern(inst)
    tops, _, _ = newick.parse_newick_file(f"{DATA}/DS1.100_topologies.nwk")
    for t in tops:
        t.polish()
    fs = forest.build_forest(tops)
    rng = np.random.default_rng(3)
    bl_splits = rng.uniform(0.02, 0.2, fs.n_splits)
    tips = sp.tip_partials()
    w = sp.weights
    t0 = time.perf_counter()
    ll_f, g_f = jax.block_until_ready(jax.jit(
        lambda b: forest.forest_jc_log_likelihoods_and_gradients(
            fs, b, jnp.asarray(tips, jnp.float32), jnp.asarray(w, jnp.float32)
        )
    )(jnp.asarray(bl_splits, jnp.float32)))
    log(f"  forest first call (compile) {time.perf_counter() - t0:.1f} s")
    sch = schedule.schedules_of_topologies(tops)
    bl = np.stack([
        np.concatenate([fs.tree_branch_lengths(t, bl_splits), [0.0]])
        for t in tops
    ])
    with jax.default_device(cpu_device()):
        ref_ll, ref_g = pruning_jc.scan_jc69(
            sch.post_children, bl, tips, w, root_id=sch.root_id
        )
    check("forest DS1.100 LLs vs per-tree f64 reference", ll_f, ref_ll,
          rtol=REF_LL_RTOL)
    check("forest DS1.100 gradients vs per-tree f64 reference",
          np.asarray(g_f)[:, : sch.root_id], ref_g, rtol=FOREST_GRAD_RTOL)


def gp_fit(dtype, mesh=None):
    from libsbn_tpu import GPInstance

    inst = GPInstance("smoke-gp")
    inst.read_newick_file(f"{DATA}/fluA.tree")
    inst.read_fasta_file(f"{DATA}/fluA.fa")
    inst.make_engine(dtype=dtype, mesh=mesh)
    marginal, iters = inst.get_engine().run_branch_ascent(1e-6, 100)
    return float(marginal), int(iters)


def phase_gp():
    import jax

    from libsbn_tpu import GPInstance

    # hello with fixed branch lengths: the reference golden
    # (gp_doctest.cpp:89-101); f32 holds an LL of ~85 to ~1e-5 [CPU f32
    # reading 4.3e-6].
    gp = GPInstance("smoke-gp-hello")
    gp.read_fasta_file(f"{DATA}/hello.fasta")
    gp.read_newick_file(f"{DATA}/hello_rooted.nwk")
    gp.make_engine(dtype=np.float32)
    eng = gp.get_engine()
    eng.branch_lengths = np.array([0.0, 0.22, 0.113, 0.15, 0.1], np.float32)
    gp.populate_plvs()
    gp.compute_likelihoods()
    check("GP hello fixed-branch marginal vs golden",
          eng.get_log_marginal_likelihood(), -84.77961943, atol=1e-4)

    marginal, iters = gp_fit(np.float32)
    with jax.default_device(cpu_device()):
        ref, ref_iters = gp_fit(np.float64)
    log(f"  fluA ascent: f32 {iters} sweeps, f64 reference {ref_iters}")
    check("GP fluA converged marginal vs f64 reference", marginal, ref,
          rtol=GP_MARGINAL_RTOL)


def phase_gpu_tests():
    """The tests marked gpu, which skip on machines without a card."""
    import importlib.util

    path = os.path.join(HERE, "tests", "test_pallas.py")
    spec = importlib.util.spec_from_file_location("gpu_tests", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    module.test_fused_kernel_compiled_on_gpu()
    log("  tests/test_pallas.py::test_fused_kernel_compiled_on_gpu passed")


def phase_hello_f64():
    from libsbn_tpu.models.phylo_model import PhyloModelSpec

    inst = unrooted_instance("hello.nwk", "hello.fasta")
    inst.prepare_for_phylo_likelihood(
        PhyloModelSpec("JC69", "constant", "strict")
    )
    check("hello f64 LL on the card vs golden", inst.log_likelihoods()[0],
          HELLO_LL, atol=HELLO_F64_ATOL)


ONE_CARD_PHASES = [
    ("ds1", phase_ds1),
    ("weibull", phase_weibull),
    ("flua", phase_flua),
    ("vbpi", phase_vbpi),
    ("forest", phase_forest),
    ("gp", phase_gp),
    ("gpu_tests", phase_gpu_tests),
    ("hello_f64", phase_hello_f64),
]


# -- multi-device phases ----------------------------------------------------------
def phase_vbpi_mesh(n):
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from libsbn_tpu.ops import pruning_jc
    from libsbn_tpu.parallel.sharding import make_mesh
    from libsbn_tpu.vi.jit_step import JitVBPI

    sp_size = 2
    mesh = make_mesh(n, dp=n // sp_size, sp=sp_size)
    P_count = 40
    jv = JitVBPI(vbpi_instance(), particle_count=P_count, mesh=mesh, seed=0,
                 dtype=jnp.float32)
    # Shard the pattern axis over "sp": pad with zero-weight all-ones
    # columns (numerically inert).
    tips, weights = pruning_jc.pad_patterns(jv.tips, jv.weights, sp_size)
    jv.tips = jax_put(tips, NamedSharding(mesh, P(None, None, "sp")))
    jv.weights = jax_put(weights, NamedSharding(mesh, P("sp")))
    one = JitVBPI(vbpi_instance(), particle_count=P_count, seed=0,
                  dtype=jnp.float32)
    for step in range(2):
        got = float(jv.step(beta=0.5)["mean_ll"])
        want = float(one.step(beta=0.5)["mean_ll"])
        check(f"VBPI dp={n // sp_size} x sp={sp_size} step {step} mean_ll "
              "vs one card", got, want, rtol=SHARD_RTOL)


def jax_put(x, sharding):
    import jax

    return jax.device_put(x, sharding)


def phase_gp_mesh(n):
    from libsbn_tpu.parallel.sharding import make_mesh

    got, _ = gp_fit(np.float32, mesh=make_mesh(n, dp=1, sp=n))
    want, _ = gp_fit(np.float32)
    check(f"GP fluA sp={n} marginal vs one card", got, want,
          rtol=GP_MARGINAL_RTOL)


def phase_forest_mesh(n):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from libsbn_tpu.io import newick
    from libsbn_tpu.ops import forest
    from libsbn_tpu.parallel.sharding import make_mesh

    sp = eng_site_pattern(unrooted_instance("DS1.100_topologies.nwk"))
    tops, _, _ = newick.parse_newick_file(f"{DATA}/DS1.100_topologies.nwk")
    for t in tops:
        t.polish()
    fs = forest.build_forest(tops)
    R = 2 * n
    bl_sets = np.random.default_rng(5).uniform(
        0.02, 0.2, (R, fs.n_splits)
    ).astype(np.float32)
    tips = jnp.asarray(sp.tip_partials(np.float32))
    w = jnp.asarray(sp.weights, jnp.float32)
    fn = jax.jit(jax.vmap(
        lambda b: forest.forest_jc_log_likelihoods_and_gradients(
            fs, b, tips, w
        )
    ))
    mesh = make_mesh(n, dp=n, sp=1)
    ll_s, g_s = fn(jax.device_put(bl_sets, NamedSharding(mesh, P("dp"))))
    ll_1, g_1 = fn(jax.device_put(bl_sets, jax.devices()[0]))
    check(f"forest dp={n} LLs vs one card", ll_s, ll_1, rtol=SHARD_RTOL)
    check(f"forest dp={n} gradients vs one card", g_s, g_1, rtol=SHARD_RTOL)


def phase_rooted_mesh(n):
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from libsbn_tpu.models.phylo_model import PhyloModelSpec
    from libsbn_tpu.parallel.sharding import make_mesh

    spec = PhyloModelSpec("JC69", "constant", "strict")
    inst = flua_instance(spec)
    eng = f32_engine(inst, spec)
    B = FLUA_TREES
    sched = batched_like(inst._batched_schedule(), B)
    bounds, ratios, rates = (
        tile_rows(a, B).astype(np.float32) for a in inst._time_tree_arrays()
    )
    params = f32_params(inst._compute_params()[0])
    sh = NamedSharding(make_mesh(n, dp=n, sp=1), P("dp"))
    got = eng.rooted_phylo_gradients(
        sched, *(jax.device_put(a, sh) for a in (bounds, ratios, rates)),
        params,
    )
    want = eng.rooted_phylo_gradients(sched, bounds, ratios, rates, params)
    for key in ("log_likelihood", "ratios_root_height", "clock_model"):
        check(f"rooted fluA dp={n} {key} vs one card", got[key], want[key],
              rtol=SHARD_RTOL)


def phase_kernel_mesh(n):
    from libsbn_tpu.ops import pruning_jc
    from libsbn_tpu.parallel.sharding import make_mesh

    inst = unrooted_instance("DS1.subsampled_10.t")
    sp = eng_site_pattern(inst)
    sch = batched_like(inst._batched_schedule(), BENCH_TREES)
    rng = np.random.default_rng(0)
    bl = tile_rows(np.pad(inst.branch_length_matrix(), ((0, 0), (0, 1))),
                   BENCH_TREES)
    bl = (bl * rng.uniform(0.8, 1.2, bl.shape)).astype(np.float32)
    tips = sp.tip_partials(np.float32)
    w = sp.weights.astype(np.float32)
    got = pruning_jc.log_likelihood_and_branch_gradient_jc69_sharded(
        make_mesh(n, dp=n, sp=1), sch.post_children, bl, tips, w,
        root_id=sch.root_id,
    )
    want = pruning_jc.log_likelihood_and_branch_gradient_jc69(
        sch.post_children, bl, tips, w, root_id=sch.root_id
    )
    check(f"JC69 LL+gradient dp={n} LLs vs one card", got[0], want[0],
          rtol=SHARD_RTOL)
    check(f"JC69 LL+gradient dp={n} gradients vs one card", got[1], want[1],
          rtol=SHARD_RTOL)


MULTI_DEVICE_PHASES = [
    ("vbpi_mesh", phase_vbpi_mesh),
    ("gp_mesh", phase_gp_mesh),
    ("rooted_mesh", phase_rooted_mesh),
    ("kernel_mesh", phase_kernel_mesh),
    ("forest_mesh", phase_forest_mesh),
]


def run_phases(phases, *args):
    for name, fn in phases:
        log(f"phase {name}")
        t0 = time.perf_counter()
        fn(*args)
        log(f"phase {name}: ok ({time.perf_counter() - t0:.1f} s)")


def nvidia_smi():
    """The card's name and power limit, read by a child that never
    imports JAX."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi unavailable: {exc}"
    return out.stdout.strip() or out.stderr.strip()


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument(
        "--devices", type=int, default=1, choices=(1, 4),
        help="4: run only the multi-device paths on four cards",
    )
    opts = parser.parse_args()
    smi = nvidia_smi()

    import jax

    backend = jax.default_backend()
    devices = jax.devices()
    if backend != "gpu" or devices[0].platform != "gpu":
        print(f"chip_smoke: needs a GPU; JAX found {backend} "
              f"({devices[0].platform})", file=sys.stderr)
        return 2
    if len(devices) < opts.devices:
        print(f"chip_smoke: --devices {opts.devices} needs {opts.devices} "
              f"GPUs; JAX found {len(devices)}", file=sys.stderr)
        return 2

    sys.path.insert(0, HERE)
    from libsbn_tpu.io import native

    t0 = time.perf_counter()
    built = subprocess.run(
        ["make", "-C", os.path.join(HERE, "native"), "all", "cpu_baseline"],
        capture_output=True, text=True,
    )
    assert built.returncode == 0, f"native build failed:\n{built.stderr}"
    assert native.get_lib() is not None, "native library did not load"
    log(f"setup: native build {time.perf_counter() - t0:.2f} s")
    log(f"card: {smi}")
    log(f"jax {jax.__version__}: {len(devices)} x {devices[0].device_kind}")

    if opts.devices == 1:
        run_phases(ONE_CARD_PHASES)
    else:
        run_phases(MULTI_DEVICE_PHASES, opts.devices)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": devices[0].platform,
            "kind": devices[0].device_kind,
            "count": len(devices),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
