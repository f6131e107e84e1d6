"""The fused JC69 kernel (ops/pruning_jc.py, Pallas interpreter on CPU)
against the scan engine, its padding and program layout, the choice of
implementation, and the rooted hand chain rule built on it."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from libsbn_tpu.core.site_pattern import SitePattern
from libsbn_tpu.io import newick
from libsbn_tpu.io.fasta import Alignment
from libsbn_tpu.ops import pruning_jc
from libsbn_tpu.ops import schedule as schedule_ops

DATA = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data"
)

DS1_GOLDEN = np.array([
    -14582.995273982739, -6911.294207416366, -6916.880235529542,
    -6904.016888831189, -6915.055570693576, -6915.50496696512,
    -6910.958836661867, -6909.02639968063, -6912.967861935749,
    -6910.7871105783515,
])


def _load(tree_file, fasta):
    path = f"{DATA}/{tree_file}"
    if tree_file.endswith(".t"):
        tops, bls, ttm = newick.parse_nexus_file(path)
    else:
        tops, bls, ttm = newick.parse_newick_file(path)
    sp = SitePattern(Alignment.read_fasta(f"{DATA}/{fasta}"), ttm)
    sched = schedule_ops.schedules_of_topologies(tops)
    bl_p = np.pad(np.stack(bls), ((0, 0), (0, 1)))
    return sched, bl_p, sp


@pytest.fixture(scope="module")
def ds1():
    return _load("DS1.subsampled_10.t", "DS1.fasta")


def test_jc_kernel_matches_scan_engine(ds1):
    """The fused kernel (interpret mode, f32) reproduces the DS1 goldens
    and the f64 scan engine: LLs, branch gradients, Weibull categories."""
    from libsbn_tpu.models.phylo_model import (
        PhyloModelSpec, default_parameters, model_tensors,
    )

    sched, bl_p, sp = ds1
    tips = sp.tip_partials(np.float32)
    w = sp.weights.astype(np.float32)
    ll, grad = pruning_jc.fused_jc69(
        sched.post_children, bl_p.astype(np.float32), tips, w,
        root_id=sched.root_id, interpret=True,
    )
    np.testing.assert_allclose(np.asarray(ll), DS1_GOLDEN, rtol=1e-5, atol=0.5)
    ll64, g64 = pruning_jc.scan_jc69(
        sched.post_children, bl_p, sp.tip_partials(), sp.weights,
        root_id=sched.root_id,
    )
    np.testing.assert_allclose(np.asarray(ll), np.asarray(ll64), atol=0.01)
    np.testing.assert_allclose(
        np.asarray(grad), np.asarray(g64), rtol=1e-3, atol=0.2
    )

    spec = PhyloModelSpec("JC69", "weibull+4", "strict")
    params = default_parameters(spec)
    params["site"] = {"shape": jnp.asarray(0.1)}
    _, _, _, _, rates, props, _ = model_tensors(spec, params)
    llw, _ = pruning_jc.fused_jc69(
        sched.post_children, bl_p.astype(np.float32), tips, w,
        root_id=sched.root_id, rates=rates, props=props, interpret=True,
    )
    wgold = np.array([
        -9456.1201098061, -6624.4110704332, -6623.4474776131,
        -6617.25658038029, -6627.5385571548, -6621.6155048722,
        -6622.3314942713, -6618.7695717585, -6616.3837517370,
        -6623.8295828648,
    ])
    np.testing.assert_allclose(np.asarray(llw), wgold, rtol=1e-5, atol=0.5)


@pytest.mark.parametrize("K", [1, 4])
@pytest.mark.parametrize("rescale", [True, False])
def test_jc_kernel_padding_categories_rescale(K, rescale):
    """A pattern count that is no multiple of the block (ds1-reduced-5 has
    few patterns, padded to blocks of 8 and 32), one or four rate
    categories, rescaling on or off: the kernel equals the f64 scan
    engine, and no padding leaks into the results."""
    sched, bl_p, sp = _load("ds1-reduced-5.nwk", "ds1-reduced-5.fasta")
    bl_p = np.random.default_rng(1).uniform(0.02, 0.3, bl_p.shape)
    bl_p[:, sched.root_id:] = 0.0  # root and ones slots
    n_pat = sp.weights.shape[0]
    assert n_pat % 8 != 0
    rates = np.array([0.3, 0.7, 1.2, 1.8])[:K] if K > 1 else None
    props = np.full(K, 1.0 / K) if K > 1 else None
    ll64, g64 = pruning_jc.scan_jc69(
        sched.post_children, bl_p, sp.tip_partials(), sp.weights,
        root_id=sched.root_id, rates=rates, props=props, rescale=rescale,
    )
    for tile in (8, 32):
        ll, g = pruning_jc.fused_jc69(
            sched.post_children, bl_p.astype(np.float32),
            sp.tip_partials(np.float32), sp.weights.astype(np.float32),
            root_id=sched.root_id, rates=rates, props=props,
            rescale=rescale, tile=tile, interpret=True,
        )
        assert g.shape == g64.shape
        np.testing.assert_allclose(np.asarray(ll), np.asarray(ll64),
                                   rtol=1e-5)
        np.testing.assert_allclose(np.asarray(g), np.asarray(g64),
                                   rtol=1e-4, atol=1e-3)


def test_jc_pad_patterns_and_programs():
    """Padding adds all-ones columns of zero weight up to the block; every
    program gets the same number of work items."""
    tips = jnp.zeros((3, 4, 13))
    w = jnp.ones((13,))
    tp, wp = pruning_jc.pad_patterns(tips, w, 8)
    assert tp.shape == (3, 4, 16) and wp.shape == (16,)
    assert float(jnp.sum(wp)) == 13.0
    assert bool(jnp.all(tp[..., 13:] == 1.0))
    same = pruning_jc.pad_patterns(tips, w, 13)
    assert same[0] is tips and same[1] is w
    assert pruning_jc.programs_for(150, 1024) == 150
    for n_items in (7680, 2048 * 3, 1031):
        g = pruning_jc.programs_for(n_items, 1024)
        assert n_items % g == 0 and (g >= 1024 or g == n_items)


def test_jc_kernel_program_layout(ds1):
    """Several work items per program (the slab reused across items) and
    one item per program give the same results."""
    sched, bl_p, sp = ds1
    args = (
        sched.post_children[:3], bl_p[:3].astype(np.float32),
        sp.tip_partials(np.float32), sp.weights.astype(np.float32),
    )
    one = pruning_jc.fused_jc69(*args, root_id=sched.root_id, tile=128,
                                interpret=True)
    many = pruning_jc.fused_jc69(*args, root_id=sched.root_id, tile=128,
                                 programs=4, interpret=True)
    for a, b in zip(one, many):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-6)


def test_jc_vjp_kernel_ad_consistency(ds1):
    """The JC69 LL+gradient the engines select (the scan engine on CPU)
    agrees with AD through the plain likelihood, in f32: the branch
    gradient of the linear-time pass equals jax.grad of the LL."""
    from libsbn_tpu.models.engine import LikelihoodEngine
    from libsbn_tpu.models.phylo_model import PhyloModelSpec, default_parameters

    sched, bl_p, sp = ds1
    spec = PhyloModelSpec("JC69", "constant", "strict")
    eng = LikelihoodEngine(sp, spec, dtype=jnp.float32)
    params = default_parameters(spec)
    bl = jnp.asarray(bl_p[:, :-1], jnp.float32)
    ll, g = pruning_jc.log_likelihood_and_branch_gradient_jc69(
        sched.post_children, jnp.asarray(bl_p, jnp.float32),
        sp.tip_partials(np.float32), sp.weights.astype(np.float32),
        root_id=sched.root_id,
    )
    g_ad = jax.grad(
        lambda b: jnp.sum(eng.log_likelihoods(sched, b, params))
    )(bl)
    np.testing.assert_allclose(
        np.asarray(ll), np.asarray(eng.log_likelihoods(sched, bl, params)),
        atol=0.01,
    )
    np.testing.assert_allclose(
        np.asarray(g), np.asarray(g_ad)[:, : sched.root_id],
        rtol=1e-3, atol=0.2,
    )


def test_jc_sharded_matches_local(ds1):
    """The shard_map wrapper over the 8-device CPU mesh == local results."""
    from libsbn_tpu.parallel.sharding import make_mesh

    sched, bl_p, sp = ds1
    B = 16
    pc = np.tile(np.asarray(sched.post_children, np.int32), (2, 1, 1))[:B]
    bl = np.tile(bl_p, (2, 1))[:B].astype(np.float32)
    tips = sp.tip_partials(np.float32)
    w = sp.weights.astype(np.float32)
    ll0, g0 = pruning_jc.log_likelihood_and_branch_gradient_jc69(
        pc, bl, tips, w, root_id=sched.root_id
    )
    ll1, g1 = pruning_jc.log_likelihood_and_branch_gradient_jc69_sharded(
        make_mesh(8, dp=8, sp=1), pc, bl, tips, w, root_id=sched.root_id
    )
    np.testing.assert_allclose(np.asarray(ll1), np.asarray(ll0), atol=1e-3)
    np.testing.assert_allclose(np.asarray(g1), np.asarray(g0), atol=1e-2)


def _flua_instance():
    from libsbn_tpu import RootedInstance
    from libsbn_tpu.models.phylo_model import PhyloModelSpec

    inst = RootedInstance("fluA")
    inst.read_newick_file(f"{DATA}/fluA.tree")
    inst.read_fasta_file(f"{DATA}/fluA.fa")
    inst.parse_dates_from_taxon_names(True)
    inst.prepare_for_phylo_likelihood(
        PhyloModelSpec("JC69", "constant", "strict")
    )
    return inst


def test_engine_rooted_hand_chain_matches_ad_f32():
    """The JC69 hand chain rule (one LL+gradient pass + dense BEAST
    recursions, models/engine._rooted_phylo_gradients_hand) == AD through
    the scan engine and the heights transform, both in f32
    (rooted_gradient_transforms.cpp:17-162 semantics)."""
    inst = _flua_instance()
    eng = inst.engine
    eng.dtype = jnp.float32
    sched = inst._batched_schedule()
    bounds, ratios, rates = inst._time_tree_arrays()
    params, _ = inst._compute_params()
    hand = eng._rooted_phylo_gradients_hand(
        sched, bounds, ratios, rates, params, True
    )
    ad = eng._rooted_phylo_gradients_ad(
        sched, bounds, ratios, rates, params, True, False
    )
    for k in ("log_likelihood", "ratios_root_height", "clock_model"):
        np.testing.assert_allclose(
            np.asarray(hand[k]), np.asarray(ad[k]), rtol=1e-3, atol=0.1,
            err_msg=k,
        )


@pytest.mark.parametrize("backend,dtype,expected", [
    ("gpu", jnp.float32, True),
    ("gpu", jnp.float64, False),
    ("cpu", jnp.float32, False),
    ("cpu", jnp.float64, False),
])
def test_use_kernel_selection(monkeypatch, backend, dtype, expected):
    """The kernel is chosen from what the code observes: a GPU platform
    and float32."""
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    assert pruning_jc.use_kernel(dtype) is expected


def _no_kernel(*args, **kwargs):
    raise AssertionError("the fused kernel must not run on the CPU")


def test_allow_kernel_false_keeps_the_scan_engine(monkeypatch, ds1):
    """allow_kernel=False (a caller that splits the batch over a mesh)
    runs the scan engine even where the kernel would be chosen."""
    sched, bl_p, sp = ds1
    args = (sched.post_children, bl_p.astype(np.float32),
            sp.tip_partials(np.float32), sp.weights.astype(np.float32))
    want = pruning_jc.scan_jc69(*args, root_id=sched.root_id)
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(pruning_jc, "fused_jc69", _no_kernel)
    got = pruning_jc.log_likelihood_and_branch_gradient_jc69(
        *args, root_id=sched.root_id, allow_kernel=False
    )
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("path", ["branch_gradients", "rooted", "vbpi"])
def test_cpu_paths_never_run_the_kernel(monkeypatch, path):
    """On the CPU every f32 JC69 path runs the scan engine: the fused
    kernel (and so its interpreter) is never called."""
    from libsbn_tpu.models.engine import LikelihoodEngine
    from libsbn_tpu.models.phylo_model import PhyloModelSpec, default_parameters

    monkeypatch.setattr(pruning_jc, "fused_jc69", _no_kernel)
    spec = PhyloModelSpec("JC69", "constant", "strict")
    if path == "branch_gradients":
        sched, bl_p, sp = _load("hello.nwk", "hello.fasta")
        eng = LikelihoodEngine(sp, spec, dtype=jnp.float32)
        ll, _ = eng.branch_gradients(sched, bl_p[:, :-1], default_parameters(spec))
        np.testing.assert_allclose(float(ll[0]), -84.852358, atol=1e-3)
    elif path == "rooted":
        inst = _flua_instance()
        inst.engine.dtype = jnp.float32
        g = inst.phylo_gradients()
        assert np.all(np.isfinite(np.asarray(g["ratios_root_height"])))
    else:
        from libsbn_tpu import UnrootedInstance
        from libsbn_tpu.vi.jit_step import JitVBPI

        inst = UnrootedInstance("vbpi")
        inst.read_nexus_file(f"{DATA}/hello_out.t")
        inst.process_loaded_trees()
        inst.train_simple_average()
        inst.read_fasta_file(f"{DATA}/hello.fasta")
        inst.prepare_for_phylo_likelihood(spec)
        jv = JitVBPI(inst, particle_count=4, seed=0, dtype=jnp.float32)
        assert not pruning_jc.use_kernel(jv.dtype)
        assert np.isfinite(float(jv.step()["mean_ll"]))


@pytest.mark.gpu
def test_fused_kernel_compiled_on_gpu():
    """The kernel as compiled for the card == its interpreter and the f64
    scan engine at DS1 width (chip_smoke.py runs this on the card)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: runs the kernel as compiled for the card")
    sched, bl_p, sp = _load("DS1.subsampled_10.t", "DS1.fasta")
    args = (
        sched.post_children, bl_p.astype(np.float32),
        sp.tip_partials(np.float32), sp.weights.astype(np.float32),
    )
    ll, g = pruning_jc.fused_jc69(*args, root_id=sched.root_id)
    ll_i, g_i = pruning_jc.fused_jc69(*args, root_id=sched.root_id,
                                      interpret=True)
    with jax.default_device(jax.devices("cpu")[0]):
        ll64, g64 = pruning_jc.scan_jc69(
            sched.post_children, bl_p, sp.tip_partials(), sp.weights,
            root_id=sched.root_id,
        )
    np.testing.assert_allclose(np.asarray(ll), np.asarray(ll_i), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(g), np.asarray(g_i), rtol=1e-4,
                               atol=0.05)
    np.testing.assert_allclose(np.asarray(ll), np.asarray(ll64), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(g), np.asarray(g64), rtol=1e-4,
                               atol=0.2)
