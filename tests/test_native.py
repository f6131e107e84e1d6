"""Native C++ host core vs pure-Python reference implementation parity
(native/libsbn_native.cpp vs io/newick.py + ops/schedule.py)."""

import numpy as np
import pytest

from libsbn_tpu.core.topology import Topology
from libsbn_tpu.io import native, newick
from libsbn_tpu.ops import schedule as schedule_ops

FILES = [
    ("hello.nwk", False),
    ("five_taxon_unrooted.nwk", False),
    ("five_taxon_rooted.nwk", False),
    ("DS1.100_topologies.nwk", False),
    ("fluA.tree", False),
    ("hotstart_bootstrap_sample.nwk", False),
    ("DS1.subsampled_10.t", True),
    ("DS1.subsampled_10.t.reordered", True),
    ("test_beast_tree_parsing.nexus", True),
    ("gradient_test.t", True),
    ("hello_out.t", True),
]


@pytest.fixture(scope="module")
def lib():
    lib = native.get_lib()
    if lib is None:
        pytest.skip("native library unavailable")
    return lib


@pytest.mark.parametrize("fname,nexus", FILES)
def test_native_parse_matches_python(lib, data_dir, fname, nexus):
    path = f"{data_dir}/{fname}"
    out = native.parse_tree_file(path, nexus)
    assert out is not None, "native parse failed"
    pv, bl, names = out

    # Pure-Python reference path (bypass the native fast path).
    if nexus:
        import libsbn_tpu.io.native as native_mod

        saved = native_mod.parse_tree_file
        native_mod.parse_tree_file = lambda *a, **k: None
        try:
            tops, bls, ttm = newick.parse_nexus_file(path)
        finally:
            native_mod.parse_tree_file = saved
    else:
        with open(path) as f:
            tops, bls, ttm = newick.parse_newick_string(f.read())

    assert names == [ttm[(i, 1)] for i in range(len(ttm))]
    assert pv.shape[0] == len(tops)
    for i, top in enumerate(tops):
        assert list(pv[i]) == top.parent_id_vector(), (fname, i)
        np.testing.assert_array_equal(bl[i], bls[i])


def test_native_schedules_match_python(lib, data_dir):
    tops, _, _ = newick.parse_newick_file(f"{data_dir}/DS1.100_topologies.nwk")
    pv = np.asarray([t.parent_id_vector() for t in tops], dtype=np.int32)
    ns = native.build_schedules(pv, tops[0].leaf_count)
    ps = schedule_ops.batch_schedules(
        [schedule_ops.schedule_of_topology(t) for t in tops]
    )
    np.testing.assert_array_equal(ns["post_node"], ps.post_node)
    np.testing.assert_array_equal(ns["post_children"], ps.post_children)
    # Up schedules may differ in order but must be the same set of steps in
    # a parents-first order.
    for t in range(len(tops)):
        a = set(
            map(
                tuple,
                np.c_[
                    ns["up_node"][t], ns["up_parent"][t],
                    np.sort(ns["up_sibs"][t], axis=1),
                ],
            )
        )
        b = set(
            map(
                tuple,
                np.c_[
                    ps.up_node[t], ps.up_parent[t], np.sort(ps.up_sibs[t], axis=1)
                ],
            )
        )
        assert a == b
        # Parents-first: a node must appear as up_node before it appears as
        # up_parent.
        seen = {int(ps.root_id)}
        for node, parent in zip(ns["up_node"][t], ns["up_parent"][t]):
            assert int(parent) in seen
            seen.add(int(node))


def test_native_schedule_likelihood_equivalence(lib, data_dir):
    """Likelihoods and gradients through native schedules match Python ones."""

    from libsbn_tpu.core.site_pattern import SitePattern
    from libsbn_tpu.io.fasta import Alignment
    from libsbn_tpu.models.engine import LikelihoodEngine
    from libsbn_tpu.models.phylo_model import PhyloModelSpec, default_parameters

    tops, bls, ttm = newick.parse_nexus_file(f"{data_dir}/DS1.subsampled_10.t")
    sp = SitePattern(Alignment.read_fasta(f"{data_dir}/DS1.fasta"), ttm)
    spec = PhyloModelSpec("JC69", "constant", "strict")
    engine = LikelihoodEngine(sp, spec)
    params = default_parameters(spec)
    bl = np.stack(bls)

    sched_native = schedule_ops.schedules_of_topologies(tops)
    sched_python = schedule_ops.batch_schedules(
        [schedule_ops.schedule_of_topology(t) for t in tops]
    )
    ll_n, g_n = engine.branch_gradients(sched_native, bl, params)
    engine._jit_cache = {}
    ll_p, g_p = engine.branch_gradients(sched_python, bl, params)
    np.testing.assert_allclose(ll_n, ll_p, rtol=0, atol=1e-9)
    np.testing.assert_allclose(g_n, g_p, rtol=1e-9, atol=1e-9)


def test_native_sampler_matches_python_distribution(lib, data_dir):
    """Native SBN sampler: canonical parent vectors, in-support samples, and
    an empirical distribution matching the Python sampler
    (sbn/sampling.py NativeSBNSampler vs SBNSampler)."""
    from collections import Counter

    from libsbn_tpu import UnrootedInstance
    from libsbn_tpu.sbn import sampling

    inst = UnrootedInstance("DS1")
    inst.read_nexus_file(f"{data_dir}/DS1.subsampled_10.t")
    inst.process_loaded_trees()
    inst.train_simple_average()
    sup = inst.sbn_support

    ns = sampling.NativeSBNSampler(sup, inst.sbn_parameters, seed=5)
    assert ns.tables is not None
    pv = ns.sample_parent_vectors(400, rooted=False)
    assert pv is not None and pv.shape == (400, 2 * sup.taxon_count() - 3)
    for row in pv[:50]:
        top = Topology.of_parent_id_vector(list(map(int, row)))
        # Canonical fixed point: the emitted vector IS the polished form.
        assert top.parent_id_vector() == list(map(int, row))
        # In support: every rooting indexes below the sentinel.
        rep = sup.dense_representations([top])[0]
        assert (rep < sup.gpcsp_count).all()

    # Rooted sampling produces one extra node.
    pvr = ns.sample_parent_vectors(10, rooted=True)
    assert pvr is not None and pvr.shape == (10, 2 * sup.taxon_count() - 2)

    # Empirical frequencies track the Python sampler (loose 3-sigma-ish gate
    # on the most common topology, p ~ 0.03 at n = 4000).
    n = 4000
    cnt = Counter(tuple(map(int, r)) for r in ns.sample_parent_vectors(n, False))
    ps = sampling.SBNSampler(sup, inst.sbn_parameters, seed=5)
    cnt_py = Counter(
        tuple(ps.sample_topology(rooted=False).parent_id_vector())
        for _ in range(1000)
    )
    (key, c), = cnt.most_common(1)
    f_native = c / n
    f_py = cnt_py.get(key, 0) / 1000
    assert abs(f_native - f_py) < 0.03


def test_normalized_range_probs_matches_loop(lib, data_dir):
    """Vectorized per-block normalization equals the per-range loop."""
    from libsbn_tpu import UnrootedInstance
    from libsbn_tpu.sbn import sampling

    inst = UnrootedInstance("DS1")
    inst.read_nexus_file(f"{data_dir}/DS1.subsampled_10.t")
    inst.process_loaded_trees()
    inst.train_simple_average()
    sup = inst.sbn_support
    params = np.asarray(inst.sbn_parameters) + np.random.default_rng(
        0
    ).normal(size=sup.gpcsp_count)
    probs = sampling.normalized_range_probs(sup, params)
    ref = np.zeros_like(probs)
    ranges = [(0, sup.rootsplit_count())] + list(sup.parent_to_range.values())
    for start, end in ranges:
        seg = params[start:end]
        p = np.exp(seg - seg.max())
        ref[start:end] = p / p.sum()
    np.testing.assert_allclose(probs, ref, atol=1e-15)


def test_native_indexer_representations_match_python(lib, data_dir):
    """Native unrooted indexer representations equal the Python path
    (native/libsbn_native.cpp lsbn_indexer_representations vs
    sbn/maps.py unrooted_indexer_representation_of) as per-row multisets,
    with identical split-index column 0."""
    from libsbn_tpu import UnrootedInstance
    from libsbn_tpu.sbn import sampling

    inst = UnrootedInstance("DS1")
    inst.read_nexus_file(f"{data_dir}/DS1.subsampled_10.t")
    inst.process_loaded_trees()
    inst.train_simple_average()
    sup = inst.sbn_support

    ns = sampling.NativeSBNSampler(sup, inst.sbn_parameters, seed=11)
    pvs = ns.sample_parent_vectors(30, rooted=False)
    reps_native = sup.dense_representations_of_parent_vectors(pvs)
    assert reps_native is not None
    tops = [Topology.of_parent_id_vector(list(map(int, r))) for r in pvs]
    reps_py = sup.dense_representations(tops)
    np.testing.assert_array_equal(reps_native[:, :, 0], reps_py[:, :, 0])
    for t in range(len(tops)):
        for e in range(reps_py.shape[1]):
            assert sorted(reps_native[t, e]) == sorted(reps_py[t, e])


def test_native_psp_representations_match_python(lib, data_dir):
    """Native PSP branch representations equal PSPIndexer.representation_of
    (native/libsbn_native.cpp lsbn_psp_representations vs sbn/support.py)."""
    from libsbn_tpu import UnrootedInstance
    from libsbn_tpu.sbn import sampling

    inst = UnrootedInstance("DS1")
    inst.read_nexus_file(f"{data_dir}/DS1.subsampled_10.t")
    inst.process_loaded_trees()
    inst.train_simple_average()
    psp = inst.psp_indexer

    ns = sampling.NativeSBNSampler(inst.sbn_support, inst.sbn_parameters, seed=7)
    pvs = ns.sample_parent_vectors(30, rooted=False)
    reps_native = psp.dense_representations_of_parent_vectors(pvs)
    assert reps_native is not None
    for t, pv in enumerate(pvs):
        top = Topology.of_parent_id_vector(list(map(int, pv)))
        rep_py = np.asarray(psp.representation_of(top), dtype=np.int32)
        np.testing.assert_array_equal(reps_native[t], rep_py)


def _native_sources(tmp_path):
    """A copy of native/ without any built library."""
    import os
    import shutil

    src = os.path.dirname(native._SO_PATH)
    for name in ("Makefile", "libsbn_native.cpp"):
        shutil.copy(os.path.join(src, name), tmp_path / name)
    return tmp_path


def test_native_build_from_source(tmp_path):
    """The library builds from the tracked sources, lands under its final
    name only (no temporary file left), loads, and a second build with
    nothing newer leaves it untouched."""
    import ctypes

    d = _native_sources(tmp_path)
    assert native.build_native("all", str(d))
    so = d / "libsbn_native.so"
    assert so.exists()
    assert not list(d.glob("*.tmp"))
    assert hasattr(ctypes.CDLL(str(so)), "lsbn_parse_newick_file")
    mtime = so.stat().st_mtime_ns
    assert native.build_native("all", str(d))
    assert so.stat().st_mtime_ns == mtime
    assert not native.build_native("all", str(d / "missing"))


def test_native_build_concurrent_is_atomic(tmp_path):
    """Several processes building at once (test workers on a fresh
    checkout) all succeed, and the library they leave loads: each compiles
    under its own temporary name and renames it into place."""
    import ctypes
    import subprocess

    d = _native_sources(tmp_path)
    procs = [
        subprocess.Popen(["make", "-C", str(d), "all"],
                         stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
        for _ in range(4)
    ]
    assert all(p.wait(timeout=300) == 0 for p in procs)
    assert not list(d.glob("*.tmp"))
    assert hasattr(ctypes.CDLL(str(d / "libsbn_native.so")),
                   "lsbn_build_schedules")


@pytest.mark.parametrize("openmp", [True, False])
def test_cpu_baseline_builds_with_and_without_openmp(tmp_path, openmp):
    """The CPU baseline builds where the compiler lacks the OpenMP runtime
    (-fopenmp fails): it then runs one thread, and otherwise OpenMP's."""
    import ctypes
    import os
    import shutil
    import subprocess

    src = os.path.dirname(native._SO_PATH)
    for name in ("Makefile", "cpu_baseline.cpp"):
        shutil.copy(os.path.join(src, name), tmp_path / name)
    cxx = "g++"
    if not openmp:
        cxx = tmp_path / "cxx.sh"
        cxx.write_text(
            "#!/bin/sh\n"
            'for a in "$@"; do [ "$a" = -fopenmp ] && exit 1; done\n'
            'exec g++ "$@"\n'
        )
        cxx.chmod(0o755)
    built = subprocess.run(
        ["make", "-C", str(tmp_path), "cpu_baseline", f"CXX={cxx}"],
        capture_output=True, text=True, timeout=300,
    )
    assert built.returncode == 0, built.stderr
    lib = ctypes.CDLL(str(tmp_path / "libsbn_cpu_baseline.so"))
    threads = lib.lsbn_cpu_baseline_threads()
    assert threads >= 1 if openmp else threads == 1
