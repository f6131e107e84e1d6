"""Generalized pruning tests (reference: /root/reference/src/gp_doctest.cpp).

The central device is the brute-force cross-check: the GP marginal over the
subsplit DAG must equal the exact marginal obtained by enumerating ALL trees
the DAG spans and log-summing their per-site likelihoods (ComputeExactMarginal,
gp_doctest.cpp:110-216)."""

import os
import jax.numpy as jnp
import numpy as np
import pytest
from scipy.special import logsumexp

from libsbn_tpu.gp import GPInstance
from libsbn_tpu.ops import pruning, schedule, substitution
from libsbn_tpu.sbn import maps as sbn_maps

DATA = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data"
)


def make_instance(fasta, newick_file):
    inst = GPInstance()
    inst.read_fasta_file(f"{DATA}/{fasta}")
    inst.read_newick_file(f"{DATA}/{newick_file}")
    inst.make_engine()
    return inst


def per_pattern_log_likelihoods(tree_collection, site_pattern):
    """(T, patterns) per-pattern log likelihoods under JC69 via the classical
    engine internals."""
    freqs, evec, ivec, evals = substitution.jc69_eigen()
    tips = jnp.asarray(site_pattern.tip_partials())
    rates = jnp.ones(1)
    props = jnp.ones(1)
    out = []
    for tree in tree_collection.trees:
        sched = schedule.schedule_of_topology(tree.topology)
        bl = jnp.asarray(np.concatenate([tree.branch_lengths, [0.0]]))
        P = pruning.node_transition_matrices(evec, ivec, evals, bl, rates)
        M, _, logscale = pruning._postorder(
            jnp.asarray(sched.post_node), jnp.asarray(sched.post_children), P,
            tips, True,
        )
        site = pruning._root_site_likelihoods(M, sched.root_id, freqs, props)
        out.append(np.asarray(jnp.log(site) + logscale))
    return np.stack(out)


def compute_exact_marginal(tree_collection, site_pattern, dag):
    """Exact (marginal log lik, {pretty gpcsp: per-pcsp log marginal}) by
    enumeration (ComputeExactMarginal)."""
    ll = per_pattern_log_likelihoods(tree_collection, site_pattern)  # (T, S)
    T = ll.shape[0]
    weights = site_pattern.weights
    log_prior = np.log(1.0 / T)
    per_site_marginal = logsumexp(ll, axis=0) + log_prior
    exact_marginal = float(np.sum(per_site_marginal * weights))

    indexer = {}
    for key, idx in dag.build_gpcsp_indexer().items():
        if idx < dag.rootsplit_count():
            indexer[min(key.subsplit_chunk(0), key.subsplit_chunk(1))] = idx
        else:
            indexer[key] = idx
    E = dag.gpcsp_count_with_fake()
    per_pcsp = np.zeros(E)
    reps = []
    for tree in tree_collection.trees:
        rep = sbn_maps.rooted_indexer_representation_of(
            indexer, tree.topology, E
        )
        assert all(i < E for i in rep), "tree contains unknown PCSP"
        reps.append(rep)
    for gpcsp_idx in range(E):
        mask = np.array([gpcsp_idx in rep for rep in reps])
        if mask.any():
            per_site = logsumexp(ll[mask], axis=0) + log_prior
            per_pcsp[gpcsp_idx] = float(np.sum(per_site * weights))
        else:
            per_pcsp[gpcsp_idx] = -np.inf
    pretty = dag.pretty_indexer()
    return exact_marginal, {pretty[i]: per_pcsp[i] for i in range(E)}


def check_composite_marginal(inst, fasta):
    """TestCompositeMarginal (gp_doctest.cpp:180-196)."""
    inst.estimate_branch_lengths(1e-4, 100)
    inst.populate_plvs()
    inst.compute_likelihoods()
    trees = inst.generate_complete_rooted_tree_collection()
    exact_marginal, exact_per_pcsp = compute_exact_marginal(
        trees, inst.get_engine().site_pattern, inst.dag
    )
    gp_marginal = inst.get_engine().get_log_marginal_likelihood()
    assert abs(gp_marginal - exact_marginal) < 1e-6, (gp_marginal, exact_marginal)
    gp_per_pcsp = inst.pretty_indexed_per_gpcsp_components_of_full_log_marginal()
    for key, gp_value in gp_per_pcsp:
        exact = exact_per_pcsp.get(key, -np.inf)
        if np.isfinite(exact):
            assert abs(exact - gp_value) < 1e-5, (key, exact, gp_value)


def test_hello_marginal_likelihood():
    """Golden: -84.77961943 (gp_doctest.cpp:89-101)."""
    inst = make_instance("hello.fasta", "hello_rooted.nwk")
    # GPCSP order: rootsplit, venus, jupiter, mars, saturn (HelloGPCSP enum).
    inst.get_engine().branch_lengths = np.array([0.0, 0.22, 0.113, 0.15, 0.1])
    inst.populate_plvs()
    inst.compute_likelihoods()
    per_gpcsp = inst.get_engine().get_per_gpcsp_log_likelihoods()
    np.testing.assert_allclose(per_gpcsp, -84.77961943, atol=1e-6)
    assert abs(inst.get_engine().get_log_marginal_likelihood() - -84.77961943) < 1e-6


def test_two_tree_marginal():
    check_composite_marginal(
        make_instance("hello.fasta", "hello_rooted_two_trees.nwk"), "hello.fasta"
    )


def test_five_taxon_marginal():
    check_composite_marginal(
        make_instance("five_taxon.fasta", "five_taxon_rooted.nwk"),
        "five_taxon.fasta",
    )


def test_ds1_reduced_5_marginal():
    check_composite_marginal(
        make_instance("ds1-reduced-5.fasta", "ds1-reduced-5.nwk"),
        "ds1-reduced-5.fasta",
    )


def test_seven_taxon_marginal():
    check_composite_marginal(
        make_instance(
            "7-taxon-slice-of-ds1.fasta", "simplest-hybrid-marginal-all-trees.nwk"
        ),
        "7-taxon-slice-of-ds1.fasta",
    )


def test_gradient():
    """Golden LL -4.806671945 and dLL/db -0.6109379521 (gp_doctest.cpp:236-239)."""
    inst = make_instance("hello_single_nucleotide.fasta", "hello_rooted.nwk")
    inst.get_engine().branch_lengths = np.array([0.0, 0.22, 0.113, 0.15, 0.1])
    inst.populate_plvs()
    inst.compute_likelihoods()
    root_id = inst.dag.node_count() - 1
    jupiter_id = 0
    ll, dll = inst.get_engine().log_likelihood_and_derivative(root_id, jupiter_id)
    assert abs(ll - -4.806671945) < 1e-6
    assert abs(dll - -0.6109379521) < 1e-6


def test_flua_rescaling():
    """69-taxon fluA (the reference's rescaling stress test,
    gp_doctest.cpp:242-253): with a single-tree DAG the GP marginal must
    equal the classical likelihood of that tree, and stay finite at scale."""
    inst = make_instance("fluA.fa", "fluA.tree")
    inst.get_engine().branch_lengths = np.full(
        inst.dag.gpcsp_count_with_fake(), 0.01
    )
    inst.populate_plvs()
    inst.compute_likelihoods()
    marginal = inst.get_engine().get_log_marginal_likelihood()
    assert np.isfinite(marginal)
    trees = inst.currently_loaded_trees_with_gp_branch_lengths()
    sp = inst.get_engine().site_pattern
    ll = per_pattern_log_likelihoods(trees, sp)
    classical = float(np.sum(ll[0] * sp.weights))
    assert abs(marginal - classical) < 1e-8, (marginal, classical)


def test_hotstart():
    """Mean of 33 bootstrap branch lengths (gp_doctest.cpp:255-287)."""
    inst = make_instance("hotstart.fasta", "hotstart_bootstrap_sample.nwk")
    inst.hot_start_branch_lengths()
    # The PCSP with sister {z2,z3} and children {z0},{z1} appears only in the
    # 33 trees (outgroup,((z0,z1),(z2,z3))); taxon order is
    # [outgroup, z2, z3, z1, z0], so sister|focal|child0 = 01100|00011|00001.
    expected = np.array([
        0.1175370000, 0.1175750000, 0.1195780000, 0.0918962000, 0.0918931000,
        0.1192590000, 0.0906988000, 0.0906972000, 0.0905154000, 0.0903663000,
        0.1245620000, 0.1244890000, 0.1245050000, 0.1245550000, 0.1245680000,
        0.1248920000, 0.1248490000, 0.1164070000, 0.1164110000, 0.1164120000,
        0.1245670000, 0.1245650000, 0.1245670000, 0.1245670000, 0.1240790000,
        0.1242540000, 0.1242160000, 0.1242560000, 0.1892030000, 0.1894900000,
        0.1895430000, 0.1896900000, 0.1905710000,
    ]).mean()
    pretty = dict(inst.pretty_indexed_branch_lengths())
    assert "01100|00011|00001" in pretty
    got = pretty["01100|00011|00001"]
    assert abs(got - expected) < 1e-12


def test_sbn_rootsplit_probabilities_five_taxon():
    """Rootsplit q = softmax(loglik + log prior), closed form
    (gp_doctest.cpp:311-364)."""
    inst = make_instance("five_taxon.fasta", "five_taxon_rooted.nwk")
    eng = inst.get_engine()
    eng.branch_lengths = np.full(inst.dag.gpcsp_count_with_fake(), 0.1)
    inst.populate_plvs()
    inst.compute_likelihoods()
    ll_vector = eng.get_per_gpcsp_log_likelihoods()

    # Exact per-rootsplit conditional marginals by enumerating each
    # rootsplit's trees: per site, log mean over the group's trees.
    trees = inst.generate_complete_rooted_tree_collection()
    assert trees.tree_count() == 4
    sp = eng.site_pattern
    ll = per_pattern_log_likelihoods(trees, sp)
    groups = {}
    for i, tree in enumerate(trees.trees):
        root = sbn_maps.rootsplit_of(tree.topology)
        groups.setdefault(root, []).append(i)
    assert len(groups) == 3

    q_prior = inst.dag.build_uniform_on_topological_support_prior()
    conds, priors, realized = [], [], []
    for root, idxs in groups.items():
        root_gpcsp = inst.dag.rootsplit_index_of_id(
            inst.dag.subsplit_to_id[root + ~root]
        )
        per_site_cond = logsumexp(ll[idxs], axis=0) - np.log(len(idxs))
        conds.append(float(np.sum(per_site_cond * sp.weights)))
        priors.append(np.log(q_prior[root_gpcsp]))
        realized.append(ll_vector[root_gpcsp])
    np.testing.assert_allclose(realized, conds, atol=1e-6)

    # q[s] proportional to exp(conditional loglik + log prior)
    # (gp_doctest.cpp:352-364).
    inst.estimate_sbn_parameters()
    logits = np.array(conds) + np.array(priors)
    logits -= logsumexp(logits)
    realized_q = [
        eng.q[
            inst.dag.rootsplit_index_of_id(inst.dag.subsplit_to_id[root + ~root])
        ]
        for root in groups
    ]
    np.testing.assert_allclose(realized_q, np.exp(logits), atol=1e-6)


def test_generate_all_trees():
    inst = make_instance("five_taxon.fasta", "five_taxon_rooted.nwk")
    trees = inst.generate_complete_rooted_tree_collection()
    assert trees.tree_count() == 4
    assert len(trees.topology_counter()) == 4


def test_trees_with_gp_branch_lengths():
    inst = make_instance("hello_single_nucleotide.fasta", "hello_rooted.nwk")
    inst.get_engine().branch_lengths = np.array([0.0, 0.1, 0.2, 0.3, 0.4])
    trees = inst.currently_loaded_trees_with_gp_branch_lengths()
    out = trees.trees[0].topology.newick(
        ["%g" % b for b in trees.trees[0].branch_lengths],
        trees.tag_taxon_map,
    )
    assert out == "(jupiter:0.2,(mars:0.3,saturn:0.4):0.1):0;"


def test_trees_with_pcsp_filter():
    inst = GPInstance()
    inst.read_fasta_file(f"{DATA}/five_taxon.fasta")
    inst.read_newick_file(f"{DATA}/five_taxon_rooted_more.nwk")
    inst.make_engine()
    inst.get_engine().branch_lengths = np.full(
        inst.dag.gpcsp_count_with_fake(), 0.9
    )
    trees = inst.currently_loaded_trees_with_a_pcsp_string_and_gp_branch_lengths(
        "000010011000010"
    )
    assert trees.tree_count() == 2


def test_priors_four_taxon():
    """Uniform-on-support and uniform-on-all priors (gp_doctest.cpp Priors)."""
    inst = make_instance(
        "four-numbered-taxa.fasta", "four-taxon-two-tree-rootsplit-uncertainty.nwk"
    )
    pretty = inst.pretty_indexer()
    support = inst.dag.build_uniform_on_topological_support_prior()
    all_prior = inst.dag.build_uniform_on_all_topologies_prior()
    by_pretty_support = dict(zip(pretty, support))
    by_pretty_all = dict(zip(pretty, all_prior))
    assert abs(by_pretty_support["0001"] - 2.0 / 3) < 1e-10
    assert abs(by_pretty_support["0011"] - 1.0 / 3) < 1e-10
    assert abs(by_pretty_support["0001|1110|0110"] - 1.0 / 2) < 1e-10
    assert abs(by_pretty_support["0001|1110|0010"] - 1.0 / 2) < 1e-10
    assert abs(by_pretty_all["0001"] - 3.0 / 15) < 1e-10
    assert abs(by_pretty_all["0011"] - 1.0 / 15) < 1e-10
    assert abs(by_pretty_all["0001|1110|0110"] - 1.0 / 3) < 1e-10
    assert abs(by_pretty_all["0001|1110|0010"] - 1.0 / 3) < 1e-10


def test_f32_engine_tracks_f64():
    """make_engine(dtype=float32) (the throughput mode) tracks the f64 marginal to
    ~1e-2 absolute through a full branch-length fit, and keeps PLVs on
    device without breaking downstream consumers."""
    results = {}
    for dtype in (np.float64, np.float32):
        inst = GPInstance()
        inst.read_fasta_file(f"{DATA}/five_taxon.fasta")
        inst.read_newick_file(f"{DATA}/five_taxon_rooted_more.nwk")
        inst.make_engine(dtype=dtype)
        inst.hot_start_branch_lengths()
        inst.estimate_branch_lengths(1e-4, 20, quiet=True)
        inst.estimate_sbn_parameters()
        results[dtype] = inst.get_engine().get_log_marginal_likelihood()
        # Downstream consumers of device-resident rows/PLVs still work.
        per = inst.get_engine().get_per_gpcsp_log_likelihoods()
        assert isinstance(per, np.ndarray)
    assert abs(results[np.float64] - results[np.float32]) < 1e-2


def test_newton_ascent_f32_matches_f64_flua():
    """Derivative-driven (Newton–bisection on the concave-in-u objective)
    branch optimization converges f32 and f64 to the SAME fluA marginal
    within 1e-3 — the quantified agreement the fixed-iteration golden
    section could not deliver (f32 drifted to −4519 vs f64 −4340; see
    ROADMAP.md, findings kept). Reference analog: Brent / analytic-derivative
    optimization, gp_engine.cpp:244-266,326-361."""
    marginals = {}
    for dtype in (np.float64, np.float32):
        inst = GPInstance("fluA")
        inst.read_newick_file(f"{DATA}/fluA.tree")
        inst.read_fasta_file(f"{DATA}/fluA.fa")
        inst.make_engine(dtype=dtype)
        m, iters = inst.get_engine().run_branch_ascent(1e-6, 100)
        assert int(iters) < 30, "ascent should converge in tens of sweeps"
        marginals[dtype] = m
    assert abs(marginals[np.float64] - marginals[np.float32]) < 1e-3
    # Converged value (pinned loosely; monotone ascent can only improve it).
    assert marginals[np.float64] < -4337.0
    assert marginals[np.float64] > -4339.0


def test_gp_sp_sharded_matches_unsharded():
    """GP with the PLV pattern axis sharded over an 8-device "sp" mesh axis
    reproduces the single-device fit (same Newton ascent, XLA inserts the
    pattern-axis psums). This is the GP multi-device path — the scaled-out
    replacement for the reference's mmapped single-host arena
    (mmapped_plv.hpp:19-47)."""
    from libsbn_tpu.parallel.sharding import make_mesh

    def fit(mesh):
        inst = GPInstance()
        inst.read_fasta_file(f"{DATA}/five_taxon.fasta")
        inst.read_newick_file(f"{DATA}/five_taxon_rooted.nwk")
        inst.make_engine(mesh=mesh)
        m, iters = inst.get_engine().run_branch_ascent(1e-8, 50)
        return m, np.asarray(inst.get_engine().branch_lengths)

    m0, bl0 = fit(None)
    mesh = make_mesh(8, dp=1, sp=8)
    m1, bl1 = fit(mesh)
    assert abs(m0 - m1) < 1e-9, (m0, m1)
    np.testing.assert_allclose(bl0, bl1, rtol=1e-9, atol=1e-12)


def test_streamed_ascent_matches_fused():
    """run_branch_ascent_streamed (pattern axis in chunks, per-edge Newton
    stats in host RAM / np.memmap — the beyond-HBM capacity mode replacing
    the reference's disk-mmapped PLV arena, mmapped_plv.hpp:19-47) matches
    the fused in-memory ascent: same sweeps, same marginal, branch lengths
    to 1e-12. Chunk 7 deliberately does not divide the pattern count."""
    def fit(**kw):
        inst = GPInstance()
        inst.read_fasta_file(f"{DATA}/five_taxon.fasta")
        inst.read_newick_file(f"{DATA}/five_taxon_rooted.nwk")
        inst.make_engine()
        eng = inst.get_engine()
        if kw:
            m, it = eng.run_branch_ascent_streamed(1e-8, 50, **kw)
        else:
            m, it = eng.run_branch_ascent(1e-8, 50)
        return m, it, np.asarray(eng.branch_lengths)

    m0, it0, bl0 = fit()
    m1, it1, bl1 = fit(pattern_chunk=7)
    m2, it2, bl2 = fit(pattern_chunk=16, memmap_dir="/tmp")
    assert (it0, m0) == (it1, m1) or abs(m0 - m1) < 1e-9
    assert abs(m0 - m2) < 1e-9
    np.testing.assert_allclose(bl1, bl0, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(bl2, bl0, rtol=1e-10, atol=1e-12)


def test_dot_export_byte_golden():
    """Byte-parity DOT export (subsplit_dag.cpp:77-119): exact traversal
    order (per rootsplit: BeforeNode, rotated=false clade before
    rotated=true, recurse unvisited non-leaf children before VisitEdge),
    leaf labels re-emitted on EVERY edge visit (the reference's quirk),
    record labels, dark23 colorscheme, lone closing brace."""
    from libsbn_tpu.gp.instance import dag_to_dot

    inst = make_instance("hello.fasta", "hello_rooted.nwk")
    expected = (
        "digraph g {\n"
        "node [shape=record];\n"
        "edge [colorscheme=dark23];\n"
        '4 [label="<f0>1,2|<f1>4|<f2>0"]\n'
        '0 [label="<f1>0"]\n'
        '"4":f2->"0":f1 [label="2", color=3, fontcolor=3]\n'
        '3 [label="<f0>1|<f1>3|<f2>2"]\n'
        '2 [label="<f1>2"]\n'
        '"3":f2->"2":f1 [label="4", color=3, fontcolor=3]\n'
        '1 [label="<f1>1"]\n'
        '"3":f0->"1":f1 [label="3", color=1, fontcolor=1]\n'
        '"4":f0->"3":f1 [label="1", color=1, fontcolor=1]\n'
        "}"
    )
    assert dag_to_dot(inst.dag, True) == expected

    # Multi-rootsplit DAG, with and without index labels; note leaf 1 and
    # leaf 0 re-emitted under the second rootsplit (reference behavior).
    inst2 = make_instance("hello.fasta", "hello_rooted_two_trees.nwk")
    out = dag_to_dot(inst2.dag, False)
    assert out.startswith(
        "digraph g {\nnode [shape=record];\nedge [colorscheme=dark23];\n"
    )
    assert out.endswith('"6":f0->"2":f1\n}')
    assert out.count('1 [label="<f1>1"]\n') == 2  # re-emission quirk
    assert '4 [label="<f0>1,2|<f1>|<f2>0"]\n' in out


def test_relative_tolerance_ascent():
    """rtol stops the ascent once per-sweep gains fall below
    tol + rtol*|marginal| — the escape hatch for near-flat objectives
    that hit the sweep cap under an absolute tolerance alone (see
    ROADMAP.md, findings kept; extension over the reference's
    absolute rule, gp_instance.cpp:129-175). A generous rtol must stop
    in no more sweeps than rtol=0 and land within rtol of its marginal;
    rtol=0 keeps the existing behavior bit-for-bit."""
    def fit(rtol):
        inst = GPInstance()
        inst.read_fasta_file(f"{DATA}/five_taxon.fasta")
        inst.read_newick_file(f"{DATA}/five_taxon_rooted.nwk")
        inst.make_engine()
        m, it = inst.get_engine().run_branch_ascent(1e-8, 50, rtol=rtol)
        return m, it

    m_exact, it_exact = fit(0.0)
    m_loose, it_loose = fit(1e-3)
    assert it_loose <= it_exact
    if it_exact > 5:  # strict improvement only meaningful with a long tail
        assert it_loose < it_exact  # 1e-3 of ~17 nats >> the late-sweep gains
    assert abs(m_loose - m_exact) <= 1e-3 * abs(m_exact)

    # The host-loop orchestration accepts rtol too.
    inst = GPInstance()
    inst.read_fasta_file(f"{DATA}/five_taxon.fasta")
    inst.read_newick_file(f"{DATA}/five_taxon_rooted.nwk")
    inst.make_engine()
    inst.estimate_branch_lengths(1e-8, 50, quiet=True, device_loop=False,
                                 rtol=1e-3)
    m_host = float(inst.get_engine().get_log_marginal_likelihood())
    assert abs(m_host - m_exact) <= 1e-3 * abs(m_exact)

    # Streamed path: same stopping rule.
    inst = GPInstance()
    inst.read_fasta_file(f"{DATA}/five_taxon.fasta")
    inst.read_newick_file(f"{DATA}/five_taxon_rooted.nwk")
    inst.make_engine()
    m_st, it_st = inst.get_engine().run_branch_ascent_streamed(
        1e-8, 50, pattern_chunk=16, rtol=1e-3
    )
    assert it_st <= it_exact
    assert abs(m_st - m_exact) <= 1e-3 * abs(m_exact)


@pytest.mark.slow
def test_flat_surface_ascent_converges_below_cap(tmp_path):
    """Near-flat (noise-alignment) surfaces converge at the absolute 1e-4
    tolerance — beyond the old 100-sweep cap but well bounded (the round-3
    'stall' was a cap artifact: period-2 Jacobi oscillation among
    near-zero-signal edges slows the tail, it does not diverge; 9 damping/
    acceleration variants measured (ROADMAP.md, findings kept), none beats the
    plain damped ascent's converged marginal). Robustness bar:
    gp_engine.cpp:326-345 (Brent + reject-if-worse)."""
    rng = np.random.default_rng(0)
    taxa, sites = 60, 256
    names = [f"t{i}" for i in range(taxa)]
    nodes = [f"{n}:0.05" for n in names]
    while len(nodes) > 1:
        i, j = sorted(rng.choice(len(nodes), 2, replace=False))
        b = nodes.pop(j)
        a = nodes.pop(i)
        nodes.append(f"({a},{b}):{rng.uniform(0.02, 0.1):.4f}")
    (tmp_path / "flat.nwk").write_text(nodes[0].rsplit(":", 1)[0] + ";\n")
    with open(tmp_path / "flat.fasta", "w") as f:
        for n in names:
            f.write(f">{n}\n{''.join(rng.choice(list('ACGT'), sites))}\n")

    inst = GPInstance("flat")
    inst.read_newick_file(str(tmp_path / "flat.nwk"))
    inst.read_fasta_file(str(tmp_path / "flat.fasta"))
    inst.make_engine(dtype=np.float64)
    eng = inst.get_engine()
    marginal, iters = eng.run_branch_ascent(1e-4, 400)
    assert iters < 400, f"flat-surface ascent hit the cap ({iters})"
    # Seeded fixture: the converged point is deterministic.
    assert abs(marginal - (-21248.732011)) < 0.5, marginal


def test_ascent_cap_hit_warns(capsys):
    """estimate_branch_lengths surfaces an unconverged (cap-hit) fit
    instead of silently returning (round-5 no-silent-stall guarantee)."""
    inst = GPInstance("warn")
    inst.read_fasta_file(f"{DATA}/five_taxon.fasta")
    inst.read_newick_file(f"{DATA}/five_taxon_rooted.nwk")
    inst.make_engine(dtype=np.float64)
    inst.estimate_branch_lengths(1e-12, 1)  # cap guaranteed to hit
    out = capsys.readouterr().out
    assert "hit max_iter" in out
    inst.estimate_branch_lengths(1e-4, 50)  # converges: no warning
    out = capsys.readouterr().out
    assert "hit max_iter" not in out
