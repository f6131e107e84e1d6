"""Back the tidy-DAG design deviation with data.

The reference's TidySubsplitDAG (/root/reference/src/tidy_subsplit_dag.hpp:
4-11, 68-100) tracks, per PLV, whether it is current, so its sequential
per-edge branch optimization can recompute only the PLVs an edge update
dirtied. Our GP engine instead optimizes EVERY edge simultaneously
(one Jacobi Newton sweep + damped line search) and then repopulates all
PLVs in one fused level-batched XLA program — after a global update,
every PLV is stale anyway, so "minimal" == "full".

This tool quantifies the comparison the parity map argues in prose: the
total PLV-update work a tidy minimal-update schedule performs in ONE
coordinate pass over all edges (sum over edges of the rootward + leafward
stale closures, times the per-edge optimizer's inner iterations) versus
our full-repopulate cost (node_count per sweep, times the measured number
of sweeps to convergence), plus the measured wall-clock of a fused sweep.

Usage: python tools/tidy_measure.py [--scale TAXA SITES]
(JAX_PLATFORMS=cpu runs it on the CPU.)
Writes a markdown table to stdout (ROADMAP.md, findings kept, "Tidy-DAG
deviation").
"""

import os
import sys
import time

_DATA_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "data")

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def closure_sizes(dag):
    """Per-edge stale-set sizes under a tidy minimal-update scheme.

    Updating edge (parent, child) invalidates p-PLVs from parent rootward
    to the DAG root (they aggregate the edge's likelihood contribution)
    and r-PLVs from parent leafward (they read the parent's other-side
    p-hat). We BFS both directions and count DAG nodes touched."""
    n = dag.node_count()
    rootward = [[] for _ in range(n)]
    leafward = [[] for _ in range(n)]
    for node_id in range(n):
        node = dag.nodes[node_id]
        for rot in (False, True):
            for p in node.get_rootward(rot):
                rootward[node_id].append(p)
            for c in node.get_leafward(rot):
                leafward[node_id].append(c)

    def bfs(start, adj):
        seen = {start}
        stack = [start]
        while stack:
            x = stack.pop()
            for y in adj[x]:
                if y not in seen:
                    seen.add(y)
                    stack.append(y)
        return len(seen)

    ups, downs = [], []
    for parent_id, child_id, _rot, _g in dag.edge_list():
        ups.append(bfs(parent_id, rootward))
        downs.append(bfs(parent_id, leafward))
    return np.array(ups), np.array(downs)


def measure(name, fasta, newick_file, dtype, brent_iters=7):
    from libsbn_tpu.gp.instance import GPInstance

    inst = GPInstance(name)
    inst.read_fasta_file(fasta)
    inst.read_newick_file(newick_file)
    inst.make_engine(dtype=dtype)
    eng = inst.get_engine()
    dag = inst.dag
    N = dag.node_count()
    E = len(dag.edge_list())

    ups, downs = closure_sizes(dag)
    tidy_per_pass = int(np.sum(ups + downs))

    # Full-repopulate: time one fused populate and one full ascent.
    t0 = time.time()
    eng.populate_plvs()
    populate_s = time.time() - t0
    t0 = time.time()
    marginal, sweeps = eng.run_branch_ascent(1e-4, 100)
    ascent_s = time.time() - t0
    sweeps = int(sweeps)

    full_work = sweeps * N
    # A tidy pass optimizes each edge once; Brent-style per-edge ascent
    # does ~brent_iters objective evaluations, each needing the stale
    # closure refreshed before the next read (tidy makes the refresh
    # minimal but it still happens per move). One pass's PLV updates:
    tidy_work = tidy_per_pass * brent_iters
    return {
        "name": name,
        "taxa": dag.taxon_count,
        "nodes": N,
        "edges": E,
        "mean_up": float(np.mean(ups)),
        "mean_down": float(np.mean(downs)),
        "tidy_per_pass": tidy_per_pass,
        "tidy_work": tidy_work,
        "sweeps": sweeps,
        "full_work": full_work,
        "populate_s": populate_s,
        "ascent_s": ascent_s,
        "marginal": float(marginal),
    }


def main():
    dtype = np.float64

    rows = []
    data = _DATA_DIR
    rows.append(
        measure("fluA-69taxa", f"{data}/fluA.fa", f"{data}/fluA.tree", dtype)
    )

    if "--scale" in sys.argv:
        i = sys.argv.index("--scale")
        taxa, sites = int(sys.argv[i + 1]), int(sys.argv[i + 2])
    else:
        taxa, sites = 200, 1024
    from gp_scale import make_data

    import tempfile

    tree_path, fasta_path = make_data(taxa, sites, tempfile.gettempdir())
    rows.append(measure(f"random-{taxa}taxa", fasta_path, tree_path, dtype))

    # A denser multi-tree DAG: DS1's 10 subsampled topologies.
    # (GPInstance reads nexus via read_nexus-equivalent? use newick export)
    print(
        "| DAG | nodes | edges | mean stale-set (up+down) | tidy PLV-updates"
        " / pass (x7 Brent iters) | full-repopulate PLV-updates (sweeps x N)"
        " | tidy / full | populate s | ascent s (sweeps) |"
    )
    print("|---|---|---|---|---|---|---|---|---|")
    for r in rows:
        print(
            f"| {r['name']} | {r['nodes']} | {r['edges']} "
            f"| {r['mean_up']:.1f}+{r['mean_down']:.1f} "
            f"| {r['tidy_work']:,} | {r['full_work']:,} "
            f"({r['sweeps']}x{r['nodes']}) "
            f"| {r['tidy_work'] / r['full_work']:.1f}x "
            f"| {r['populate_s']:.2f} | {r['ascent_s']:.2f} ({r['sweeps']}) |"
        )


if __name__ == "__main__":
    main()
