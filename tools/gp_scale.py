"""GP scale measurement: a >=200-taxa, >=4k-pattern generalized-pruning
fit. Generates a random coalescent-style tree and a
random alignment (random sequences barely compress, so patterns ~ sites),
builds the subsplit DAG, and times the fused and streamed ascents.

Usage: python tools/gp_scale.py [taxa] [sites] [--f32]
(JAX_PLATFORMS=cpu runs it on the CPU.)
(default 200 taxa, 4096 sites, f64 on CPU).
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def make_data(taxa: int, sites: int, tmpdir: str, seed=0):
    rng = np.random.default_rng(seed)
    names = [f"t{i}" for i in range(taxa)]
    # Random binary tree by sequential joining.
    nodes = [f"{n}:0.05" for n in names]
    while len(nodes) > 1:
        i, j = sorted(rng.choice(len(nodes), 2, replace=False))
        b = nodes.pop(j)
        a = nodes.pop(i)
        nodes.append(f"({a},{b}):{rng.uniform(0.02, 0.1):.4f}")
    newick = nodes[0].rsplit(":", 1)[0] + ";"
    tree_path = f"{tmpdir}/scale.nwk"
    with open(tree_path, "w") as f:
        f.write(newick + "\n")
    fasta_path = f"{tmpdir}/scale.fasta"
    with open(fasta_path, "w") as f:
        for n in names:
            seq = "".join(rng.choice(list("ACGT"), sites))
            f.write(f">{n}\n{seq}\n")
    return tree_path, fasta_path


def main():
    taxa = int(sys.argv[1]) if len(sys.argv) > 1 else 200
    sites = int(sys.argv[2]) if len(sys.argv) > 2 else 4096
    dtype = np.float32 if "--f32" in sys.argv else np.float64
    import tempfile

    from libsbn_tpu.gp.instance import GPInstance

    tree_path, fasta_path = make_data(taxa, sites, tempfile.gettempdir())
    t0 = time.time()
    inst = GPInstance("scale")
    inst.read_newick_file(tree_path)
    inst.read_fasta_file(fasta_path)
    inst.make_engine(dtype=dtype)
    eng = inst.get_engine()
    N = inst.dag.node_count()
    E = inst.dag.gpcsp_count_with_fake()
    S = eng.patterns
    item = np.dtype(dtype).itemsize
    arena_mb = 6 * (N + 1) * 4 * S * item / 2**20
    print(
        f"taxa={taxa} sites={sites} patterns={S} dag_nodes={N} gpcsps={E} "
        f"PLV arena={arena_mb:.0f} MB ({np.dtype(dtype).name}); "
        f"build {time.time() - t0:.1f}s"
    )
    t0 = time.time()
    m, it = eng.run_branch_ascent(1e-4, 20)
    t_fused = time.time() - t0
    print(f"fused ascent:    marginal={m:.4f} sweeps={it} time={t_fused:.1f}s")
    eng.branch_lengths = np.full_like(eng.branch_lengths, 0.1)
    t0 = time.time()
    m2, it2 = eng.run_branch_ascent_streamed(
        1e-4, 20, pattern_chunk=512, finalize=False
    )
    t_str = time.time() - t0
    print(
        f"streamed ascent: marginal={m2:.4f} sweeps={it2} time={t_str:.1f}s "
        f"(chunk=512; device arena {arena_mb * 512 / S:.0f} MB)"
    )
    assert abs(m - m2) < max(1e-3, 1e-6 * abs(m))


if __name__ == "__main__":
    main()
