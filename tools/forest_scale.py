"""Forest-engine scale measurement: sharing and throughput on an
SBN-sampled support (the regime fixed-support workloads actually see).

Trains SA on DS1.100_topologies, samples N topologies from the SBN
(native bulk sampler), hash-conses them into a forest, and measures the
split-keyed evaluation surfaces. Usage:
  python tools/forest_scale.py [n_trees]
(JAX_PLATFORMS=cpu runs it on the CPU.)
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402


def main():
    n_trees = int(sys.argv[1]) if len(sys.argv) > 1 else 1000
    import jax
    import jax.numpy as jnp

    from libsbn_tpu import UnrootedInstance
    from libsbn_tpu.core.site_pattern import SitePattern
    from libsbn_tpu.io.fasta import Alignment
    from libsbn_tpu.ops import forest

    data = os.path.join(os.path.dirname(__file__), "..", "data")
    inst = UnrootedInstance("scale")
    inst.read_newick_file(f"{data}/DS1.100_topologies.nwk")
    inst.process_loaded_trees()
    inst.train_simple_average()
    t0 = time.time()
    inst.sample_trees(n_trees)
    sample_s = time.time() - t0
    tops = [t.topology for t in inst.tree_collection.trees]
    for t in tops:
        if t.id < 0:
            t.polish()
    t0 = time.time()
    fs = forest.build_forest(tops)
    build_s = time.time() - t0
    st = forest.forest_stats(fs)
    print(
        f"{n_trees} SBN-sampled trees: sample {sample_s*1e3:.0f} ms, "
        f"build {build_s*1e3:.0f} ms"
    )
    print(
        f"sharing: down {st['down_internal_total']}/"
        f"{st['down_internal_unique']} = "
        f"{st['down_internal_total']/st['down_internal_unique']:.1f}x, "
        f"up {st['up_total']}/{st['up_unique']} = "
        f"{st['up_total']/st['up_unique']:.1f}x, "
        f"edges {st['edges_total']}/{st['edges_unique']} = "
        f"{st['edges_total']/st['edges_unique']:.1f}x, "
        f"splits {fs.n_splits}"
    )

    ttm = inst.tree_collection.tag_taxon_map
    sp = SitePattern(Alignment.read_fasta(f"{data}/DS1.fasta"), ttm)
    tips = jnp.asarray(sp.tip_partials(np.float32))
    w = jnp.asarray(sp.weights, jnp.float32)
    rng = np.random.default_rng(0)
    R = 8
    bl = jax.device_put(jnp.asarray(
        rng.uniform(0.02, 0.2, (R, fs.n_splits)).astype(np.float32)
    ))

    # One timing methodology for the whole repo: bench.py's harness
    # (value-fetch barriers, fixed iteration counts, best-of-windows).
    from bench import timed_evals_per_sec as timed

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
    fn_opt = jax.jit(jax.vmap(
        lambda b: forest.forest_jc_weighted_ll_and_split_gradient(
            fs, b, tips, w
        )
    ))
    n_evals = R * n_trees
    print(f"LL-only:        {timed(lambda: fn_ll(bl), n_evals):,.0f} evals/s")
    print(f"LL+grad (bf16): {timed(lambda: fn_full(bl), n_evals):,.0f} evals/s")
    print(f"LL+split-grad:  {timed(lambda: fn_opt(bl), n_evals):,.0f} evals/s")


if __name__ == "__main__":
    main()
