"""End-to-end DS1 VBPI training soak on the attached backend.

Soak protocol (ROADMAP.md, findings kept, "DS1 VBPI soak"): 20k JitVBPI
steps, 10 particles, VIMCO, split-lognormal,
beta annealed over 2k steps, step_many(20) dispatch; asserts the converged
importance-weighted marginal against the recorded value.

Usage: python tools/soak_vbpi.py [n_steps]
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402


def main():
    import jax.numpy as jnp

    from libsbn_tpu import UnrootedInstance
    from libsbn_tpu.models.phylo_model import PhyloModelSpec
    from libsbn_tpu.vi.jit_step import JitVBPI

    n_target = int(sys.argv[1]) if len(sys.argv) > 1 else 20000
    data = os.path.join(os.path.dirname(__file__), "..", "data")
    inst = UnrootedInstance("soak")
    inst.read_nexus_file(f"{data}/DS1.subsampled_10.t")
    inst.process_loaded_trees()
    inst.train_simple_average()
    inst.read_fasta_file(f"{data}/DS1.fasta")
    inst.prepare_for_phylo_likelihood(
        PhyloModelSpec("JC69", "constant", "strict")
    )
    jv = JitVBPI(inst, particle_count=10, seed=0, dtype=jnp.float32)
    t0 = time.time()
    n_steps = 0
    while n_steps < n_target:
        beta = min(1.0, (n_steps + 1) / 2000)
        jv.step_many(20, beta=beta)
        n_steps += 20
    dt = time.time() - t0
    elbo = float(jv.estimate_elbo(100))
    marg = float(jv.marginal_likelihood_estimate(1000))
    print(f"soak: {n_steps} steps in {dt:.1f}s ({dt / n_steps * 1e3:.2f} ms/step)")
    print(f"ELBO(100)={elbo:.2f}  IW marginal(1000)={marg:.2f}")
    assert np.isfinite(elbo) and np.isfinite(marg)
    if n_target >= 20000:
        # Round-3 recorded -6768.50; round-5 measured -6768.04.
        assert marg > -6790, f"IW marginal regressed: {marg}"
    print("SOAK OK")


if __name__ == "__main__":
    main()
