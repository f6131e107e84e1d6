#!/usr/bin/env python3
"""Time the fused JC69 kernel against the XLA scan engine on the paths it
serves, in one process, alternating kernel, XLA, XLA, kernel.

    python tools/kernel_vs_xla.py [--out results.json] [--reps 30]

Rows (float32, DS1 and fluA at full width):

  ds1_b512_pass        LL + branch gradient of 512 perturbed DS1 trees:
                       ops.pruning_jc.fused_jc69 vs scan_jc69
  flua_b64_pass        the same pass at the fluA shape the rooted hand
                       chain feeds it (64 trees, 69 taxa)
  flua_b64_hand_chain  LikelihoodEngine.rooted_phylo_gradients on the
                       selected implementation (the kernel on a GPU); its
                       XLA time is this minus the kernel pass plus the
                       scan pass (the rest of the chain is the same code)
  vbpi_p10_step        JitVBPI on DS1, 10 particles, one step() call, with
                       the step's allow_kernel static on and off
  vbpi_p10_step_many   step_many(16), per step

The kernel needs a GPU; elsewhere its rows are skipped and the XLA rows
still run. Each row prints median, 25th and 75th percentile in ms; both
implementations' results are checked against each other first.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import chip_smoke as cs  # noqa: E402  (instances, batches and the card's name)


def timed(fn, reps, warm=2):
    import jax

    for _ in range(warm):
        jax.block_until_ready(fn())
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    ms = np.asarray(ts) * 1e3
    return [float(np.median(ms)), float(np.percentile(ms, 25)),
            float(np.percentile(ms, 75))]


def pass_inputs(inst, trees, rng, scale=1.0):
    """(post_children, padded branch lengths, tips, weights, root_id) of
    ``trees`` copies of the instance's trees with lengths times ``scale``
    times U(0.8, 1.2)."""
    sch = inst._batched_schedule()
    pc = cs.tile_rows(np.asarray(sch.post_children, np.int32), trees)
    bl = cs.tile_rows(np.pad(inst.branch_length_matrix(), ((0, 0), (0, 1))),
                      trees)
    bl = bl * scale * rng.uniform(0.8, 1.2, bl.shape)
    bl[:, sch.root_id:] = 0.0
    sp = cs.eng_site_pattern(inst)
    return (pc, bl.astype(np.float32), sp.tip_partials(np.float32),
            sp.weights.astype(np.float32), sch.root_id)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", help="write the rows as JSON here")
    parser.add_argument("--reps", type=int, default=30)
    parser.add_argument("--trees", type=int, default=512,
                        help="DS1 batch of the first row")
    opts = parser.parse_args()
    smi = cs.nvidia_smi()

    import jax
    import jax.numpy as jnp

    from libsbn_tpu.models.phylo_model import PhyloModelSpec
    from libsbn_tpu.ops import pruning_jc
    from libsbn_tpu.vi.jit_step import JitVBPI

    kernel_ok = pruning_jc.use_kernel(jnp.float32)
    print(f"card: {smi}", flush=True)
    print(f"jax {jax.__version__}: {jax.devices()[0].device_kind}; kernel "
          f"{'on' if kernel_ok else 'skipped (needs a GPU)'}", flush=True)
    rng = np.random.default_rng(0)
    spec = PhyloModelSpec("JC69", "constant", "strict")

    def pass_fns(args):
        pc, bl, tips, w, root_id = (
            jnp.asarray(a) if not isinstance(a, int) else a for a in args
        )
        fns = {"xla": jax.jit(lambda p, b: pruning_jc.scan_jc69(
            p, b, tips, w, root_id=root_id))}
        if kernel_ok:
            fns["kernel"] = jax.jit(lambda p, b: pruning_jc.fused_jc69(
                p, b, tips, w, root_id=root_id))
        out = {k: f(pc, bl) for k, f in fns.items()}
        if kernel_ok:
            cs.check("  kernel vs XLA LLs", out["kernel"][0], out["xla"][0],
                     rtol=cs.REF_LL_LONG_RTOL)
            cs.check("  kernel vs XLA gradients", out["kernel"][1],
                     out["xla"][1], rtol=cs.ROOTED_GRAD_RTOL)
        return {k: (lambda f=f: f(pc, bl)) for k, f in fns.items()}

    rows = {}
    ds1 = cs.unrooted_instance("DS1.subsampled_10.t")
    rows["ds1_b512_pass"] = pass_fns(pass_inputs(ds1, opts.trees, rng))
    finst = cs.flua_instance(spec)
    # fluA's branch lengths are in years. The pass's time does not depend
    # on their values; scaled by 0.1 they lie in 0.002-0.3 substitutions
    # per site, where f32 branch gradients are well conditioned and the
    # two implementations can be compared (at the strict clock's 0.001
    # the shortest branches are ~1e-5, and both lose digits in 1 - e).
    rows["flua_b64_pass"] = pass_fns(
        pass_inputs(finst, cs.FLUA_TREES, rng, scale=0.1)
    )

    feng = cs.f32_engine(finst, spec)
    fsch = cs.batched_like(finst._batched_schedule(), cs.FLUA_TREES)
    fb, fr, frt = (jnp.asarray(cs.tile_rows(a, cs.FLUA_TREES), jnp.float32)
                   for a in finst._time_tree_arrays())
    fp = cs.f32_params(finst._compute_params()[0])
    rows["flua_b64_hand_chain"] = {
        ("kernel" if kernel_ok else "xla"): lambda: feng.rooted_phylo_gradients(
            fsch, fb, fr, frt, fp)["ratios_root_height"]
    }

    vbpi = {}
    for label, allow in (("kernel", True), ("xla", False)):
        if allow and not kernel_ok:
            continue
        jv = JitVBPI(cs.vbpi_instance(), particle_count=10, seed=0,
                     dtype=jnp.float32)
        jv.statics = jv.statics._replace(allow_kernel=allow)
        vbpi[label] = jv
    rows["vbpi_p10_step"] = {
        k: (lambda jv=jv: jv.step()["mean_ll"]) for k, jv in vbpi.items()
    }
    rows["vbpi_p10_step_many"] = {
        k: (lambda jv=jv: jv.step_many(16)["mean_ll"]) for k, jv in vbpi.items()
    }

    results = {"card": smi, "device": jax.devices()[0].device_kind}
    for name, fns in rows.items():
        per = 16 if name == "vbpi_p10_step_many" else 1
        reps = max(3, opts.reps // per)
        order = ["kernel", "xla", "xla", "kernel"]
        for label in [x for x in order if x in fns]:
            ms = [x / per for x in timed(fns[label], reps)]
            results.setdefault(name, {}).setdefault(label, []).append(ms)
            print(f"{name} {label}: median {ms[0]:.3f} ms (q25 {ms[1]:.3f}, "
                  f"q75 {ms[2]:.3f})", flush=True)
    if opts.out:
        with open(opts.out, "w") as f:
            json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
