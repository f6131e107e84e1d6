"""Device-vs-native throughput at configurable scale (taxa x patterns):

    python tools/scale_compare.py [taxa] [patterns] [batch]

Workload: LL + linear-time branch gradient on a random unrooted tree
with one-hot random tips, in f32 on the JC69 path ops/pruning_jc.py
selects (the fused kernel on a GPU) vs native/cpu_baseline.cpp. The
native side runs f64: its unscaled f32 path underflows to -inf beyond
~100 taxa (the device path rescales per level and stays f32). Gradient
parity device-f32 vs native-f64 is asserted at 1e-4 relative.
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np  # noqa: E402


def main():
    import jax
    import jax.numpy as jnp

    from libsbn_tpu.core.topology import Topology
    from libsbn_tpu.ops import pruning_jc, schedule
    from libsbn_tpu.utils import cpu_baseline

    taxa = int(sys.argv[1]) if len(sys.argv) > 1 else 200
    S = int(sys.argv[2]) if len(sys.argv) > 2 else 1024
    B = int(sys.argv[3]) if len(sys.argv) > 3 else 64
    rng = np.random.default_rng(0)

    nodes = [Topology.leaf(i) for i in range(taxa)]
    while len(nodes) > 3:
        i, j = sorted(rng.choice(len(nodes), 2, replace=False), reverse=True)
        a, b = nodes.pop(i), nodes.pop(j)
        nodes.append(Topology.join2(a, b))
    top = Topology.join(nodes)
    top.polish()
    sch = schedule.schedule_of_topology(top)

    tile = lambda a: np.tile(a[None], (B,) + (1,) * a.ndim)  # noqa: E731
    pc = tile(np.asarray(sch.post_children)).astype(np.int32)
    bl = rng.uniform(0.01, 0.3, (B, sch.node_count + 1))
    bl[:, sch.root_id] = 0.0
    bl[:, -1] = 0.0
    states = rng.integers(0, 4, (taxa, S))
    tips = np.zeros((taxa, 4, S), np.float32)
    tips[np.arange(taxa)[:, None], states, np.arange(S)[None, :]] = 1.0
    w = np.ones(S, np.float32)

    fn = jax.jit(
        lambda b: pruning_jc.log_likelihood_and_branch_gradient_jc69(
            pc, b, tips, w, root_id=sch.root_id
        )
    )
    b32 = jnp.asarray(bl, jnp.float32)
    out = fn(b32)
    grad_t = np.asarray(out[1])
    t0 = time.perf_counter()
    for _ in range(10):
        out = fn(b32)
    jax.block_until_ready(out)
    device = B * 10 / (time.perf_counter() - t0)

    run_native = lambda: cpu_baseline.eval_batch(  # noqa: E731
        pc, tile(np.asarray(sch.up_node)), tile(np.asarray(sch.up_parent)),
        tile(np.asarray(sch.up_sibs)), bl, tips.astype(np.float64),
        w.astype(np.float64), taxa, threads=0, dtype_bits=64,
    )
    ll_n, grad_n = run_native()
    t0 = time.time()
    run_native()
    native = B / (time.time() - t0)

    ne = sch.node_count - 1
    rel = np.max(
        np.abs(grad_t[:, :ne] - grad_n[:, :ne]) / (np.abs(grad_n[:, :ne]) + 1)
    )
    assert rel < 1e-4, f"gradient parity broke at scale: {rel}"
    print(
        f"{taxa} taxa x {S} patterns (B={B}): "
        f"{jax.devices()[0].device_kind} {device:,.0f} evals/s, "
        f"native f64 {native:,.0f} evals/s -> {device / native:.1f}x "
        f"(grad parity {rel:.1e})"
    )


if __name__ == "__main__":
    main()
