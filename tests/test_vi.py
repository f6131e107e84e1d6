"""VBPI training loop tests (reference: vip/test/test_burrito.py,
test_scalar_models.py, test_priors.py)."""

import os
import numpy as np
import pytest

from libsbn_tpu.models.phylo_model import PhyloModelSpec
from libsbn_tpu.vi import priors, scalar_models
from libsbn_tpu.vi.burrito import Burrito

DATA = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data"
)


def test_log_exp_prior():
    sample = np.array([[1.0, 2.0, 3.0], [0.26097, 0.0286401, 0.113843]])
    # Sum of Exponential(10) log densities: log(10)*n - 10*sum.
    expected = np.log(10.0) * 3 - 10.0 * sample.sum(axis=1)
    np.testing.assert_allclose(priors.log_exp_prior(sample), expected)


def test_lognormal_log_prob_closed_form():
    params = np.array([[0.4, 1.3], [-2.0, 4.0], [3.0, 0.2]])
    sample = np.array([0.3, 3.14159, 0.0001])
    model = scalar_models.LogNormalModel(3)
    model.q_params[:, :] = params
    ours = model.log_prob(sample, which_variables=np.arange(3))
    # Independent closed form.
    mu, sigma = params[:, 0], params[:, 1]
    expected = np.sum(
        -np.log(sample) - np.log(sigma) - 0.5 * np.log(2 * np.pi)
        - (np.log(sample) - mu) ** 2 / (2 * sigma**2)
    )
    assert ours == pytest.approx(expected)


def test_lognormal_gradients_match_ad():
    """Hand-derived dg/dpsi and dlog_qg/dpsi (eq:dgdPsi, eq:dlogqgdPsi) must
    equal AD of the reparameterization."""
    import jax
    import jax.numpy as jnp

    params = np.array([[0.4, 1.3], [-2.0, 0.7], [3.0, 0.2]])
    model = scalar_models.LogNormalModel(3)
    model.q_params[:, :] = params
    which = np.array([[0, 1, 2]])
    sample, dg_dpsi, dlog_qg_dpsi = model.sample_and_gradients(which)
    eps = (np.log(sample[0]) - params[:, 0]) / params[:, 1]

    def g(psi):
        mu, sigma = psi[:, 0], psi[:, 1]
        return jnp.exp(mu + sigma * jnp.asarray(eps))

    jac = jax.jacobian(g)(jnp.asarray(params))  # (3, 3, 2)
    for v in range(3):
        np.testing.assert_allclose(dg_dpsi[0, v], jac[v, v], rtol=1e-9)

    def log_q_of_psi(psi):
        mu, sigma = psi[:, 0], psi[:, 1]
        theta = jnp.exp(mu + sigma * jnp.asarray(eps))
        return jnp.sum(
            -jnp.log(theta) - jnp.log(sigma) - 0.5 * jnp.log(2 * jnp.pi)
            - (jnp.log(theta) - mu) ** 2 / (2 * sigma**2)
        )

    jq = jax.grad(log_q_of_psi)(jnp.asarray(params))
    np.testing.assert_allclose(dlog_qg_dpsi[0], jq, rtol=1e-9)


@pytest.fixture(scope="module")
def hello_burrito():
    return Burrito(
        mcmc_nexus_path=f"{DATA}/hello_out.t",
        burn_in_fraction=0,
        fasta_path=f"{DATA}/hello.fasta",
        phylo_model_specification=PhyloModelSpec("JC69", "constant", "strict"),
        branch_model_name="split",
        scalar_model_name="lognormal",
        optimizer_name="simple",
        particle_count=1,
    )


def test_elbo_innards(hello_burrito):
    """Golden ELBO internals 'From Mathieu' (vip/test/test_burrito.py)."""
    burro = hello_burrito
    burro.sample_topologies(1)
    theta_sample = np.array([0.184472, 0.027993, 0.045583])
    px_theta_sample = theta_sample[None, :]
    for tree in burro.inst.tree_collection.trees:
        tree.branch_lengths[:-1] = theta_sample

    mathieu_q_params = np.array(
        [[-1.728809, 0.459529], [-2.410943, 0.748569], [-2.410977, 0.748571]]
    )
    px_branch_representation = burro.branch_model.px_branch_representation()
    branch_rep = px_branch_representation[0]
    burro.branch_model.scalar_model.q_params[branch_rep, :] = mathieu_q_params

    lls = burro.inst.log_likelihoods()
    assert lls[0] == pytest.approx(-81.446550)
    assert burro.branch_model.log_prior(px_theta_sample)[0] == pytest.approx(
        4.327275
    )
    assert burro.branch_model.log_prob(
        px_theta_sample, px_branch_representation
    ) == pytest.approx(5.330697, rel=1e-5)


@pytest.mark.parametrize("branch_model_name", ["split", "psp"])
def test_gradient_steps_improve_elbo(branch_model_name):
    """Short VBPI runs should run end-to-end and not diverge."""
    burro = Burrito(
        mcmc_nexus_path=f"{DATA}/hello_out.t",
        burn_in_fraction=0,
        fasta_path=f"{DATA}/hello.fasta",
        phylo_model_specification=PhyloModelSpec("JC69", "constant", "strict"),
        branch_model_name=branch_model_name,
        scalar_model_name="lognormal",
        optimizer_name="simple",
        particle_count=4,
        seed=1,
    )
    start = np.mean([burro.estimate_elbo(20) for _ in range(5)])
    burro.gradient_steps(30)
    end = np.mean([burro.estimate_elbo(20) for _ in range(5)])
    assert np.isfinite(end)
    assert end > start - 5.0  # not diverging; usually improves
    ml = burro.marginal_likelihood_estimate(50)
    assert np.isfinite(ml)


def test_optimizer_trajectory_golden():
    """The optax-based optimizers must reproduce the reference optimizer
    semantics (vip/optimizers.py:83-127, vip/sgd_server.py adam) exactly:
    golden trajectories recorded from the pre-rewrite port on scripted
    gradients (tools/capture_opt_golden.py), including a non-finite step at
    t=7 and a forced windowed-ELBO turn-around."""
    from libsbn_tpu.vi import optimizers

    class DummyScalarModel:
        def __init__(self):
            self.q_params = np.zeros((4, 2))

        def suggested_step_size(self):
            return 0.1

    class DummyInst:
        def __init__(self):
            self.sbn_parameters = np.zeros(6)

    def run(opt_name, steps=25):
        rng = np.random.default_rng(42)
        sm, inst = DummyScalarModel(), DummyInst()
        elbo_script = iter(np.concatenate([
            np.linspace(-100.0, -80.0, 12),
            np.linspace(-85.0, -95.0, 8),
            np.linspace(-90.0, -88.0, 10),
        ]))
        opt = optimizers.of_name(
            opt_name, inst, sm, lambda particle_count: next(elbo_script)
        )
        for t in range(steps):
            g_scalar = rng.normal(size=sm.q_params.shape)
            g_sbn = rng.normal(size=inst.sbn_parameters.shape)
            if t == 7:
                g_scalar[0, 0] = np.nan
            opt.gradient_step({"scalar_params": g_scalar, "sbn_params": g_sbn})
        return sm.q_params, np.asarray(inst.sbn_parameters), opt.step_size

    golden_sbn = [0.00625997775297908, -0.00482123994754173,
                  -0.00356712387527671, -0.00282605875008791,
                  0.00520004015586435, 0.00412473711705528]

    q, sbn, step = run("simple")
    np.testing.assert_allclose(q, [
        [0.23821568852482944, -0.4106849239434605],
        [0.37644719998301396, 0.36710732397569545],
        [-0.5150804716844086, -0.6357384987438139],
        [0.43277085260722786, -0.0312598286768741]], rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(sbn, golden_sbn, rtol=1e-12, atol=1e-14)
    assert step == pytest.approx(0.03928390704036094, rel=1e-12)

    q, sbn, step = run("bump")
    np.testing.assert_allclose(q, [
        [0.15261367830466793, -0.5971235845294068],
        [0.5380459394059177, 0.6889955471485564],
        [-0.9007971628919077, -1.0723958517501575],
        [0.8193473043582463, 0.14955118246467874]], rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(sbn, golden_sbn, rtol=1e-12, atol=1e-14)
    assert step == pytest.approx(0.07475534218409334, rel=1e-12)


@pytest.mark.parametrize(
    "name", ["tf_lognormal", "tf_gamma", "tf_truncated_lognormal"]
)
@pytest.mark.slow
def test_ad_scalar_models(name):
    """The AD scalar-model zoo (reference: TFScalarModel wrappers): samplers,
    densities, and gradients are finite; the AD lognormal's gradients match
    the hand-coded eq:dgdPsi/eq:dlogqgdPsi exactly."""
    model = scalar_models.of_name(name, 3)
    which = np.array([[0, 1, 2], [2, 1, 0]])
    sample, dg, dq = model.sample_and_gradients(which)
    assert sample.shape == (2, 3)
    assert np.all(sample > 0)
    assert np.isfinite(dg).all() and np.isfinite(dq).all()
    assert np.isfinite(model.log_prob(sample[0], which[0]))
    model.mode_match(np.array([0.1, 0.2, 0.05]))
    assert np.isfinite(model.q_params).all()


def test_ad_lognormal_matches_hand_coded():
    params = np.array([[0.4, 1.3], [-2.0, 0.7], [3.0, 0.2]])
    ad = scalar_models.of_name("tf_lognormal", 3)
    ad.q_params[:] = params
    hand = scalar_models.LogNormalModel(3)
    hand.q_params[:] = params
    which = np.array([[0, 1, 2]])
    sample, dg, dq = ad.sample_and_gradients(which)
    _, hand_dg, hand_dq = hand.sample_and_gradients(
        which, prebaked_sample=sample
    )
    np.testing.assert_allclose(dg[0], hand_dg[0], rtol=1e-8)
    np.testing.assert_allclose(dq[0], hand_dq[0], rtol=1e-8)


@pytest.mark.slow
def test_burrito_with_gamma_scalar_model():
    burro = Burrito(
        mcmc_nexus_path=f"{DATA}/hello_out.t",
        burn_in_fraction=0,
        fasta_path=f"{DATA}/hello.fasta",
        phylo_model_specification=PhyloModelSpec("JC69", "constant", "strict"),
        branch_model_name="split",
        scalar_model_name="tf_gamma",
        optimizer_name="simple",
        particle_count=4,
        seed=5,
    )
    burro.gradient_steps(10)
    assert np.isfinite(burro.estimate_elbo(20))


def test_jit_vbpi_psp_matches_reference_gradient(data_dir):
    """The jitted PSP scalar gradient (eq:dLdPsi over 3 component rows)
    equals branch_models.PSPModel.scalar_grad on controlled inputs, and PSP
    training improves the mean log likelihood."""
    import jax

    from libsbn_tpu import UnrootedInstance
    from libsbn_tpu.models.phylo_model import PhyloModelSpec
    from libsbn_tpu.vi import branch_models
    from libsbn_tpu.vi.jit_step import JitVBPI

    inst = UnrootedInstance("DS1")
    inst.read_nexus_file(f"{data_dir}/DS1.subsampled_10.t")
    inst.read_fasta_file(f"{data_dir}/DS1.fasta")
    inst.process_loaded_trees()
    inst.train_simple_average()
    inst.prepare_for_phylo_likelihood(PhyloModelSpec("JC69", "constant", "none"), 1)

    pm = branch_models.PSPModel("lognormal", inst)
    V = pm.scalar_model.variable_count
    rng = np.random.default_rng(5)
    q = rng.normal(size=(V, 2)) * 0.1 + np.array([-0.7, 0.2])
    q[-1] = 0.0
    pm.q_params[:] = q
    tops = [t.topology for t in inst.tree_collection.trees[:3]]
    px = np.asarray(
        [inst.psp_indexer.representation_of(t) for t in tops], np.int32
    )
    P, C, B = px.shape
    eps = rng.normal(size=(P, B))
    mu = q[px, 0].sum(axis=1)
    sigma = q[px, 1].sum(axis=1)
    theta = np.exp(mu + sigma * eps)
    bgrads = rng.normal(size=(P, B))

    dg = np.zeros((P, V, 2))
    dlq = np.zeros((P, V, 2))
    dlq[:, :, 0] = -1.0
    for i, rep in enumerate(px):
        epsilon = (np.log(theta[i]) - mu[i]) / sigma[i]
        for wv in rep:
            dg[i, wv, 0] = theta[i]
            dg[i, wv, 1] = theta[i] * epsilon
            dlq[i, wv, 1] = -epsilon - 1.0 / sigma[i]
    ref = pm.scalar_grad(theta, bgrads, px, dg, dlq)

    dlogp = bgrads + pm.grad_log_prior(theta)
    g0 = dlogp * theta - (-1.0)
    g1 = dlogp * theta * eps - (-eps - 1.0 / sigma)
    mine = np.zeros((V, 2))
    occ = px.reshape(-1)
    np.add.at(mine, (occ, np.zeros_like(occ)),
              np.broadcast_to(g0[:, None, :], (P, C, B)).reshape(-1))
    np.add.at(mine, (occ, np.ones_like(occ)),
              np.broadcast_to(g1[:, None, :], (P, C, B)).reshape(-1))
    mine[-1] = 0.0
    np.testing.assert_allclose(mine, ref, atol=1e-12)

    v = JitVBPI(inst, particle_count=5, seed=0, branch_model="psp")
    lls = [float(v.step()["mean_ll"]) for _ in range(60)]
    assert np.mean(lls[-10:]) > np.mean(lls[:10])


@pytest.mark.slow
def test_step_many_matches_step_trajectory(data_dir):
    """step_many(K) samples the K-step window's topologies from SBN params
    frozen at dispatch (up to K-1 updates stale); the MC gradient must
    tolerate that. Gate: on DS1 (deterministic CPU f64, fixed seeds), the
    tail-mean ELBO gap between K=16 windows and K=1 live stepping is an
    order of magnitude INSIDE the K=1 between-seed MC spread (measured:
    gap 11.3 vs spread 125 at 160 steps; ROADMAP.md, findings kept,
    "step_many staleness")."""
    from libsbn_tpu import UnrootedInstance
    from libsbn_tpu.vi.jit_step import JitVBPI

    def make(seed):
        inst = UnrootedInstance("ds1")
        inst.read_nexus_file(f"{data_dir}/DS1.subsampled_10.t")
        inst.process_loaded_trees()
        inst.train_simple_average()
        inst.read_fasta_file(f"{data_dir}/DS1.fasta")
        inst.prepare_for_phylo_likelihood(
            PhyloModelSpec("JC69", "constant", "strict")
        )
        return JitVBPI(inst, particle_count=10, seed=seed)

    n_steps = 160
    tails = {}
    for mode in ("k1", "k16"):
        vals = []
        for seed in (0, 1):
            jv = make(seed)
            elbos = []
            if mode == "k1":
                for _ in range(n_steps):
                    elbos.append(float(jv.step(beta=1.0)["elbo_like"]))
            else:
                for _ in range(n_steps // 16):
                    m = jv.step_many(16, beta=1.0)
                    elbos.extend(np.asarray(m["elbo_like"]).ravel().tolist())
            vals.append(float(np.mean(elbos[-n_steps // 5:])))
        tails[mode] = vals
    gap = abs(np.mean(tails["k1"]) - np.mean(tails["k16"]))
    seed_spread = abs(tails["k1"][0] - tails["k1"][1])
    assert gap < max(seed_spread, 30.0), (tails, gap, seed_spread)


def test_jitvbpi_elbo_and_marginal_estimators():
    """JitVBPI evaluation surface (Burrito.estimate_elbo /
    marginal_likelihood_estimate analogs): finite, ordered (IW marginal
    >= naive ELBO by Jensen), and log_f matches an independent
    recomputation of one term."""
    import jax.numpy as jnp
    import numpy as np

    from libsbn_tpu import UnrootedInstance
    from libsbn_tpu.models.phylo_model import PhyloModelSpec
    from libsbn_tpu.vi.jit_step import JitVBPI

    inst = UnrootedInstance("elbo-est")
    inst.read_nexus_file(f"{DATA}/hello_out.t")
    inst.process_loaded_trees()
    inst.train_simple_average()
    inst.read_fasta_file(f"{DATA}/hello.fasta")
    inst.prepare_for_phylo_likelihood(
        PhyloModelSpec("JC69", "constant", "strict")
    )
    jv = JitVBPI(inst, particle_count=4, seed=0)
    for _ in range(3):
        jv.step(beta=1.0)
    logf = jv.log_f_values(256)
    assert logf.shape == (256,) and np.all(np.isfinite(logf))
    elbo = jv.estimate_elbo(256)
    from scipy.special import logsumexp

    marg = float(logsumexp(logf) - np.log(len(logf)))
    assert np.isfinite(elbo) and np.isfinite(marg)
    # Jensen: the IW bound computed from the same particles dominates the
    # naive mean.
    assert marg >= logf.mean() - 1e-9


def test_step_overlapped_pipeline():
    """step_overlapped: call #1 is bit-identical to step() (same seed),
    later calls run with one-step-stale topology sampling and keep
    training healthy (ELBO-like metric finite and improving on average).
    The aim: hide the host sampling cost behind device compute."""
    from libsbn_tpu import UnrootedInstance
    from libsbn_tpu.models.phylo_model import PhyloModelSpec
    from libsbn_tpu.vi.jit_step import JitVBPI

    def make():
        inst = UnrootedInstance("overlap")
        inst.read_nexus_file(f"{DATA}/hello_out.t")
        inst.process_loaded_trees()
        inst.train_simple_average()
        inst.read_fasta_file(f"{DATA}/hello.fasta")
        inst.prepare_for_phylo_likelihood(
            PhyloModelSpec("JC69", "constant", "strict")
        )
        return JitVBPI(inst, particle_count=4, seed=0)

    a, b = make(), make()
    m_live = a.step(beta=1.0)
    m_over = b.step_overlapped(beta=1.0)
    np.testing.assert_allclose(
        float(m_live["mean_ll"]), float(m_over["mean_ll"]), rtol=0, atol=0
    )
    np.testing.assert_allclose(
        np.asarray(a.state.sbn_params), np.asarray(b.state.sbn_params)
    )

    first = float(m_over["elbo_like"])
    vals = [float(b.step_overlapped(beta=1.0)["elbo_like"])
            for _ in range(30)]
    assert np.all(np.isfinite(vals))
    # Training signal: the tail beats the untrained start.
    assert np.mean(vals[-10:]) > first - 50.0
