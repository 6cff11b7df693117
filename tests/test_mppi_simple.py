"""Simple-mode MPPI coverage.

Three gaps closed: a golden test of the Williams weight/update math against
an independent numpy recomputation (reference formulas mppi.py:335-363),
the ``noise_abs_cost`` branch, end-to-end convergence of ``mppi_mode=simple``
on point navigation, and one ``sampling_method=random`` halton-mode run.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from m3p2i_aip_tpu.config.config_store import load_config
from m3p2i_aip_tpu.planners.motion_planner.mppi import (
    MPPI,
    MPPIConfig,
    make_task_params,
)
from m3p2i_aip_tpu.tamp.sim_loop import SimLoop

_DT = 0.1
_GOAL = 1.0


def _toy_mppi(**cfg_kwargs):
    """1-D velocity-integrator env: s' = s + dt*u, cost = (s' - goal)^2."""
    mcfg = MPPIConfig(
        num_samples=16,
        horizon=12,
        nx=2,
        mppi_mode="simple",
        noise_sigma=[[0.25]],
        u_min=[-1.0],
        u_max=[1.0],
        lambda_=0.5,
        sample_null_action=True,
        filter_u=False,
        use_pallas=False,
        **cfg_kwargs,
    )
    cfg = types.SimpleNamespace(env_type="point_env", multi_modal=False, mppi=mcfg)

    def dynamics(s, u, ext):
        return s + _DT * u

    def running_cost(s, u, task, mode):
        return jnp.sum((s - _GOAL) ** 2), jnp.zeros(1)

    return MPPI(cfg, dynamics, running_cost, zero_ext=lambda: jnp.zeros(1))


def _manual_simple_update(planner, state, s0):
    """Independent numpy recomputation of the Williams update.

    Reproduces the planner's noise draw (same PRNG ops on the stored key),
    then recomputes rollout costs, action cost, weights, and the U update
    with plain python loops — reference formulas mppi.py:335-363.
    """
    K, T = planner.K, planner.T
    U = np.roll(np.asarray(state.U), -1, axis=0)  # shift (mppi.py:221)
    _, sub = jax.random.split(state.rng)
    noise = np.asarray(
        jax.random.multivariate_normal(
            sub,
            jnp.asarray(planner.noise_mu),
            jnp.asarray(planner.noise_sigma),
            shape=(K, T),
        ).astype(jnp.float32)
    )
    perturbed = np.clip(U[None] + noise, -1.0, 1.0)
    perturbed[K - 1] = 0.0  # braking sample
    noise_b = perturbed - U[None]  # post-bounding noise (mppi.py:356)

    cost_total = np.zeros(K)
    for k in range(K):
        s = float(np.asarray(s0)[0])
        for t in range(T):
            s = s + _DT * perturbed[k, t, 0]
            cost_total[k] += (s - _GOAL) ** 2

    sigma_inv = np.asarray(planner.noise_sigma_inv)
    lam = planner.lambda_
    if planner.cfg.noise_abs_cost:
        action_cost = lam * (np.abs(noise_b) @ sigma_inv)
    else:
        action_cost = lam * (noise_b @ sigma_inv)
    cost_total = cost_total + np.sum(U[None] * action_cost, axis=(1, 2))

    beta = cost_total.min()
    nz = np.exp((-1.0 / lam) * (cost_total - beta))
    weights = nz / nz.sum()
    U_new = U + np.einsum("k,ktu->tu", weights, noise_b)
    return weights, U_new


@pytest.mark.parametrize("abs_cost", [False, True])
def test_simple_williams_update_golden(abs_cost):
    planner = _toy_mppi(noise_abs_cost=abs_cost)
    state = planner.init_state()
    s0 = jnp.zeros(1)
    task = make_task_params("navigation", [_GOAL, 0.0])

    want_w, want_U = _manual_simple_update(planner, state, s0)
    _, new_state, _ = planner.command(state, s0, task)

    np.testing.assert_allclose(np.asarray(new_state.weights), want_w, atol=1e-4)
    np.testing.assert_allclose(np.asarray(new_state.U), want_U, atol=1e-4)


def test_simple_mode_drives_toward_goal():
    """Iterating command on the toy env moves the state to the goal: the
    Williams update must actually converge, not just run."""
    planner = _toy_mppi()
    state = planner.init_state()
    task = make_task_params("navigation", [_GOAL, 0.0])
    s = jnp.zeros(1)
    for _ in range(60):
        actions, state, _ = planner.command(state, s, task)
        s = s + _DT * actions[0]
    assert abs(float(s[0]) - _GOAL) < 0.1, f"settled at {float(s[0]):.3f}"


@pytest.mark.slow
def test_simple_mode_point_navigation():
    """Point nav reaches the goal with mppi_mode=simple (reference
    mppi.py:220-233 mode) through the full TAMP stack."""
    cfg = load_config(
        "config_point",
        [
            "task=navigation",
            "goal=[-3,3]",
            "mppi.num_samples=128",
            "mppi.mppi_mode=simple",
        ],
    )
    loop = SimLoop(cfg)
    loop.warmup(10)
    done = None
    for i in range(200):
        if loop.tick(i):
            done = i
            break
    assert done is not None, f"simple-mode nav failed at {loop.log.robot_pos[-1]}"


@pytest.mark.slow
def test_halton_mode_random_sampling():
    """halton-spline mode with sampling_method=random (fresh Gaussian draws
    per tick instead of cached Halton deltas, mppi.py:220-226) still reaches
    the nav goal and advances the PRNG key."""
    cfg = load_config(
        "config_point",
        [
            "task=navigation",
            "goal=[-3,3]",
            "mppi.num_samples=128",
            "mppi.sampling_method=random",
        ],
    )
    loop = SimLoop(cfg)
    loop.warmup(10)
    key0 = np.asarray(loop.tamp.mppi_state.rng).copy()
    done = None
    for i in range(200):
        if loop.tick(i):
            done = i
            break
    assert done is not None, f"random-sampling nav failed at {loop.log.robot_pos[-1]}"
    assert not np.array_equal(np.asarray(loop.tamp.mppi_state.rng), key0)


def test_halton_elite_injection_flag():
    """sample_best_traj=True (single-mode elite injection, extension mirroring
    the multi-modal per-mode elites) must keep the best sequence alive and
    actually change the planned actions."""
    import jax.numpy as jnp

    def build(flag):
        mcfg = MPPIConfig(
            num_samples=16,
            horizon=12,
            nx=2,
            noise_sigma=[[0.25]],
            u_min=[-1.0],
            u_max=[1.0],
            lambda_=0.5,
            filter_u=False,
            use_pallas=False,
            exploration_noise=0.0,
            sample_best_traj=flag,
        )
        cfg = types.SimpleNamespace(env_type="point_env", multi_modal=False, mppi=mcfg)

        def dynamics(s, u, ext):
            return s + _DT * u

        def running_cost(s, u, task, mode):
            return jnp.sum((s - _GOAL) ** 2), jnp.zeros(1)

        return MPPI(cfg, dynamics, running_cost, zero_ext=lambda: jnp.zeros(1))

    on, off = build(True), build(False)
    s_on, s_off = on.init_state(), off.init_state()
    task = make_task_params("navigation", [_GOAL, 0.0])
    a_on = a_off = None
    for _ in range(4):
        seq_on, s_on, _ = on.command(s_on, jnp.zeros(1), task)
        seq_off, s_off, _ = off.command(s_off, jnp.zeros(1), task)
    assert np.all(np.isfinite(np.asarray(seq_on)))
    assert not np.allclose(np.asarray(s_on.best_traj), 0.0)
    assert not np.allclose(np.asarray(seq_on), np.asarray(seq_off), atol=1e-6)


def test_sample_refine_improves_plan_cost():
    """Annealed resampling refinement (MPPIConfig.refine_iters): same seed,
    same state — the refined mean plan's true discounted cost must be no
    worse than the unrefined one's, and the mean must actually move.  This
    is the data-parallel replacement for grad_refine (each refine iteration
    reuses the full-width rollout instead of a sequential 3-lane
    differentiable chain)."""

    def build(iters):
        mcfg = MPPIConfig(
            num_samples=32,
            horizon=12,
            nx=2,
            mppi_mode="halton-spline",
            noise_sigma=[[0.25]],
            u_min=[-1.0],
            u_max=[1.0],
            lambda_=0.5,
            filter_u=False,
            use_pallas=False,
            exploration_noise=0.0,
            refine_iters=iters,
            refine_scale=0.3,
        )
        cfg = types.SimpleNamespace(
            env_type="point_env", multi_modal=False, mppi=mcfg
        )

        def dynamics(s, u, ext):
            return s + _DT * u

        def running_cost(s, u, task, mode):
            return jnp.sum((s - _GOAL) ** 2), jnp.zeros(1)

        return MPPI(cfg, dynamics, running_cost, zero_ext=lambda: jnp.zeros(1))

    def plan_cost(planner, mean):
        s, c = 0.0, 0.0
        g = np.asarray(planner.gamma_seq)
        m = np.asarray(mean)
        for t in range(planner.T):
            s = s + _DT * m[t, 0]
            c += g[t] * (s - _GOAL) ** 2
        return c

    task = make_task_params("navigation", [_GOAL, 0.0])
    plain, refined = build(0), build(2)
    st_p, st_r = plain.init_state(), refined.init_state()
    _, st_p, _ = plain.command(st_p, jnp.zeros(1), task)
    _, st_r, _ = refined.command(st_r, jnp.zeros(1), task)
    c_plain = plan_cost(plain, st_p.mean_action)
    c_ref = plan_cost(refined, st_r.mean_action)
    assert np.isfinite(c_ref)
    assert not np.allclose(
        np.asarray(st_r.mean_action), np.asarray(st_p.mean_action), atol=1e-7
    ), "refine_iters=2 left the mean untouched"
    assert c_ref <= c_plain + 1e-6, (
        f"refined plan cost {c_ref} worse than unrefined {c_plain}"
    )
