"""Multi-chip sharding tests on the virtual 8-device CPU mesh.

Validates that the sharded planner (sample axis partitioned over the mesh,
GSPMD-inserted collectives) produces the same actions as the unsharded one.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from m3p2i_aip_tpu.config.config_store import load_config
from m3p2i_aip_tpu.parallel import make_mesh, shard_planner
from m3p2i_aip_tpu.tamp.reactive_tamp import ReactiveTAMP


def _build(K):
    cfg = load_config(
        "config_point",
        [
            "task=push_pull",
            "multi_modal=True",
            "goal=[-3.75,-3.75]",
            f"mppi.num_samples={K}",
            "mppi.horizon=12",
            "mppi.u_per_command=12",
        ],
    )
    return ReactiveTAMP(cfg)


def test_mesh_creation():
    assert len(jax.devices()) == 8, "conftest should provide 8 virtual devices"
    mesh = make_mesh()
    assert mesh.devices.size == 8


def test_sharded_command_matches_unsharded():
    tamp_a = _build(32)
    tamp_b = _build(32)
    shard_planner(tamp_b.motion_planner, make_mesh())

    state = tamp_a.env.init_state()
    act_a = np.asarray(tamp_a.run_tamp(state))
    act_b = np.asarray(tamp_b.run_tamp(state))
    assert np.allclose(act_a, act_b, atol=1e-4), (act_a, act_b)


def test_shard_planner_rejects_indivisible_K():
    tamp = _build(30)
    with pytest.raises(ValueError):
        shard_planner(tamp.motion_planner, make_mesh())


def test_dryrun_multichip_hook():
    import sys, pathlib

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import __graft_entry__ as g

    g.dryrun_multichip(8)


@pytest.mark.slow
def test_dryrun_multichip_self_provisions():
    """Replicate the driver: a clean subprocess with NO mesh env vars set.

    dryrun_multichip must provision its own virtual 8-device mesh (the
    round-1 driver check failed exactly here: rc=1 'need 8 devices, have 1').
    """
    import os
    import pathlib
    import subprocess
    import sys

    repo = pathlib.Path(__file__).resolve().parents[1]
    env = {
        k: v
        for k, v in os.environ.items()
        if k not in ("XLA_FLAGS", "JAX_PLATFORMS", "JAX_PLATFORM_NAME")
    }
    out = subprocess.run(
        [sys.executable, "-c",
         "import __graft_entry__ as g; g.dryrun_multichip(8)"],
        cwd=repo, env=env, capture_output=True, text=True, timeout=600,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert "dryrun_multichip OK" in out.stdout, out.stdout[-2000:]


@pytest.mark.slow
def test_sharded_equals_unsharded_large_K():
    """Action equality sharded vs unsharded at K=512."""
    tamp_a = _build(512)
    tamp_b = _build(512)
    shard_planner(tamp_b.motion_planner, make_mesh())

    state = tamp_a.env.init_state()
    act_a = np.asarray(tamp_a.run_tamp(state))
    act_b = np.asarray(tamp_b.run_tamp(state))
    assert np.allclose(act_a, act_b, atol=1e-4), (act_a, act_b)


@pytest.mark.slow
def test_sharded_kernel_rollout_matches_unsharded():
    """The fused rollout kernel composes with the mesh: under shard_map each
    device runs the kernel on its K/n slice with a global sample offset, so
    the M3P2I mode split (second half of K = pull) stays correct.  Validated
    on the virtual CPU mesh via the interpret-mode Triton kernel."""
    from m3p2i_aip_tpu.ops.pallas_rollout import make_point_rollout

    tamp = _build(32)
    mp = tamp.motion_planner
    cfg = tamp.cfg
    # reduced physics: interpret-mode compiles of the full-size kernel take
    # tens of minutes on CPU (see tests/test_pallas.py); the sharding
    # mechanics under test are independent of the contact-pass count
    full = tamp.env.params
    red = full.replace(
        substeps=1,
        pos_iters=1,
        stat_pos=full.stat_pos[:2],
        stat_yaw=full.stat_yaw[:2],
        stat_half=full.stat_half[:2],
        stat_friction=full.stat_friction[:2],
        stat_actor_idx=full.stat_actor_idx[:2],
    )
    ov = make_point_rollout(
        red, float(cfg.kp_suction), mp.K, mp.T,
        bool(cfg.multi_modal), interpret=True,
    )
    assert ov is not None
    state = tamp.env.init_state()
    tp = tamp.tamp_interface(state)
    sK = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (mp.K,) + x.shape), state
    )
    rng = np.random.default_rng(0)
    acts = jnp.asarray(
        rng.uniform(-3, 3, size=(mp.K, mp.T, 2)).astype(np.float32)
    )

    mp.set_rollout_override(ov)
    ch_un, tps_un = jax.jit(lambda s, a: mp._rollout(s, a, tp))(sK, acts)
    mp.set_mesh(make_mesh())
    ch_sh, tps_sh = jax.jit(lambda s, a: mp._rollout(s, a, tp))(sK, acts)
    assert np.allclose(np.asarray(ch_un), np.asarray(ch_sh), atol=1e-4)
    assert np.allclose(np.asarray(tps_un), np.asarray(tps_sh), atol=1e-5)


def test_sharded_albert_xla_rollout_matches_unsharded():
    """The albert family's XLA rollout composes with the sample-axis mesh:
    GSPMD partitions the vmapped rollout over the 8 devices and the results
    must match the unsharded call."""
    from m3p2i_aip_tpu.config.config_store import load_config
    from m3p2i_aip_tpu.tamp.reactive_tamp import ReactiveTAMP

    cfg = load_config(
        "config_albert",
        [
            "task=push_reach", "goal=[3.0,0.0,0.6]",
            "mppi.num_samples=16", "mppi.horizon=4",
            "mppi.refine_iters=0",
        ],
    )
    tamp = ReactiveTAMP(cfg)
    mp = tamp.motion_planner
    assert mp.rollout_override is None
    state = tamp.env.init_state()
    tp = tamp.tamp_interface(state)
    sK = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (mp.K,) + x.shape), state
    )
    rng = np.random.default_rng(2)
    acts = jnp.asarray(
        rng.uniform(-1.5, 1.5, size=(mp.K, mp.T, 13)).astype(np.float32)
    )

    ch_un, tps_un = jax.jit(lambda s, a: mp._rollout(s, a, tp))(sK, acts)
    mp.set_mesh(make_mesh())
    ch_sh, tps_sh = jax.jit(
        lambda s, a: mp._rollout(s, mp._constrain_samples(a), tp)
    )(sK, acts)
    assert len(ch_sh.sharding.device_set) == 8
    assert np.allclose(np.asarray(ch_un), np.asarray(ch_sh), atol=1e-4)
    assert np.allclose(np.asarray(tps_un), np.asarray(tps_sh), atol=1e-5)
