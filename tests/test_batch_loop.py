"""Vectorized multi-seed runner (tamp/batch_loop.py) vs the serial path.

The batched runner's contract is exact log equivalence with B sequential
``SimLoop.run_chunked`` runs at the same chunk size — same per-tick
positions, same success tick, same collision counts — with ~B-fold fewer
device dispatches.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from m3p2i_aip_tpu.config.config_store import load_config
from m3p2i_aip_tpu.tamp.batch_loop import BatchSimLoop
from m3p2i_aip_tpu.tamp.sim_loop import SimLoop

_OVR = [
    "task=push_pull",
    "multi_modal=True",
    "goal=[-3.75,-3.75]",
    "mppi.num_samples=64",
    "mppi.horizon=10",
]
_SEEDS = [0, 1, 2]
_STEPS = 24
_CHUNK = 8


def _serial_logs(cfg):
    logs, views = [], []
    loop = None
    for s in _SEEDS:
        cfg.mppi.seed_val = s
        if loop is None:
            loop = SimLoop(cfg)
        else:
            loop.reset(s)
        loop.warmup(20)
        logs.append(loop.run_chunked(_STEPS, chunk=_CHUNK))
        views.append(loop._view)
    return logs, views


@pytest.mark.slow
def test_batched_matches_serial_runs():
    cfg = load_config("config_point", _OVR)
    serial_logs, serial_views = _serial_logs(cfg)

    cfg = load_config("config_point", _OVR)
    batch = BatchSimLoop(cfg, _SEEDS)
    batch.warmup(20)
    batch_logs = batch.run_chunked(_STEPS, chunk=_CHUNK)

    for b, (sl, bl) in enumerate(zip(serial_logs, batch_logs)):
        assert bl.steps == sl.steps, f"seed {b}: tick counts differ"
        assert bl.success_step == sl.success_step, f"seed {b}"
        assert bl.collisions == sl.collisions, f"seed {b}"
        np.testing.assert_allclose(
            np.asarray(bl.robot_pos),
            np.asarray(sl.robot_pos),
            atol=1e-4,
            err_msg=f"seed {b} robot trajectory diverged",
        )
        np.testing.assert_allclose(
            np.asarray(bl.box_pos),
            np.asarray(sl.box_pos),
            atol=1e-4,
            err_msg=f"seed {b} box trajectory diverged",
        )
        np.testing.assert_allclose(
            np.asarray(batch.views[b]["robot_pos"]),
            np.asarray(serial_views[b]["robot_pos"]),
            atol=1e-4,
        )
    # the three seeds must be genuinely different runs (per-seed Halton
    # deltas are traced state, not shared)
    assert not np.allclose(
        np.asarray(batch_logs[0].robot_pos), np.asarray(batch_logs[1].robot_pos)
    )


@pytest.mark.slow
def test_batched_seed_freeze_on_early_success():
    """A seed that finishes mid-batch must freeze: its log stops at the
    success tick and its recorded view is the success-tick observation,
    while the other seeds keep running."""
    # navigation converges fast and at seed-dependent ticks
    cfg = load_config(
        "config_point",
        ["task=navigation", "goal=[-1.5,1.5]", "mppi.num_samples=64",
         "mppi.horizon=10"],
    )
    batch = BatchSimLoop(cfg, [0, 1, 2, 3])
    batch.warmup(20)
    logs = batch.run_chunked(200, chunk=8)
    done_steps = [log.success_step for log in logs]
    assert all(d is not None for d in done_steps), done_steps
    for b, log in enumerate(logs):
        assert log.steps == done_steps[b] + 1  # log frozen at the crossing
        final = np.asarray(batch.views[b]["robot_pos"])
        assert np.linalg.norm(final - np.array([-1.5, 1.5])) < 0.1


@pytest.mark.slow
def test_batched_panda_matches_serial():
    """Panda batch path (vmapped _run_chunk_panda_impl): stage progression
    and final views must match B serial SimLoop.run_chunked runs — the
    on-device AIF gate, zup stall carry and done-freeze all ride the vmap."""
    ovr = [
        "mppi.num_samples=16",
        "mppi.horizon=6",
        "multi_modal=False",
    ]
    seeds = [0, 1]
    steps, chunk = 24, 8

    cfg = load_config("config_panda", ovr)
    serial_logs, serial_views = [], []
    loop = None
    for s in seeds:
        cfg.mppi.seed_val = s
        if loop is None:
            loop = SimLoop(cfg)
        else:
            loop.reset(s)
        loop.warmup(10)
        serial_logs.append(loop.run_chunked(steps, chunk=chunk))
        serial_views.append(loop._view)

    cfg = load_config("config_panda", ovr)
    batch = BatchSimLoop(cfg, seeds)
    batch.warmup(10)
    batch_logs = batch.run_chunked(steps, chunk=chunk)

    for b in range(len(seeds)):
        sl, bl = serial_logs[b], batch_logs[b]
        assert bl.steps == sl.steps, f"seed {b}"
        assert bl.success_step == sl.success_step, f"seed {b}"
        assert bl.task == sl.task, f"seed {b}: stage sequences diverged"
        for key in ("cube_state", "ee_state"):
            np.testing.assert_allclose(
                np.asarray(batch.views[b][key]),
                np.asarray(serial_views[b][key]),
                atol=1e-4,
                err_msg=f"seed {b} {key}",
            )
    # different seeds must produce genuinely different ee trajectories
    assert not np.allclose(
        np.asarray(batch.views[0]["ee_state"]),
        np.asarray(batch.views[1]["ee_state"]),
    )


@pytest.mark.slow
def test_batch_reset_revalidates_shard_divisibility():
    """reset(seeds) with a batch size that no longer divides the seed mesh
    must fail loudly at reset time, not with an opaque device_put error at
    warmup."""
    import jax

    if len(jax.devices()) < 2:
        pytest.skip("needs the multi-device virtual mesh")
    n = len(jax.devices())
    cfg = load_config(
        "config_point",
        ["task=navigation", "mppi.num_samples=32", "mppi.horizon=8"],
    )
    batch = BatchSimLoop(cfg, list(range(n)), shard=True)
    with pytest.raises(ValueError, match="must divide"):
        batch.reset(list(range(n + 1)))


@pytest.mark.slow
def test_batched_sharded_over_seed_mesh():
    """shard=True lays the seed axis over the 8-device virtual mesh; logs
    must match the unsharded batched run."""
    import jax

    if len(jax.devices()) < 2:
        pytest.skip("needs the multi-device virtual mesh")
    n = len(jax.devices())
    seeds = list(range(n))
    ovr = [
        "task=navigation",
        "goal=[-1.5,1.5]",
        "mppi.num_samples=32",
        "mppi.horizon=8",
    ]
    cfg = load_config("config_point", ovr)
    plain = BatchSimLoop(cfg, seeds)
    plain.warmup(10)
    plain_logs = plain.run_chunked(16, chunk=8)

    cfg = load_config("config_point", ovr)
    sharded = BatchSimLoop(cfg, seeds, shard=True)
    sharded.warmup(10)
    sharded_logs = sharded.run_chunked(16, chunk=8)

    for b in range(n):
        assert sharded_logs[b].steps == plain_logs[b].steps
        np.testing.assert_allclose(
            np.asarray(sharded_logs[b].robot_pos),
            np.asarray(plain_logs[b].robot_pos),
            atol=1e-4,
        )


@pytest.mark.slow
def test_batched_panda_sharded_over_seed_mesh():
    """Panda seed-axis sharding: shard=True on the panda
    batch lays the seed axis over the 8-device virtual mesh; stage
    progression and views must match the unsharded batched run (both ride
    the pure-XLA rollout on CPU, so this is apples-to-apples)."""
    import jax

    if len(jax.devices()) < 2:
        pytest.skip("needs the multi-device virtual mesh")
    n = len(jax.devices())  # B must divide the full seed mesh
    seeds = list(range(n))
    ovr = [
        "mppi.num_samples=16",
        "mppi.horizon=6",
        "multi_modal=False",
    ]
    steps, chunk = 16, 8

    cfg = load_config("config_panda", ovr)
    plain = BatchSimLoop(cfg, seeds)
    plain.warmup(10)
    plain_logs = plain.run_chunked(steps, chunk=chunk)

    cfg = load_config("config_panda", ovr)
    sharded = BatchSimLoop(cfg, seeds, shard=True)
    sharded.warmup(10)
    sharded_logs = sharded.run_chunked(steps, chunk=chunk)

    for b in range(len(seeds)):
        assert sharded_logs[b].steps == plain_logs[b].steps, f"seed {b}"
        assert sharded_logs[b].task == plain_logs[b].task, f"seed {b}"
        for key in ("cube_state", "ee_state"):
            np.testing.assert_allclose(
                np.asarray(sharded.views[b][key]),
                np.asarray(plain.views[b][key]),
                atol=1e-4,
                err_msg=f"seed {b} {key}",
            )
