"""Vectorized multi-seed evaluation: run a whole seeded experiment batch as
ONE jitted, vmapped device program.

The reference evaluates its n=20 quality batches strictly serially — one
Isaac Gym process per run, seeds back to back (SURVEY.md §4.3).  On an
accelerator there is no reason to: every seeded run is the same traced program with
different MPPIState data (the seeded Halton deltas are traced state,
CLAUDE.md invariants), so B seeds vmap into a single [B, ...] chunk program
whose rollout batch is effectively B x K.  The host keeps B independent
symbolic planners (the latches/stall detectors are per-run mutable state)
and drains B logs per chunk boundary — one device dispatch and one fetch
where the serial runner paid B of each.

On a GPU the fused point rollout and weight kernels stay live under the
vmap: their ``custom_vmap`` rules dispatch one batched kernel per chunk tick
(ops/pallas_rollout.py, ops/pallas_kernels.py), so the batched runner keeps
the serial path's kernel speed.  Parity: host logs are tick-for-tick
identical to B serial ``SimLoop.run_chunked`` runs at the same chunk size ON
THE SAME ROLLOUT BACKEND (tests/test_batch_loop.py asserts this on the CPU
XLA path; the batched-kernel == serial-kernel check is the vmap parity tests
in tests/test_pallas.py).

Seeds finish at different ticks: the chunk program's success gate takes a
``done0`` pre-latch (ReactiveTAMP._run_chunk_impl / _run_chunk_panda_impl),
and jax's batched ``lax.while_loop`` masks the body per element, so a
finished seed's state is frozen mid-batch exactly as if the host had stopped
dispatching it.

``shard=True`` lays the seed axis over all visible devices
(`jax.sharding.Mesh` axis "seeds"): embarrassingly data-parallel, so GSPMD
partitions the whole chunk program with no cross-seed collectives except the
while-gate's global any().  Sharding forces the pure-XLA rollout (GSPMD
cannot partition an opaque pallas_call); it does not compose with the K-axis
sample sharding (parallel/mesh.py) — one mesh axis at a time.  Both the
point and the panda families shard (tests/test_batch_loop.py seed-mesh
equality tests; the panda surface also runs in __graft_entry__'s dryrun).
"""
from __future__ import annotations

import time
from typing import List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from m3p2i_aip_tpu.planners.motion_planner.mppi import TASK_IDS, TaskParams
from m3p2i_aip_tpu.tamp.reactive_tamp import ReactiveTAMP, build_task_planner
from m3p2i_aip_tpu.tamp.sim_loop import TickLog

_STAGE_TASK = ("reach", "pick", "place")


def _tree_stack(trees):
    return jax.tree.map(lambda *xs: jnp.stack(xs), *trees)


class BatchSimLoop:
    """B independent seeded runs, one device program per chunk.

    Parity: B sequential ``SimLoop`` runs of ``run_chunked(n, chunk)`` —
    same seeds, same logs, ~B-fold fewer dispatches.
    """

    def __init__(self, cfg, seeds: Sequence[int], shard: bool = False) -> None:
        self.cfg = cfg
        self.tamp = ReactiveTAMP(cfg)
        self.env = self.tamp.env
        self.is_panda = self.env.env_type == "panda_env"

        self._sharding = None
        if shard:
            from jax.sharding import Mesh, NamedSharding, PartitionSpec

            # GSPMD treats a pallas_call as an opaque custom call it cannot
            # partition along the seed axis — sharded mode pins itself to
            # the pure-XLA rollout (which GSPMD auto-vectorizes over the
            # folded B x K batch).  Unsharded batches keep the kernels.
            self.tamp.motion_planner.set_rollout_override(None)
            self.tamp.motion_planner.use_pallas = False
            devs = jax.devices()
            self._check_batch(len(seeds), len(devs))
            mesh = Mesh(np.asarray(devs), ("seeds",))
            self._sharding = NamedSharding(mesh, PartitionSpec("seeds"))

        self.reset(seeds)

        if self.is_panda:
            def chunk_panda_fn(ms, rs, stage, zs, done0, length):
                return self.tamp._run_chunk_panda_impl(
                    ms, rs, stage, zs, length, done0=done0
                )

            self._chunk_batched_panda = jax.jit(
                jax.vmap(chunk_panda_fn, in_axes=(0, 0, 0, 0, 0, None)),
                static_argnums=(5,),
            )
        else:
            def chunk_fn(ms, rs, task, i0, done0, length):
                return self.tamp._run_chunk_impl(
                    ms, rs, task, i0, length, gate=True, done0=done0
                )

            self._chunk_batched = jax.jit(
                jax.vmap(chunk_fn, in_axes=(0, 0, 0, None, 0, None)),
                static_argnums=(5,),
            )

    @staticmethod
    def _check_batch(B: int, n_devs: int) -> None:
        if B % n_devs != 0:
            raise ValueError(
                f"B={B} seeds must divide the {n_devs}-device mesh; "
                "pad the seed list (pad rows are cheap — drop their logs)"
            )

    # ------------------------------------------------------------------ setup
    def reset(self, seeds: Optional[Sequence[int]] = None) -> None:
        """Fresh seeded batch WITHOUT rebuilding the planner or (for the same
        batch size B) retracing the vmapped chunk program — the per-seed
        Halton deltas are traced MPPIState data (SimLoop.reset's invariant,
        batched).  Changing B changes the batched program's shapes and so
        costs one retrace."""
        if seeds is not None:
            self.seeds = list(seeds)
        B = len(self.seeds)
        if self._sharding is not None:
            self._check_batch(B, self._sharding.mesh.devices.size)
        # per-seed host symbolic planners (mutable latches live here);
        # the panda runs its AIF gate on-device and only needs the log labels
        self.planners = [
            build_task_planner(self.cfg, self.env, self.tamp.objective)
            for _ in range(B)
        ]
        # per-seed sampler state: reseed regenerates the Halton deltas, which
        # live in MPPIState (traced data) — B states, ONE compiled program
        mp = self.tamp.motion_planner
        states = []
        for s in self.seeds:
            mp.reseed(int(s))
            states.append(mp.init_state())
        self.mppi_state = _tree_stack(states)
        self.state = None  # set by warmup()
        self.logs: List[TickLog] = [TickLog() for _ in range(B)]
        self.views: List[Optional[dict]] = [None] * B  # frozen at success
        self.done = np.zeros(B, dtype=bool)
        if self.is_panda:
            self._stage = jnp.zeros(B, jnp.int32)
            self._zs = jnp.broadcast_to(self.tamp.zup_zs0(), (B, 4))

    def warmup(self, n: int = 20) -> None:
        """Settle ONE scene and broadcast it: the warmup is zero-action and
        deterministic, so every seed starts from the identical settled state
        (matching SimLoop.warmup per seed)."""
        from m3p2i_aip_tpu.tamp.sim_loop import SimLoop

        single = SimLoop(self.cfg, tamp=self.tamp)
        single.warmup(n)
        B = len(self.seeds)
        state = jax.tree.map(
            lambda x: jnp.broadcast_to(x, (B,) + x.shape), single.state
        )
        view0 = single._view
        self.state = state
        for b in range(B):
            self.views[b] = view0
        if self._sharding is not None:
            self.state = jax.device_put(self.state, self._sharding)
            self.mppi_state = jax.device_put(self.mppi_state, self._sharding)
            if self.is_panda:
                self._stage = jax.device_put(self._stage, self._sharding)
                self._zs = jax.device_put(self._zs, self._sharding)

    # --------------------------------------------------------------- internals
    def _stacked_task_params(self) -> TaskParams:
        """Per-seed symbolic decisions as ONE batched TaskParams pytree
        (4 host->device puts per chunk boundary, not 4*B)."""
        B = len(self.planners)
        ids = np.zeros(B, np.int32)
        goals = np.zeros((B, 7), np.float32)
        zups = np.zeros(B, np.float32)
        for b, tp in enumerate(self.planners):
            ids[b] = TASK_IDS[tp.task]
            g = np.asarray(tp.curr_goal, np.float32).reshape(-1)
            goals[b, : g.shape[0]] = g
            zups[b] = float(getattr(tp, "zup_gate", 0.0))
        leaves = TaskParams(
            task_id=jnp.asarray(ids),
            goal=jnp.asarray(goals),
            gripper=jnp.zeros(B, jnp.int32),  # point/albert: "none"
            zup_gate=jnp.asarray(zups),
        )
        if self._sharding is not None:
            leaves = jax.device_put(leaves, self._sharding)
        return leaves

    def _drain_seed(
        self, b: int, i: int, views_b, n_ticks: int, dev_done: bool, per: float
    ) -> None:
        """Host-side processing of one seed's slice of a fetched chunk —
        the per-seed twin of SimLoop._drain_chunk."""
        tp = self.planners[b]
        log = self.logs[b]
        for k in range(n_ticks):
            view = self.env.view_unpack(views_b[k])
            self.views[b] = view
            if hasattr(tp, "observe"):
                # tick-granular stall bookkeeping (PLANNER_SIMPLE.observe):
                # update_plan only runs at chunk boundaries
                tp.observe(view)
            success = tp.check_task_success(view)
            log.steps += 1
            log.replan_s.append(per)
            log.sim_s.append(per)
            log.task.append(tp.task)
            if self.env.env_type == "point_env":
                log.robot_pos.append(view["robot_pos"])
                log.robot_vel.append(view["robot_vel"])
                log.box_pos.append(view["box_pos"])
                if view.get("dynobs_contact", 0.0) > 0.1:
                    log.collisions += 1
            if success:
                log.success_step = i + k
                self.done[b] = True
                return  # freeze the log/view at the success tick
        if dev_done and not self.done[b]:
            # device gate latched but the host check disagreed at the float
            # boundary: trust the device (its state is frozen there)
            log.success_step = i + n_ticks - 1
            self.done[b] = True

    # ---------------------------------------------------------------- running
    def run_chunked(self, n_steps: int, chunk: int = 10) -> List[TickLog]:
        """Run every seed to success or ``n_steps``; returns the B TickLogs
        (self.views holds each seed's success-tick observation)."""
        if self.state is None:
            self.warmup(0)
        if self.is_panda:
            return self._run_chunked_panda(n_steps, chunk)
        B = len(self.seeds)
        i = 0
        while i < n_steps and not self.done.all():
            t0 = time.perf_counter()
            for b in range(B):
                if not self.done[b]:
                    self.planners[b].update_plan(self.views[b])
            task = self._stacked_task_params()
            done0 = jnp.asarray(self.done)
            if self._sharding is not None:
                done0 = jax.device_put(done0, self._sharding)
            ms, rs, views, n_ticks, _dev_done = self._chunk_batched(
                self.mppi_state, self.state, task, jnp.asarray(i), done0, chunk
            )
            views, n_ticks, dev_done = jax.device_get(
                (views, n_ticks, _dev_done)
            )
            t1 = time.perf_counter()
            self.mppi_state, self.state = ms, rs
            total_ticks = int(np.sum(n_ticks))
            # amortized per-seed-tick cost: B seeds share one dispatch
            per = (t1 - t0) / max(total_ticks, 1)
            for b in range(B):
                if not self.done[b] and n_ticks[b] > 0:
                    self._drain_seed(
                        b, i, views[b], int(n_ticks[b]), bool(dev_done[b]), per
                    )
            i += chunk
        return self._finish_logs()

    def _run_chunked_panda(self, n_steps: int, chunk: int) -> List[TickLog]:
        """Batched panda chunks: the AIF stage gate, replan, and step all run
        on-device per seed (ReactiveTAMP._run_chunk_panda_impl under vmap).
        A finished seed freezes via the ``done0`` pre-latch; its post-success
        zero-action ticks match the serial path's within-chunk freeze."""
        B = len(self.seeds)
        i = 0
        while i < n_steps and not self.done.all():
            t0 = time.perf_counter()
            done0 = jnp.asarray(self.done)
            if self._sharding is not None:
                done0 = jax.device_put(done0, self._sharding)
            ms, rs, stage, zs, _done, views, stages, dones = (
                self._chunk_batched_panda(
                    self.mppi_state, self.state, self._stage, self._zs,
                    done0, chunk,
                )
            )
            views, stages, dones = jax.device_get((views, stages, dones))
            t1 = time.perf_counter()
            self.mppi_state, self.state = ms, rs
            self._stage, self._zs = stage, zs
            live = max(int((~self.done).sum()), 1)
            per = (t1 - t0) / max(chunk * live, 1)
            for b in range(B):
                if self.done[b]:
                    continue
                log = self.logs[b]
                for k in range(chunk):
                    self.views[b] = self.env.view_unpack(views[b, k])
                    log.steps += 1
                    log.replan_s.append(per)
                    log.sim_s.append(per)
                    log.task.append(_STAGE_TASK[int(stages[b, k])])
                    if bool(dones[b, k]):
                        log.success_step = i + k
                        self.done[b] = True
                        break  # freeze log/view at the success tick
            i += chunk
        return self._finish_logs()

    def _finish_logs(self) -> List[TickLog]:
        for log in self.logs:
            if not log.sim_s:  # seed done before its first drained tick
                log.sim_s.append(1e-9)
                log.replan_s.append(1e-9)
        return self.logs

    def settle(self, n: int = 150) -> None:
        """Batched twin of SimLoop.settle: ``n`` zero-action free-run steps
        for every seed in ONE dispatch (panda: place-stage open gripper so
        the cube releases), then refresh every seed's view.  Call before
        logging panda envelope rows (the reference logs the RELEASED,
        settled cube — see SimLoop.settle)."""
        zero_u = jnp.zeros(self.env.nu)
        if self.is_panda:
            zero_u = zero_u.at[7:9].set(1.5)
        ext = self.env.zero_ext()

        def one(s):
            def body(c, _):
                return self.env.step(c, zero_u, ext), None

            return jax.lax.scan(body, s, None, length=n)[0]

        self.state = jax.jit(jax.vmap(one))(self.state)
        views = jax.device_get(
            jax.jit(jax.vmap(self.env.view_vec))(self.state)
        )
        for b in range(len(self.seeds)):
            self.views[b] = self.env.view_unpack(views[b])
