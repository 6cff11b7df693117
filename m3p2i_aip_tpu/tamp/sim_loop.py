"""Real-system loop: the single "actuated" env driven by the TAMP planner.

Parity target: ``scripts/sim.py`` (run_sim, :19-58).  Same engine as the
rollouts, at batch 1, in the same process — the zerorpc round-trip per tick
(sim.py:41-49) becomes two in-process calls on the jitted engine.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from m3p2i_aip_tpu.envs import Env, make_env, update_dyn_obs
from m3p2i_aip_tpu.tamp.reactive_tamp import ReactiveTAMP
from m3p2i_aip_tpu.utils import skill_utils


def real_suction_ext(cfg, env: Env, state, action):
    """Suction force pair for the REAL env (threshold 1.5), or zero forces.

    Parity: skill_utils.check_and_apply_suction (:36-44) +
    check_suction_condition (:47-56) + calculate_suction real-env branch
    (:77-82): apply only for pull-family tasks with suction granted, the robot
    within 0.6 m of the box, and the action pointing away from the box.
    """
    ext = env.zero_ext()
    if env.env_type != "point_env":
        return ext
    box_slot = None
    names = list(env.params.actor_names)
    if "box" in names:
        box_slot = env.params.dyn_actor_idx.index(names.index("box"))
    if box_slot is None:
        return ext
    box_pos = state.dyn_pos[box_slot]
    robot_pos = state.q[:2]  # 3-dof bases carry yaw in q[2]
    from m3p2i_aip_tpu.envs import command_world_vel

    cmd_vel = command_world_vel(env.params, state.q, action)
    if not skill_utils.check_suction_condition(
        cfg.task, bool(cfg.suction_active), robot_pos, box_pos, cmd_vel
    ):
        return ext
    f_box, f_robot = skill_utils.calculate_suction(
        box_pos, robot_pos, float(cfg.kp_suction), threshold=1.5
    )
    return ext.replace(robot=f_robot, dyn=ext.dyn.at[box_slot].set(f_box))


@dataclass
class TickLog:
    """Per-run statistics in the reference's log spirit (plot_point.py:26-34)."""

    robot_pos: List = field(default_factory=list)
    robot_vel: List = field(default_factory=list)
    box_pos: List = field(default_factory=list)
    task: List = field(default_factory=list)
    replan_s: List = field(default_factory=list)
    sim_s: List = field(default_factory=list)
    collisions: int = 0
    steps: int = 0
    success_step: Optional[int] = None


class SimLoop:
    """Owns the real env state and the TAMP planner; steps them in lock-step."""

    def __init__(self, cfg, tamp: Optional[ReactiveTAMP] = None) -> None:
        self.cfg = cfg
        self.tamp = tamp if tamp is not None else ReactiveTAMP(cfg)
        self.env = self.tamp.env
        self._step = jax.jit(self.env.step)
        self.state = self.env.init_state()
        self.log = TickLog()
        self._view: Optional[dict] = None  # host copy of the current obs

    def reset(self, seed_val: Optional[int] = None) -> None:
        """Reset for a fresh seeded run WITHOUT rebuilding (and so without
        retracing/recompiling) the planner — the sampler seed lives in
        traced MPPIState data (MPPI.reseed)."""
        if seed_val is not None:
            self.cfg.mppi.seed_val = seed_val
            self.tamp.motion_planner.reseed(seed_val)
        self.tamp.mppi_state = self.tamp.motion_planner.init_state()
        self.tamp.task_planner.reset_plan()
        self.tamp.task_success = False
        self.state = self.env.init_state()
        self.log = TickLog()
        self._view = None
        self._panda_stage = 0
        self._panda_zs = None

    def warmup(self, n: int = 150) -> None:
        """Settle the scene before planning (sim.py:32-33)."""
        zero_u = jnp.zeros(self.env.nu)
        ext = self.env.zero_ext()
        for _ in range(n):
            self.state = self._step(self.state, zero_u, ext)
        jax.block_until_ready(self.state)
        self._view = self.env.view(self.state)

    def _record(self, i: int, view: dict, replan_s: float, sim_s: float) -> bool:
        self.log.steps += 1
        self.log.replan_s.append(replan_s)
        self.log.sim_s.append(sim_s)
        self.log.task.append(self.tamp.task_planner.task)
        if self.env.env_type == "point_env":
            self.log.robot_pos.append(view["robot_pos"])
            self.log.robot_vel.append(view["robot_vel"])
            self.log.box_pos.append(view["box_pos"])
            if view.get("dynobs_contact", 0.0) > 0.1:
                self.log.collisions += 1
        if self.tamp.task_success and self.log.success_step is None:
            self.log.success_step = i
        return bool(self.tamp.task_success)

    def tick(self, i: int) -> bool:
        """One control tick = ONE device dispatch + ONE small transfer.

        Parity: the sim.py main-loop body (:37-58) minus viewer/keyboard —
        dyn-obs motion, replanning, suction and the real-env step all run
        inside the fused jitted tick (see ReactiveTAMP._tick_fused_impl).
        The host only runs the symbolic task planner on the previous tick's
        packed observation.
        """
        if self._view is None:
            self._view = self.env.view(self.state)
        t0 = time.perf_counter()
        task_params = self.tamp.tamp_interface_view(self._view)
        if self.tamp.task_success:
            return self._record(i, self._view, 0.0, 0.0)
        action, self.tamp.mppi_state, self.state, vvec = self.tamp.tick_fused(
            self.tamp.mppi_state, self.state, task_params, i
        )
        vvec = jax.block_until_ready(vvec)
        t1 = time.perf_counter()
        self._view = self.env.view_unpack(vvec)
        # gate on the FRESH post-step view so success is recorded at the
        # crossing tick itself (the chunked path's on-device latch uses the
        # same convention; checking only at the next tick's top would lag
        # the logged task time by one tick)
        self.tamp.task_success = self.tamp.task_planner.check_task_success(
            self._view
        )
        # replan and real-env step run in ONE fused program: the tick
        # duration is both the replan time and the sim time (cols 14/16 of
        # the reference log schema coincide in this architecture)
        return self._record(i, self._view, t1 - t0, t1 - t0)

    def run(
        self,
        n_steps: int = 1000,
        realtime: bool = False,
        verbose: bool = False,
        interactive: bool = False,
    ):
        """Run until success or ``n_steps``. Parity: sim.py:36-58.

        ``interactive=True`` polls the terminal each tick so a human can
        disturb the scene WHILE the planner runs (the reference's
        play_with_cube viewer interaction, isaacgym_wrapper.py:413-437):
        i/j/k/l shove the box (point) / cubeA (panda), v toggles a live
        ASCII view with the planned top-trajectory overlay, q quits.
        Degrades to a plain run when stdin is not a tty.
        """
        from m3p2i_aip_tpu.utils.teleop import SHOVE_KEYS, KeyboardTeleop

        shove_target = "cubeA" if self.env.env_type == "panda_env" else "box"
        if self.env.env_type != "panda_env":
            names = list(self.env.params.actor_names)
            if shove_target not in names:
                shove_target = None  # e.g. albert scene ships no box
        show_view = False
        t = time.time()
        with KeyboardTeleop(enabled=interactive) as keys:
            if interactive and keys.active:
                shove_msg = (
                    f"i/j/k/l shove the {shove_target}, "
                    if shove_target is not None
                    else ""
                )
                print(f"interactive: {shove_msg}v toggles the live view, q quits")
            for i in range(n_steps):
                if interactive:
                    for key in keys.poll():
                        if key == "q":
                            return self.log
                        if key == "v":
                            show_view = not show_view
                        elif key in SHOVE_KEYS and shove_target is not None:
                            self.perturb_body(
                                shove_target, list(SHOVE_KEYS[key]) + [0.0]
                            )
                done = self.tick(i)
                if interactive and show_view and self.env.env_type == "point_env":
                    from m3p2i_aip_tpu.utils.render import render_point_env

                    trajs = self.tamp.get_trajs()
                    sys_out = "\x1b[2J\x1b[H" + render_point_env(
                        self.env,
                        self.state,
                        trajs=None if trajs is None else np.asarray(trajs),
                    )
                    print(sys_out)
                if realtime:
                    t = skill_utils.time_tracking(t, self.cfg.sim.dt, verbose=verbose)
                if done:
                    break
        return self.log

    def settle(self, n: int = 100) -> None:
        """Free-run ``n`` zero-action env steps (one dispatch) and refresh
        the view.

        Evaluation-protocol parity: the reference's sim loop never breaks on
        success (sim.py:37 runs 10000 ticks), so its logged rows reflect a
        RELEASED, fully settled cube — the published ori errors (~0.003) are
        post-settling.  Call this before logging a row.
        """
        zero_u = jnp.zeros(self.env.nu)
        if self.env.env_type == "panda_env":
            # the reference's post-success ticks keep the place-stage OPEN
            # gripper command active (the planner runs for all 10000 ticks);
            # without it the fingers never travel and the cube never releases
            zero_u = zero_u.at[7:9].set(1.5)
        ext = self.env.zero_ext()

        def body(s, _):
            return self.env.step(s, zero_u, ext), None

        self.state, _ = jax.jit(
            lambda s: jax.lax.scan(body, s, None, length=n)
        )(self.state)
        jax.block_until_ready(self.state)
        self._view = self.env.view(self.state)

    def perturb_body(self, name: str, dpos) -> None:
        """Displace a named dynamic body in the real env (host-side).

        The scripted analogue of the reference's interactive cube
        perturbation (``play_with_cube``/viewer keys, isaacgym_wrapper.py:413-437)
        used in its "reactive" scenarios: shove the object mid-task and let
        the planner re-plan.
        """
        names = list(self.env.params.actor_names)
        if self.env.env_type == "panda_env":
            from m3p2i_aip_tpu.models.panda_env import _DYN_NAMES

            slot = _DYN_NAMES.index(name)
            self.state = self.state.replace(
                body_pos=self.state.body_pos.at[slot].add(jnp.asarray(dpos))
            )
        elif self.env.env_type == "albert_env":
            self.state = self.state.replace(
                box_pos=self.state.box_pos + jnp.asarray(dpos[:2])
            )
        else:
            slot = self.env.params.dyn_actor_idx.index(names.index(name))
            self.state = self.state.replace(
                dyn_pos=self.state.dyn_pos.at[slot].add(jnp.asarray(dpos[:2]))
            )
        self._view = self.env.view(self.state)

    def run_chunked(
        self, n_steps: int, chunk: int = 10, pipelined: bool = False
    ) -> TickLog:
        """Chunked execution: ``chunk`` full replan+step ticks per dispatch.

        Amortizes dispatch latency via lax.scan (ReactiveTAMP.run_chunk).
        Exact for fixed-plan tasks (point env PLANNER_SIMPLE); the symbolic
        plan is refreshed between chunks, so a task switch is delayed by at
        most ``chunk - 1`` ticks.

        ``pipelined=True`` double-buffers chunks: chunk N+1 is dispatched
        (as a chain of device futures) BEFORE chunk N's views are fetched,
        so the host<->device round trip and the host's view unpack overlap
        on-device compute instead of serializing with it.
        The symbolic plan then reacts with one extra chunk of delay (at
        most ``2*chunk - 1`` ticks); the on-device success gate still
        freezes the state at the latch tick, so a chunk dispatched past
        success is a no-op on the final state.
        """
        if self._view is None:
            self.warmup(0)
        if self.env.env_type == "panda_env":
            return self._run_chunked_panda(n_steps, chunk)
        if pipelined:
            return self._run_chunked_pipelined(n_steps, chunk)
        i = 0
        while i < n_steps:
            t0 = time.perf_counter()
            task_params = self.tamp.tamp_interface_view(self._view)
            if self.tamp.task_success:
                self._record(i, self._view, 0.0, 0.0)
                break
            ms, rs, views, n_ticks, dev_done = self.tamp.run_chunk(
                self.tamp.mppi_state, self.state, task_params, i, chunk
            )
            # ONE batched fetch: views + gate scalars together (separate
            # int()/bool() pulls each cost a device->host round trip)
            views, n_ticks, dev_done = jax.device_get((views, n_ticks, dev_done))
            t1 = time.perf_counter()
            self.tamp.mppi_state, self.state = ms, rs
            done_at = self._drain_chunk(
                i, views, int(n_ticks), bool(dev_done), t1 - t0
            )
            if done_at is not None:
                break
            i += chunk
        return self.log

    def _drain_chunk(
        self, i: int, views, n_ticks: int, dev_done: bool, elapsed: float
    ) -> Optional[int]:
        """Host-side processing of one fetched chunk: unpack views, run the
        host success check per tick, record log rows.  Returns the success
        tick index, or None."""
        per = elapsed / max(n_ticks, 1)
        done_at = None
        tp = self.tamp.task_planner
        for k in range(n_ticks):
            self._view = self.env.view_unpack(views[k])
            if hasattr(tp, "observe"):
                # tick-granular stall bookkeeping (PLANNER_SIMPLE.observe):
                # update_plan only runs at chunk boundaries
                tp.observe(self._view)
            self.tamp.task_success = tp.check_task_success(self._view)
            self._record(i + k, self._view, per, 0.0)
            if self.tamp.task_success:
                done_at = i + k
                break  # stop at the success tick so _view/log match it
        if done_at is None and dev_done:
            # device gate latched but the host check disagreed at the
            # float boundary: trust the device (its state is frozen there)
            self.tamp.task_success = True
            done_at = i + n_ticks - 1
            self.log.success_step = done_at
        return done_at

    def _run_chunked_pipelined(self, n_steps: int, chunk: int) -> TickLog:
        """Double-buffered chunk execution (see run_chunked docstring).

        The loop keeps exactly one chunk in flight: dispatch N+1 from the
        device-future carry of N, then fetch and drain N while N+1 computes.
        When the host detects success in chunk N, the in-flight chunk N+1 is
        discarded unfetched (its carry was already committed, but the
        on-device gate froze the state at the latch, so the final state is
        the success state).
        """
        pending = None  # (i0, views, n_ticks, dev_done, t_dispatched)
        i = 0
        while True:
            nxt = None
            if i < n_steps and not self.tamp.task_success:
                task_params = self.tamp.tamp_interface_view(self._view)
                ms, rs, views, n_ticks, dev_done = self.tamp.run_chunk(
                    self.tamp.mppi_state, self.state, task_params, i, chunk
                )
                # carry stays on device as futures; chunk N+1 chains on it
                self.tamp.mppi_state, self.state = ms, rs
                nxt = (i, views, n_ticks, dev_done, time.perf_counter())
                i += chunk
            if pending is not None:
                i0, views, n_ticks, dev_done, t0 = pending
                views, n_ticks, dev_done = jax.device_get(
                    (views, n_ticks, dev_done)
                )
                t1 = time.perf_counter()
                done_at = self._drain_chunk(
                    i0, views, int(n_ticks), bool(dev_done), t1 - t0
                )
                if done_at is not None:
                    break
            if nxt is None:
                if pending is None:
                    break
                pending = None
            else:
                pending = nxt
        return self.log

    def _run_chunked_panda(self, n_steps: int, chunk: int) -> TickLog:
        """Chunked panda execution: per-tick symbolic switches stay EXACT
        because the AIF gate runs on-device inside the scan
        (ReactiveTAMP._panda_gate_device) — no chunk-boundary plan delay.

        The symbolic stage persists on the loop (``self._panda_stage``), so
        interrupting a run to perturb the scene (reactive scenarios) and
        calling run_chunked again resumes the plan, like the host planner's
        latches do on the per-tick path."""
        _STAGE_TASK = ("reach", "pick", "place")
        stage = getattr(self, "_panda_stage", 0)
        zs = getattr(self, "_panda_zs", None)
        if zs is None:
            zs = np.asarray(self.tamp.zup_zs0())
        i = 0
        while i < n_steps:
            t0 = time.perf_counter()
            ms, rs, stage_dev, zs_dev, done, views, stages, dones = (
                self.tamp.run_chunk_panda(
                    self.tamp.mppi_state, self.state, stage, zs, chunk
                )
            )
            views = np.asarray(jax.block_until_ready(views))
            stages = np.asarray(stages)
            dones = np.asarray(dones)
            t1 = time.perf_counter()
            self.tamp.mppi_state, self.state = ms, rs
            stage = int(stage_dev)
            zs = np.asarray(zs_dev)
            self._panda_stage = stage
            self._panda_zs = zs
            per = (t1 - t0) / chunk
            done_at = None
            for k in range(chunk):
                self._view = self.env.view_unpack(views[k])
                # keep the host planner's view of the task in sync for logs
                self.tamp.task_planner.task = _STAGE_TASK[int(stages[k])]
                self._record(i + k, self._view, per, 0.0)
                if bool(dones[k]):
                    done_at = i + k
                    break  # stop at the success tick so _view/log match it
            if done_at is not None:
                self.tamp.task_success = True
                self.log.success_step = done_at
                break
            i += chunk
        return self.log


def run_sim(cfg, n_steps: Optional[int] = None, warmup: int = 150, **kwargs):
    """Build everything from config and run — the one-process reactive TAMP.

    Replaces the two-terminal reactive_tamp.py + sim.py workflow with a
    single call; returns the TickLog.
    """
    loop = SimLoop(cfg)
    loop.warmup(warmup)
    return loop.run(n_steps or cfg.n_steps, **kwargs)
