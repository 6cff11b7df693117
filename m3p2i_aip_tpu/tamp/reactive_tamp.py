"""REACTIVE_TAMP orchestrator: task planner + objective + M3P2I in one loop.

Parity target: ``scripts/reactive_tamp.py`` (REACTIVE_TAMP class, :22-87).
Architectural differences (SURVEY.md §7):

  * No rollout Isaac Gym instance: the env is a pure ``step`` function and the
    K rollouts are vmapped inside the planner's single jitted ``command``.
  * No zerorpc: ``run_tamp`` takes/returns arrays in-process.  (The TCP compat
    server in ``utils/rpc.py`` wraps this same class for the two-terminal
    workflow.)
  * The task planner runs host-side and its outputs enter the jitted planner
    as traced :class:`TaskParams` — a task switch never recompiles.
"""
from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from m3p2i_aip_tpu.envs import (
    Env,
    command_world_vel,
    make_env,
    update_dyn_obs_device,
)
from m3p2i_aip_tpu.ops import general_ori_cube2goal
from m3p2i_aip_tpu.planners.motion_planner import cost_functions
from m3p2i_aip_tpu.planners.motion_planner.m3p2i import M3P2I
from m3p2i_aip_tpu.planners.motion_planner.mppi import TaskParams, make_task_params
from m3p2i_aip_tpu.planners.task_planner.task_planner import (
    ZUP_IMPROVE_M,
    ZUP_RELEASE_M,
    ZUP_STALL_TICKS,
    set_task_planner,
)
from m3p2i_aip_tpu.utils import compile_cache, skill_utils


def build_task_planner(cfg, env, objective):
    """Construct the host-side symbolic planner for one seeded run.

    Shared by ReactiveTAMP (one planner) and the vmapped multi-seed runner
    (tamp/batch_loop.py, one planner PER SEED — the latches/stall detectors
    are per-run mutable state).
    """
    tp = set_task_planner(cfg)
    if (
        env.env_type == "point_env"
        and float(env.params.arena_bound) > 0.0
        and hasattr(tp, "configure_pocket_endgame")
    ):
        # pocket-endgame latches (see PLANNER_SIMPLE): same pocket
        # geometry the pull cost's veto uses.  Diff drive arms both
        # latches; holonomic bases arm only the stall latch (their
        # rollout arbitration finishes pocket goals unstaged — the
        # latch exists for the two-corner vetoed-pull freeze)
        p = env.params
        tp.configure_pocket_endgame(
            float(p.arena_bound)
            - 2.0 * float(p.robot_radius)
            - float(p.dyn_half[objective.box_dyn_slot, 0]),
            proximity_latch=(p.robot_type == "boxer"),
            # keep a clipped standoff off the box itself (the point
            # reposition cost is bare navigation — a standoff ON the box
            # would have the base plow it away while "repositioning")
            min_clearance=float(p.robot_radius)
            + float(p.dyn_half[objective.box_dyn_slot, 0])
            + 0.1,
        )
    elif env.env_type == "albert_env" and hasattr(
        tp, "configure_pocket_endgame"
    ):
        # open floor (no arena): arm ONLY the stall latch — the albert base
        # parks beside an off-axis box exactly like the boxer (the
        # reposition arc exceeds the lookahead), and the same
        # stall -> reposition -> push cycle breaks the fixed point.
        # min_clearance keeps a clipped standoff outside the reposition
        # keep-out radius (AlbertObjective.clearance_r) so the nav and
        # clearance cost terms never fight.
        tp.configure_pocket_endgame(
            10.0,
            proximity_latch=False,
            min_clearance=getattr(objective, "clearance_r", 0.0),
        )
    return tp


class ReactiveTAMP:
    def __init__(self, cfg, env: Optional[Env] = None) -> None:
        compile_cache.enable()
        self.cfg = cfg
        self.env = env if env is not None else make_env(cfg)

        if self.env.env_type == "point_env":  # incl. heijn/boxer robot variants
            self.objective = cost_functions.PointObjective(self.env.params, cfg)
        elif self.env.env_type == "albert_env":
            self.objective = cost_functions.AlbertObjective(self.env.params, cfg)
        else:
            self.objective = cost_functions.PandaObjective(self.env.params, cfg)

        self.task_planner = build_task_planner(cfg, self.env, self.objective)
        self.task_success = False

        # Per-sample friction randomization (point family): activates when an
        # actor YAML sets noise_percentage_friction > 0 — each of the K
        # rollout states then carries its own friction draw, the reference's
        # per-env creation-time noise (isaacgym_wrapper.py:313-319)
        fric_kwargs = {}
        if self.env.env_type == "point_env":
            noise = np.asarray(self.env.params.dyn_fric_noise)
            if noise.size and np.any(noise):
                fric_kwargs = dict(
                    fric_noise=noise,
                    fric_inject=lambda sk, fs: sk.replace(fric_scale=fs),
                )

        self.motion_planner = M3P2I(
            cfg,
            dynamics=self.env.step,
            running_cost=self.objective.compute,
            zero_ext=self.env.zero_ext,
            traj_point=self.env.traj_point,
            **fric_kwargs,
        )
        if self.env.env_type == "point_env" and self.motion_planner.use_pallas:
            from m3p2i_aip_tpu.ops import pallas_rollout

            if pallas_rollout.rollout_kernel_supported(self.env.params):
                self.motion_planner.set_rollout_override(
                    pallas_rollout.make_point_rollout(
                        self.env.params,
                        float(cfg.kp_suction),
                        self.motion_planner.K,
                        self.motion_planner.T,
                        bool(cfg.multi_modal),
                        boxer_continuous_align=bool(
                            getattr(cfg.mppi, "boxer_continuous_align", True)
                        ),
                    )
                )

        self.mppi_state = self.motion_planner.init_state()
        self.suction_active = int(cfg.suction_active)
        self.top_trajs = None
        self._zero_action = jnp.zeros(self.env.nu)
        # On-device success gate for chunked execution (False = benchmark
        # mode: every tick replans regardless of goal distance).  Static jit
        # arg, so flipping it costs one extra compile, not a per-tick branch.
        self.device_gate = True
        self._tick_fused = jax.jit(self._tick_fused_impl)
        self._run_chunk = jax.jit(self._run_chunk_impl, static_argnums=(4, 5))
        self._run_chunk_panda = jax.jit(
            self._run_chunk_panda_impl, static_argnums=(4,)
        )

    # ------------------------------------------------------------------ api
    def run_tamp(self, real_state) -> jnp.ndarray:
        """One replanning tick: sync plan, then compute the optimal action.

        Parity: REACTIVE_TAMP.run_tamp (reactive_tamp.py:43-61).  The state
        broadcast into all K rollout envs (:45-48) happens inside the jitted
        command (mppi.py `_command_impl`), not by copying tensors K times.
        Returns the first action of the optimized sequence [nu].
        """
        task_params = self.tamp_interface(real_state)
        if self.task_success:
            return self._zero_action
        action_seq, self.mppi_state, aux = self.motion_planner.command(
            self.mppi_state, real_state, task_params
        )
        self.top_trajs = aux["top_trajs"]
        return action_seq[0]

    def run_tamp_sequence(self, real_state) -> jnp.ndarray:
        """Like :meth:`run_tamp` but returns the whole [u_per_command, nu]
        sequence (the reference's ``command`` return before the ``[0]`` at
        reactive_tamp.py:60)."""
        task_params = self.tamp_interface(real_state)
        if self.task_success:
            return jnp.zeros((self.cfg.mppi.u_per_command, self.env.nu))
        action_seq, self.mppi_state, aux = self.motion_planner.command(
            self.mppi_state, real_state, task_params
        )
        self.top_trajs = aux["top_trajs"]
        return action_seq[: self.cfg.mppi.u_per_command]

    def tamp_interface(self, real_state):
        """Update plan -> gripper -> objective params -> suction -> success.

        Parity: REACTIVE_TAMP.tamp_interface (reactive_tamp.py:75-81).
        """
        return self.tamp_interface_view(self.env.view(real_state))

    def tamp_interface_view(self, view: dict):
        """:meth:`tamp_interface` on an already-pulled observation dict —
        zero device round-trips (the fused tick returns next tick's view)."""
        self.task_planner.update_plan(view)
        gripper = self.motion_planner.update_gripper_command(self.task_planner.task)
        # NOTE: the pull-vs-push preference is NOT synced here — the fused
        # tick arbitrates on-device (_suction_ext_device) and get_suction()
        # computes it on demand, keeping the host tick free of device
        # round-trips (the CLAUDE.md fused-loop invariant).
        self.task_success = self.task_planner.check_task_success(view)
        grip = gripper if self.env.env_type == "panda_env" else "none"
        # cache the device TaskParams: the symbolic plan changes at ~1 Hz,
        # so skip the host->device puts on unchanged ticks
        zup = float(getattr(self.task_planner, "zup_gate", 0.0))
        key = (
            self.task_planner.task,
            tuple(np.ravel(self.task_planner.curr_goal)),
            grip,
            zup,
        )
        if getattr(self, "_tp_key", None) != key:
            self._tp_key = key
            self._tp_cached = make_task_params(
                self.task_planner.task, self.task_planner.curr_goal, grip, zup
            )
        return self._tp_cached

    # ------------------------------------------------------- fused device tick
    def _suction_ext_device(self, mppi_state, real_state, task, action):
        """On-device real-env suction (point env only).

        Parity: check_and_apply_suction + check_suction_condition
        (skill_utils.py:36-56) + the real-env branch of calculate_suction
        (threshold 1.5, :77-82); the pull-vs-push arbitration uses the
        incoming weights (m3p2i.py:16-22) exactly like the reference's
        get_suction RPC, which reports the pre-command preference.
        """
        ext = self.env.zero_ext()
        if self.env.env_type != "point_env" or not (
            bool(self.cfg.suction_active) or self.multi_modal_suction
        ):
            return ext
        names = list(self.env.params.actor_names)
        if "box" not in names:
            return ext
        box_slot = self.env.params.dyn_actor_idx.index(names.index("box"))
        box_pos = real_state.dyn_pos[box_slot]
        robot_pos = real_state.q[:2]  # 3-dof bases carry yaw in q[2]

        if self.multi_modal_suction:
            w = mppi_state.weights
            suction_on = jnp.sum(w[self.motion_planner.half_K :]) > jnp.sum(
                w[: self.motion_planner.half_K]
            )
        else:
            suction_on = jnp.asarray(bool(self.cfg.suction_active))
        task_ok = (task.task_id == 2) | (task.task_id == 3)
        dir_rb = robot_pos - box_pos
        cmd_vel = command_world_vel(self.env.params, real_state.q, action)
        align_ok = jnp.sum(cmd_vel * dir_rb) > 0
        dist_ok = jnp.linalg.norm(dir_rb) < 0.6
        on = suction_on & task_ok & align_ok & dist_ok

        f_box, f_robot = skill_utils.calculate_suction(
            box_pos, robot_pos, float(self.cfg.kp_suction), threshold=1.5
        )
        zero2 = jnp.zeros(2)
        return ext.replace(
            robot=jnp.where(on, f_robot, zero2),
            dyn=ext.dyn.at[box_slot].set(jnp.where(on, f_box, zero2)),
        )

    @property
    def multi_modal_suction(self) -> bool:
        return bool(self.cfg.multi_modal) and self.env.env_type == "point_env"

    def _tick_fused_impl(self, mppi_state, real_state, task, i):
        """One full control tick in a single XLA program: dyn-obs oscillation,
        K-rollout replan, real-env suction, real-env step, packed observation.

        This is the SURVEY.md §7 "one device-resident loop": the
        reference's per-tick call pattern (state sync + command + suction
        query + step + named getters, reactive_tamp.py:43-61 / sim.py:37-58)
        collapses into ONE dispatch and ONE small device->host transfer.
        """
        real_state = update_dyn_obs_device(self.env, real_state, i)
        pre_state = mppi_state  # pre-command weights drive the arbitration:
        # the reference computes get_pull_preference in tamp_interface BEFORE
        # motion_planner.command (reactive_tamp.py:75-81)
        action_seq, mppi_state, aux = self.motion_planner._command_impl(
            mppi_state, real_state, task
        )
        action = action_seq[0]
        ext = self._suction_ext_device(pre_state, real_state, task, action)
        real_state = self.env.step(real_state, action, ext)
        # top_trajs stays a DEVICE array output (no host transfer unless the
        # caller renders it) so get_trajs works on the fused path too
        return (
            action,
            mppi_state,
            real_state,
            self.env.view_vec(real_state),
            aux["top_trajs"],
        )

    def tick_fused(self, mppi_state, real_state, task, i):
        action, ms, rs, vvec, self.top_trajs = self._tick_fused(
            mppi_state, real_state, task, jnp.asarray(i)
        )
        return action, ms, rs, vvec

    def _point_success_device(self, real_state, task):
        """PLANNER_SIMPLE's success gate as traced data (task_planner.py:48-58
        semantics: nav = robot strictly within 0.1 m, push-family = box within
        0.1 m inclusive).  Tasks without a device gate (e.g. albert ee_reach)
        never latch here; the host's chunk-boundary check still covers them."""
        goal2 = task.goal[:2]
        nav_ok = jnp.linalg.norm(real_state.q[:2] - goal2) < 0.1
        if self.env.env_type == "albert_env":
            # albert: push_reach gates on the pushed box (ee_reach keeps the
            # host's chunk-boundary check — FK per tick isn't worth the gate)
            box_ok = jnp.linalg.norm(real_state.box_pos - goal2) <= 0.1
            return jnp.where(
                task.task_id == 0,
                nav_ok,
                jnp.where(task.task_id == 9, box_ok, False),
            )
        names = list(self.env.params.actor_names)
        if "box" in names:
            slot = self.env.params.dyn_actor_idx.index(names.index("box"))
            box_ok = jnp.linalg.norm(real_state.dyn_pos[slot] - goal2) <= 0.1
        else:
            box_ok = jnp.asarray(False)
        push_family = (task.task_id >= 1) & (task.task_id <= 3)
        return jnp.where(
            task.task_id == 0, nav_ok, jnp.where(push_family, box_ok, False)
        )

    def _run_chunk_impl(
        self,
        mppi_state,
        real_state,
        task,
        i0,
        length: int,
        gate: bool = True,
        done0=None,
    ):
        """Up to ``length`` fused ticks in one dispatch, stopping the moment
        the success gate latches (lax.while_loop) so
        chunked task-time stats match the per-tick path exactly and no
        replans are wasted past the goal.  ``gate=False`` compiles the
        benchmark variant that always runs the full chunk.

        Valid while the symbolic plan is constant across the chunk (always
        true for PLANNER_SIMPLE's fixed task, SURVEY.md §1 L4a); the host
        checks the per-tick packed views afterwards.

        ``done0`` (traced bool, gate mode only) pre-latches the gate: a
        chunk entered already-done runs ZERO ticks and returns its state
        unchanged.  This is what lets the vmapped multi-seed runner
        (tamp/batch_loop.py) keep dispatching one batched program while
        individual seeds finish at different ticks — jax masks the while
        body per batch element, so a finished seed's state is frozen
        exactly as if the host had stopped dispatching it.
        Returns (mppi_state, real_state, views [length, nv], n_ticks, done).
        """
        nv = self.env.view_vec(real_state).shape[0]

        def tick(k, ms, rs):
            rs = update_dyn_obs_device(self.env, rs, i0 + k)
            pre_ms = ms  # pre-command weights, as in _tick_fused_impl
            action_seq, ms, aux = self.motion_planner._command_impl(ms, rs, task)
            action = action_seq[0]
            ext = self._suction_ext_device(pre_ms, rs, task, action)
            rs = self.env.step(rs, action, ext)
            return ms, rs

        if not gate:
            # benchmark variant: fixed trip count, so a scan — its trip
            # count is static, unlike the gated while_loop's
            def body(carry, k):
                ms, rs = carry
                ms, rs = tick(k, ms, rs)
                return (ms, rs), self.env.view_vec(rs)

            (mppi_state, real_state), views = jax.lax.scan(
                body, (mppi_state, real_state), jnp.arange(length)
            )
            return (
                mppi_state,
                real_state,
                views,
                jnp.asarray(length, jnp.int32),
                jnp.asarray(False),
            )

        def cond(carry):
            k, _, _, done, _ = carry
            return (k < length) & jnp.logical_not(done)

        def body(carry):
            k, ms, rs, done, buf = carry
            ms, rs = tick(k, ms, rs)
            buf = jax.lax.dynamic_update_index_in_dim(
                buf, self.env.view_vec(rs), k, axis=0
            )
            done = self._point_success_device(rs, task)
            return k + 1, ms, rs, done, buf

        k, mppi_state, real_state, done, views = jax.lax.while_loop(
            cond,
            body,
            (
                jnp.asarray(0, jnp.int32),
                mppi_state,
                real_state,
                jnp.asarray(False) if done0 is None else done0,
                jnp.zeros((length, nv)),
            ),
        )
        return mppi_state, real_state, views, k, done

    def run_chunk(self, mppi_state, real_state, task, i0: int, length: int):
        ms, rs, views, n_ticks, done = self._run_chunk(
            mppi_state, real_state, task, jnp.asarray(i0), length, self.device_gate
        )
        if not self.device_gate:
            # statically known: avoid two extra device->host round trips per
            # chunk boundary
            return ms, rs, views, length, False
        return ms, rs, views, n_ticks, done

    # --------------------------------------------- on-device panda AIF gate
    @staticmethod
    def zup_zs0():
        """Initial [best_d, stall_n, gate, latch_d] stall carry for the
        wedged-pick detector (thresholds shared with the host mirror —
        task_planner.ZUP_*)."""
        return jnp.asarray([1e9, 0.0, 0.0, 0.0], jnp.float32)

    def _zup_update(self, zs, d, in_pick, att):
        """One stall-detector step (pure; jnp scalars in, f32[4] out).
        Device twin of PLANNER_AIF_PANDA._zup_update."""
        best, n, gate, latch = zs[0], zs[1], zs[2], zs[3]
        improved = d < best - ZUP_IMPROVE_M
        best = jnp.minimum(best, d)
        active = in_pick & (att > 0.5)
        n = jnp.where(active & ~improved, n + 1.0, 0.0)
        was_on = gate > 0.5
        turn_on = n >= float(ZUP_STALL_TICKS)
        latch = jnp.where(active & turn_on & ~was_on, d, latch)
        release = d < latch - ZUP_RELEASE_M
        gate = jnp.where(
            active & ((was_on & ~release) | turn_on), 1.0, 0.0
        )
        best = jnp.where(in_pick, best, 1e9)
        return jnp.stack([best, n, gate, latch])

    def _panda_gate_device(self, real_state, stage, zs):
        """The PLANNER_AIF_PANDA decision as traced data (task_planner.py:90-123).

        The AIF machinery's observable behavior on MDPIsCubeAtReal is a
        3-stage latch (reach -> pick -> place driven by the geometric
        thresholds with pick_always/place_always hysteresis), so the plan can
        be computed on-device — which is what lets the panda loop CHUNK
        (symbolic switches no longer need a host sync every tick).
        Equivalence against the host path is asserted in
        tests/test_tamp_integration.py.
        Returns (TaskParams, new_stage, success, new_zs).
        """
        from m3p2i_aip_tpu.models import panda_fk

        p = self.env.params
        links = panda_fk.fk(real_state.q, p.base_pos)
        ee = links["ee"][0]
        cube = real_state.body_pos[1]
        cube_q = real_state.body_quat[1]
        goal_pos = real_state.body_pos[2]
        goal_q = real_state.body_quat[2]
        th = float(self.cfg.pre_height_diff) + 0.005

        pre_place = jnp.concatenate([goal_pos.at[2].add(th), goal_q])
        reach_cost = jnp.linalg.norm(ee - cube)
        dist_cost = jnp.linalg.norm(pre_place[:2] - cube[:2])
        # host passes (goal quat, cube quat) in that order (task_planner.py:94-98)
        ori_cost = general_ori_cube2goal(goal_q, cube_q)

        new_stage = jnp.where(
            (dist_cost + ori_cost < 0.03) | (stage >= 2),
            2,
            jnp.where((reach_cost < th) | (stage >= 1), 1, 0),
        ).astype(jnp.int32)
        zs = self._zup_update(
            zs,
            jnp.linalg.norm(pre_place[:3] - cube),
            new_stage == 1,
            real_state.attached,
        )
        task = TaskParams(
            task_id=jnp.asarray(4, jnp.int32) + new_stage,
            goal=pre_place,
            # reach/place -> open(1), pick -> close(2) (m3p2i.py:22-28)
            gripper=jnp.where(new_stage == 1, 2, 1).astype(jnp.int32),
            zup_gate=zs[2],
        )
        success = (new_stage == 2) & (dist_cost < 0.04)
        return task, new_stage, success, zs

    def _run_chunk_panda_impl(
        self, mppi_state, real_state, stage, zs, length: int, done0=None
    ):
        """``length`` panda ticks in ONE dispatch: the AIF gate, replan, and
        real-env step all run on-device under lax.scan (the point env's
        chunked mode extended to the panda via _panda_gate_device).  ``zs``
        is the wedged-pick stall carry (see zup_zs0).

        ``done0`` (traced bool) pre-latches the success gate so a chunk
        entered already-done keeps its zero-action freeze — the vmapped
        multi-seed runner (tamp/batch_loop.py) relies on this when seeds
        finish at different ticks (a finished seed must not resume planning
        if its cube later drifts past the success threshold)."""

        def body(carry, _):
            ms, rs, st, zc, done = carry
            task, st, succ, zc = self._panda_gate_device(rs, st, zc)
            done = done | succ
            action_seq, ms, aux = self.motion_planner._command_impl(ms, rs, task)
            action = jnp.where(done, jnp.zeros_like(action_seq[0]), action_seq[0])
            rs = self.env.step(rs, action, self.env.zero_ext())
            return (ms, rs, st, zc, done), (self.env.view_vec(rs), st, done)

        (mppi_state, real_state, stage, zs, done), (views, stages, dones) = (
            jax.lax.scan(
                body,
                (
                    mppi_state,
                    real_state,
                    stage,
                    zs,
                    jnp.asarray(False) if done0 is None else done0,
                ),
                None,
                length=length,
            )
        )
        return mppi_state, real_state, stage, zs, done, views, stages, dones

    def run_chunk_panda(self, mppi_state, real_state, stage, zs, length: int):
        return self._run_chunk_panda(
            mppi_state,
            real_state,
            jnp.asarray(stage, jnp.int32),
            jnp.asarray(zs, jnp.float32),
            length,
        )

    # -------------------------------------------------------------- queries
    def get_trajs(self):
        """Top-20 rollout trajectories. Parity: reactive_tamp.py:83-84."""
        return self.top_trajs

    def get_suction(self) -> int:
        """Parity: reactive_tamp.py:86-87 (computed on demand — see
        tamp_interface_view)."""
        self.suction_active = self.motion_planner.get_pull_preference(
            self.mppi_state
        )
        return int(self.suction_active)


class ReactiveTAMPServer:
    """Wire-level facade for the two-process compat workflow.

    Speaks the reference's RPC surface — ``run_tamp(dof_state, root_state)``
    with raw Isaac-layout tensors (reactive_tamp.py:43-61) — on top of the
    in-process :class:`ReactiveTAMP`.  Serve it with
    ``m3p2i_aip_tpu.utils.rpc.Server``.
    """

    def __init__(self, cfg) -> None:
        self.tamp = ReactiveTAMP(cfg)
        self._state = self.tamp.env.init_state()

    def run_tamp(self, dof_state, root_state):
        env = self.tamp.env
        state = env.load_dof_state(self._state, jnp.asarray(dof_state))
        state = env.load_root_state(state, jnp.asarray(root_state))
        self._state = state
        return np.asarray(self.tamp.run_tamp(state))

    def get_trajs(self):
        return np.asarray(self.tamp.get_trajs())

    def get_suction(self) -> int:
        return self.tamp.get_suction()
