"""Unified environment abstraction over the JAX scene models.

Replaces the reference's ``IsaacGymWrapper`` (isaacgym_wrapper.py:39-469) as
the single construction point for a scene: per-actor YAML configs are packed
into device arrays once, and the env is exposed as a bundle of *pure
functions* closed over those params.  K MPPI rollouts are ``jax.vmap`` of
``step`` over the state pytree; the "real system" is the same ``step`` at
batch 1 — one engine for both roles (SURVEY.md §7 "Architecture stance"),
replacing the reference's two Isaac Gym instances bridged by zerorpc.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import jax.numpy as jnp
import numpy as np

from m3p2i_aip_tpu.models import panda_env, panda_fk, point_env
from m3p2i_aip_tpu.sim.sim_config import load_env_cfgs


@dataclass
class Env:
    """A scene as a bundle of pure functions (all closed over the params)."""

    env_type: str
    params: Any
    nu: int  # action dimension (dofs per robot)
    nx: int  # interleaved dof-state dimension
    step: Callable  # (state, u, ext) -> state
    init_state: Callable  # () -> state
    zero_ext: Callable  # () -> ext pytree
    dof_state_view: Callable  # (state) -> [nx]
    load_dof_state: Callable  # (state, dof) -> state
    root_state_view: Callable  # (state) -> [A, 13]
    load_root_state: Callable  # (state, root) -> state
    view: Callable  # (state) -> dict for the host-side task planner
    view_vec: Callable  # (state) -> packed [V] device array (jit-safe)
    view_unpack: Callable  # ([V] host array) -> same dict as `view`
    traj_point: Callable  # (state) -> [2|3] point for trajectory viz
    actor_names: tuple = ()
    dyn_obs_slot: int = -1  # index into the dynamic-body array for "dyn-obs"


def make_env(cfg) -> Env:
    """Build the scene named by ``cfg.env_type`` from its per-actor YAMLs.

    Parity: IsaacGymWrapper.__init__ + creat_env (isaacgym_wrapper.py:40-66,
    242-267) — minus envs/viewer plumbing, which the functional design removes.
    """
    actors = load_env_cfgs(cfg.env_type)
    # cfg.actors + cfg.initial_actor_positions override named actors' spawn
    # poses — the reference declares exactly this pair in its ExampleConfig
    # schema (config_store.py:17-18; never wired upstream).  It is how the
    # paper's corner scenarios reposition the box (e.g. corner2: box STARTS
    # in a corner), without forking the per-actor YAML scene.
    for name, pos in zip(cfg.actors, cfg.initial_actor_positions):
        hits = [a for a in actors if a.name == name]
        if not hits:
            raise ValueError(
                f"initial_actor_positions: no actor named {name!r} in "
                f"{cfg.env_type}"
            )
        p = list(map(float, pos))
        hits[0].init_pos = p + hits[0].init_pos[len(p):]
    if float(getattr(cfg, "fric_noise", 0.0)) > 0.0:
        # CLI domain-randomization shorthand (ExampleConfig.fric_noise):
        # friction noise on every movable non-robot actor
        for a in actors:
            if not a.fixed and a.type != "robot":
                a.noise_percentage_friction = float(cfg.fric_noise)
    if cfg.env_type in ("point_env", "heijn_env", "boxer_env"):
        return _make_point_env(cfg, actors)
    if cfg.env_type == "panda_env":
        return _make_panda_env(cfg, actors)
    if cfg.env_type == "albert_env":
        return _make_albert_env(cfg, actors)
    raise ValueError(f"unknown env_type {cfg.env_type!r}")


def _domain_rng(cfg, actors):
    """Seeded RNG when any actor requests friction/size randomization."""
    wants = any(
        a.noise_percentage_friction or a.noise_sigma_size for a in actors
    )
    return np.random.default_rng(cfg.mppi.seed_val) if wants else None


def _make_point_env(cfg, actors) -> Env:
    params = point_env.build_params(actors, cfg.sim, rng=_domain_rng(cfg, actors))
    names = list(params.actor_names)
    box_slot = (
        params.dyn_actor_idx.index(names.index("box")) if "box" in names else 0
    )
    dynobs_slot = (
        params.dyn_actor_idx.index(names.index("dyn-obs"))
        if "dyn-obs" in names
        else -1
    )

    dynobs_actor = (
        params.dyn_actor_idx[dynobs_slot] if dynobs_slot >= 0 else 0
    )

    def view_vec(state):
        """Pack the planner observations into ONE small device array.

        One device->host transfer per tick instead of one per named getter —
        load-bearing when dispatch and host-sync latency dominate the tick.
        Layout: [robot_pos(2), robot_vel(2), box_pos(2), box_quat(4),
        dynobs_contact(1)].
        """
        from m3p2i_aip_tpu.ops import quat as quat_ops

        cf = jnp.sum(jnp.abs(state.contact_force[dynobs_actor][:2]))
        return jnp.concatenate(
            [
                state.q[:2],
                state.qd[:2],
                state.dyn_pos[box_slot],
                quat_ops.quat_from_yaw(state.dyn_yaw[box_slot])[None][0],
                cf[None],
            ]
        )

    def view_unpack(vec) -> dict:
        vec = np.asarray(vec)
        return {
            "robot_pos": vec[0:2],
            "robot_vel": vec[2:4],
            "box_pos": vec[4:6],
            "box_quat": vec[6:10],
            "dynobs_contact": float(vec[10]),
        }

    def view(state):
        """Named observations (parity: isaacgym_wrapper getters :120-188)."""
        return view_unpack(view_vec(state))

    return Env(
        env_type="point_env",  # planner-facing family; robot varies via params
        params=params,
        nu=point_env.robot_nu(params),
        nx=2 * point_env.robot_nq(params),
        step=lambda s, u, e: point_env.step(params, s, u, e),
        init_state=lambda: point_env.init_state(params),
        zero_ext=lambda: point_env.zero_ext(params),
        dof_state_view=point_env.dof_state_view,
        load_dof_state=point_env.load_dof_state,
        root_state_view=lambda s: point_env.root_state_view(params, s),
        load_root_state=lambda s, r: point_env.load_root_state(params, s, r),
        view=view,
        view_vec=view_vec,
        view_unpack=view_unpack,
        traj_point=lambda s: s.q[:2],
        actor_names=params.actor_names,
        dyn_obs_slot=dynobs_slot,
    )


def _make_albert_env(cfg, actors) -> Env:
    """Albert mobile manipulator (models/albert.py): boxer base + panda arm.

    The reference ships only the asset (assets/urdf/albert/albert.urdf) with
    no scene/task config; this scene makes the model runnable end-to-end —
    the ``ee_reach`` task drives base AND arm so the end effector reaches a
    3D goal the arm alone cannot.
    """
    from m3p2i_aip_tpu.models import albert

    params = albert.build_params(actors, cfg.sim)

    def view_vec(state):
        """[base_pose(3), base_vel(3), ee_pos(3), box_pos(2)] in one device
        array (box rows park at 1e3 in boxless scenes)."""
        ee_pos, _ = albert.fk(state)["ee"]
        return jnp.concatenate(
            [state.q[:3], state.qd[:3], ee_pos, state.box_pos]
        )

    def view_unpack(vec) -> dict:
        vec = np.asarray(vec)
        return {
            "robot_pos": vec[0:2],
            "robot_yaw": float(vec[2]),
            "robot_vel": vec[3:5],
            "ee_pos": vec[6:9],
            "box_pos": vec[9:11],
        }

    def view(state):
        return view_unpack(view_vec(state))

    root = jnp.zeros((1, 13)).at[0, 6].set(1.0)

    return Env(
        env_type="albert_env",
        params=params,
        nu=13,
        nx=24,
        step=lambda s, u, e: albert.step(params, s, u),
        init_state=lambda: albert.init_state(params),
        zero_ext=lambda: jnp.zeros(0),
        dof_state_view=albert.dof_state_view,
        load_dof_state=albert.load_dof_state,
        root_state_view=lambda s: root,
        load_root_state=lambda s, r: s,
        view=view,
        view_vec=view_vec,
        view_unpack=view_unpack,
        traj_point=lambda s: s.q[:2],
        actor_names=params.actor_names,
        dyn_obs_slot=-1,
    )


def _make_panda_env(cfg, actors) -> Env:
    params = panda_env.build_params(actors, cfg.sim, cube_on_shelf=cfg.cube_on_shelf)

    def view_vec(state):
        """[cube_state(7), cube_goal(7), ee_state(7), attached(1)] in one
        device array."""
        from m3p2i_aip_tpu.ops import quat as quat_ops

        links = panda_fk.fk(state.q, params.base_pos)
        lf_pos, lf_rot = links["leftfinger"]
        rf_pos, _ = links["rightfinger"]
        ee_pos = (lf_pos + rf_pos) / 2.0
        ee_quat = quat_ops.mat_to_quat(lf_rot)
        return jnp.concatenate(
            [
                state.body_pos[1],
                state.body_quat[1],
                state.body_pos[2],
                state.body_quat[2],
                ee_pos,
                ee_quat,
                state.attached[None],
            ]
        )

    def view_unpack(vec) -> dict:
        vec = np.asarray(vec)
        return {
            "cube_state": vec[0:7],
            "cube_goal": vec[7:14],
            "ee_state": vec[14:21],
            "attached": float(vec[21]),
        }

    def view(state):
        return view_unpack(view_vec(state))

    def traj_point(state):
        links = panda_fk.fk(state.q, params.base_pos)
        return links["ee"][0][:2]

    return Env(
        env_type="panda_env",
        params=params,
        nu=9,
        nx=18,
        step=lambda s, u, e: panda_env.step(params, s, u, e),
        init_state=lambda: panda_env.init_state(params),
        zero_ext=lambda: panda_env.zero_ext(params),
        dof_state_view=panda_env.dof_state_view,
        load_dof_state=panda_env.load_dof_state,
        root_state_view=lambda s: panda_env.root_state_view(params, s),
        load_root_state=lambda s, r: panda_env.load_root_state(params, s, r),
        view=view,
        view_vec=view_vec,
        view_unpack=view_unpack,
        traj_point=traj_point,
        actor_names=params.actor_names,
        dyn_obs_slot=0,  # _DYN_NAMES order: dyn-obs first
    )


def update_dyn_obs_device(env: Env, state, i, period: int = 100):
    """Traced-version of :func:`update_dyn_obs` (``i`` may be a device int),
    usable inside a jitted tick / lax.scan."""
    if env.dyn_obs_slot < 0 or env.env_type != "point_env":
        return state
    phase = jnp.mod(i, period)
    sign = jnp.where((phase > period // 4) & (phase < 3 * period // 4), 1.0, -1.0)
    off = jnp.asarray([0.01, 0.01]) * sign
    return state.replace(dyn_pos=state.dyn_pos.at[env.dyn_obs_slot].add(off))


def update_dyn_obs(env: Env, state, i: int, period: int = 100):
    """Oscillate the dynamic obstacle, host-driven.

    Parity: IsaacGymWrapper.update_dyn_obs (isaacgym_wrapper.py:205-220):
    point env moves dyn-obs by ±[0.01, 0.01] per tick in a square wave of the
    given period; panda env's offsets are zero in the reference (kept so the
    call sites match).
    """
    if env.dyn_obs_slot < 0:
        return state
    phase = i % period
    sign = 1.0 if (period / 4 < phase < 3 * period / 4) else -1.0
    if env.env_type == "point_env":
        off = jnp.asarray([0.01, 0.01]) * sign
        return state.replace(
            dyn_pos=state.dyn_pos.at[env.dyn_obs_slot].add(off)
        )
    return state


def command_world_vel(params, q, action):
    """World-frame commanded base velocity of a point-family robot.

    The suction alignment gate (skill_utils.check_suction_condition parity)
    compares the COMMANDED velocity direction with the robot->box direction;
    for the boxer the action channels are wheel speeds, so they must go
    through the diff-drive FK (wheel radius x mean speed along the heading)
    before the dot product — raw ``action[:2]`` would gate on meaningless
    per-wheel values.  Point/heijn actions are already world velocities.
    """
    if getattr(params, "robot_type", "point") == "boxer":
        v = params.wheel_radius * (action[..., 0] + action[..., 1]) * 0.5
        return v * jnp.stack([jnp.cos(q[2]), jnp.sin(q[2])])
    return action[..., :2]
