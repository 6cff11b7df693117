"""Point-robot environment: batched planar rigid-body simulation in pure JAX.

This is the from-scratch replacement for the Isaac Gym point_env scene
(``config/point_env/*.yaml`` + ``isaacgym_wrapper.py``): an omni point robot
(2 prismatic DOFs, velocity drive), four arena walls, one static obstacle, a
movable obstacle ("dyn-obs"), a pushable/pullable box, and non-colliding goal
and axis markers.

Design: the whole env is one pure function ``step(params, state, u, ext)``.
K MPPI rollouts are ``jax.vmap`` over the state pytree — the analogue of the
reference's K identical Isaac envs stepped in lock-step
(``reactive_tamp.py:23-30``, ``mppi.py:275-332``) — and the "real system" is
the same function at batch size 1.
"""
from __future__ import annotations

import dataclasses
from typing import List

import jax
import jax.numpy as jnp
import numpy as np

from m3p2i_aip_tpu.ops import quat
from m3p2i_aip_tpu.sim import pbd2d
from m3p2i_aip_tpu.sim.sim_config import ActorCfg, SimConfig
from m3p2i_aip_tpu.utils import struct

GRAVITY = 9.8  # matches sim_params.gravity (isaacgym_wrapper.py:25)


@struct.dataclass
class PointEnvState:
    """Per-env simulation state (vmap adds a leading K axis).

    ``q``/``qd`` are [2] (x, y) for the point robot and [3] (x, y, yaw) for
    the heijn omni base and the boxer differential-drive base.
    """

    q: jnp.ndarray  # [nq] robot dof positions
    qd: jnp.ndarray  # [nq] robot dof velocities
    dyn_pos: jnp.ndarray  # [D, 2]
    dyn_yaw: jnp.ndarray  # [D]
    dyn_vel: jnp.ndarray  # [D, 2]
    dyn_om: jnp.ndarray  # [D]
    contact_force: jnp.ndarray  # [A, 3] net contact force per actor
    # Per-state friction multiplier on the dynamic actors' material friction
    # (ones = nominal).  A TRACED leaf so the K vmapped rollout states can
    # each carry a DIFFERENT friction — the reference draws fresh friction
    # noise per env at creation, i.e. its K rollout envs physics-differ
    # (isaacgym_wrapper.py:311-326); MPPI draws these per reseed when the
    # actor YAML sets noise_percentage_friction > 0.
    fric_scale: jnp.ndarray = struct.field(default=None)  # [D]


@struct.dataclass
class PointExtForces:
    """External (e.g. suction) forces carried into the next step.

    Functional replacement for ``apply_rigid_body_force_tensors`` mutating the
    live sim inside the pull cost (cost_functions.py:71-76).
    """

    robot: jnp.ndarray  # [2]
    dyn: jnp.ndarray  # [D, 2]


@struct.dataclass
class PointEnvParams:
    # static geometry
    stat_pos: jnp.ndarray  # [S, 2]
    stat_yaw: jnp.ndarray  # [S]
    stat_half: jnp.ndarray  # [S, 2]
    stat_friction: jnp.ndarray  # [S]
    # dynamic boxes
    dyn_half: jnp.ndarray  # [D, 2]
    dyn_mass: jnp.ndarray  # [D]
    dyn_inv_mass: jnp.ndarray  # [D]
    dyn_inv_inertia: jnp.ndarray  # [D]
    dyn_mu_ground: jnp.ndarray  # [D]
    dyn_friction: jnp.ndarray  # [D]
    dyn_z: jnp.ndarray  # [D] resting height of the root
    init_dyn_pos: jnp.ndarray  # [D, 2]
    # robot
    robot_mass: float = struct.field(pytree_node=False, default=10.0)
    robot_radius: float = struct.field(pytree_node=False, default=0.2)
    # innermost wall-face coordinate of a closed axis-aligned arena
    # (0 = no closed arena); the robot is clamped inside it (see build_params)
    arena_bound: float = struct.field(pytree_node=False, default=0.0)
    drive_rate: float = struct.field(pytree_node=False, default=60.0)
    robot_friction: float = struct.field(pytree_node=False, default=0.05)
    # robot family: "point" (2-dof omni, pointRobot.urdf), "heijn" (3-dof
    # omni, heijn.urdf), "boxer" (2-wheel differential drive, boxer.urdf —
    # wheel-speed control mapped through the diff-drive kinematics that
    # skill_utils.apply_fk/apply_ik expose, skill_utils.py:97-137)
    robot_type: str = struct.field(pytree_node=False, default="point")
    wheel_radius: float = struct.field(pytree_node=False, default=0.08)
    wheel_base: float = struct.field(pytree_node=False, default=0.314)
    # integration
    dt: float = struct.field(pytree_node=False, default=0.05)
    substeps: int = struct.field(pytree_node=False, default=2)
    pos_iters: int = struct.field(pytree_node=False, default=2)
    max_dyn_speed: float = struct.field(pytree_node=False, default=20.0)
    # bookkeeping (host-side, static)
    actor_names: tuple = struct.field(pytree_node=False, default=())
    dyn_actor_idx: tuple = struct.field(pytree_node=False, default=())
    stat_actor_idx: tuple = struct.field(pytree_node=False, default=())
    robot_actor_idx: int = struct.field(pytree_node=False, default=0)
    num_actors: int = struct.field(pytree_node=False, default=0)
    init_root: jnp.ndarray = struct.field(default=None)  # [A, 13]
    # per-dyn-actor noise_percentage_friction from the actor YAMLs — the
    # per-SAMPLE randomization amplitude (MPPI draws fric_scale per reseed)
    dyn_fric_noise: jnp.ndarray = struct.field(default=None)  # [D]


def build_params(
    actors: List[ActorCfg],
    sim_cfg: SimConfig,
    rng: "np.random.Generator | None" = None,
) -> PointEnvParams:
    """Pack the per-actor YAML configs (actor_utils.py:16-46 schema) into
    device arrays.  Ground-friction combine follows PhysX's default *average*
    of the two materials (plane friction 1.0, isaacgym_wrapper.py:466-467).

    Domain randomization parity: when ``rng`` is given, per-actor friction is
    perturbed by uniform(+-noise_percentage_friction * friction)
    (isaacgym_wrapper.py:311-326) and box sizes by normal(0, noise_sigma_size)
    (actor_utils.py:64-69)."""
    stat, dyn, dyn_idx, stat_idx = [], [], [], []
    dyn_fric_noise = []
    robot_idx, robot_cfg = 0, None
    init_root = np.zeros((len(actors), 13), dtype=np.float32)
    init_root[:, 6] = 1.0  # identity quat w
    names = []

    def rand_friction(a: ActorCfg) -> float:
        if rng is None or not a.noise_percentage_friction:
            return a.friction
        lim = a.noise_percentage_friction * a.friction
        return a.friction + float(rng.uniform(-lim, lim))

    def rand_size(a: ActorCfg) -> np.ndarray:
        size = np.asarray(a.size, dtype=np.float32)
        if rng is None or not a.noise_sigma_size:
            return size
        return size + rng.normal(0.0, np.asarray(a.noise_sigma_size)).astype(
            np.float32
        )

    for i, a in enumerate(actors):
        names.append(a.name)
        init_root[i, 0:3] = a.init_pos
        init_root[i, 3:7] = a.init_ori
        if a.type == "robot":
            robot_idx, robot_cfg = i, a
        elif a.type == "box" and a.collision:
            yaw = float(quat.yaw_from_quat(jnp.asarray(a.init_ori)))
            friction = rand_friction(a)
            size = rand_size(a)
            if a.fixed:
                stat.append(
                    (a.init_pos[0], a.init_pos[1], yaw, size[0] / 2, size[1] / 2, friction)
                )
                stat_idx.append(i)
            else:
                dyn.append(
                    (
                        a.init_pos[0],
                        a.init_pos[1],
                        size[0] / 2,
                        size[1] / 2,
                        a.mass,
                        friction,
                        size[2] / 2,
                    )
                )
                dyn_idx.append(i)
                dyn_fric_noise.append(float(a.noise_percentage_friction or 0.0))
    stat = np.asarray(stat, dtype=np.float32).reshape(-1, 6)
    dyn = np.asarray(dyn, dtype=np.float32).reshape(-1, 7)
    half = dyn[:, 2:4]
    # Mass from PhysX's default density (1000 kg/m^3): the reference's YAML
    # mass is never applied — the set_rigid_body_properties block is commented
    # out (isaacgym_wrapper.py:294-300) — so Isaac's procedural boxes weigh
    # density * volume (the 0.4x0.4x0.1 box = 16 kg), which is what makes the
    # +-500-clamped suction force (skill_utils.py:92) well-behaved.
    masses = 1000.0 * (2 * half[:, 0]) * (2 * half[:, 1]) * (2 * dyn[:, 6])
    # box inertia about z: m*(w^2+h^2)/12 with w=2*hx etc.
    inertia = masses * ((2 * half[:, 0]) ** 2 + (2 * half[:, 1]) ** 2) / 12.0

    robot_type, robot_radius, robot_mass = "point", 0.2, 10.0
    wheel_radius, wheel_base = 0.08, 2 * 0.157  # boxer.urdf wheel geometry
    if robot_cfg is not None:
        urdf = (robot_cfg.urdf_file or "").lower()
        if robot_cfg.differential_drive or "boxer" in urdf or "albert" in urdf:
            robot_type, robot_radius, robot_mass = "boxer", 0.3, 40.0
            if robot_cfg.wheel_radius:
                wheel_radius = float(robot_cfg.wheel_radius)
            if robot_cfg.wheel_base:
                wheel_base = float(robot_cfg.wheel_base)
        elif "heijn" in urdf:
            robot_type, robot_radius, robot_mass = "heijn", 0.35, 30.0

    # closed-arena bound: innermost face of the axis-aligned boundary walls.
    # A squeezed contact chain (box pinned by +-500 N suction against a wall
    # with the robot in between) can walk the robot's PBD projection across
    # a thin wall's midplane, after which it resolves to the OUTSIDE — a
    # physically impossible escape PhysX's closed arena forbids by
    # construction.  The robot is clamped to this bound every substep.
    arena_bound = 0.0
    for a in actors:
        if a.type == "box" and a.collision and a.fixed and "wall" in a.name:
            # wall thickness = the smaller footprint extent (walls may be
            # yaw-rotated, e.g. the north/south walls reuse the [0.1, 8]
            # east-wall shape rotated 90 deg)
            thickness = min(a.size[0], a.size[1]) / 2
            b = max(abs(a.init_pos[0]), abs(a.init_pos[1])) - thickness
            arena_bound = b if arena_bound == 0.0 else min(arena_bound, b)

    return PointEnvParams(
        arena_bound=float(arena_bound),
        stat_pos=jnp.asarray(stat[:, 0:2]),
        stat_yaw=jnp.asarray(stat[:, 2]),
        stat_half=jnp.asarray(stat[:, 3:5]),
        stat_friction=jnp.asarray(stat[:, 5]),
        dyn_half=jnp.asarray(half),
        dyn_mass=jnp.asarray(masses),
        dyn_inv_mass=jnp.asarray(1.0 / masses),
        dyn_inv_inertia=jnp.asarray(1.0 / inertia),
        dyn_mu_ground=jnp.asarray((dyn[:, 5] + 1.0) / 2.0),
        dyn_friction=jnp.asarray(dyn[:, 5]),
        dyn_z=jnp.asarray(dyn[:, 6]),
        init_dyn_pos=jnp.asarray(dyn[:, 0:2]),
        robot_mass=robot_mass,
        robot_radius=robot_radius,
        drive_rate=sim_cfg.drive_damping / 10.0,
        robot_friction=robot_cfg.friction if robot_cfg else 0.05,
        robot_type=robot_type,
        wheel_radius=wheel_radius,
        wheel_base=wheel_base,
        dt=sim_cfg.dt,
        substeps=sim_cfg.substeps,
        actor_names=tuple(names),
        dyn_actor_idx=tuple(dyn_idx),
        stat_actor_idx=tuple(stat_idx),
        robot_actor_idx=robot_idx,
        num_actors=len(actors),
        init_root=jnp.asarray(init_root),
        dyn_fric_noise=jnp.asarray(np.asarray(dyn_fric_noise, np.float32)),
    )


def robot_nq(params: PointEnvParams) -> int:
    return 2 if params.robot_type == "point" else 3


def robot_nu(params: PointEnvParams) -> int:
    """Action dim: point (vx, vy); heijn (vx, vy, vyaw); boxer (vl, vr)."""
    return {"point": 2, "heijn": 3, "boxer": 2}[params.robot_type]


def init_state(params: PointEnvParams) -> PointEnvState:
    D = params.dyn_half.shape[0]
    nq = robot_nq(params)
    return PointEnvState(
        q=jnp.zeros(nq),
        qd=jnp.zeros(nq),
        dyn_pos=params.init_dyn_pos,
        dyn_yaw=jnp.zeros(D),
        dyn_vel=jnp.zeros((D, 2)),
        dyn_om=jnp.zeros(D),
        contact_force=jnp.zeros((params.num_actors, 3)),
        fric_scale=jnp.ones(D),
    )


def zero_ext(params: PointEnvParams) -> PointExtForces:
    return PointExtForces(
        robot=jnp.zeros(2), dyn=jnp.zeros((params.dyn_half.shape[0], 2))
    )


def step(
    params: PointEnvParams,
    state: PointEnvState,
    u_target: jnp.ndarray,
    ext: PointExtForces,
) -> PointEnvState:
    """One control step = ``substeps`` PBD substeps.

    Parity: IsaacGymWrapper.step (isaacgym_wrapper.py:354-364) preceded by
    set_dof_velocity_target_tensor (velocity drive, damping 600:341-344) and
    apply_rigid_body_force_tensors (ext forces).

    Contact passes are solved Gauss-Seidel style with dynamic-vs-static
    projections LAST and at full strength, so every substep ends with all
    bodies outside the static geometry (walls are impenetrable regardless of
    how hard the velocity drive pushes) — the PBD analogue of PhysX's
    position-iteration priority.
    """
    h = params.dt / params.substeps
    D = params.dyn_half.shape[0]
    S = params.stat_pos.shape[0]

    q, qd = state.q, state.qd
    dpos, dyaw = state.dyn_pos, state.dyn_yaw
    dvel, dom = state.dyn_vel, state.dyn_om
    # Dense per-category force accumulators (robot / dynamic / static) —
    # NO per-pass actor-index scatters: scatters serialize, and the ~30 of
    # them per step dominated the vmapped rollout's runtime.  The actor-
    # indexed contact_force tensor is assembled once at the end by stacking.
    f_rob = jnp.zeros(3)
    f_dyn = jnp.zeros((D, 3))
    f_stat = jnp.zeros((S, 3))

    wm_r = 1.0 / params.robot_mass
    decay = float(np.exp(-params.drive_rate * params.dt / params.substeps))

    # per-state friction (domain randomization: state.fric_scale is ones
    # nominally; the K rollout states may each carry a different draw).
    # Ground combine recomputed from the scaled material (PhysX average vs
    # the plane's 1.0) — bit-identical to the precomputed dyn_mu_ground
    # when fric_scale is ones.
    fric = params.dyn_friction * state.fric_scale
    mu_ground = (fric + 1.0) * 0.5

    def pad3(f):
        return jnp.concatenate([f, jnp.zeros(f.shape[:-1] + (1,))], axis=-1)

    for _ in range(params.substeps):
        # --- velocity integration -------------------------------------------
        qd = qd.at[:2].add(ext.robot * (wm_r * h))
        if params.robot_type == "boxer":
            # differential-drive kinematics: wheel speeds (vl, vr) -> base
            # twist (the inverse of skill_utils.apply_fk, skill_utils.py:97-115)
            v = params.wheel_radius * (u_target[0] + u_target[1]) / 2.0
            om = (
                params.wheel_radius
                * (u_target[1] - u_target[0])
                / params.wheel_base
            )
            th = q[2]
            qd_target = jnp.stack([v * jnp.cos(th), v * jnp.sin(th), om])
        else:
            qd_target = u_target  # world-frame dof velocities (point/heijn)
        qd = qd_target + (qd - qd_target) * decay  # exact 1st-order vel drive
        # cap robot speed so one substep can never out-run the contact
        # envelope (radius + wall half-thickness) — suction forces (up to
        # 500 N, skill_utils.py:92) could otherwise tunnel the robot through
        # the arena-corner wall junction (PhysX equivalently enforces
        # maxLinearVelocity)
        qspeed = jnp.linalg.norm(qd[:2])
        qcap = jnp.minimum(1.0, 6.0 / jnp.maximum(qspeed, 1e-9))
        qd = qd.at[:2].multiply(qcap)
        dvel = dvel + ext.dyn * (params.dyn_inv_mass[:, None] * h)
        dvel, dom = pbd2d.ground_friction(
            dvel, dom, mu_ground, GRAVITY, h,
            jnp.mean(params.dyn_half, axis=-1),
        )
        speed = jnp.linalg.norm(dvel, axis=-1, keepdims=True)
        dvel = dvel * jnp.minimum(1.0, params.max_dyn_speed / jnp.maximum(speed, 1e-9))

        # --- position integration --------------------------------------------
        q = q + qd * h
        dpos = dpos + dvel * h
        dyaw = dyaw + dom * h

        for _ in range(params.pos_iters):
            # pass 1: robot circle vs dynamic boxes [D]
            c = pbd2d.circle_vs_obb(
                jnp.broadcast_to(q[:2], (D, 2)), params.robot_radius,
                dpos, dyaw, params.dyn_half,
            )
            out = pbd2d.resolve_contact(
                c,
                jnp.broadcast_to(q[:2], (D, 2)), jnp.zeros(D),
                jnp.broadcast_to(qd[:2], (D, 2)), jnp.zeros(D), wm_r, 0.0,
                dpos, dyaw, dvel, dom,
                params.dyn_inv_mass, params.dyn_inv_inertia,
                h, friction=(params.robot_friction + fric) / 2,
                relax=1.0,
            )
            q = q.at[:2].add(out[0].sum(0))
            qd = qd.at[:2].add(out[2].sum(0))
            dpos = dpos + out[4]
            dyaw = dyaw + out[5]
            dvel = dvel + out[6]
            dom = dom + out[7]
            f_r = pad3(out[8])
            f_rob = f_rob + f_r.sum(0)
            f_dyn = f_dyn - f_r

            # pass 2: dynamic vs dynamic (corners of i inside j, both
            # orders).  Unrolled over the static (i, j) pairs: D is tiny and
            # static, and per-pair scalar indexing avoids gather/scatter ops.
            if D > 1:
                ddpos = jnp.zeros_like(dpos)
                ddyaw = jnp.zeros_like(dyaw)
                ddvel = jnp.zeros_like(dvel)
                ddom = jnp.zeros_like(dom)
                for i in range(D):
                    for j in range(D):
                        if i == j:
                            continue
                        c = pbd2d.corners_vs_obb(
                            dpos[i], dyaw[i], params.dyn_half[i],
                            dpos[j], dyaw[j], params.dyn_half[j],
                        )
                        out = pbd2d.resolve_contact(
                            c,
                            dpos[i][None, :], dyaw[i][None],
                            dvel[i][None, :], dom[i][None],
                            params.dyn_inv_mass[i],
                            params.dyn_inv_inertia[i],
                            dpos[j][None, :], dyaw[j][None],
                            dvel[j][None, :], dom[j][None],
                            params.dyn_inv_mass[j],
                            params.dyn_inv_inertia[j],
                            h,
                            friction=(fric[i] + fric[j]) / 2,
                            relax=0.5,
                        )
                        ddpos = ddpos.at[i].add(out[0].sum(0)).at[j].add(out[4].sum(0))
                        ddyaw = ddyaw.at[i].add(out[1].sum(0)).at[j].add(out[5].sum(0))
                        ddvel = ddvel.at[i].add(out[2].sum(0)).at[j].add(out[6].sum(0))
                        ddom = ddom.at[i].add(out[3].sum(0)).at[j].add(out[7].sum(0))
                        f_p = pad3(out[8]).sum(0)
                        f_dyn = f_dyn.at[i].add(f_p).at[j].add(-f_p)
                dpos, dyaw = dpos + ddpos, dyaw + ddyaw
                dvel, dom = dvel + ddvel, dom + ddom

            # pass 3: dynamic boxes vs static boxes [D, S, 4].  Full-strength
            # projection: per-corner corrections are normalized by the number
            # of active corners on the face so the summed translation removes
            # the full penetration — statics are impenetrable, no residual
            # drift that could carry a body across a thin wall's midplane.
            c = pbd2d.corners_vs_obb(
                dpos[:, None, :], dyaw[:, None], params.dyn_half[:, None, :],
                params.stat_pos[None, :, :], params.stat_yaw[None, :],
                params.stat_half[None, :, :],
            )
            n_active = jnp.sum(c.pen > 0, axis=-1, keepdims=True)  # [D, S, 1]
            relax_ds = 1.0 / jnp.maximum(n_active, 1)
            out = pbd2d.resolve_contact(
                c,
                dpos[:, None, None, :], dyaw[:, None, None],
                dvel[:, None, None, :], dom[:, None, None],
                params.dyn_inv_mass[:, None, None],
                params.dyn_inv_inertia[:, None, None],
                params.stat_pos[None, :, None, :], params.stat_yaw[None, :, None],
                jnp.zeros((1, S, 1, 2)), jnp.zeros((1, S, 1)), 0.0, 0.0,
                h,
                friction=(fric[:, None, None]
                          + params.stat_friction[None, :, None]) / 2,
                relax=relax_ds,
            )
            dpos = dpos + out[0].sum((1, 2))
            dyaw = dyaw + out[1].sum((1, 2))
            dvel = dvel + out[2].sum((1, 2))
            dom = dom + out[3].sum((1, 2))
            f_d = pad3(out[8])  # [D, S, 4, 3]
            f_dyn = f_dyn + f_d.sum((1, 2))
            f_stat = f_stat - f_d.sum((0, 2))

            # pass 4: robot circle vs static boxes [S] — full strength, last
            c = pbd2d.circle_vs_obb(
                jnp.broadcast_to(q[:2], (S, 2)), params.robot_radius,
                params.stat_pos, params.stat_yaw, params.stat_half,
            )
            out = pbd2d.resolve_contact(
                c,
                jnp.broadcast_to(q[:2], (S, 2)), jnp.zeros(S),
                jnp.broadcast_to(qd[:2], (S, 2)), jnp.zeros(S), wm_r, 0.0,
                params.stat_pos, params.stat_yaw, jnp.zeros((S, 2)), jnp.zeros(S),
                0.0, 0.0,
                h, friction=(params.robot_friction + params.stat_friction) / 2,
                relax=1.0,
            )
            q = q.at[:2].add(out[0].sum(0))
            qd = qd.at[:2].add(out[2].sum(0))
            f_r = pad3(out[8])
            f_rob = f_rob + f_r.sum(0)
            f_stat = f_stat - f_r

            # pass 5: robot vs dynamic again, with the dynamic body IMMOVABLE.
            # Closes the robot->box->wall constraint chain: pass 3 pinned the
            # box outside the statics; now the robot is projected fully out of
            # the box, so the velocity drive can never squeeze the box across
            # a thin wall's midplane (the PBD equivalent of PhysX resolving
            # the contact chain within one solver iteration set).
            c = pbd2d.circle_vs_obb(
                jnp.broadcast_to(q[:2], (D, 2)), params.robot_radius,
                dpos, dyaw, params.dyn_half,
            )
            out = pbd2d.resolve_contact(
                c,
                jnp.broadcast_to(q[:2], (D, 2)), jnp.zeros(D),
                jnp.broadcast_to(qd[:2], (D, 2)), jnp.zeros(D), wm_r, 0.0,
                dpos, dyaw, dvel, dom, 0.0, 0.0,
                h, friction=0.0, relax=1.0,
            )
            q = q.at[:2].add(out[0].sum(0))
            qd = qd.at[:2].add(out[2].sum(0))

        # closed-arena invariant (see build_params arena_bound): the robot
        # can never end a substep outside the boundary walls
        if params.arena_bound > 0.0:
            lim = params.arena_bound - params.robot_radius
            q = q.at[:2].set(jnp.clip(q[:2], -lim, lim))

    n_norm = params.substeps * params.pos_iters
    # assemble the actor-indexed contact_force by stacking in actor order
    # (static permutation -> plain concatenation, no scatter)
    rows = [jnp.zeros(3)] * params.num_actors
    rows[params.robot_actor_idx] = f_rob
    for k, a in enumerate(params.dyn_actor_idx):
        rows[a] = f_dyn[k]
    for k, a in enumerate(params.stat_actor_idx):
        rows[a] = f_stat[k]
    force_accum = jnp.stack(rows)
    return state.replace(
        q=q,
        qd=qd,
        dyn_pos=dpos,
        dyn_yaw=dyaw,
        dyn_vel=dvel,
        dyn_om=dom,
        contact_force=force_accum / n_norm,
    )


def root_state_view(params: PointEnvParams, state: PointEnvState) -> jnp.ndarray:
    """Assemble the Isaac-style root-state tensor [A, 13].

    Parity: ``acquire_actor_root_state_tensor`` view (isaacgym_wrapper.py:102-104).
    Fixed-base robots keep their initial root (robot motion lives in the DOFs).
    """
    root = params.init_root
    dyn_actor = jnp.asarray(params.dyn_actor_idx, dtype=jnp.int32)
    z = params.dyn_z
    pos3 = jnp.concatenate([state.dyn_pos, z[:, None]], axis=-1)
    quat4 = quat.quat_from_yaw(state.dyn_yaw)
    vel3 = jnp.concatenate([state.dyn_vel, jnp.zeros_like(z[:, None])], axis=-1)
    om3 = jnp.concatenate(
        [jnp.zeros((state.dyn_om.shape[0], 2)), state.dyn_om[:, None]], axis=-1
    )
    root = root.at[dyn_actor, 0:3].set(pos3)
    root = root.at[dyn_actor, 3:7].set(quat4)
    root = root.at[dyn_actor, 7:10].set(vel3)
    root = root.at[dyn_actor, 10:13].set(om3)
    return root


def load_root_state(
    params: PointEnvParams, state: PointEnvState, root: jnp.ndarray
) -> PointEnvState:
    """Inverse of :func:`root_state_view` — sync dynamics from a root tensor.

    Parity: REACTIVE_TAMP.run_tamp copying the real env's root state into all
    rollout envs (reactive_tamp.py:45-48).
    """
    dyn_actor = jnp.asarray(params.dyn_actor_idx, dtype=jnp.int32)
    rows = root[dyn_actor]
    return state.replace(
        dyn_pos=rows[:, 0:2],
        dyn_yaw=quat.yaw_from_quat(rows[:, 3:7]),
        dyn_vel=rows[:, 7:9],
        dyn_om=rows[:, 12],
    )


def dof_state_view(state: PointEnvState) -> jnp.ndarray:
    """Interleaved Isaac dof_state [x, vx, y, vy(, yaw, vyaw)]
    (isaacgym_wrapper.py:98-100).  3-dof bases append their yaw pair."""
    nq = state.q.shape[-1]
    return jnp.stack([state.q, state.qd], axis=-1).reshape(
        state.q.shape[:-1] + (2 * nq,)
    )


def load_dof_state(state: PointEnvState, dof: jnp.ndarray) -> PointEnvState:
    nq = state.q.shape[-1]
    pairs = dof.reshape(dof.shape[:-1] + (nq, 2))
    return state.replace(q=pairs[..., 0], qd=pairs[..., 1])
