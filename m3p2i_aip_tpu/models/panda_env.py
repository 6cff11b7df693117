"""Panda tabletop environment: 9-DOF arm + graspable cube, pure JAX.

Replaces the Isaac Gym panda_env scene (``config/panda_env/*.yaml``): a
velocity-driven Franka Panda (first-order joint-velocity tracking + FK — the
faithful reduction of PhysX velocity drives, SURVEY.md §7.10), a table, two
stands, a shelf, a floating plate obstacle ("dyn-obs"), the manipulated cubeA
and the goal cubeB.

Grasping is modeled as an explicit attach constraint: when the gripper is
closing and the fingertip midpoint is within grasp range of cubeA, the cube is
welded to the hand frame until the gripper opens — mirroring how the reference
models suction as a force pair rather than simulating finger friction
(SURVEY.md §7 "Panda grasping").
"""
from __future__ import annotations

from typing import List

import jax
import jax.numpy as jnp
import numpy as np

from m3p2i_aip_tpu.models import panda_fk
from m3p2i_aip_tpu.ops import quat as quat_ops
from m3p2i_aip_tpu.sim.sim_config import ActorCfg, SimConfig
from m3p2i_aip_tpu.utils import struct

_HIGHEST = jax.lax.Precision.HIGHEST

GRAVITY = 9.8


@struct.dataclass
class PandaEnvState:
    q: jnp.ndarray  # [9]
    qd: jnp.ndarray  # [9]
    # dynamic bodies: 0=dyn-obs (gravity off), 1=cubeA, 2=cubeB
    body_pos: jnp.ndarray  # [3, 3]
    body_quat: jnp.ndarray  # [3, 4]
    body_vel: jnp.ndarray  # [3, 3]
    body_om: jnp.ndarray  # [3, 3]
    attached: jnp.ndarray  # [] float, 1.0 when cubeA welded to hand
    attach_pos: jnp.ndarray  # [3] cube pos in hand frame
    attach_rot: jnp.ndarray  # [3, 3] cube ori in hand frame (rotation matrix)
    contact_force: jnp.ndarray  # [A, 3]


@struct.dataclass
class PandaEnvParams:
    # static colliders as 3D AABBs (all panda_env statics are axis-aligned)
    stat_min: jnp.ndarray  # [S, 3]
    stat_max: jnp.ndarray  # [S, 3]
    # support surfaces (top faces cubes can rest on): table, stands, shelf
    sup_min: jnp.ndarray  # [P, 2] xy extent
    sup_max: jnp.ndarray  # [P, 2]
    sup_z: jnp.ndarray  # [P] top height
    body_half: jnp.ndarray  # [3, 3]
    body_mass: jnp.ndarray  # [3]
    body_gravity: jnp.ndarray  # [3] 1/0 flags
    init_body_pos: jnp.ndarray  # [3, 3]
    init_q: jnp.ndarray  # [9]
    base_pos: jnp.ndarray  # [3]
    joint_lower: jnp.ndarray  # [9]
    joint_upper: jnp.ndarray  # [9]
    init_root: jnp.ndarray = struct.field(default=None)  # [A, 13]
    dt: float = struct.field(pytree_node=False, default=0.01)
    substeps: int = struct.field(pytree_node=False, default=2)
    drive_rate: float = struct.field(pytree_node=False, default=200.0)
    grasp_range: float = struct.field(pytree_node=False, default=0.05)
    actor_names: tuple = struct.field(pytree_node=False, default=())
    dyn_actor_idx: tuple = struct.field(pytree_node=False, default=())
    stat_actor_idx: tuple = struct.field(pytree_node=False, default=())
    robot_actor_idx: int = struct.field(pytree_node=False, default=0)
    num_actors: int = struct.field(pytree_node=False, default=0)


@struct.dataclass
class PandaExtForces:
    body: jnp.ndarray  # [3, 3] world forces on the dynamic bodies


_DYN_NAMES = ("dyn-obs", "cubeA", "cubeB")


def build_params(
    actors: List[ActorCfg], sim_cfg: SimConfig, cube_on_shelf: bool = False
) -> PandaEnvParams:
    names, stat_min, stat_max, stat_idx = [], [], [], []
    dyn = {}
    robot_idx, robot_cfg = 0, None
    init_root = np.zeros((len(actors), 13), dtype=np.float32)
    init_root[:, 6] = 1.0
    for i, a in enumerate(actors):
        names.append(a.name)
        if a.name == "cubeA":
            pos = a.init_pos_on_shelf if cube_on_shelf else a.init_pos_on_table
        else:
            pos = a.init_pos
        init_root[i, 0:3] = pos
        init_root[i, 3:7] = a.init_ori
        if a.type == "robot":
            robot_idx, robot_cfg = i, a
        elif a.fixed and a.collision:
            h = np.asarray(a.size, dtype=np.float32) / 2
            stat_min.append(np.asarray(pos) - h)
            stat_max.append(np.asarray(pos) + h)
            stat_idx.append(i)
        elif a.name in _DYN_NAMES:
            dyn[a.name] = (i, a, pos)

    dyn_idx = [dyn[n][0] for n in _DYN_NAMES]
    half = np.stack([np.asarray(dyn[n][1].size, np.float32) / 2 for n in _DYN_NAMES])
    # PhysX default density 1000 kg/m^3 (the reference never applies YAML
    # mass — isaacgym_wrapper.py:294-300 is commented out).
    mass = np.asarray(
        [1000.0 * float(np.prod(np.asarray(dyn[n][1].size))) for n in _DYN_NAMES],
        np.float32,
    )
    grav = np.asarray([1.0 if dyn[n][1].gravity else 0.0 for n in _DYN_NAMES], np.float32)
    ipos = np.stack([np.asarray(dyn[n][2], np.float32) for n in _DYN_NAMES])

    # support surfaces = top faces of the static AABBs plus the ground
    sup_min = [m[:2] for m in stat_min] + [np.array([-10.0, -10.0], np.float32)]
    sup_max = [m[:2] for m in stat_max] + [np.array([10.0, 10.0], np.float32)]
    sup_z = [m[2] for m in stat_max] + [np.float32(0.0)]

    init_q = np.zeros(9, dtype=np.float32)
    if robot_cfg is not None and robot_cfg.init_joint_pose:
        # Isaac dof_state interleaves (pos, vel) — init_joint_pose is that
        # 18-vector (panda.yaml init_joint_pose).
        init_q = np.asarray(robot_cfg.init_joint_pose, np.float32)[0::2]

    return PandaEnvParams(
        stat_min=jnp.asarray(np.stack(stat_min)),
        stat_max=jnp.asarray(np.stack(stat_max)),
        sup_min=jnp.asarray(np.stack(sup_min)),
        sup_max=jnp.asarray(np.stack(sup_max)),
        sup_z=jnp.asarray(np.stack(sup_z)),
        body_half=jnp.asarray(half),
        body_mass=jnp.asarray(mass),
        body_gravity=jnp.asarray(grav),
        init_body_pos=jnp.asarray(ipos),
        init_q=jnp.asarray(init_q),
        base_pos=jnp.asarray(np.asarray(robot_cfg.init_pos, np.float32)),
        joint_lower=jnp.asarray(panda_fk.JOINT_LOWER),
        joint_upper=jnp.asarray(panda_fk.JOINT_UPPER),
        init_root=jnp.asarray(init_root),
        dt=sim_cfg.dt,
        substeps=sim_cfg.substeps,
        actor_names=tuple(names),
        dyn_actor_idx=tuple(dyn_idx),
        stat_actor_idx=tuple(stat_idx),
        robot_actor_idx=robot_idx,
        num_actors=len(actors),
    )


def init_state(params: PandaEnvParams) -> PandaEnvState:
    return PandaEnvState(
        q=params.init_q,
        qd=jnp.zeros(9),
        body_pos=params.init_body_pos,
        body_quat=jnp.broadcast_to(jnp.asarray([0.0, 0, 0, 1]), (3, 4)),
        body_vel=jnp.zeros((3, 3)),
        body_om=jnp.zeros((3, 3)),
        attached=jnp.asarray(0.0),
        attach_pos=jnp.zeros(3),
        attach_rot=jnp.eye(3),
        contact_force=jnp.zeros((params.num_actors, 3)),
    )


def zero_ext(params: PandaEnvParams) -> PandaExtForces:
    return PandaExtForces(body=jnp.zeros((3, 3)))


def _sphere_vs_aabb(center, radius, bmin, bmax):
    """Penetration + outward normal of a sphere against an AABB (3D).

    Gather-free formulation: the push-out axis/sign selection uses arithmetic
    one-hot masks instead of ``argmin`` + ``take_along_axis`` / ``eye[idx]``.
    Computed-index gathers inside XLA:CPU loop fusions re-evaluate their
    (here: whole-FK-chain) operands per output element — measured ~500x
    slowdown of the vmapped step; masks fuse cleanly on every backend
    (elementwise select ops, no dynamic addressing).
    """
    closest = jnp.clip(center, bmin, bmax)
    diff = center - closest
    dist = jnp.linalg.norm(diff, axis=-1)
    inside = jnp.all((center > bmin) & (center < bmax), axis=-1)
    # if inside, push out along the axis of least separation
    sep_lo = center - bmin
    sep_hi = bmax - center
    sep = jnp.minimum(sep_lo, sep_hi)
    min_sep = jnp.min(sep, axis=-1, keepdims=True)
    one_hot = (sep <= min_sep).astype(center.dtype)
    one_hot = one_hot / jnp.sum(one_hot, axis=-1, keepdims=True)  # break ties
    sign = jnp.where(sep_hi < sep_lo, 1.0, -1.0)
    n_inside = sign * one_hot
    pen_inside = radius + min_sep[..., 0]
    normal = jnp.where(inside[..., None], n_inside, diff / jnp.maximum(dist, 1e-9)[..., None])
    pen = jnp.where(inside, pen_inside, radius - dist)
    return pen, normal


def step(
    params: PandaEnvParams,
    state: PandaEnvState,
    u_target: jnp.ndarray,
    ext: PandaExtForces,
) -> PandaEnvState:
    """One control step: drive joints, update FK, cube dynamics, grasp logic.

    Parity: sim.step + velocity targets (isaacgym_wrapper.py:196-197, 354-364)
    with the explicit grasp constraint replacing finger/cube friction.
    """
    h = params.dt / params.substeps
    decay = float(np.exp(-params.drive_rate * params.dt / params.substeps))
    q, qd = state.q, state.qd
    bpos, bquat = state.body_pos, state.body_quat
    bvel, bom = state.body_vel, state.body_om
    attached = state.attached
    attach_pos, attach_rot = state.attach_pos, state.attach_rot
    force_accum = jnp.zeros((params.num_actors, 3))

    gripper_closing = u_target[7] < 0.0

    vel_lim = jnp.asarray(panda_fk.JOINT_VEL_LIMIT)
    acc_lim = jnp.asarray(panda_fk.JOINT_ACCEL_LIMIT)
    u_clamped = jnp.clip(u_target, -vel_lim, vel_lim)

    # finger-travel release model: while gripping, the fingers rest ON the
    # cube surface (PhysX finger-cube contact stops them there), and the
    # grasp persists until the fingers have physically cleared the cube
    # width.  An instantaneous release on the open COMMAND throws the cube
    # at the arm's approach speed (~1.7 m/s measured); the 2-4 tick finger
    # travel lets the velocity drive (rate 200/s) settle the arm first —
    # which is why the reference's placed cubes land gently.
    half_w = params.body_half[1, 0]
    release_gap = 2.0 * half_w + 0.005

    for _ in range(params.substeps):
        # --- joint velocity drive + integrate + limits ----------------------
        # First-order velocity tracking with drive-force (acceleration)
        # saturation — see JOINT_ACCEL_LIMIT in panda_fk.py.
        dv = (u_clamped - qd) * (1.0 - decay)
        qd = qd + jnp.clip(dv, -acc_lim * h, acc_lim * h)
        q = jnp.clip(q + qd * h, params.joint_lower, params.joint_upper)
        q = q.at[7:9].set(
            jnp.where(attached > 0.5, jnp.maximum(q[7:9], half_w * 0.96), q[7:9])
        )

        links = panda_fk.fk(q, params.base_pos)
        hand_pos, hand_rot = links["hand"]
        tip_pos, _ = links["fingertip"]

        # --- grasp attach / detach -----------------------------------------
        cube_pos = bpos[1]
        cube_prev = bpos[1]  # substep-start position (for the held velocity)
        near = jnp.linalg.norm(tip_pos - cube_pos) < params.grasp_range
        do_attach = (attached < 0.5) & gripper_closing & near
        # == hand_rot.T @ d
        rel_pos = jnp.matmul(cube_pos - hand_pos, hand_rot, precision=_HIGHEST)
        rel_rot = jnp.matmul(
            hand_rot.T, quat_ops.quat_to_rotmat(bquat[1]), precision=_HIGHEST
        )
        attach_pos = jnp.where(do_attach, rel_pos, attach_pos)
        attach_rot = jnp.where(do_attach, rel_rot, attach_rot)
        attached = jnp.where(do_attach, 1.0, attached)
        # release only while the fingers are OPENING and have cleared the
        # cube width — during the initial close the gap is still wide and
        # an unconditional gap check would drop the cube at the attach tick
        attached = jnp.where(
            ~gripper_closing & (q[7] + q[8] > release_gap), 0.0, attached
        )

        # --- dynamic bodies --------------------------------------------------
        # gravity + ext forces
        acc = ext.body / params.body_mass[:, None]
        acc = acc.at[:, 2].add(-GRAVITY * params.body_gravity)
        bvel = bvel + acc * h
        new_pos = bpos + bvel * h
        bquat = quat_ops.quat_integrate(bquat, bom, h)

        # support: highest surface below each body's footprint
        over = jnp.all(
            (new_pos[:, None, :2] >= params.sup_min[None])
            & (new_pos[:, None, :2] <= params.sup_max[None]),
            axis=-1,
        )  # [3, P]
        below = params.sup_z[None, :] <= (bpos[:, 2:3] - params.body_half[:, 2:3] + 1e-3)
        sup_height = jnp.max(
            jnp.where(over & below, params.sup_z[None, :], -jnp.inf), axis=-1
        )
        # stacking: cubeA can rest on cubeB's top face — the place target is
        # ON cubeB (pre_place z = cubeB + cube height), and the reference
        # stacks them through PhysX; without this the released cube falls
        # past cubeB and the place protocol breaks
        cb_top = bpos[2, 2] + params.body_half[2, 2]
        overB = jnp.all(
            jnp.abs(new_pos[1, :2] - bpos[2, :2]) <= params.body_half[2, :2]
        )
        belowB = cb_top <= bpos[1, 2] - params.body_half[1, 2] + 1e-3
        sup_height = sup_height.at[1].set(
            jnp.maximum(
                sup_height[1], jnp.where(overB & belowB, cb_top, -jnp.inf)
            )
        )
        rest_z = sup_height + params.body_half[:, 2]
        landing = (new_pos[:, 2] <= rest_z) & (params.body_gravity > 0.5)
        new_pos = new_pos.at[:, 2].set(jnp.where(landing, rest_z, new_pos[:, 2]))
        bvel = bvel.at[:, 2].set(jnp.where(landing, 0.0, bvel[:, 2]))
        # ground/support friction on xy when resting
        mu = 0.75
        speed = jnp.linalg.norm(bvel[:, :2], axis=-1)
        scale = jnp.maximum(0.0, 1.0 - mu * GRAVITY * h / jnp.maximum(speed, 1e-9))
        bvel = bvel.at[:, :2].set(
            jnp.where(landing[:, None], bvel[:, :2] * scale[:, None], bvel[:, :2])
        )
        # contact settling: a resting cube's support moment rotates its
        # nearest face flat onto the surface (PhysX does this through the
        # contact solver; without it a released cube keeps its release tilt
        # forever and the final orientation error can never reach the
        # reference's ~0.003).  Restoring angular velocity along u x z
        # flattens the body z-axis toward world z; yaw is untouched.
        up = quat_ops.quat_to_rotmat(bquat)[..., :, 2]  # [3, 3] body z in world
        settle_gain = 5.0
        near_flat = (up[..., 2] > 0.5)[..., None]
        om_settle = settle_gain * jnp.stack(
            [up[..., 1], -up[..., 0], jnp.zeros_like(up[..., 0])], axis=-1
        )
        bom = jnp.where(
            landing[:, None],
            bom * 0.8 + jnp.where(near_flat, om_settle, 0.0),
            bom,
        )

        # lateral pushout of cubes vs static AABBs (cube approx as sphere)
        r_eff = jnp.mean(params.body_half, axis=-1)
        pen, normal = _sphere_vs_aabb(
            new_pos[:, None, :], r_eff[:, None],
            params.stat_min[None], params.stat_max[None],
        )  # [3, S]
        # don't fight the support constraint: ignore pushout pointing up
        lateral = jnp.abs(normal[..., 2]) < 0.9
        active = (pen > 0) & lateral
        corr = jnp.where(active[..., None], pen[..., None] * normal, 0.0)
        new_pos = new_pos + corr.sum(1)
        f_stat = corr / (h * h) * params.body_mass[:, None, None]  # [3, S, 3]
        dyn_actor = jnp.asarray(params.dyn_actor_idx, dtype=jnp.int32)
        stat_actor = jnp.asarray(params.stat_actor_idx, dtype=jnp.int32)
        force_accum = force_accum.at[dyn_actor].add(f_stat.sum(1))
        force_accum = force_accum.at[stat_actor].add(-f_stat.sum(0))

        bpos = new_pos

        # --- attached cube follows the hand ----------------------------------
        held_pos = hand_pos + jnp.matmul(hand_rot, attach_pos, precision=_HIGHEST)
        held_quat = quat_ops.mat_to_quat(
            jnp.matmul(hand_rot, attach_rot, precision=_HIGHEST)
        )
        is_att = attached > 0.5
        # velocity of the HELD cube = hand velocity: difference against the
        # substep-START position.  Differencing against the post-integration
        # position (old + v*h, then reset to held) made the stored velocity
        # NEGATE itself every substep while the hand was still — so release
        # threw the cube at the stale grasp-approach speed.
        new_vel = (held_pos - cube_prev) / h
        bpos = bpos.at[1].set(jnp.where(is_att, held_pos, bpos[1]))
        bquat = bquat.at[1].set(
            jnp.where(is_att, held_quat, bquat[1])
        )
        bvel = bvel.at[1].set(jnp.where(is_att, new_vel, bvel[1]))

        # --- arm collision sensing (table / shelf / cubeB lateral hits) ------
        # NOTE: the probe links are processed in an unrolled Python loop, NOT
        # jnp.stack-ed: a concatenate of the (expensive) FK chains feeding
        # multiple reduce consumers triggers a combinatorial re-evaluation
        # blowup in XLA:CPU's fusion emitter (measured 426 ms vs 1 ms for the
        # same math per-probe at K=16).  Per-probe unrolling fuses each FK
        # chain into exactly one consumer group on every backend.
        probe_links = (
            links["link4"][0],
            links["link5"][0],
            links["link6"][0],
            hand_pos,
            links["leftfinger"][0],
            links["rightfinger"][0],
            tip_pos,
        )
        cb_min = bpos[2] - params.body_half[2]
        cb_max = bpos[2] + params.body_half[2]
        for pr in probe_links:
            pen_a, normal_a = _sphere_vs_aabb(
                pr[None, :], 0.05, params.stat_min, params.stat_max
            )  # [S]
            f_arm = (jnp.maximum(pen_a, 0.0)[..., None] * normal_a) * 2000.0
            force_accum = force_accum.at[stat_actor].add(-f_arm)
            force_accum = force_accum.at[params.robot_actor_idx].add(f_arm.sum(0))
            # probe vs cubeB (treated as an AABB around its pose)
            pen_b, normal_b = _sphere_vs_aabb(pr, 0.04, cb_min, cb_max)
            f_b = (jnp.maximum(pen_b, 0.0)[..., None] * normal_b) * 2000.0
            force_accum = force_accum.at[dyn_actor[2]].add(-f_b)

        # held/free cubeA vs cubeB contact (pushes cubeB, records force)
        pen_ab, normal_ab = _sphere_vs_aabb(
            bpos[1], jnp.mean(params.body_half[1]), cb_min, cb_max
        )
        hit_ab = jnp.maximum(pen_ab, 0.0)
        f_ab = hit_ab[..., None] * normal_ab * 2000.0
        force_accum = force_accum.at[dyn_actor[2]].add(-f_ab)
        bpos = bpos.at[2, :2].add(-jnp.where(hit_ab > 0, 1.0, 0.0) * normal_ab[:2] * hit_ab * 0.5)


    n = params.substeps
    return state.replace(
        q=q,
        qd=qd,
        body_pos=bpos,
        body_quat=bquat,
        body_vel=bvel,
        body_om=bom,
        attached=attached,
        attach_pos=attach_pos,
        attach_rot=attach_rot,
        contact_force=force_accum / n,
    )


def root_state_view(params: PandaEnvParams, state: PandaEnvState) -> jnp.ndarray:
    root = params.init_root
    dyn_actor = jnp.asarray(params.dyn_actor_idx, dtype=jnp.int32)
    root = root.at[dyn_actor, 0:3].set(state.body_pos)
    root = root.at[dyn_actor, 3:7].set(state.body_quat)
    root = root.at[dyn_actor, 7:10].set(state.body_vel)
    root = root.at[dyn_actor, 10:13].set(state.body_om)
    return root


def load_root_state(
    params: PandaEnvParams, state: PandaEnvState, root: jnp.ndarray
) -> PandaEnvState:
    dyn_actor = jnp.asarray(params.dyn_actor_idx, dtype=jnp.int32)
    rows = root[dyn_actor]
    return state.replace(
        body_pos=rows[:, 0:3],
        body_quat=rows[:, 3:7],
        body_vel=rows[:, 7:10],
        body_om=rows[:, 10:13],
    )


def dof_state_view(state: PandaEnvState) -> jnp.ndarray:
    """Interleaved [q0, qd0, q1, qd1, ...] — 18 floats."""
    return jnp.stack([state.q, state.qd], axis=-1).reshape(
        state.q.shape[:-1] + (18,)
    )


def load_dof_state(state: PandaEnvState, dof: jnp.ndarray) -> PandaEnvState:
    pairs = dof.reshape(dof.shape[:-1] + (9, 2))
    return state.replace(q=pairs[..., 0], qd=pairs[..., 1])
