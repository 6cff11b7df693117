"""Albert mobile manipulator: boxer differential-drive base + Panda arm.

Parity target: ``assets/urdf/albert/albert.urdf`` (13 DOF: 2 castors,
2 drive wheels, 7 arm joints, 2 fingers) and the reference's control-channel
convention where the wheel speeds live at u[11], u[12]
(``skill_utils.apply_fk:97-115``, albert branch).  The reference ships the
asset and the FK/IK mapping but no albert task config; this model provides
the same surface: a steppable velocity-drive dynamics + full-arm FK, usable
with the planar arena scenes.

Control layout (matching apply_fk's channel convention):
  u[0:2]   castor joints (free-spinning, ignored)
  u[2:9]   panda arm joint velocity targets
  u[9:11]  finger velocity targets
  u[11:13] wheel speeds (left, right)

State q: [x, y, yaw, arm(7), fingers(2)] = 12.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from m3p2i_aip_tpu.models import panda_fk
from m3p2i_aip_tpu.utils import struct

WHEEL_RADIUS = 0.08  # skill_utils.apply_fk r
WHEEL_BASE = 2 * 0.157  # skill_utils.apply_fk L
ARM_MOUNT = np.array([0.0, 0.0, 0.4], dtype=np.float32)  # arm base on the torso


@struct.dataclass
class AlbertState:
    q: jnp.ndarray  # [12] base pose (3) + arm (7) + fingers (2)
    qd: jnp.ndarray  # [12]
    # pushable box (zeros / parked far away when the scene ships none):
    # couples the base and the arm through contact — the mobile-manipulator
    # scenario the bare asset upstream never exercises
    box_pos: jnp.ndarray = struct.field(default=None)  # [2]
    box_yaw: jnp.ndarray = struct.field(default=None)  # []
    box_vel: jnp.ndarray = struct.field(default=None)  # [2]
    box_om: jnp.ndarray = struct.field(default=None)  # []


@struct.dataclass
class AlbertParams:
    init_q: jnp.ndarray = struct.field(
        default=None
    )  # [12] base pose (3) + arm (7) + fingers (2)
    dt: float = struct.field(pytree_node=False, default=0.05)
    substeps: int = struct.field(pytree_node=False, default=2)
    drive_rate: float = struct.field(pytree_node=False, default=60.0)
    actor_names: tuple = struct.field(pytree_node=False, default=("albert",))
    # pushable box (trace-time gate: scenes without one skip the contact
    # solve entirely — ee_reach compiles to the old kinematic program)
    has_box: bool = struct.field(pytree_node=False, default=False)
    box_init: jnp.ndarray = struct.field(default=None)  # [3] x, y, yaw
    box_half: jnp.ndarray = struct.field(default=None)  # [2]
    box_inv_mass: jnp.ndarray = struct.field(default=None)  # []
    box_inv_inertia: jnp.ndarray = struct.field(default=None)  # []
    box_friction: jnp.ndarray = struct.field(default=None)  # [] material
    # base collision footprint + PBD mass (contact only; the drive itself
    # stays velocity-kinematic like the boxer base in point_env)
    base_radius: float = struct.field(pytree_node=False, default=0.35)
    base_mass: float = struct.field(pytree_node=False, default=100.0)


_REST_ARM = np.asarray([0, 0, 0, -2, 0, 1.8675, 0, 0.02, 0.02], np.float32)


def build_params(actors, sim_cfg) -> AlbertParams:
    """Scene params from the albert_env actor YAMLs (ActorCfg schema)."""
    init_q = np.zeros(12, dtype=np.float32)
    init_q[3:12] = _REST_ARM
    names = []
    box_kwargs = {}
    for a in actors:
        names.append(a.name)
        if a.type == "robot":
            init_q[0:2] = np.asarray(a.init_pos[:2], np.float32)
            if a.init_joint_pose:
                # interleaved (pos, vel) 24-vector, like the panda convention
                init_q = np.asarray(a.init_joint_pose, np.float32)[0::2]
        elif a.type == "box" and a.collision and not a.fixed:
            half = np.asarray(a.size, np.float32) / 2.0
            # PhysX-default density 1000 kg/m^3 — the reference never applies
            # the YAML mass (isaacgym_wrapper.py:294-300, same quirk as
            # point_env.build_params)
            mass = 1000.0 * float(8.0 * half[0] * half[1] * half[2])
            inertia = mass * float(
                (2 * half[0]) ** 2 + (2 * half[1]) ** 2
            ) / 12.0
            box_kwargs = dict(
                has_box=True,
                box_init=jnp.asarray(
                    [a.init_pos[0], a.init_pos[1], 0.0], jnp.float32
                ),
                box_half=jnp.asarray(half[:2]),
                box_inv_mass=jnp.asarray(1.0 / mass),
                box_inv_inertia=jnp.asarray(1.0 / inertia),
                box_friction=jnp.asarray(float(a.friction)),
            )
    return AlbertParams(
        init_q=jnp.asarray(init_q),
        dt=sim_cfg.dt,
        substeps=sim_cfg.substeps,
        actor_names=tuple(names),
        **box_kwargs,
    )


def _box_defaults(params: AlbertParams | None):
    if params is not None and params.has_box:
        return dict(
            box_pos=params.box_init[:2],
            box_yaw=params.box_init[2],
            box_vel=jnp.zeros(2),
            box_om=jnp.zeros(()),
        )
    # boxless scenes keep concrete leaves (stable jit signature), parked out
    # of every arena
    return dict(
        box_pos=jnp.asarray([1e3, 1e3]),
        box_yaw=jnp.zeros(()),
        box_vel=jnp.zeros(2),
        box_om=jnp.zeros(()),
    )


def init_state(params: AlbertParams = None) -> AlbertState:
    if params is not None and params.init_q is not None:
        return AlbertState(q=params.init_q, qd=jnp.zeros(12), **_box_defaults(params))
    q = jnp.zeros(12)
    # reference panda rest pose for the arm portion
    q = q.at[3:12].set(jnp.asarray(_REST_ARM))
    return AlbertState(q=q, qd=jnp.zeros(12), **_box_defaults(params))


def step(params: AlbertParams, state: AlbertState, u: jnp.ndarray) -> AlbertState:
    """Velocity-drive step for the 13-channel control vector, plus (when the
    scene ships a pushable box) a PBD contact solve between the base circle
    and the box — the base can shove the box exactly like the boxer base in
    point_env, coupling wheel and arm channels through the same samples."""
    from m3p2i_aip_tpu.sim import pbd2d

    GRAVITY = 9.8
    h = params.dt / params.substeps
    decay = float(np.exp(-params.drive_rate * params.dt / params.substeps))
    q, qd = state.q, state.qd
    bpos, byaw = state.box_pos, state.box_yaw
    bvel, bom = state.box_vel, state.box_om

    arm_lower = jnp.asarray(panda_fk.JOINT_LOWER)
    arm_upper = jnp.asarray(panda_fk.JOINT_UPPER)
    wm_base = 1.0 / params.base_mass

    for _ in range(params.substeps):
        v = WHEEL_RADIUS * (u[11] + u[12]) / 2.0
        om = WHEEL_RADIUS * (u[12] - u[11]) / WHEEL_BASE
        th = q[2]
        base_target = jnp.stack([v * jnp.cos(th), v * jnp.sin(th), om])
        arm_target = u[2:11]
        qd_target = jnp.concatenate([base_target, arm_target])
        qd = qd_target + (qd - qd_target) * decay
        q = q + qd * h
        q = q.at[3:12].set(jnp.clip(q[3:12], arm_lower, arm_upper))

        if params.has_box:  # trace-time gate (static scene property)
            mu_g = (params.box_friction + 1.0) * 0.5  # PhysX combine vs plane
            bvel, bom = pbd2d.ground_friction(
                bvel, bom, mu_g, GRAVITY, h, jnp.mean(params.box_half)
            )
            bpos = bpos + bvel * h
            byaw = byaw + bom * h
            for _ in range(2):  # Jacobi passes, point_env-style
                c = pbd2d.circle_vs_obb(
                    q[:2], params.base_radius, bpos, byaw, params.box_half
                )
                out = pbd2d.resolve_contact(
                    c,
                    q[:2], q[2], qd[:2], jnp.zeros(()), wm_base, 0.0,
                    bpos, byaw, bvel, bom,
                    params.box_inv_mass, params.box_inv_inertia,
                    h,
                    friction=(0.05 + params.box_friction) / 2,
                    relax=1.0,
                )
                q = q.at[:2].add(out[0])
                qd = qd.at[:2].add(out[2])
                bpos = bpos + out[4]
                byaw = byaw + out[5]
                bvel = bvel + out[6]
                bom = bom + out[7]
    return state.replace(
        q=q, qd=qd, box_pos=bpos, box_yaw=byaw, box_vel=bvel, box_om=bom
    )


def dof_state_view(state: AlbertState) -> jnp.ndarray:
    """Interleaved [q0, qd0, ...] — 24 floats (panda convention)."""
    return jnp.stack([state.q, state.qd], axis=-1).reshape(
        state.q.shape[:-1] + (24,)
    )


def load_dof_state(state: AlbertState, dof: jnp.ndarray) -> AlbertState:
    pairs = dof.reshape(dof.shape[:-1] + (12, 2))
    return state.replace(q=pairs[..., 0], qd=pairs[..., 1])


def fk(state: AlbertState):
    """Arm link poses in the world frame (base pose composed in).

    Returns the same link dict as :func:`panda_fk.fk` (positions [3] +
    rotation matrices [3, 3]).
    """
    th = state.q[2]
    c, s = jnp.cos(th), jnp.sin(th)
    base_rot = jnp.asarray([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
    base_pos = jnp.concatenate([state.q[:2], jnp.zeros(1)]) + jnp.matmul(
        base_rot, jnp.asarray(ARM_MOUNT), precision=jax.lax.Precision.HIGHEST
    )
    return panda_fk.fk(state.q[3:12], base_pos, base_rot=base_rot)
