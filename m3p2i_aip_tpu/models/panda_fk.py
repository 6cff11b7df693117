"""Franka Panda forward kinematics in pure JAX (batched, jit/vmap friendly).

Kinematic parameters transcribed from the reference's URDF
(``assets/urdf/franka_description/robots/franka_panda.urdf``): 7 revolute
joints about local z with the classic Franka offsets, a fixed hand joint with
a -45deg twist, and two prismatic finger joints along local +/-y of the hand.

The velocity-drive articulated dynamics of the reference (PhysX, damping 600 —
isaacgym_wrapper.py:341-344) reduce to first-order joint-velocity tracking +
FK for the link states, which is what :mod:`m3p2i_aip_tpu.models.panda_env`
builds on (SURVEY.md §7.10).

Link orientations are ROTATION MATRICES, composed by 3x3 matmuls.  This is
deliberate and load-bearing, twice over:

  * Accelerators: the FK chain is a sequence of small dots, which XLA
    schedules well, instead of scalar quaternion shuffles.
  * CPU: quaternion composition builds nested 4-way ``concatenate``s
    (jnp.stack per quat_mul); when such a chain is duplicated into 2+
    consumers, XLA:CPU's loop-fusion emitter scalarizes through every
    concat level — 4^depth re-evaluation, a measured ~500x runtime blowup
    of the vmapped env step.  ``dot`` ops are fusion barriers, so the
    matrix chain stays linear on every backend.

Use :func:`m3p2i_aip_tpu.ops.quat.mat_to_quat` at the boundary where a
quaternion is required (e.g. storing cube orientation state).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

# Per-joint fixed origin: (xyz translation, rpy-roll about x) — all joint
# frames in this URDF only use a roll rotation; joint rotation is about local z.
_JOINT_XYZ = np.array(
    [
        [0.0, 0.0, 0.333],  # joint1
        [0.0, 0.0, 0.0],  # joint2
        [0.0, -0.316, 0.0],  # joint3
        [0.0825, 0.0, 0.0],  # joint4
        [-0.0825, 0.384, 0.0],  # joint5
        [0.0, 0.0, 0.0],  # joint6
        [0.088, 0.0, 0.0],  # joint7
    ],
    dtype=np.float32,
)
_HALF_PI = float(np.pi / 2)
_JOINT_ROLL = np.array(
    [0.0, -_HALF_PI, _HALF_PI, _HALF_PI, -_HALF_PI, _HALF_PI, _HALF_PI],
    dtype=np.float32,
)
HAND_XYZ = np.array([0.0, 0.0, 0.107], dtype=np.float32)
HAND_YAW = float(-np.pi / 4)
FINGER_XYZ = np.array([0.0, 0.0, 0.0584], dtype=np.float32)
# Fingertip reach below the finger-link origin (finger collision mesh length).
FINGERTIP_Z = 0.045

# Joint limits (revolute 7 + fingers), from the URDF <limit> tags.
JOINT_LOWER = np.array(
    [-2.8973, -1.7628, -2.8973, -3.0718, -2.8973, -0.0175, -2.8973, 0.0, 0.0],
    dtype=np.float32,
)
JOINT_UPPER = np.array(
    [2.8973, 1.7628, 2.8973, -0.0698, 2.8973, 3.7525, 2.8973, 0.04, 0.04],
    dtype=np.float32,
)
JOINT_VEL_LIMIT = np.array(
    [2.175, 2.175, 2.175, 2.175, 2.61, 2.61, 2.61, 0.2, 0.2], dtype=np.float32
)
# Drive-force saturation: URDF effort limits (87/87/87/87/12/12/12 Nm arm,
# 20 N fingers) over approximate effective joint inertias give a max joint
# acceleration; PhysX's velocity drive (damping 600, force clamped to the
# effort limit — isaacgym_wrapper.py:342-344 + URDF <limit effort>) tracks
# velocity targets with this slew rate, which is what makes fine positioning
# possible under coarse MPPI velocity noise.
JOINT_ACCEL_LIMIT = np.array(
    [50.0, 50.0, 50.0, 50.0, 80.0, 80.0, 80.0, 10.0, 10.0], dtype=np.float32
)


def _rot_x_static(angle: float) -> np.ndarray:
    c, s = np.cos(angle), np.sin(angle)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]], dtype=np.float32)


def _rot_z_static(angle: float) -> np.ndarray:
    c, s = np.cos(angle), np.sin(angle)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], dtype=np.float32)


# Fixed per-joint frame rotations, precomputed at import time.
_ROLL_MATS = [
    _rot_x_static(a) if a != 0.0 else None for a in _JOINT_ROLL
]
_HAND_MAT = _rot_z_static(HAND_YAW)


def _rot_z(theta: jnp.ndarray) -> jnp.ndarray:
    """Rotation about local z as a [..., 3, 3] matrix (one stack level)."""
    c, s = jnp.cos(theta), jnp.sin(theta)
    o, z = jnp.ones_like(c), jnp.zeros_like(c)
    return jnp.stack(
        [
            jnp.stack([c, -s, z], axis=-1),
            jnp.stack([s, c, z], axis=-1),
            jnp.stack([z, z, o], axis=-1),
        ],
        axis=-2,
    )


def fk(q: jnp.ndarray, base_pos: jnp.ndarray, base_rot: jnp.ndarray | None = None):
    """Forward kinematics for joint positions q [..., 9].

    Returns a dict of (pos [..., 3], rot [..., 3, 3]) for 'link1'..'link7',
    'hand', 'leftfinger', 'rightfinger', 'ee' (finger midpoint = the
    reference's (leftfinger + rightfinger)/2, cost_functions.py:92-94) and
    'fingertip' (grasp point between the fingertips).
    """
    batch = q.shape[:-1]
    if base_rot is None:
        base_rot = jnp.broadcast_to(jnp.eye(3, dtype=q.dtype), batch + (3, 3))
    pos = jnp.broadcast_to(jnp.asarray(base_pos, dtype=q.dtype), batch + (3,))
    rot = base_rot

    # full-f32 matmuls: a reduced-precision default (TF32 on a GPU) costs
    # up to ~5e-2 absolute error by link 7; HIGHEST pins every backend to
    # the same f32 arithmetic
    _hi = jax.lax.Precision.HIGHEST
    links = {}
    for j in range(7):
        off = jnp.asarray(_JOINT_XYZ[j], dtype=q.dtype)
        pos = pos + jnp.einsum("...ij,j->...i", rot, off, precision=_hi)
        if _ROLL_MATS[j] is not None:
            rot = jnp.matmul(rot, jnp.asarray(_ROLL_MATS[j], dtype=q.dtype), precision=_hi)
        rot = jnp.matmul(rot, _rot_z(q[..., j]), precision=_hi)
        links[f"link{j+1}"] = (pos, rot)

    hand_pos = pos + jnp.einsum(
        "...ij,j->...i", rot, jnp.asarray(HAND_XYZ, dtype=q.dtype), precision=_hi
    )
    hand_rot = jnp.matmul(rot, jnp.asarray(_HAND_MAT, dtype=q.dtype), precision=_hi)
    links["hand"] = (hand_pos, hand_rot)

    f_base = hand_pos + jnp.einsum(
        "...ij,j->...i", hand_rot, jnp.asarray(FINGER_XYZ, dtype=q.dtype),
        precision=_hi,
    )
    y_axis = hand_rot[..., :, 1]
    left_pos = f_base + y_axis * q[..., 7:8]
    right_pos = f_base - y_axis * q[..., 8:9]
    links["leftfinger"] = (left_pos, hand_rot)
    links["rightfinger"] = (right_pos, hand_rot)
    links["ee"] = ((left_pos + right_pos) / 2.0, hand_rot)
    z_axis = hand_rot[..., :, 2]
    links["fingertip"] = (links["ee"][0] + z_axis * FINGERTIP_Z, hand_rot)
    return links
