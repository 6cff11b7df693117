"""Quaternion / orientation math in Isaac Gym's (x, y, z, w) scalar-last convention.

Replaces the torch implementations in the reference's
``src/m3p2i_aip/utils/skill_utils.py:140-290`` (quaternion_rotation_matrix,
get_ori_cube2goal, get_ori_ee2cube, get_general_ori_cube2goal,
get_general_ori_ee2cube) with batched, jit-friendly JAX versions.

All functions take quaternions shaped ``[..., 4]`` with components ordered
``(x, y, z, w)`` and broadcast over leading batch dims.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

_HIGHEST = jax.lax.Precision.HIGHEST


def quat_to_rotmat(q: jnp.ndarray) -> jnp.ndarray:
    """Rotation matrix from an (x, y, z, w) quaternion.

    Parity: ``skill_utils.quaternion_rotation_matrix`` (skill_utils.py:140-180)
    which reads components in JPL/scalar-last order (note at :153).
    Input ``[..., 4]`` -> output ``[..., 3, 3]`` mapping local -> global frame.
    """
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r00 = 2 * (w * w + x * x) - 1
    r01 = 2 * (x * y - w * z)
    r02 = 2 * (x * z + w * y)
    r10 = 2 * (x * y + w * z)
    r11 = 2 * (w * w + y * y) - 1
    r12 = 2 * (y * z - w * x)
    r20 = 2 * (x * z - w * y)
    r21 = 2 * (y * z + w * x)
    r22 = 2 * (w * w + z * z) - 1
    rows = jnp.stack(
        [
            jnp.stack([r00, r01, r02], axis=-1),
            jnp.stack([r10, r11, r12], axis=-1),
            jnp.stack([r20, r21, r22], axis=-1),
        ],
        axis=-2,
    )
    return rows


def quat_mul(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Hamilton product a*b for (x, y, z, w) quaternions, broadcasting."""
    ax, ay, az, aw = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bx, by, bz, bw = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return jnp.stack(
        [
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
            aw * bw - ax * bx - ay * by - az * bz,
        ],
        axis=-1,
    )


def quat_conj(q: jnp.ndarray) -> jnp.ndarray:
    return jnp.concatenate([-q[..., :3], q[..., 3:4]], axis=-1)


def quat_rotate(q: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """Rotate vector(s) v [..., 3] by quaternion(s) q [..., 4]."""
    qv = q[..., :3]
    w = q[..., 3:4]
    t = 2.0 * jnp.cross(qv, v)
    return v + w * t + jnp.cross(qv, t)


def quat_inv_rotate(q: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    return quat_rotate(quat_conj(q), v)


def quat_from_yaw(yaw: jnp.ndarray) -> jnp.ndarray:
    """(x,y,z,w) quaternion for a rotation of ``yaw`` about +z. yaw [...] -> [..., 4]."""
    half = 0.5 * yaw
    z = jnp.sin(half)
    w = jnp.cos(half)
    zero = jnp.zeros_like(z)
    return jnp.stack([zero, zero, z, w], axis=-1)


def yaw_from_quat(q: jnp.ndarray) -> jnp.ndarray:
    """Yaw (rotation about z) extracted from an (x,y,z,w) quaternion."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return jnp.arctan2(2.0 * (w * z + x * y), 1.0 - 2.0 * (y * y + z * z))


def quat_normalize(q: jnp.ndarray, eps: float = 1e-12) -> jnp.ndarray:
    return q / jnp.maximum(jnp.linalg.norm(q, axis=-1, keepdims=True), eps)


def quat_integrate(q: jnp.ndarray, omega: jnp.ndarray, dt: float) -> jnp.ndarray:
    """First-order quaternion integration with world-frame angular velocity."""
    ow = jnp.concatenate([omega, jnp.zeros_like(omega[..., :1])], axis=-1)
    dq = 0.5 * quat_mul(ow, q) * dt
    return quat_normalize(q + dq)


def mat_to_quat(m: jnp.ndarray) -> jnp.ndarray:
    """(x, y, z, w) quaternion from a rotation matrix [..., 3, 3].

    Branch-free Shepperd selection via ``where`` over the four candidate
    formulations (numerically safe for any proper rotation).
    """
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22

    def mk(x, y, z, w):
        return jnp.stack([x, y, z, w], axis=-1)

    s0 = jnp.sqrt(jnp.maximum(1.0 + tr, 1e-12)) * 2.0
    c0 = mk((m21 - m12) / s0, (m02 - m20) / s0, (m10 - m01) / s0, 0.25 * s0)
    s1 = jnp.sqrt(jnp.maximum(1.0 + m00 - m11 - m22, 1e-12)) * 2.0
    c1 = mk(0.25 * s1, (m01 + m10) / s1, (m02 + m20) / s1, (m21 - m12) / s1)
    s2 = jnp.sqrt(jnp.maximum(1.0 - m00 + m11 - m22, 1e-12)) * 2.0
    c2 = mk((m01 + m10) / s2, 0.25 * s2, (m12 + m21) / s2, (m02 - m20) / s2)
    s3 = jnp.sqrt(jnp.maximum(1.0 - m00 - m11 + m22, 1e-12)) * 2.0
    c3 = mk((m02 + m20) / s3, (m12 + m21) / s3, 0.25 * s3, (m10 - m01) / s3)

    use0 = (tr > 0.0)[..., None]
    use1 = ((m00 >= m11) & (m00 >= m22))[..., None]
    use2 = (m11 >= m22)[..., None]
    q = jnp.where(use0, c0, jnp.where(use1, c1, jnp.where(use2, c2, c3)))
    return quat_normalize(q)


# --------------------------------------------------------------------------
# Orientation costs (cost_functions helpers in the reference)
# --------------------------------------------------------------------------

def ori_cost_cube2goal(cube_q: jnp.ndarray, goal_q: jnp.ndarray) -> jnp.ndarray:
    """Axis-alignment cost between two orientations.

    Parity: ``skill_utils.get_ori_cube2goal`` (skill_utils.py:183-203):
    (1-cosα)+(1-cosβ)+(1-cosγ) over the three paired body axes.
    """
    cr = quat_to_rotmat(cube_q)
    gr = quat_to_rotmat(goal_q)
    cos = jnp.sum(cr * gr, axis=-2)  # [..., 3]: per-axis column dot products
    return jnp.sum(1.0 - cos, axis=-1)


def ori_cost_ee2cube(ee_q: jnp.ndarray, cube_q: jnp.ndarray) -> jnp.ndarray:
    """Parity: ``skill_utils.get_ori_ee2cube`` (skill_utils.py:206-220).

    Wants ee x/y/z axes anti-aligned with the cube's: (1+cosα)+(1+cosθ)+(1+cosω).
    """
    er = quat_to_rotmat(ee_q)
    cr = quat_to_rotmat(cube_q)
    cos = jnp.sum(er * cr, axis=-2)
    return jnp.sum(1.0 + cos, axis=-1)


def general_ori_cube2goal(cube_q: jnp.ndarray, goal_q: jnp.ndarray) -> jnp.ndarray:
    """Flip-invariant orientation cost between cube and goal.

    Parity: ``skill_utils.get_general_ori_cube2goal`` (skill_utils.py:224-252).
    For the goal's x and y axes, takes the best |cos| match over all three cube
    axes, so a flipped/upside-down cube still scores 0.
    """
    cr = quat_to_rotmat(cube_q)  # [..., 3, 3] columns are cube axes
    gr = quat_to_rotmat(goal_q)
    # dots[..., i, j] = <goal axis i, cube axis j>
    dots = jnp.einsum("...ki,...kj->...ij", gr, cr, precision=_HIGHEST)
    best = 1.0 - jnp.max(jnp.abs(dots), axis=-1)  # [..., 3] per goal axis
    return best[..., 0] + best[..., 1]


def general_ori_ee2cube(
    ee_q: jnp.ndarray, cube_q: jnp.ndarray, tilt_value: float = 0.0
) -> jnp.ndarray:
    """Flip-invariant grasp-orientation cost between end effector and cube.

    Parity: ``skill_utils.get_general_ori_ee2cube`` (skill_utils.py:256-290).
    tilt_value == 0: ee z-axis should be parallel (up to sign) to *some* cube
    axis.  tilt_value != 0: the cube axis most aligned with world-x is selected
    and the ee z-axis should make the given tilt angle (cos) with it.
    ``tilt_value`` is a static Python float (selects the branch at trace time,
    matching the reference which branches on it in Python).
    """
    return general_ori_ee2cube_mat(quat_to_rotmat(ee_q), cube_q, tilt_value)


def general_ori_ee2cube_mat(
    er: jnp.ndarray, cube_q: jnp.ndarray, tilt_value: float = 0.0
) -> jnp.ndarray:
    """:func:`general_ori_ee2cube` with the ee orientation already a rotation
    matrix [..., 3, 3] (the native output of the matrix FK)."""
    cr = quat_to_rotmat(cube_q)
    ee_y = er[..., :, 1]
    ee_z = er[..., :, 2]
    cube_axes = jnp.stack(
        [cr[..., :, 0], cr[..., :, 1], cr[..., :, 2]], axis=-2
    )  # [..., 3(axis), 3(xyz)]

    if tilt_value == 0.0:
        cos_z = jnp.abs(
            jnp.einsum("...j,...aj->...a", ee_z, cube_axes, precision=_HIGHEST)
        )
        cost_z = jnp.min(1.0 - cos_z, axis=-1)
    else:
        # Reference picks the axis via the argmax of sample 0's axes
        # (skill_utils.py:276-277 uses indice_list[0]); we select per-sample,
        # which is the intended semantics.
        xness = jnp.abs(cube_axes[..., 0])  # |x-component| of each cube axis
        idx = jnp.argmax(xness, axis=-1)
        sel = jnp.take_along_axis(
            cube_axes, idx[..., None, None], axis=-2
        )[..., 0, :]
        cost_z = jnp.abs(tilt_value - jnp.sum(ee_z * sel, axis=-1))

    cos_y = jnp.abs(
        jnp.einsum("...j,...aj->...a", ee_y, cube_axes, precision=_HIGHEST)
    )
    cost_y = jnp.min(1.0 - cos_y, axis=-1)
    return cost_z + cost_y
