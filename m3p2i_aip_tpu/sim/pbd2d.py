"""Planar position-based (PBD/XPBD-style) rigid contact primitives.

This is the JAX replacement for the PhysX contact solver the reference
drives through Isaac Gym (``isaacgym_wrapper.py:27-32``: TGS solver, 6 position
iterations).  Position-based projection gives hard, unconditionally stable
contacts with static geometry at any dt — no penalty-stiffness/dt stability
trade-off — and is branch-free (mask arithmetic), so it vmaps over thousands of
rollout envs and fuses into one XLA program.

Conventions: 2D world; a "body" is (pos[2], yaw, inv_mass, inv_inertia).
Contacts are returned as (penetration, normal, point) with the normal pointing
from the *other* object toward the body (the direction to push the body).
All functions are shape-static and differentiable-ish (where-masked).
"""
from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp


class Contact(NamedTuple):
    pen: jnp.ndarray  # [...]: penetration depth, <=0 means no contact
    normal: jnp.ndarray  # [..., 2]: unit, push direction for body A
    point: jnp.ndarray  # [..., 2]: world contact point


def rot2d(yaw):
    c, s = jnp.cos(yaw), jnp.sin(yaw)
    return jnp.stack(
        [jnp.stack([c, -s], axis=-1), jnp.stack([s, c], axis=-1)], axis=-2
    )


def world_to_local(p, center, yaw):
    d = p - center
    c, s = jnp.cos(yaw), jnp.sin(yaw)
    return jnp.stack(
        [c * d[..., 0] + s * d[..., 1], -s * d[..., 0] + c * d[..., 1]], axis=-1
    )


def local_to_world_dir(v, yaw):
    c, s = jnp.cos(yaw), jnp.sin(yaw)
    return jnp.stack(
        [c * v[..., 0] - s * v[..., 1], s * v[..., 0] + c * v[..., 1]], axis=-1
    )


def circle_vs_obb(center, radius, box_pos, box_yaw, box_half) -> Contact:
    """Circle against an oriented box; normal pushes the circle out.

    When the center is inside the box the push face is chosen by the center's
    dominant *normalized* coordinate (which side it entered from), not minimum
    separation — this prevents tunneling through thin walls once the body is
    more than half-way in.
    """
    local = world_to_local(center, box_pos, box_yaw)
    clamped = jnp.clip(local, -box_half, box_half)
    inside = jnp.all(jnp.abs(local) < box_half, axis=-1)
    sep = box_half - jnp.abs(local)  # distance to each face (positive inside)
    axis = jnp.argmax(jnp.abs(local) / box_half, axis=-1)
    sign = jnp.sign(jnp.take_along_axis(local, axis[..., None], axis=-1))[..., 0]
    sign = jnp.where(sign == 0, 1.0, sign)
    face_pt = jnp.where(
        (axis == 0)[..., None],
        jnp.stack([sign * box_half[..., 0], local[..., 1]], axis=-1),
        jnp.stack([local[..., 0], sign * box_half[..., 1]], axis=-1),
    )
    surf_local = jnp.where(inside[..., None], face_pt, clamped)

    diff = local - surf_local
    dist = jnp.linalg.norm(diff, axis=-1)
    n_local_out = jnp.where(
        inside[..., None],
        jnp.where(
            (axis == 0)[..., None],
            jnp.stack([sign, jnp.zeros_like(sign)], axis=-1),
            jnp.stack([jnp.zeros_like(sign), sign], axis=-1),
        ),
        diff / jnp.maximum(dist, 1e-9)[..., None],
    )
    pen = jnp.where(inside, radius + dist, radius - dist)
    normal = local_to_world_dir(n_local_out, box_yaw)
    point = box_pos + local_to_world_dir(surf_local, box_yaw)
    return Contact(pen, normal, point)


def _corners(pos, yaw, half):
    """[..., 4, 2] world corners of an oriented box."""
    signs = jnp.array([[1.0, 1.0], [1.0, -1.0], [-1.0, 1.0], [-1.0, -1.0]])
    local = signs * half[..., None, :]
    return pos[..., None, :] + local_to_world_dir(local, yaw[..., None])


def corners_vs_obb(pos_a, yaw_a, half_a, pos_b, yaw_b, half_b) -> Contact:
    """Contacts of A's 4 corners inside box B; normal pushes A out of B.

    The push face is chosen once per body from A's *center* position relative
    to B (dominant normalized coordinate), so a body squeezed into a thin wall
    is always corrected back toward the side its center is on — no tunneling.
    Returns Contact with leading axis 4 (one candidate per corner).
    """
    corners = _corners(pos_a, yaw_a, half_a)  # [..., 4, 2]
    local = world_to_local(corners, pos_b[..., None, :], yaw_b[..., None])
    sep = half_b[..., None, :] - jnp.abs(local)  # [..., 4, 2]

    center_local = world_to_local(pos_a, pos_b, yaw_b)  # [..., 2]
    axis = jnp.argmax(jnp.abs(center_local) / half_b, axis=-1)  # [...]
    sign = jnp.sign(
        jnp.take_along_axis(center_local, axis[..., None], axis=-1)[..., 0]
    )
    sign = jnp.where(sign == 0, 1.0, sign)
    # Penetration of each corner measured against the chosen face.  One-sided:
    # a corner that overshot past the box's FAR face still counts (pen grows),
    # so a hard shove can never carry a corner across a thin wall unseen.
    local_a = jnp.take_along_axis(local, axis[..., None, None], axis=-1)[..., 0]
    half_b_a = jnp.take_along_axis(half_b, axis[..., None], axis=-1)
    pen_val = half_b_a - sign[..., None] * local_a  # [..., 4]
    # gate on the lateral axis only (corner within the face's extent)
    other = 1 - axis
    sep_other = jnp.take_along_axis(sep, other[..., None, None], axis=-1)[..., 0]
    n_local = jnp.where(
        (axis == 0)[..., None],
        jnp.stack([sign, jnp.zeros_like(sign)], axis=-1),
        jnp.stack([jnp.zeros_like(sign), sign], axis=-1),
    )
    pen = jnp.where((pen_val > 0) & (sep_other > 0), pen_val, -1.0)
    normal = jnp.broadcast_to(
        local_to_world_dir(n_local, yaw_b)[..., None, :], pen.shape + (2,)
    )
    return Contact(pen, normal, corners)


def cross2(a, b):
    return a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]


def resolve_contact(
    contact: Contact,
    pos_a,
    yaw_a,
    vel_a,
    om_a,
    wm_a,
    wi_a,
    pos_b,
    yaw_b,
    vel_b,
    om_b,
    wm_b,
    wi_b,
    dt: float,
    friction: float = 0.5,
    relax: float = 1.0,
):
    """One Jacobi projection of a single contact (masked when pen<=0).

    Returns position/yaw/velocity corrections for both bodies plus the
    equivalent contact force (for net-contact-force sensing, parity with
    ``acquire_net_contact_force_tensor`` in isaacgym_wrapper.py:110-112).
    ``wm_* / wi_*`` are inverse mass / inverse inertia (0 for statics).
    """
    pen, n, p = contact
    active = pen > 0.0
    d = jnp.where(active, pen, 0.0)

    ra = p - pos_a
    rb = p - pos_b
    ca = cross2(ra, n)
    cb = cross2(rb, n)
    w_sum = wm_a + wi_a * ca**2 + wm_b + wi_b * cb**2
    lam = relax * d / jnp.maximum(w_sum, 1e-9)

    dpos_a = (wm_a * lam)[..., None] * n
    dyaw_a = wi_a * lam * ca
    dpos_b = -(wm_b * lam)[..., None] * n
    dyaw_b = -wi_b * lam * cb

    # Velocity solve: kill approaching normal velocity (restitution 0,
    # matching add_ground_plane's restitution=0, isaacgym_wrapper.py:462-469),
    # plus Coulomb friction on the tangential relative velocity.
    va = vel_a + om_a[..., None] * jnp.stack([-ra[..., 1], ra[..., 0]], axis=-1)
    vb = vel_b + om_b[..., None] * jnp.stack([-rb[..., 1], rb[..., 0]], axis=-1)
    vrel = va - vb
    vn = jnp.sum(vrel * n, axis=-1)
    jn = jnp.where(active & (vn < 0), -vn / jnp.maximum(w_sum, 1e-9), 0.0)

    t = jnp.stack([-n[..., 1], n[..., 0]], axis=-1)
    ta = cross2(ra, t)
    tb = cross2(rb, t)
    wt_sum = wm_a + wi_a * ta**2 + wm_b + wi_b * tb**2
    vt = jnp.sum(vrel * t, axis=-1)
    jt_unclamped = -vt / jnp.maximum(wt_sum, 1e-9)
    jt_max = friction * (jn + lam / dt)
    jt = jnp.where(active, jnp.clip(jt_unclamped, -jt_max, jt_max), 0.0)

    dvel_a = (wm_a * jn)[..., None] * n + (wm_a * jt)[..., None] * t
    dom_a = wi_a * jn * ca + wi_a * jt * ta
    dvel_b = -(wm_b * jn)[..., None] * n - (wm_b * jt)[..., None] * t
    dom_b = -wi_b * jn * cb - wi_b * jt * tb

    # Equivalent force on A (reaction -force on B): impulse + position
    # correction expressed as force over the substep.
    force = ((jn + lam / dt) / dt)[..., None] * n
    return (
        dpos_a,
        dyaw_a,
        dvel_a,
        dom_a,
        dpos_b,
        dyaw_b,
        dvel_b,
        dom_b,
        force,
    )


def ground_friction(vel, omega, mu: float, g: float, dt: float, ang_radius: float):
    """Coulomb ground friction for a planar body resting on the floor.

    Replaces PhysX's box-on-ground friction (plane static/dynamic friction 1,
    isaacgym_wrapper.py:462-469, combined with per-actor friction from the env
    YAMLs).  Decelerates linear and angular velocity without sign flips.
    """
    speed = jnp.linalg.norm(vel, axis=-1)
    scale = jnp.maximum(0.0, 1.0 - mu * g * dt / jnp.maximum(speed, 1e-9))
    vel_new = vel * scale[..., None]
    om_scale = jnp.maximum(
        0.0, 1.0 - mu * g * dt / jnp.maximum(jnp.abs(omega) * ang_radius, 1e-9)
    )
    return vel_new, omega * om_scale
