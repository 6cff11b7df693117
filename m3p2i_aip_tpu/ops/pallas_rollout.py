"""Pallas (Triton route) kernel: the FULL point-env MPPI rollout in one program.

The XLA rollout (`MPPI._rollout`: lax.scan over T of the vmapped env step)
is a device loop of many small fused kernels per substep, each moving
[K, small] tensors through device memory.  Here the whole rollout is one
kernel: one lane (GPU thread) per sample, every physics quantity of that
sample a register, and the T x substeps x pos_iters loop nest runs inside
the kernel with no device-memory round trip between steps.

Semantics mirror models/point_env.step (point / heijn / boxer bases) + the
PointObjective costs (cost_functions.py parity chain), including the
suction-force carry from the pull cost into the next step.  Parity with the
XLA path: tests/test_pallas.py (interpret mode on the CPU, compiled on the
GPU under the ``gpu`` marker).

Layout: grid ``(B, Kp / BLOCK)``; a program owns ``BLOCK`` samples of one
batch element.  K is padded to a multiple of ``BLOCK``; the per-sample
action rows (t * n_u + channel) and state rows are padded to powers of two
(Triton's block shapes).  The task scalars and the shard's sample offset
``k0`` are one [4] operand that each program loads itself.  The D dynamic
boxes are unrolled in Python (box quantities are lists of [BLOCK]
vectors); the statics are a loop over a small geometry-table operand.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

GRAVITY = 9.8
# samples per program: small, so K=200 spreads over 7 SMs; one warp each
BLOCK = 32
NUM_WARPS = 1


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _next_pow2(x: int) -> int:
    return 1 << max(int(x) - 1, 0).bit_length()


# ---------------------------------------------------------------------------
# lane-wise planar contact math (mirrors sim/pbd2d.py; args are [block]
# vectors or Python floats)
# ---------------------------------------------------------------------------


def _rot_to_local(dx, dy, c, s):
    """world delta -> box-local coords for box yaw with cos c / sin s."""
    return c * dx + s * dy, -s * dx + c * dy


def _rot_to_world(lx, ly, c, s):
    return c * lx - s * ly, s * lx + c * ly


def _circle_vs_obb(cx, cy, radius, bx, by, bc, bs, hx, hy):
    """Circle (center cx/cy, scalar radius) vs oriented box (pose bx/by,
    cos/sin bc/bs, half extents hx/hy).

    Returns pen, world normal (nx, ny), world contact point (px, py).
    Mirrors pbd2d.circle_vs_obb.
    """
    lx, ly = _rot_to_local(cx - bx, cy - by, bc, bs)
    clx = jnp.clip(lx, -hx, hx)
    cly = jnp.clip(ly, -hy, hy)
    inside = (jnp.abs(lx) < hx) & (jnp.abs(ly) < hy)
    use_x = (jnp.abs(lx) / hx) >= (jnp.abs(ly) / hy)
    sgn_x = jnp.where(lx >= 0, 1.0, -1.0)
    sgn_y = jnp.where(ly >= 0, 1.0, -1.0)
    face_x = jnp.where(use_x, sgn_x * hx, lx)
    face_y = jnp.where(use_x, ly, sgn_y * hy)
    sx = jnp.where(inside, face_x, clx)
    sy = jnp.where(inside, face_y, cly)
    dx = lx - sx
    dy = ly - sy
    dist = jnp.sqrt(dx * dx + dy * dy)
    inv = 1.0 / jnp.maximum(dist, 1e-9)
    n_in_x = jnp.where(use_x, sgn_x, 0.0)
    n_in_y = jnp.where(use_x, 0.0, sgn_y)
    nlx = jnp.where(inside, n_in_x, dx * inv)
    nly = jnp.where(inside, n_in_y, dy * inv)
    pen = jnp.where(inside, radius + dist, radius - dist)
    nx, ny = _rot_to_world(nlx, nly, bc, bs)
    wx, wy = _rot_to_world(sx, sy, bc, bs)
    return pen, nx, ny, bx + wx, by + wy


def _resolve(
    pen, nx, ny, px, py,
    ax, ay, avx, avy, aom, wm_a, wi_a,
    bx, by, bvx, bvy, bom, wm_b, wi_b,
    h, friction, relax,
):
    """One Jacobi contact projection (mirrors pbd2d.resolve_contact).

    Returns position/velocity corrections for A and B plus the equivalent
    force on A (fx, fy).
    """
    active = pen > 0.0
    d = jnp.where(active, pen, 0.0)
    rax, ray = px - ax, py - ay
    rbx, rby = px - bx, py - by
    ca = rax * ny - ray * nx
    cb = rbx * ny - rby * nx
    w_sum = wm_a + wi_a * ca * ca + wm_b + wi_b * cb * cb
    lam = relax * d / jnp.maximum(w_sum, 1e-9)

    dax, day = wm_a * lam * nx, wm_a * lam * ny
    dyaw_a = wi_a * lam * ca
    dbx, dby = -wm_b * lam * nx, -wm_b * lam * ny
    dyaw_b = -wi_b * lam * cb

    vax = avx - aom * ray
    vay = avy + aom * rax
    vbx = bvx - bom * rby
    vby = bvy + bom * rbx
    vrx, vry = vax - vbx, vay - vby
    vn = vrx * nx + vry * ny
    jn = jnp.where(active & (vn < 0), -vn / jnp.maximum(w_sum, 1e-9), 0.0)

    tx, ty = -ny, nx
    ta = rax * ty - ray * tx
    tb = rbx * ty - rby * tx
    wt_sum = wm_a + wi_a * ta * ta + wm_b + wi_b * tb * tb
    vt = vrx * tx + vry * ty
    jt_un = -vt / jnp.maximum(wt_sum, 1e-9)
    jt_max = friction * (jn + lam / h)
    jt = jnp.where(active, jnp.clip(jt_un, -jt_max, jt_max), 0.0)

    dvax = wm_a * (jn * nx + jt * tx)
    dvay = wm_a * (jn * ny + jt * ty)
    dom_a = wi_a * (jn * ca + jt * ta)
    dvbx = -wm_b * (jn * nx + jt * tx)
    dvby = -wm_b * (jn * ny + jt * ty)
    dom_b = -wi_b * (jn * cb + jt * tb)

    f = (jn + lam / h) / h
    return (
        dax, day, dyaw_a, dvax, dvay, dom_a,
        dbx, dby, dyaw_b, dvbx, dvby, dom_b,
        f * nx, f * ny,
    )


def _corner_pens(cx, cy, cc, cs, hxa, hya, bx, by, bc, bs, hxb, hyb):
    """Penetrations of A's 4 corners against box B's dominant face.

    Mirrors pbd2d.corners_vs_obb.  Returns (pens [4], corner world coords
    [4 of (x, y)], face normal (nx, ny)).
    """
    clx, cly = _rot_to_local(cx - bx, cy - by, bc, bs)
    use_x = (jnp.abs(clx) / hxb) >= (jnp.abs(cly) / hyb)
    sgn = jnp.where(
        use_x,
        jnp.where(clx >= 0, 1.0, -1.0),
        jnp.where(cly >= 0, 1.0, -1.0),
    )
    half_axis = jnp.where(use_x, hxb, hyb)
    nlx = jnp.where(use_x, sgn, 0.0)
    nly = jnp.where(use_x, 0.0, sgn)
    nx, ny = _rot_to_world(nlx, nly, bc, bs)

    pens, corners = [], []
    for sxs, sys in ((1, 1), (1, -1), (-1, 1), (-1, -1)):
        ox, oy = _rot_to_world(sxs * hxa, sys * hya, cc, cs)
        wx, wy = cx + ox, cy + oy
        lx, ly = _rot_to_local(wx - bx, wy - by, bc, bs)
        local_a = jnp.where(use_x, lx, ly)
        sep_other = jnp.where(
            use_x, hyb - jnp.abs(ly), hxb - jnp.abs(lx)
        )
        pen_val = half_axis - sgn * local_a
        pen = jnp.where((pen_val > 0) & (sep_other > 0), pen_val, -1.0)
        pens.append(pen)
        corners.append((wx, wy))
    return pens, corners, (nx, ny)


# ---------------------------------------------------------------------------
# the rollout kernel
# ---------------------------------------------------------------------------


def _rollout_kernel(
    task_ref,  # [4]: task_id, goal_x, goal_y, k0 (global sample offset)
    stat_ref,  # [S_p, 8]: per static x, y, cos, sin, half x, half y, friction
    acts_ref,  # [R_a, block]: row t * n_u + c = channel c of step t
    state_ref,  # [R_s, block]: q, qd, then dyn rows grouped BY FIELD
    #             (x*D, y*D, yaw*D, vx*D, vy*D, om*D, fric_scale*D)
    cost_ref,  # out [Tp, block]
    trajx_ref,  # out [Tp, block]
    trajy_ref,  # out [Tp, block]
    *,
    P,  # dict of static params (python/numpy)
    block: int,
):
    D, S = P["D"], P["S"]
    h = P["dt"] / P["substeps"]
    decay = P["decay"]
    wm_r = 1.0 / P["robot_mass"]
    rr = P["robot_radius"]
    n_q, n_u = P["n_q"], P["n_u"]
    rtype = P["robot_type"]
    box, obs = P["box_slot"], P["dynobs_slot"]
    inv_mass, inv_inertia = P["inv_mass"], P["inv_inertia"]
    half = P["half"]

    # clip like the XLA dispatch (cost_functions.py lax.switch clip);
    # reposition (id 8) runs the navigation cost, NOT a clip-to-push_pull
    task_id = jnp.where(
        task_ref[0] == 8.0, 0.0, jnp.clip(task_ref[0], 0.0, 3.0)
    )
    gx = task_ref[1]
    gy = task_ref[2]
    k0 = task_ref[3]  # global sample offset of this shard (0 unsharded)

    col = pl.program_id(1) * block + jax.lax.broadcasted_iota(
        jnp.int32, (block,), 0
    )
    # mode split is GLOBAL-index based so a shard_map shard covering samples
    # [k0, k0+K_loc) keeps the reference's half-batch semantics (mppi.py)
    gcol = col.astype(jnp.float32) + k0
    mode1 = (gcol >= P["half_K"]) & (gcol < P["K"])  # second-half samples

    # Loops over the statics (and over substeps / position iterations) are
    # real loops, not unrolled: the kernel stays small enough to compile in
    # seconds; the D dynamic boxes stay unrolled (D = 2 in every scene).
    def over_statics(body, init):
        def step(s, carry):
            return body(tuple(stat_ref[s, c] for c in range(7)), carry)

        return jax.lax.fori_loop(0, S, step, init)

    def row(i):
        return state_ref[i, :]

    zero = jnp.zeros((block,), jnp.float32)
    qx, qy = row(0), row(1)
    qyaw = row(2) if n_q == 3 else zero
    qdx, qdy = row(n_q), row(n_q + 1)
    qdyaw = row(n_q + 2) if n_q == 3 else zero
    base = 2 * n_q

    def field(f):
        return [row(base + f * D + i) for i in range(D)]

    X, Y, YAW, VX, VY, OM = (field(f) for f in range(6))
    # per-SAMPLE friction: base material x the state's fric_scale rows
    # (domain randomization — point_env.step's `fric`/`mu_ground` twin)
    fric_d = [P["friction"][i] * fs for i, fs in enumerate(field(6))]
    mu_g_d = [(f + 1.0) * 0.5 for f in fric_d]

    def pos_iter(_, carry):
        """One position iteration: the five Jacobi contact passes."""
        qx, qy, qdx, qdy, X, Y, YAW, VX, VY, OM, f_obs_x, f_obs_y = carry
        X, Y, YAW, VX, VY, OM = map(list, (X, Y, YAW, VX, VY, OM))

        # pass 1: robot circle vs every dynamic box, Jacobi — all D
        # contacts from the PRE-pass robot pose, robot corrections summed
        # after
        dq = [zero, zero, zero, zero]
        for i in range(D):
            pen, nx, ny, px, py = _circle_vs_obb(
                qx, qy, rr, X[i], Y[i], jnp.cos(YAW[i]),
                jnp.sin(YAW[i]), half[i][0], half[i][1],
            )
            out = _resolve(
                pen, nx, ny, px, py,
                qx, qy, qdx, qdy, 0.0, wm_r, 0.0,
                X[i], Y[i], VX[i], VY[i], OM[i],
                inv_mass[i], inv_inertia[i],
                h, (P["robot_friction"] + fric_d[i]) / 2, 1.0,
            )
            X[i], Y[i], YAW[i] = X[i] + out[6], Y[i] + out[7], YAW[i] + out[8]
            VX[i], VY[i], OM[i] = VX[i] + out[9], VY[i] + out[10], OM[i] + out[11]
            if i == obs:
                f_obs_x = f_obs_x - out[12]
                f_obs_y = f_obs_y - out[13]
            dq = [dq[0] + out[0], dq[1] + out[1], dq[2] + out[3], dq[3] + out[4]]
        qx, qy = qx + dq[0], qy + dq[1]
        qdx, qdy = qdx + dq[2], qdy + dq[3]

        # pass 2: dynamic vs dynamic, Jacobi from frozen poses — the corners
        # of each box i (as A) meet every other box j (as B)
        if D > 1:
            X0, Y0, VX0, VY0, OM0 = list(X), list(Y), list(VX), list(VY), list(OM)
            c0 = [jnp.cos(a) for a in YAW]
            s0 = [jnp.sin(a) for a in YAW]
            dd = [[zero] * 6 for _ in range(D)]
            for i in range(D):
                for j in range(D):
                    if j == i:
                        continue
                    pens, corners, (nx, ny) = _corner_pens(
                        X0[i], Y0[i], c0[i], s0[i], half[i][0], half[i][1],
                        X0[j], Y0[j], c0[j], s0[j], half[j][0], half[j][1],
                    )
                    for pen, (wx, wy) in zip(pens, corners):
                        out = _resolve(
                            pen, nx, ny, wx, wy,
                            X0[i], Y0[i], VX0[i], VY0[i], OM0[i],
                            inv_mass[i], inv_inertia[i],
                            X0[j], Y0[j], VX0[j], VY0[j], OM0[j],
                            inv_mass[j], inv_inertia[j],
                            h, (fric_d[i] + fric_d[j]) / 2, 0.5,
                        )
                        dd[i] = [a + b for a, b in zip(dd[i], out[0:6])]
                        dd[j] = [a + b for a, b in zip(dd[j], out[6:12])]
                        if i == obs:
                            f_obs_x = f_obs_x + out[12]
                            f_obs_y = f_obs_y + out[13]
                        if j == obs:
                            f_obs_x = f_obs_x - out[12]
                            f_obs_y = f_obs_y - out[13]
            for i in range(D):
                X[i], Y[i], YAW[i] = X[i] + dd[i][0], Y[i] + dd[i][1], YAW[i] + dd[i][2]
                VX[i], VY[i], OM[i] = VX[i] + dd[i][3], VY[i] + dd[i][4], OM[i] + dd[i][5]

        # pass 3: each dynamic box vs every static (full strength, per-corner
        # corrections normalized by the active-corner count per static) —
        # Jacobi per box from its pre-pass pose
        for i in range(D):
            x, y, vx, vy, om = X[i], Y[i], VX[i], VY[i], OM[i]
            ci, si = jnp.cos(YAW[i]), jnp.sin(YAW[i])

            def vs_static(st, carry, i=i, x=x, y=y, vx=vx, vy=vy, om=om, ci=ci, si=si):
                acc, fx, fy = carry
                sx, sy, sc, ss, shx, shy, sfr = st
                pens, corners, (nx, ny) = _corner_pens(
                    x, y, ci, si, half[i][0], half[i][1], sx, sy, sc, ss, shx, shy,
                )
                n_act = sum((pen > 0).astype(jnp.float32) for pen in pens)
                relax = 1.0 / jnp.maximum(n_act, 1.0)
                for pen, (wx, wy) in zip(pens, corners):
                    out = _resolve(
                        pen, nx, ny, wx, wy,
                        x, y, vx, vy, om, inv_mass[i], inv_inertia[i],
                        sx, sy, 0.0, 0.0, 0.0, 0.0, 0.0,
                        h, (fric_d[i] + sfr) / 2, relax,
                    )
                    acc = tuple(a + b for a, b in zip(acc, out[0:6]))
                    if i == obs:
                        fx, fy = fx + out[12], fy + out[13]
                return acc, fx, fy

            acc, f_obs_x, f_obs_y = over_statics(
                vs_static, ((zero,) * 6, f_obs_x, f_obs_y)
            )
            X[i], Y[i], YAW[i] = X[i] + acc[0], Y[i] + acc[1], YAW[i] + acc[2]
            VX[i], VY[i], OM[i] = VX[i] + acc[3], VY[i] + acc[4], OM[i] + acc[5]

        # pass 4: robot circle vs every static, Jacobi
        def robot_vs_static(st, dq):
            sx, sy, sc, ss, shx, shy, sfr = st
            pen, nx, ny, px, py = _circle_vs_obb(qx, qy, rr, sx, sy, sc, ss, shx, shy)
            out = _resolve(
                pen, nx, ny, px, py,
                qx, qy, qdx, qdy, 0.0, wm_r, 0.0,
                sx, sy, 0.0, 0.0, 0.0, 0.0, 0.0,
                h, (P["robot_friction"] + sfr) / 2, 1.0,
            )
            return (dq[0] + out[0], dq[1] + out[1], dq[2] + out[3], dq[3] + out[4])

        dq = over_statics(robot_vs_static, (zero,) * 4)
        qx, qy = qx + dq[0], qy + dq[1]
        qdx, qdy = qdx + dq[2], qdy + dq[3]

        # pass 5: robot vs dynamic again (immovable), Jacobi
        dq = [zero, zero, zero, zero]
        for i in range(D):
            pen, nx, ny, px, py = _circle_vs_obb(
                qx, qy, rr, X[i], Y[i], jnp.cos(YAW[i]),
                jnp.sin(YAW[i]), half[i][0], half[i][1],
            )
            out = _resolve(
                pen, nx, ny, px, py,
                qx, qy, qdx, qdy, 0.0, wm_r, 0.0,
                X[i], Y[i], VX[i], VY[i], OM[i], 0.0, 0.0,
                h, 0.0, 1.0,
            )
            dq = [dq[0] + out[0], dq[1] + out[1], dq[2] + out[3], dq[3] + out[4]]
        qx, qy = qx + dq[0], qy + dq[1]
        qdx, qdy = qdx + dq[2], qdy + dq[3]
        return (qx, qy, qdx, qdy, tuple(X), tuple(Y), tuple(YAW),
                tuple(VX), tuple(VY), tuple(OM), f_obs_x, f_obs_y)

    def t_body(t, carry):
        (qx, qy, qyaw, qdx, qdy, qdyaw, X, Y, YAW, VX, VY, OM,
         ext_rx, ext_ry, ext_bx, ext_by) = carry
        # actions arrive pre-scaled (the caller applies u_scale, matching
        # MPPI._command_halton's `u_scale * act_seq` at the _rollout boundary)
        u = [acts_ref[t * n_u + c, :] for c in range(n_u)]

        def substep(_, c):
            (qx, qy, qyaw, qdx, qdy, qdyaw, X, Y, YAW, VX, VY, OM,
             f_obs_x, f_obs_y) = c
            X, Y, YAW, VX, VY, OM = map(list, (X, Y, YAW, VX, VY, OM))
            # velocity integration + drive (point_env.py step)
            qdx = qdx + ext_rx * (wm_r * h)
            qdy = qdy + ext_ry * (wm_r * h)
            if rtype == "boxer":
                # wheel speeds -> base twist (diff-drive, current yaw)
                v = P["wheel_radius"] * (u[0] + u[1]) * 0.5
                omt = P["wheel_radius"] * (u[1] - u[0]) / P["wheel_base"]
                tx_ = v * jnp.cos(qyaw)
                ty_ = v * jnp.sin(qyaw)
                qdx = tx_ + (qdx - tx_) * decay
                qdy = ty_ + (qdy - ty_) * decay
                qdyaw = omt + (qdyaw - omt) * decay
            else:
                qdx = u[0] + (qdx - u[0]) * decay
                qdy = u[1] + (qdy - u[1]) * decay
                if n_q == 3:  # heijn: world-frame yaw-rate channel
                    qdyaw = u[2] + (qdyaw - u[2]) * decay
            # robot speed cap: without it ±500 N suction forces can tunnel
            # the robot through wall junctions
            qsp = jnp.sqrt(qdx * qdx + qdy * qdy)
            qcap = jnp.minimum(1.0, 6.0 / jnp.maximum(qsp, 1e-9))
            qdx = qdx * qcap
            qdy = qdy * qcap

            for i in range(D):
                if i == box:
                    VX[i] = VX[i] + ext_bx * (inv_mass[i] * h)
                    VY[i] = VY[i] + ext_by * (inv_mass[i] * h)
                # ground friction (pbd2d.ground_friction)
                speed = jnp.sqrt(VX[i] * VX[i] + VY[i] * VY[i])
                scale = jnp.maximum(
                    0.0, 1.0 - mu_g_d[i] * GRAVITY * h / jnp.maximum(speed, 1e-9)
                )
                VX[i], VY[i] = VX[i] * scale, VY[i] * scale
                om_scale = jnp.maximum(
                    0.0,
                    1.0 - mu_g_d[i] * GRAVITY * h
                    / jnp.maximum(jnp.abs(OM[i]) * P["ang_rad"][i], 1e-9),
                )
                OM[i] = OM[i] * om_scale
                sp = jnp.sqrt(VX[i] * VX[i] + VY[i] * VY[i])
                cap = jnp.minimum(1.0, P["max_speed"] / jnp.maximum(sp, 1e-9))
                VX[i], VY[i] = VX[i] * cap, VY[i] * cap
                X[i] = X[i] + VX[i] * h
                Y[i] = Y[i] + VY[i] * h
                YAW[i] = YAW[i] + OM[i] * h
            qx = qx + qdx * h
            qy = qy + qdy * h
            if n_q == 3:
                qyaw = qyaw + qdyaw * h

            (qx, qy, qdx, qdy, X, Y, YAW, VX, VY, OM, f_obs_x, f_obs_y) = (
                jax.lax.fori_loop(
                    0, P["pos_iters"], pos_iter,
                    (qx, qy, qdx, qdy, tuple(X), tuple(Y), tuple(YAW),
                     tuple(VX), tuple(VY), tuple(OM), f_obs_x, f_obs_y),
                )
            )

            # closed-arena invariant (point_env.py arena_bound clamp)
            if P["arena_bound"] > 0.0:
                lim = P["arena_bound"] - rr
                qx = jnp.clip(qx, -lim, lim)
                qy = jnp.clip(qy, -lim, lim)
            return (qx, qy, qyaw, qdx, qdy, qdyaw, X, Y, YAW, VX, VY, OM,
                    f_obs_x, f_obs_y)

        (qx, qy, qyaw, qdx, qdy, qdyaw, X, Y, YAW, VX, VY, OM,
         f_obs_x, f_obs_y) = jax.lax.fori_loop(
            0, P["substeps"], substep,
            (qx, qy, qyaw, qdx, qdy, qdyaw, X, Y, YAW, VX, VY, OM, zero, zero),
        )

        # ------------------------------------------------------------- cost
        # (parity: PointObjective.compute; mode flag = second half of K)
        n_norm = P["substeps"] * P["pos_iters"]
        coll = jnp.abs(f_obs_x / n_norm) + jnp.abs(f_obs_y / n_norm)
        motion_cost = jnp.where(coll > 0.1, 1000.0, 0.0)

        bx_, by_ = X[box], Y[box]
        r2bx, r2by = qx - bx_, qy - by_
        b2gx, b2gy = gx - bx_, gy - by_
        d_rb = jnp.sqrt(r2bx * r2bx + r2by * r2by)
        d_bg = jnp.sqrt(b2gx * b2gx + b2gy * b2gy)
        dist_cost = d_rb + d_bg * 10.0
        cos_theta = (r2bx * b2gx + r2by * b2gy) / jnp.maximum(d_rb * d_bg, 1e-9)

        nav = jnp.sqrt((qx - gx) ** 2 + (qy - gy) ** 2) + motion_cost
        if rtype == "boxer" and P["boxer_continuous_align"]:
            # continuous side alignment for the diff-drive base (see
            # PointObjective._push): gradient all the way around the box
            push_align = 1.5 * (1.0 + cos_theta)
        else:
            push_align = jnp.maximum(cos_theta, 0.0)
        push = 3.0 * dist_cost + push_align

        # pull: suction force (rollout threshold 1.8), velocity + align costs
        pdx, pdy = bx_ - qx, by_ - qy  # robot -> block
        towards = (qdx * pdx + qdy * pdy) > 0.0
        mag = 1.0 / jnp.maximum(d_rb, 1e-6)
        gate = (mag > 1.8).astype(jnp.float32)
        fx = jnp.clip(-P["kp_suction"] * pdx * mag * gate, -500.0, 500.0)
        fy = jnp.clip(-P["kp_suction"] * pdy * mag * gate, -500.0, 500.0)
        off = towards
        if P["multi_modal"]:
            off = off | ~mode1  # mode 0 (push half) gets no suction
        s_bx = jnp.where(off, 0.0, fx)
        s_by = jnp.where(off, 0.0, fy)
        s_rx = jnp.where(off, 0.0, -fx)
        s_ry = jnp.where(off, 0.0, -fy)
        vel_cost = jnp.where(towards & (d_rb <= 0.5), 0.6, 0.0)
        # wall-crush penalty (mirrors PointObjective._wall_crush): max
        # robot-circle penetration into the statics
        crush_pen = over_statics(
            lambda st, m: jnp.maximum(m, _circle_vs_obb(qx, qy, rr, *st[:6])[0]),
            jnp.full((block,), -jnp.inf, jnp.float32),
        )
        if P["arena_bound"] > 0.0:
            # boundary contact counts as crush (PointObjective._pull).
            # 5 cm margin: box<->robot contact can hold the puller ~2 cm off
            # its pin limit (measured on the boxer), so a contact-tight
            # margin never fires and the pull deadlocks in wall pockets
            lim_e = P["arena_bound"] - rr - 0.05
            at_edge = jnp.maximum(jnp.abs(qx), jnp.abs(qy)) > lim_e
            crush_pen = jnp.where(at_edge, 1.0, crush_pen)
            if P["multi_modal"] and rtype == "boxer":
                # pocket-goal endgame veto (PointObjective._pull, diff-drive
                # only): flip the arbitration to push BEFORE a nonholonomic
                # puller wedges itself between box and wall
                pocket_lim = P["arena_bound"] - (2.0 * rr + half[box][0])
                goal_in_pocket = (
                    jnp.maximum(jnp.abs(gx), jnp.abs(gy)) > pocket_lim
                )
                crush_pen = jnp.where(
                    goal_in_pocket & (d_bg < 1.0), 1.0, crush_pen
                )
        crush = jnp.where(crush_pen > 0.02, 1000.0, 0.0)
        pull = (3.0 * dist_cost + 3.0 * vel_cost
                + 7.0 * jnp.maximum(-cos_theta, 0.0) + crush)

        pp = jnp.where(mode1, pull, push)

        is_nav = (task_id == 0).astype(jnp.float32)
        is_push = (task_id == 1).astype(jnp.float32)
        is_pull = (task_id == 2).astype(jnp.float32)
        is_pp = (task_id == 3).astype(jnp.float32)
        cost = is_nav * nav + is_push * push + is_pull * pull + is_pp * pp

        # ext forces for the NEXT step: pull applies them to every sample
        # (mode-gated inside `off` when multi-modal); push_pull applies them
        # to the pull half only (the push_pull mode-masked ext in
        # PointObjective.compute)
        sel = is_pull + is_pp * mode1.astype(jnp.float32)
        ext_bx = s_bx * sel
        ext_by = s_by * sel
        ext_rx = s_rx * sel
        ext_ry = s_ry * sel

        cost_ref[t, :] = cost
        trajx_ref[t, :] = qx
        trajy_ref[t, :] = qy
        return (qx, qy, qyaw, qdx, qdy, qdyaw, X, Y, YAW, VX, VY, OM,
                ext_rx, ext_ry, ext_bx, ext_by)

    jax.lax.fori_loop(
        0,
        P["T"],
        t_body,
        (qx, qy, qyaw, qdx, qdy, qdyaw,
         tuple(X), tuple(Y), tuple(YAW), tuple(VX), tuple(VY), tuple(OM),
         zero, zero, zero, zero),
    )


def rollout_kernel_supported(env_params) -> bool:
    """The kernel covers the point-family scenes with a box and a dyn-obs."""
    names = list(env_params.actor_names)
    return (
        env_params.robot_type in ("point", "heijn", "boxer")
        and "box" in names
        and "dyn-obs" in names
    )


def make_point_rollout(
    env_params,
    kp_suction: float,
    K: int,
    T: int,
    multi_modal: bool,
    interpret: bool = False,
    boxer_continuous_align: bool = True,
):
    """Build the fused rollout callable for a point-robot scene.

    Returns ``rollout(sim_state_k, acts, task, k0=None) -> (cost_horizon
    [K, T], traj_points [K, T, 2])`` — a drop-in for ``MPPI._rollout`` (acts
    arrive already u_scale-scaled).  All K rollouts must start from the same
    state (the planner broadcasts the real state).  ``interpret=True`` runs
    the kernel in the Pallas interpreter (CPU tests only).  Raises
    ``ValueError`` for a scene the kernel does not cover
    (see :func:`rollout_kernel_supported`).
    """
    if not rollout_kernel_supported(env_params):
        raise ValueError(
            "the point rollout kernel needs a point/heijn/boxer scene with "
            "a 'box' and a 'dyn-obs' actor"
        )

    D = int(env_params.dyn_half.shape[0])
    S = int(env_params.stat_pos.shape[0])
    names = list(env_params.actor_names)
    box_slot = env_params.dyn_actor_idx.index(names.index("box"))
    dynobs_slot = env_params.dyn_actor_idx.index(names.index("dyn-obs"))

    half = np.asarray(env_params.dyn_half)
    stat_pos = np.asarray(env_params.stat_pos)
    stat_yaw = np.asarray(env_params.stat_yaw)
    stat_half = np.asarray(env_params.stat_half)
    n_q = 3 if env_params.robot_type in ("heijn", "boxer") else 2
    n_u = 3 if env_params.robot_type == "heijn" else 2

    P = dict(
        D=D,
        S=S,
        T=T,
        K=K,
        half_K=K // 2,
        dt=float(env_params.dt),
        substeps=int(env_params.substeps),
        pos_iters=int(env_params.pos_iters),
        decay=float(np.exp(-env_params.drive_rate * env_params.dt / env_params.substeps)),
        robot_mass=float(env_params.robot_mass),
        robot_radius=float(env_params.robot_radius),
        robot_friction=float(env_params.robot_friction),
        max_speed=float(env_params.max_dyn_speed),
        half=[(float(half[i, 0]), float(half[i, 1])) for i in range(D)],
        inv_mass=[float(x) for x in np.asarray(env_params.dyn_inv_mass)],
        inv_inertia=[float(x) for x in np.asarray(env_params.dyn_inv_inertia)],
        ang_rad=[float(x) for x in np.mean(half, axis=-1)],
        friction=[float(x) for x in np.asarray(env_params.dyn_friction)],
        stat=[(float(stat_pos[i, 0]), float(stat_pos[i, 1]), float(stat_yaw[i])) for i in range(S)],
        stat_friction=[float(x) for x in np.asarray(env_params.stat_friction)],
        stat_half=[(float(stat_half[i, 0]), float(stat_half[i, 1])) for i in range(S)],
        box_slot=box_slot,
        dynobs_slot=dynobs_slot,
        multi_modal=bool(multi_modal),
        kp_suction=float(kp_suction),
        robot_type=env_params.robot_type,
        arena_bound=float(env_params.arena_bound),
        n_q=n_q,
        n_u=n_u,
        wheel_radius=float(env_params.wheel_radius),
        wheel_base=float(env_params.wheel_base),
        boxer_continuous_align=bool(boxer_continuous_align),
    )
    Tp = _next_pow2(T)
    n_act_rows = _next_pow2(T * n_u)
    n_state = 2 * n_q + 7 * D  # +D: per-sample fric_scale rows
    n_state_rows = _next_pow2(n_state)
    # static geometry table, one row per static: x, y, cos, sin, half x,
    # half y, friction (rows and columns padded to powers of two)
    stat_tab = np.zeros((_next_pow2(max(S, 1)), 8), np.float32)
    for i, ((sx, sy, syaw), (hx, hy), fr) in enumerate(
        zip(P["stat"], P["stat_half"], P["stat_friction"])
    ):
        stat_tab[i, :7] = (sx, sy, np.cos(syaw), np.sin(syaw), hx, hy, fr)

    # one pallas_call per (batch, LOCAL sample count): the same callable
    # serves unsharded (K_loc == K), batched (B > 1) and shard_map shards
    # (K_loc == K / mesh_size)
    _calls = {}

    def _get_call(B: int, K_loc: int):
        key = (B, K_loc)
        if key not in _calls:
            Kp = _round_up(K_loc, BLOCK)

            # a NAMED closure, not functools.partial: pallas derives the
            # kernel name from the callable, and a partial's repr embeds a
            # memory address (unstable persistent-compilation-cache key)
            def point_rollout_kernel(*refs):
                return _rollout_kernel(*refs, P=P, block=BLOCK)

            out = jax.ShapeDtypeStruct((B, Tp, Kp), jnp.float32)
            out_spec = pl.BlockSpec((None, Tp, BLOCK), lambda b, k: (b, 0, k))
            _calls[key] = (
                pl.pallas_call(
                    point_rollout_kernel,
                    grid=(B, Kp // BLOCK),
                    out_shape=(out, out, out),
                    in_specs=[
                        pl.BlockSpec((None, 4), lambda b, k: (b, 0)),
                        pl.BlockSpec(stat_tab.shape, lambda b, k: (0, 0)),
                        pl.BlockSpec((None, n_act_rows, BLOCK), lambda b, k: (b, 0, k)),
                        pl.BlockSpec((None, n_state_rows, BLOCK), lambda b, k: (b, 0, k)),
                    ],
                    out_specs=(out_spec, out_spec, out_spec),
                    backend="triton",
                    compiler_params=pl_triton.CompilerParams(
                        num_warps=NUM_WARPS, num_stages=1
                    ),
                    interpret=interpret,
                ),
                Kp,
            )
        return _calls[key]

    def _pack(sim_state_k, acts, task, k0v, Kp):
        """(task_vec [4], acts_p [n_act_rows, Kp], state_p [n_state_rows, Kp])
        for ONE batch element."""
        # single start state (all K identical by construction — EXCEPT the
        # per-sample fric_scale domain-randomization rows, packed below)
        s0 = jax.tree_util.tree_map(lambda x: x[0], sim_state_k)
        K_loc = acts.shape[0]
        rows = [s0.q[i] for i in range(n_q)] + [s0.qd[i] for i in range(n_q)]
        # dyn rows grouped BY FIELD (all x, all y, ...)
        rows += [s0.dyn_pos[i, 0] for i in range(D)]
        rows += [s0.dyn_pos[i, 1] for i in range(D)]
        rows += [s0.dyn_yaw[i] for i in range(D)]
        rows += [s0.dyn_vel[i, 0] for i in range(D)]
        rows += [s0.dyn_vel[i, 1] for i in range(D)]
        rows += [s0.dyn_om[i] for i in range(D)]
        state_p = jnp.zeros((n_state_rows, Kp), jnp.float32)
        state_p = state_p.at[: n_state - D].set(
            jnp.broadcast_to(jnp.stack(rows)[:, None], (n_state - D, Kp))
        )
        # per-sample friction scale [K_loc, D] -> [D, Kp] rows (pad lanes 1.0)
        fs = jnp.ones((D, Kp), jnp.float32).at[:, :K_loc].set(
            jnp.swapaxes(sim_state_k.fric_scale.astype(jnp.float32), 0, 1)
        )
        state_p = state_p.at[n_state - D : n_state].set(fs)

        # [K_loc, T, n_u] -> rows t * n_u + c
        acts_rows = jnp.transpose(acts, (1, 2, 0)).reshape(T * n_u, K_loc)
        acts_p = jnp.zeros((n_act_rows, Kp), jnp.float32)
        acts_p = acts_p.at[: T * n_u, :K_loc].set(acts_rows.astype(jnp.float32))

        task_vec = jnp.stack(
            [task.task_id.astype(jnp.float32), task.goal[0], task.goal[1], k0v]
        )
        return task_vec, acts_p, state_p

    def _unpack(cost, tx, ty, K_loc):
        cost_horizon = jnp.swapaxes(cost[:T, :K_loc], 0, 1)  # [K_loc, T]
        tps = jnp.stack([tx[:T, :K_loc], ty[:T, :K_loc]], axis=-1)
        return cost_horizon, jnp.swapaxes(tps, 0, 1)

    def _batched(sim_state_k, acts, task, k0v):
        """Every argument carries a leading batch axis B."""
        B, K_loc = acts.shape[0], acts.shape[1]
        call, Kp = _get_call(B, K_loc)
        tv, ap, sp = jax.vmap(lambda s, a, t: _pack(s, a, t, k0v, Kp))(
            sim_state_k, acts, task
        )
        cost, tx, ty = call(tv, jnp.asarray(stat_tab), ap, sp)  # [B, Tp, Kp] each
        return jax.vmap(lambda c, x, y: _unpack(c, x, y, K_loc))(cost, tx, ty)

    def _single(sim_state_k, acts, task, k0):
        k0v = jnp.zeros((), jnp.float32) if k0 is None else jnp.asarray(k0, jnp.float32)
        add_b = lambda x: jnp.asarray(x)[None]
        ch, tps = _batched(
            jax.tree.map(add_b, sim_state_k), acts[None],
            jax.tree.map(add_b, task), k0v,
        )
        return ch[0], tps[0]

    # A jax.vmap over the rollout (the vmapped multi-seed runner,
    # tamp/batch_loop.py) dispatches ONE kernel over grid (B, Kp / block)
    from jax.custom_batching import custom_vmap

    @custom_vmap
    def _rollout_cv(sim_state_k, acts, task):
        return _single(sim_state_k, acts, task, None)

    @_rollout_cv.def_vmap
    def _rollout_cv_rule(axis_size, in_batched, sim_state_k, acts, task):
        B = axis_size

        def bc(x, batched):
            x = jnp.asarray(x)
            return x if batched else jnp.broadcast_to(x[None], (B,) + x.shape)

        sim_state_k = jax.tree.map(bc, sim_state_k, in_batched[0])
        acts = bc(acts, in_batched[1])
        task = jax.tree.map(bc, task, in_batched[2])
        # k0 = 0: batched mode never shards K
        out = _batched(sim_state_k, acts, task, jnp.zeros((), jnp.float32))
        return out, (True, True)

    def rollout(sim_state_k, acts, task, k0=None):
        """``k0`` = this shard's global sample offset (None/0 unsharded)."""
        if k0 is None:
            return _rollout_cv(sim_state_k, acts, task)
        return _single(sim_state_k, acts, task, k0)

    return rollout
