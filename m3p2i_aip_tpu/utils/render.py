"""Headless scene rendering: ASCII viewer + optional matplotlib plots.

Replaces the Isaac Gym viewer surface the reference uses for inspection
(``isaacgym_wrapper.py:374-460``: viewer camera, top-20 trajectory lines,
keyboard teleop feedback).  On a headless host the fast path is an ASCII
top-down view; ``save_trajectory_plot`` writes a PNG when matplotlib is
available (it is optional — gated import).
"""
from __future__ import annotations

from typing import Optional

import numpy as np


def render_point_env(
    env,
    state,
    width: int = 41,
    height: int = 21,
    extent: float = 4.2,
    trajs: Optional[np.ndarray] = None,
) -> str:
    """Top-down ASCII view of the point env: R robot, B box, D dyn-obs,
    # statics; ``trajs`` [n, T, 2] overlays planned rollout points as ``.``
    (the terminal analogue of the viewer's top-20 trajectory lines,
    isaacgym_wrapper.py:374-391)."""
    grid = [[" "] * width for _ in range(height)]

    def to_cell(x, y):
        c = int((x + extent) / (2 * extent) * (width - 1))
        r = int((extent - y) / (2 * extent) * (height - 1))
        return min(max(r, 0), height - 1), min(max(c, 0), width - 1)

    if trajs is not None:
        tt = np.asarray(trajs)
        for k in range(tt.shape[0]):
            for t in range(tt.shape[1]):
                r, c = to_cell(tt[k, t, 0], tt[k, t, 1])
                grid[r][c] = "."

    p = env.params
    stat_pos = np.asarray(p.stat_pos)
    stat_half = np.asarray(p.stat_half)
    for i in range(stat_pos.shape[0]):
        hx, hy = stat_half[i]
        for sx in np.linspace(-hx, hx, max(2, int(20 * hx))):
            for sy in np.linspace(-hy, hy, max(2, int(20 * hy))):
                r, c = to_cell(stat_pos[i, 0] + sx, stat_pos[i, 1] + sy)
                grid[r][c] = "#"

    dyn_pos = np.asarray(state.dyn_pos)
    names = list(p.actor_names)
    for slot, actor_i in enumerate(p.dyn_actor_idx):
        ch = "B" if names[actor_i] == "box" else "D"
        r, c = to_cell(dyn_pos[slot, 0], dyn_pos[slot, 1])
        grid[r][c] = ch

    q = np.asarray(state.q)
    r, c = to_cell(q[0], q[1])
    grid[r][c] = "R"

    border = "+" + "-" * width + "+"
    return "\n".join([border] + ["|" + "".join(row) + "|" for row in grid] + [border])


def save_trajectory_plot(
    env,
    log,
    path: str,
    top_trajs: Optional[np.ndarray] = None,
    goal: Optional[np.ndarray] = None,
) -> Optional[str]:
    """Write a PNG of the run: robot path, box path, scene, top-K rollouts.

    Parity: the in-viewer trajectory lines (isaacgym_wrapper.py:374-391) plus
    the offline analysis plots (plot/plot_point.py).  Returns the path, or
    None when matplotlib is unavailable.
    """
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return None

    fig, ax = plt.subplots(figsize=(6, 6))
    p = env.params
    stat_pos = np.asarray(p.stat_pos)
    stat_half = np.asarray(p.stat_half)
    for i in range(stat_pos.shape[0]):
        ax.add_patch(
            plt.Rectangle(
                stat_pos[i] - stat_half[i],
                2 * stat_half[i, 0],
                2 * stat_half[i, 1],
                color="0.3",
            )
        )
    if log.robot_pos:
        rp = np.asarray(log.robot_pos)
        ax.plot(rp[:, 0], rp[:, 1], "b-", label="robot")
    if log.box_pos:
        bp = np.asarray(log.box_pos)
        ax.plot(bp[:, 0], bp[:, 1], "r-", label="box")
    if top_trajs is not None:
        tt = np.asarray(top_trajs)
        for k in range(tt.shape[0]):
            ax.plot(tt[k, :, 0], tt[k, :, 1], "g-", alpha=0.2, lw=0.5)
    if goal is not None:
        ax.plot(goal[0], goal[1], "g*", markersize=15, label="goal")
    ax.set_xlim(-4.5, 4.5)
    ax.set_ylim(-4.5, 4.5)
    ax.set_aspect("equal")
    ax.legend(loc="upper right", fontsize=8)
    fig.savefig(path, dpi=100, bbox_inches="tight")
    plt.close(fig)
    return path


def save_frames(
    env,
    log,
    outdir: str,
    every: int = 5,
    goal: Optional[np.ndarray] = None,
    gif: bool = True,
) -> Optional[str]:
    """Render the run as per-tick PNG frames (+ an animated GIF when PIL is
    available) — the offline twin of the Isaac Gym viewer's live camera
    (isaacgym_wrapper.py:374-460) for headless hosts.

    Frames show the scene statics, the robot/box paths so far, and the
    current positions.  Returns the GIF path (or the frame dir when no GIF
    writer exists), None without matplotlib.
    """
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return None
    import os

    os.makedirs(outdir, exist_ok=True)
    rp = np.asarray(log.robot_pos) if log.robot_pos else None
    bp = np.asarray(log.box_pos) if log.box_pos else None
    if rp is None:
        return None
    p = env.params
    stat_pos = np.asarray(p.stat_pos)
    stat_half = np.asarray(p.stat_half)
    paths = []
    for t in range(0, rp.shape[0], max(1, every)):
        fig, ax = plt.subplots(figsize=(4, 4))
        for i in range(stat_pos.shape[0]):
            ax.add_patch(
                plt.Rectangle(
                    stat_pos[i] - stat_half[i],
                    2 * stat_half[i, 0],
                    2 * stat_half[i, 1],
                    color="0.3",
                )
            )
        ax.plot(rp[: t + 1, 0], rp[: t + 1, 1], "b-", lw=1)
        ax.plot(rp[t, 0], rp[t, 1], "bo", markersize=8)
        if bp is not None and bp.shape[0] > t:
            ax.plot(bp[: t + 1, 0], bp[: t + 1, 1], "r-", lw=1)
            ax.plot(bp[t, 0], bp[t, 1], "rs", markersize=8)
        if goal is not None:
            ax.plot(goal[0], goal[1], "g*", markersize=12)
        ax.set_xlim(-4.5, 4.5)
        ax.set_ylim(-4.5, 4.5)
        ax.set_aspect("equal")
        ax.set_title(f"tick {t}")
        fp = os.path.join(outdir, f"frame_{t:05d}.png")
        fig.savefig(fp, dpi=80, bbox_inches="tight")
        plt.close(fig)
        paths.append(fp)
    if gif and paths:
        try:
            from PIL import Image

            frames = [Image.open(fp) for fp in paths]
            gif_path = os.path.join(outdir, "run.gif")
            frames[0].save(
                gif_path, save_all=True, append_images=frames[1:],
                duration=100, loop=0,
            )
            return gif_path
        except ImportError:
            pass
    return outdir
