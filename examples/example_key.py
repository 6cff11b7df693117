#!/usr/bin/env python3
"""Teleop of the JAX sim engine: scripted smoke test or LIVE keyboard drive.

Parity target: ``examples/example_key.py`` — the reference drives one env
with the keyboard (isaacgym_wrapper.py:439-460, WASD -> +/-2 velocity) and
optionally demos suction.  A headless host has no viewer, so two modes exist:

  * default: the same velocity commands are scripted (CI-safe smoke test);
  * ``--interactive``: a real terminal teleop — raw-mode stdin reads
    w/a/s/d (drive), space (stop), x (toggle suction), q (quit), with the
    ASCII renderer (:mod:`m3p2i_aip_tpu.utils.render`) as the live viewer —
    the capability surface of the reference's viewer keyboard loop.

Run: python3 examples/example_key.py [--suction] [--interactive]
"""
import sys

import jax
import jax.numpy as jnp
import numpy as np

import os, sys
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from m3p2i_aip_tpu.config.config_store import load_config
from m3p2i_aip_tpu.envs import make_env
from m3p2i_aip_tpu.utils import skill_utils
from m3p2i_aip_tpu.utils.render import render_point_env


def interactive() -> None:
    """Raw-mode stdin teleop: the reference's keyboard_control, terminal-native."""
    import select
    import termios
    import time
    import tty

    cfg = load_config("config_point")
    env = make_env(cfg)
    step = jax.jit(env.step)
    state = env.init_state()
    names = list(env.params.actor_names)
    box_slot = env.params.dyn_actor_idx.index(names.index("box"))

    keymap = {
        "w": jnp.asarray([0.0, 2.0]),
        "s": jnp.asarray([0.0, -2.0]),
        "a": jnp.asarray([-2.0, 0.0]),
        "d": jnp.asarray([2.0, 0.0]),
        " ": jnp.asarray([0.0, 0.0]),
    }
    u = keymap[" "]
    suction_on = False

    fd = sys.stdin.fileno()
    try:
        old = termios.tcgetattr(fd)
    except termios.error:
        print("stdin is not a terminal — run from an interactive shell")
        return
    print("teleop: w/a/s/d drive, space stop, x suction, q quit")
    try:
        tty.setcbreak(fd)
        t = time.time()
        while True:
            if select.select([sys.stdin], [], [], 0)[0]:
                key = sys.stdin.read(1).lower()
                if key == "q":
                    break
                if key == "x":
                    suction_on = not suction_on
                u = keymap.get(key, u)
            ext = env.zero_ext()
            if suction_on:
                f_box, f_robot = skill_utils.calculate_suction(
                    state.dyn_pos[box_slot], state.q[:2], float(cfg.kp_suction), 1.5
                )
                ext = ext.replace(
                    robot=f_robot, dyn=ext.dyn.at[box_slot].set(f_box)
                )
            state = step(state, u, ext)
            # soft real-time pacing + live ASCII viewer
            t = skill_utils.time_tracking(t, cfg.sim.dt)
            sys.stdout.write("\x1b[2J\x1b[H")
            print(f"u={np.asarray(u)} suction={'ON' if suction_on else 'off'}"
                  f"  robot={np.round(np.asarray(state.q), 2)}  (q quits)")
            print(render_point_env(env, state))
    finally:
        termios.tcsetattr(fd, termios.TCSADRAIN, old)


def main() -> None:
    if "--interactive" in sys.argv:
        return interactive()
    cfg = load_config("config_point")
    env = make_env(cfg)
    step = jax.jit(env.step)
    state = env.init_state()

    # the keyboard_control velocity map (isaacgym_wrapper.py:439-460)
    keymap = {
        "up": jnp.asarray([0.0, 2.0]),
        "down": jnp.asarray([0.0, -2.0]),
        "left": jnp.asarray([-2.0, 0.0]),
        "right": jnp.asarray([2.0, 0.0]),
    }
    script = ["up"] * 30 + ["right"] * 20 + ["down"] * 25 + ["left"] * 20

    use_suction = "--suction" in sys.argv
    names = list(env.params.actor_names)
    box_slot = env.params.dyn_actor_idx.index(names.index("box"))

    for i, key in enumerate(script):
        u = keymap[key]
        ext = env.zero_ext()
        if use_suction:
            f_box, f_robot = skill_utils.calculate_suction(
                state.dyn_pos[box_slot], state.q, float(cfg.kp_suction), 1.5
            )
            ext = ext.replace(robot=f_robot, dyn=ext.dyn.at[box_slot].set(f_box))
        state = step(state, u, ext)
        if i % 15 == 0:
            print(f"step {i:3d} key={key:5s} robot={np.round(np.asarray(state.q), 2)}")
            print(render_point_env(env, state))


if __name__ == "__main__":
    main()
