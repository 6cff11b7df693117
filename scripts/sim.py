#!/usr/bin/env python3
"""Real-system loop — the reference's two-terminal workflow, terminal 2.

Parity target: ``scripts/sim.py`` (run_sim:19-58): single actuated env,
150-step warmup, per-tick RPC to the planner server, suction application,
soft real-time pacing.

Run in the command line (after starting scripts/reactive_tamp.py):
    python3 scripts/sim.py
    python3 scripts/sim.py task=pull
    python3 scripts/sim.py task=push_pull
    python3 scripts/sim.py -cn config_panda

Live interaction while the planner runs (the reference's play_with_cube /
keyboard loop, sim.py:39 + isaacgym_wrapper.py:413-460): i/j/k/l shove the
box, v toggles the ASCII view with the planner's top-trajectory overlay
(get_trajs RPC), q quits.  Inert when stdin is not a tty.
"""
import os
import sys
import time

# The stand-in for the robot steps its one env on the CPU on purpose: the
# planner server (scripts/reactive_tamp.py) owns the card, and a second JAX
# process on it would fail for want of memory (one JAX process per card).
os.environ["JAX_PLATFORMS"] = "cpu"

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from m3p2i_aip_tpu.config.config_store import load_config_from_argv
from m3p2i_aip_tpu.envs import make_env, update_dyn_obs
from m3p2i_aip_tpu.tamp.sim_loop import real_suction_ext
from m3p2i_aip_tpu.utils import rpc
from m3p2i_aip_tpu.utils.render import render_point_env
from m3p2i_aip_tpu.utils.skill_utils import time_tracking
from m3p2i_aip_tpu.utils.teleop import SHOVE_KEYS, KeyboardTeleop


def _shove(env, state, dpos):
    """Displace the box mid-run (play_with_cube's cube dragging)."""
    names = list(env.params.actor_names)
    if "box" not in names:
        return state
    slot = env.params.dyn_actor_idx.index(names.index("box"))
    return state.replace(
        dyn_pos=state.dyn_pos.at[slot].add(jnp.asarray(dpos))
    )


def run_sim(argv) -> None:
    cfg = load_config_from_argv(argv, default_config="config_point")
    env = make_env(cfg)
    step = jax.jit(env.step)
    state = env.init_state()

    planner = rpc.Client().connect("127.0.0.1", 4242)
    print("Server found and wait for the warmup")
    zero_u, zero_ext = jnp.zeros(env.nu), env.zero_ext()
    for _ in range(150):
        state = step(state, zero_u, zero_ext)
    print("Start simulation!")

    show_view = False
    t = time.time()
    with KeyboardTeleop() as keys:
        for i in range(10000):
            for key in keys.poll():
                if key == "q":
                    return
                if key == "v":
                    show_view = not show_view
                elif key in SHOVE_KEYS and env.env_type == "point_env":
                    state = _shove(env, state, SHOVE_KEYS[key])
            state = update_dyn_obs(env, state, i)
            action = jnp.asarray(
                planner.run_tamp(env.dof_state_view(state), env.root_state_view(state))
            )
            cfg.suction_active = bool(planner.get_suction())
            ext = real_suction_ext(cfg, env, state, action)
            state = step(state, action, ext)
            if show_view and env.env_type == "point_env":
                trajs = planner.get_trajs()
                print("\x1b[2J\x1b[H" + render_point_env(
                    env, state, trajs=np.asarray(trajs)
                ))
            t = time_tracking(t, cfg.sim.dt)


if __name__ == "__main__":
    run_sim(sys.argv[1:])
