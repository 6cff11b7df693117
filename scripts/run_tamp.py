#!/usr/bin/env python3
"""Single-process reactive TAMP — the in-process replacement for the
two-terminal reactive_tamp.py + sim.py workflow (SURVEY.md §7 "Architecture
stance": one process, one device-resident jitted loop).

Run in the command line:
    python3 scripts/run_tamp.py task=navigation goal="[-3, 3]"
    python3 scripts/run_tamp.py task=push goal="[-1, -1]"
    python3 scripts/run_tamp.py task=pull goal="[0, 0]"
    python3 scripts/run_tamp.py task=push_pull multi_modal=True goal="[-3.75, -3.75]"
    python3 scripts/run_tamp.py -cn config_panda
    python3 scripts/run_tamp.py -cn config_panda multi_modal=True cube_on_shelf=True

``--interactive`` adds live keyboard disturbance while the planner runs
(i/j/k/l shove the box/cube, v live ASCII view with planned trajectories,
q quit) — the reference's play_with_cube surface (isaacgym_wrapper.py:413-437).
"""
import sys

import numpy as np

import os, sys
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from m3p2i_aip_tpu.config.config_store import load_config_from_argv
from m3p2i_aip_tpu.tamp.sim_loop import run_sim


def main(argv) -> None:
    record = None
    for a in list(argv):
        if a.startswith("--record="):
            record = a.split("=", 1)[1]
            argv = [x for x in argv if x != a]
    cfg = load_config_from_argv(argv, default_config="config_point")
    log = run_sim(cfg, verbose=True, interactive="--interactive" in argv)
    n = max(1, len(log.replan_s))
    print(
        f"steps={log.steps} success_step={log.success_step} "
        f"collisions={log.collisions} "
        f"replan_hz={1.0 / (sum(log.replan_s) / n):.1f} "
        f"sim_hz={1.0 / max(sum(log.sim_s) / n, 1e-9):.1f}"
    )
    if record:
        # offline viewer frames + GIF (utils/render.save_frames): the
        # headless twin of the reference's live Isaac Gym camera
        from m3p2i_aip_tpu.envs import make_env
        from m3p2i_aip_tpu.utils.render import save_frames

        out = save_frames(
            make_env(cfg), log, record, goal=np.asarray(cfg.goal, float)
        )
        print(f"frames -> {out}")


if __name__ == "__main__":
    main(sys.argv[1:])
