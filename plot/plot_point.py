#!/usr/bin/env python3
"""Offline statistics over point-env experiment logs.

Parity target: ``src/m3p2i_aip/plot/plot_point.py`` — same 19-column row
schema (documented in analysis/run_logger.py), same cost formulas
(pos error vs goal, flip-invariant orientation error vs identity), same
mean ± std reporting, box plots via matplotlib instead of plotly.

Run after scripts/run_experiments.py has produced logs under plot/point/:
    python3 plot/plot_point.py [logdir]
"""
import glob
import os
import sys

import jax
import numpy as np

# offline analysis: the few tiny orientation-cost ops it needs run on the
# CPU, leaving the accelerator to the planner process
jax.config.update("jax_platforms", "cpu")

import os, sys
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from m3p2i_aip_tpu.analysis import point_costs, summarize
from m3p2i_aip_tpu.analysis.stats import box_plot


def main(logdir: str = "plot/point") -> None:
    files = sorted(glob.glob(os.path.join(logdir, "*.npy")))
    if not files:
        print(f"no .npy logs under {logdir}; run scripts/run_experiments.py first")
        return
    groups_time, groups_pos = {}, {}
    for f in files:
        name = os.path.splitext(os.path.basename(f))[0]
        data = np.load(f)
        print(f"---------{name} (n={data.shape[0]})---------")
        stats = summarize(data, "point")
        for k, (m, s) in stats.items():
            print(f"{k}: {m:.4f} ± {s:.4f}")
        pos, _ = point_costs(data)
        groups_pos[name] = pos
        groups_time[name] = data[:, 18]
    out = box_plot(groups_time, os.path.join(logdir, "task_time_box.png"))
    out2 = box_plot(groups_pos, os.path.join(logdir, "pos_error_box.png"))
    if out:
        print(f"\nbox plots -> {out}, {out2}")


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "plot/point")
