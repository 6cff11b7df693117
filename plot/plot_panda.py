#!/usr/bin/env python3
"""Offline statistics over panda-env experiment logs.

Parity target: ``src/m3p2i_aip/plot/plot_panda.py`` — 15-column rows
(timestamp, cube pose 7, goal pose 7; analysis/run_logger.finalize_panda_row),
cube-vs-goal position/orientation errors, mean ± std + box plots.

    python3 plot/plot_panda.py [logdir]
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

from m3p2i_aip_tpu.analysis import panda_costs, summarize
from m3p2i_aip_tpu.analysis.stats import box_plot


def main(logdir: str = "plot/panda") -> None:
    files = sorted(glob.glob(os.path.join(logdir, "*.npy")))
    if not files:
        print(f"no .npy logs under {logdir}; run scripts/run_experiments.py first")
        return
    groups = {}
    for f in files:
        name = os.path.splitext(os.path.basename(f))[0]
        data = np.load(f)
        print(f"---------{name} (n={data.shape[0]})---------")
        stats = summarize(data, "panda")
        for k, (m, s) in stats.items():
            print(f"{k}: {m:.4f} ± {s:.4f}")
        pos, _ = panda_costs(data)
        groups[name] = pos
    out = box_plot(groups, os.path.join(logdir, "pos_error_box.png"))
    if out:
        print(f"\nbox plot -> {out}")


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "plot/panda")
