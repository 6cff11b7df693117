#!/usr/bin/env python3
"""Recompute RESULTS.md row statistics from a committed experiment log.

A RESULTS row must be reproducible from its shipped
artifact.  This script is the one-command recompute: schema is sniffed from
the column count (19 = point, 15 = panda, 11 = albert — see
analysis/run_logger.py), stats come from the same ``analysis.summarize``
formulas the plot scripts use (themselves the reference's formulas,
``/root/reference/src/m3p2i_aip/plot/plot_point.py:37-45``).

    python scripts/recompute_results.py plot/albert/push_reach.npy [more.npy]
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from m3p2i_aip_tpu.analysis import summarize

_SCHEMAS = {19: "point", 15: "panda", 11: "albert"}


def recompute(path: str) -> None:
    data = np.load(path)
    env = _SCHEMAS.get(data.shape[1])
    if env is None:
        raise SystemExit(
            f"{path}: {data.shape[1]} columns matches no known schema "
            f"({_SCHEMAS})"
        )
    print(f"--- {path} (n={data.shape[0]}, schema={env}) ---")
    for k, (m, s) in summarize(data, env).items():
        print(f"{k}: {m:.4f} +- {s:.4f}")
    if env == "albert":
        # per-axis EE breakdown for the push_reach hover-floor note
        ee, goal = data[:, 1:4], data[:, 6:9]
        err = np.linalg.norm(ee - goal, axis=1)
        xy = np.linalg.norm(ee[:, :2] - goal[:, :2], axis=1)
        z = np.abs(ee[:, 2] - goal[:, 2])
        print(
            f"ee xy: {xy.mean():.4f} +- {xy.std():.4f}  "
            f"ee z: {z.mean():.4f} +- {z.std():.4f}  worst: {err.max():.4f}"
        )
        print(f"success: {int(data[:, 9].sum())}/{len(data)}")


if __name__ == "__main__":
    if len(sys.argv) < 2:
        raise SystemExit(__doc__)
    for p in sys.argv[1:]:
        recompute(p)
