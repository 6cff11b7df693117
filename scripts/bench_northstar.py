#!/usr/bin/env python3
"""North-star workload benchmark: K=500 x T=30 per-tick full replan rate.

SURVEY.md section 6 sets the north star at >=100 Hz replanning with
K=500 samples x T=30 horizon per mode on one accelerator.  Same methodology as
bench.py (chunked scan, success gates off, every tick a full replan + real
step), different workload shape.  Usage:

    python scripts/bench_northstar.py [K] [T] [chunk]
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    k = int(sys.argv[1]) if len(sys.argv) > 1 else 500
    t = int(sys.argv[2]) if len(sys.argv) > 2 else 30
    chunk = int(sys.argv[3]) if len(sys.argv) > 3 else 100

    if os.environ.get("M3P2I_BENCH_CPU") == "1":
        # explicit CPU run; jax may already be imported, so the platform
        # is chosen through its config
        import jax

        jax.config.update("jax_platforms", "cpu")

    from m3p2i_aip_tpu.config.config_store import load_config
    from m3p2i_aip_tpu.tamp.sim_loop import SimLoop

    cfg = load_config(
        "config_point",
        [
            "task=push_pull",
            "multi_modal=True",
            "goal=[-3.75,-3.75]",
            f"mppi.num_samples={k}",
            f"mppi.horizon={t}",
        ],
    )
    loop = SimLoop(cfg)
    loop.warmup(50)
    loop.tamp.task_planner.check_task_success = lambda view: False
    loop.tamp.device_gate = False

    for _ in range(2):  # compile + settle
        loop.run_chunked(chunk, chunk=chunk)

    n = 400
    t0 = time.perf_counter()
    done = 0
    while done < n:
        loop.run_chunked(chunk, chunk=chunk)
        done += chunk
    dt = time.perf_counter() - t0

    hz = done / dt
    print(
        json.dumps(
            {
                "metric": f"m3p2i_replan_rate_point_K{k}_T{t}_multimodal",
                "value": round(hz, 2),
                "unit": "Hz",
                "vs_target": round(hz / 100.0, 2),
            }
        )
    )


if __name__ == "__main__":
    main()
