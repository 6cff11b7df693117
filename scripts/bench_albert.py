#!/usr/bin/env python3
"""Albert replan-rate benchmark.

Measures the sustained full-replan rate of the 13-DOF mobile manipulator on
its hardest task (``push_reach``: base pushes the box through the PBD
contact solver while the arm tracks a hover target riding the box) at the
reference-class workload K=200 x T=12.  Every tick is a full K-rollout
replan (XLA scan rollout — the albert has no fused kernel) + real-env step, chunked on-device like the point/panda benches.

Prints ONE JSON line and writes ALBERT_BENCH.json at the repo root.
Baseline class: the reference publishes no albert tasks at all (it ships
only the asset), so vs_baseline uses the same 21.2 Hz best point-scenario
mean as the other benches — the closest thing to a reference number.
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

BASELINE_HZ = 21.2  # best reference scenario mean (plot/point/*.npy col 16)


def main(argv) -> None:
    out = "ALBERT_BENCH.json"
    overrides = ["task=push_reach", "goal=[3.0,0.0,0.6]"]
    for a in argv:
        if a.startswith("out="):
            out = a.split("=", 1)[1]
        elif a == "platform=cpu":
            import jax

            jax.config.update("jax_platforms", "cpu")
        else:
            overrides.append(a)

    import jax

    from m3p2i_aip_tpu.config.config_store import load_config
    from m3p2i_aip_tpu.tamp.sim_loop import SimLoop

    cfg = load_config("config_albert", overrides)
    loop = SimLoop(cfg)
    loop.warmup(20)
    # sustained replan rate: disable both success gates (host + device) so
    # every tick replans regardless of box/goal distance, like bench.py
    loop.tamp.task_planner.check_task_success = lambda view: False
    loop.tamp.device_gate = False

    chunk = int(os.environ.get("M3P2I_BENCH_CHUNK", "100"))
    n = int(os.environ.get("M3P2I_BENCH_TICKS", "400"))

    for _ in range(2):  # compile + settle (2nd catches signature drift)
        loop.run_chunked(chunk, chunk=chunk)

    t0 = time.perf_counter()
    done = 0
    while done < n:
        loop.run_chunked(chunk, chunk=chunk)
        done += chunk
    dt = time.perf_counter() - t0

    hz = done / dt
    rec = {
        "metric": (
            f"m3p2i_replan_rate_albert_K{int(cfg.mppi.num_samples)}"
            f"_T{int(cfg.mppi.horizon)}_push_reach"
        ),
        "value": round(hz, 2),
        "unit": "Hz",
        "vs_baseline": round(hz / BASELINE_HZ, 2),
        "platform": jax.devices()[0].platform,
        "K": int(cfg.mppi.num_samples),
        "T": int(cfg.mppi.horizon),
        "chunk": chunk,
        "ticks": n,
        "use_pallas": bool(loop.tamp.motion_planner.rollout_override is not None),
    }
    line = json.dumps(rec)
    print(line)
    if out != "-":
        with open(out, "w") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main(sys.argv[1:])
