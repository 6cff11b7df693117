#!/usr/bin/env python3
"""Benchmark: serial vs vectorized (BatchSimLoop) seed-batch evaluation.

The reference evaluates its n=20 quality batches strictly serially — one
Isaac Gym run per seed, back to back (SURVEY.md §4.3).  This framework runs
the whole batch as ONE vmapped chunk program (tamp/batch_loop.py): B seeds
share each device dispatch and each fetch, the rollout batch is effectively
B x K, and the fused Pallas kernels stay live under the vmap (grid=(B,)
custom_vmap rules).  This script measures both paths end-to-end (warmup +
run-to-success for every seed, the run_experiments.py protocol) in one
process and prints one JSON line:

    {"metric": "batch_eval_speedup", "serial_s": ..., "batched_s": ...,
     "value": <speedup>, "B": ..., ...}

Run on the GPU (or, with platform=cpu, on the CPU):
    python scripts/bench_batch_eval.py [n_runs=20] [family=point|panda]
Artifact: BATCH_EVAL_BENCH.json / BATCH_EVAL_BENCH_PANDA.json at the repo
root (unless out=- is given).
"""
import json
import os
import sys
import time


sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from m3p2i_aip_tpu.config.config_store import load_config
from m3p2i_aip_tpu.tamp.batch_loop import BatchSimLoop
from m3p2i_aip_tpu.tamp.sim_loop import SimLoop

_CHUNK = 10
_WARMUP = 20


def _serial(loop, seeds, n_steps, is_panda):
    """One full seed sweep on an existing SimLoop (reset keeps the one
    traced+compiled planner across seeds)."""
    t0 = time.perf_counter()
    ticks = 0
    ok = 0
    for s in seeds:
        loop.reset(s)  # assigns cfg.mppi.seed_val and reseeds the sampler
        loop.warmup(_WARMUP)
        log = loop.run_chunked(n_steps, chunk=_CHUNK)
        if is_panda:
            loop.settle(150)  # rows log the released, settled cube
        ticks += log.steps
        ok += int(log.success_step is not None)
    return time.perf_counter() - t0, ticks, ok


def _batched(batch, seeds, n_steps, is_panda):
    """One full batched sweep on an existing BatchSimLoop."""
    t0 = time.perf_counter()
    batch.reset(seeds)
    batch.warmup(_WARMUP)
    logs = batch.run_chunked(n_steps, chunk=_CHUNK)
    if is_panda:
        batch.settle(150)
    ticks = sum(log.steps for log in logs)
    ok = sum(int(log.success_step is not None) for log in logs)
    return time.perf_counter() - t0, ticks, ok


def main(argv):
    n_runs = 20
    family = "point"
    out = None
    for a in argv:
        if a.startswith("n_runs="):
            n_runs = int(a.split("=", 1)[1])
        elif a.startswith("family="):
            family = a.split("=", 1)[1]
        elif a.startswith("out="):
            out = a.split("=", 1)[1]
        elif a == "platform=cpu":
            # explicit CPU run; jax may already be imported, so the
            # platform is chosen through its config
            import jax

            jax.config.update("jax_platforms", "cpu")
    seeds = list(range(n_runs))
    is_panda = family == "panda"
    if out is None:
        out = (
            "BATCH_EVAL_BENCH_PANDA.json" if is_panda else "BATCH_EVAL_BENCH.json"
        )
    config_name = "config_panda" if is_panda else "config_point"
    # the published case2 push scenario / the table pick-place
    ovr = [] if is_panda else ["task=push", "goal=[-1,-1]"]
    scenario = "pick-place chunk=10" if is_panda else "push goal=[-1,-1] chunk=10"

    import jax

    platform = jax.devices()[0].platform

    # Sweep 1 on each path pays its compiles (the serial tick at B=1 vs the
    # vmapped chunk at B=n_runs); sweep 2 reuses the SAME loop objects, so it
    # is the honest steady-state cost of another n_runs-seed batch.  Both
    # paths run the SAME rollout backend (the fused kernels vmap via their
    # grid=(B,) custom_vmap rules, ops/pallas_rollout.py).
    cfg_s = load_config(config_name, list(ovr))
    n_steps = int(cfg_s.n_steps)
    serial_loop = SimLoop(cfg_s)
    serial_s, serial_ticks, serial_ok = _serial(
        serial_loop, seeds, n_steps, is_panda
    )
    serial2_s, _, _ = _serial(serial_loop, seeds, n_steps, is_panda)

    cfg_b = load_config(config_name, list(ovr))
    batch = BatchSimLoop(cfg_b, seeds)
    batched_s, batched_ticks, batched_ok = _batched(
        batch, seeds, n_steps, is_panda
    )
    batched2_s, _, _ = _batched(batch, seeds, n_steps, is_panda)

    rec = {
        "metric": f"batch_eval_speedup_{family}",
        "value": round(serial2_s / batched2_s, 2),
        "unit": "x (serial / batched wall, warm)",
        "B": n_runs,
        "platform": platform,
        "task": scenario,
        "use_pallas": batch.tamp.motion_planner.rollout_override is not None,
        "serial_s": round(serial_s, 2),
        "batched_s": round(batched_s, 2),
        "serial_warm_s": round(serial2_s, 2),
        "batched_warm_s": round(batched2_s, 2),
        "cold_speedup": round(serial_s / batched_s, 2),
        "serial_ticks": serial_ticks,
        "batched_ticks": batched_ticks,
        "serial_success": f"{serial_ok}/{n_runs}",
        "batched_success": f"{batched_ok}/{n_runs}",
    }
    line = json.dumps(rec)
    print(line)
    if out != "-":
        with open(out, "w") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main(sys.argv[1:])
