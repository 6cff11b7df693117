#!/usr/bin/env python3
"""Headline benchmark: M3P2I replanning rate on the reference workload.

Measures the full replanning step — K=200 rollouts x T=15 horizon of the JAX
physics engine, multi-modal push/pull costs + suction, importance-weighted
update, trajectory extraction — on the point env, end to end (host task
planner included), on an NVIDIA GPU.  With no GPU it exits non-zero: a CPU
number is not a device number.

Baseline: the reference's logged motion-planner rate is 12.9-21.2 Hz mean per
scenario at the same K=200 x T=15 on an NVIDIA GPU via Isaac Gym
(BASELINE.md "Throughput / rates"); vs_baseline uses the best scenario mean,
21.2 Hz.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "Hz", "vs_baseline": N,
   "device": {"platform": ..., "kind": ..., "count": N}}
"""
import json
import os
import sys
import time

BASELINE_HZ = 21.2  # best reference scenario mean (plot/point/*.npy col 16)


def main() -> None:
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py: needs an NVIDIA GPU, JAX found {dev.platform!r}")

    from m3p2i_aip_tpu.config.config_store import load_config
    from m3p2i_aip_tpu.tamp.sim_loop import SimLoop

    cfg = load_config(
        "config_point",
        ["task=push_pull", "multi_modal=True", "goal=[-3.75,-3.75]"],
    )
    loop = SimLoop(cfg)
    loop.warmup(50)
    # keep replanning forever: the benchmark measures sustained replan rate,
    # not task completion (the box reaches the goal within the settle phase).
    # Both gates off: the host check and the on-device early-exit latch.
    loop.tamp.task_planner.check_task_success = lambda view: False
    loop.tamp.device_gate = False

    # chunked execution: every tick is a full K x T replan + real-env step,
    # scanned on-device so dispatch latency is amortized (the reference pays
    # an RPC + state sync + 2 queries per tick instead, sim.py:37-58).
    # Default mode: double-buffered chunks (SimLoop._run_chunked_pipelined)
    # overlap the chunk-boundary fetch and view unpack with on-device
    # compute; tick math is identical (tests/test_tamp_integration.py).
    # --serial / M3P2I_BENCH_SERIAL=1 measures the unpipelined mode.
    pipelined = not (
        "--serial" in sys.argv or os.environ.get("M3P2I_BENCH_SERIAL") == "1"
    )
    chunk = int(os.environ.get("M3P2I_BENCH_CHUNK", "200"))
    for _ in range(2):  # compile + settle (2nd round catches signature drift)
        loop.run_chunked(chunk, chunk=chunk)

    n = 800
    t0 = time.perf_counter()
    if pipelined:
        loop.run_chunked(n, chunk=chunk, pipelined=True)
        done = n
    else:
        done = 0
        while done < n:
            loop.run_chunked(chunk, chunk=chunk)
            done += chunk
    jax.block_until_ready(loop.state)
    dt = time.perf_counter() - t0

    hz = done / dt
    line = {
        "metric": "m3p2i_replan_rate_point_K200_T15_multimodal",
        "value": round(hz, 2),
        "unit": "Hz",
        "vs_baseline": round(hz / BASELINE_HZ, 2),
        "device": {
            "platform": dev.platform,
            "kind": dev.device_kind,
            "count": len(jax.devices()),
        },
    }
    print(json.dumps(line))


if __name__ == "__main__":
    main()
