#!/usr/bin/env python3
"""Panda headline benchmark: sustained pick-place replan rate at the
reference workload (K=200 samples x T=12 horizon, config/mppi/panda.yaml:6-7)
with the on-device AIF gate chunk (ReactiveTAMP._run_chunk_panda_impl).

Every tick is a FULL K-rollout replan + AIF stage gate + real-env step; the
on-device success latch only zeroes the applied action (the replan itself
runs every tick), so the measured rate is the sustained planning rate, not
an early-exit artifact.  Chunks are dispatched as chained device futures —
the host never syncs until the end, so the host round trip is paid once,
not per chunk.

Baseline class: the reference's logged motion-planner rate is 12.9-21.2 Hz
mean per scenario on an NVIDIA GPU via Isaac Gym (BASELINE.md); its panda
config runs the same K=200 at T=12.  vs_baseline uses the best scenario
mean, 21.2 Hz.

Prints ONE JSON line and writes PANDA_BENCH.json at the repo root:
  {"metric": "m3p2i_replan_rate_panda_K200_T12_multimodal", "value": N, ...}
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

BASELINE_HZ = 21.2  # best reference scenario mean (plot/point/*.npy col 16)


def main(argv) -> None:
    out = "PANDA_BENCH.json"
    overrides = ["multi_modal=True"]
    for a in argv:
        if a.startswith("out="):
            out = a.split("=", 1)[1]
        elif a == "platform=cpu":
            import jax

            jax.config.update("jax_platforms", "cpu")
        else:
            # config overrides, e.g. mppi.grad_refine_unroll=True
            overrides.append(a)

    import jax

    from m3p2i_aip_tpu.config.config_store import load_config
    from m3p2i_aip_tpu.tamp.sim_loop import SimLoop

    cfg = load_config("config_panda", overrides)
    loop = SimLoop(cfg)
    loop.warmup(50)
    tamp = loop.tamp

    chunk = int(os.environ.get("M3P2I_BENCH_CHUNK", "200"))
    n = int(os.environ.get("M3P2I_BENCH_TICKS", "800"))

    def run(n_ticks):
        """n_ticks panda chunks, carries chained as device futures."""
        ms, rs = tamp.mppi_state, loop.state
        stage = 0
        zs = tamp.zup_zs0()
        done = 0
        while done < n_ticks:
            ms, rs, stage, zs, _d, views, _st, _dn = tamp.run_chunk_panda(
                ms, rs, stage, zs, chunk
            )
            done += chunk
        jax.block_until_ready(views)
        return views

    run(2 * chunk)  # compile + settle (2nd chunk catches signature drift)
    t0 = time.perf_counter()
    run(n)
    dt = time.perf_counter() - t0

    hz = n / dt
    rec = {
        "metric": "m3p2i_replan_rate_panda_K200_T12_multimodal",
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
