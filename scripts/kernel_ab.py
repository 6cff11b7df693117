#!/usr/bin/env python3
"""Whole-program A/B of the GPU kernels on the main path.

Ticks/s of the chunked point push_pull tick (K=200 x T=15, multi-modal,
gates off) with and without each Triton kernel, all variants in ONE process,
timed in turns (A, B, B, A) so drift in clocks or power hits both sides:

  xla      no kernel (plain XLA rollout + while-loop weights)
  rollout  the rollout kernel only
  weights  the weight kernel only
  both     both kernels (the default on a GPU)

    python scripts/kernel_ab.py [--ticks 400] [--chunk 100] [--trace DIR]

``--trace DIR`` also profiles one chunk of ``xla`` and of ``both`` and prints,
per variant, the device→host copies and the busiest device operations
(the host-polled while loops show up as one copy per loop iteration).
Prints one line per timed run and a JSON summary as the last line.
"""
import argparse
import collections
import glob
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

POINT_MAIN = ["task=push_pull", "multi_modal=True", "goal=[-3.75,-3.75]"]


def build(variant: str, chunk: int):
    import jax

    from m3p2i_aip_tpu.config.config_store import load_config
    from m3p2i_aip_tpu.tamp.sim_loop import SimLoop

    loop = SimLoop(load_config("config_point", POINT_MAIN))
    mp = loop.tamp.motion_planner
    if variant in ("xla", "weights"):
        mp.set_rollout_override(None)
    if variant in ("xla", "rollout"):
        mp.use_pallas = False
    loop.warmup(50)
    loop.tamp.task_planner.check_task_success = lambda view: False
    loop.tamp.device_gate = False
    t0 = time.perf_counter()
    loop.run_chunked(chunk, chunk=chunk)
    jax.block_until_ready(loop.state)
    return loop, time.perf_counter() - t0


def timed(loop, ticks: int, chunk: int) -> float:
    import jax

    t0 = time.perf_counter()
    for _ in range(ticks // chunk):
        loop.run_chunked(chunk, chunk=chunk)
    jax.block_until_ready(loop.state)
    return ticks / (time.perf_counter() - t0)


def trace_summary(loop, chunk: int, out_dir: str, top: int = 12) -> dict:
    """Profile one chunk; count device->host copies and rank device ops."""
    import jax

    os.makedirs(out_dir, exist_ok=True)
    with jax.profiler.trace(out_dir):
        loop.run_chunked(chunk, chunk=chunk)
        jax.block_until_ready(loop.state)
    path = sorted(glob.glob(os.path.join(out_dir, "**", "*.xplane.pb"), recursive=True))[-1]
    data = jax.profiler.ProfileData.from_file(path)
    dtoh, per_op, busy = 0, collections.Counter(), 0.0
    for plane in data.planes:
        is_dev = plane.name.startswith("/device:GPU")
        for line in plane.lines:
            for ev in line.events:
                name = ev.name
                if "d2h" in name.lower():  # e.g. "MemcpyD2H"
                    dtoh += 1
                if is_dev:
                    per_op[name] += ev.duration_ns
                    busy += ev.duration_ns
    return {
        "device_to_host_copies": dtoh,
        "device_event_ns_total": busy,
        "top_device_ops_ns": per_op.most_common(top),
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ticks", type=int, default=400)
    ap.add_argument("--chunk", type=int, default=100)
    ap.add_argument("--trace", default=None)
    args = ap.parse_args()

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"kernel_ab: needs an NVIDIA GPU, JAX found {dev.platform!r}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(f"card (name, power limit): {card}", flush=True)

    loops, setup = {}, {}
    for v in ("xla", "rollout", "weights", "both"):
        loops[v], setup[v] = build(v, args.chunk)
        print(f"{v}: set-up {setup[v]:.1f} s", flush=True)

    rates = collections.defaultdict(list)
    for a, b in (("xla", "rollout"), ("xla", "weights"), ("xla", "both")):
        for v in (a, b, b, a):
            r = timed(loops[v], args.ticks, args.chunk)
            rates[f"{a}_vs_{b}:{v}"].append(r)
            print(f"{a} vs {b}: {v} {r:.1f} ticks/s", flush=True)

    summary = {
        "card": card,
        "K": 200, "T": 15, "ticks": args.ticks, "chunk": args.chunk,
        "setup_s": setup,
        "ticks_per_s": dict(rates),
    }
    if args.trace:
        for v in ("xla", "both"):
            s = trace_summary(loops[v], args.chunk, os.path.join(args.trace, v))
            summary[f"trace_{v}"] = s
            print(f"trace {v}: {json.dumps(s)}", flush=True)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
