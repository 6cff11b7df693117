#!/usr/bin/env python3
"""Smoke run of the reactive TAMP system on an NVIDIA GPU.

    python chip_smoke.py               # one card: phases 1-5
    python chip_smoke.py --four-cards  # four cards: the sharded phase only

Phases (one process; any failure exits non-zero, no phase carries on):
  1. device stamp: JAX's platform must be ``gpu``; the card's name and power
     limit (read by an ``nvidia-smi`` child that stays off JAX) and the
     compile-cache directory in use;
  2. main path: point push_pull multi-modal, K=200 x T=15, built as a user
     builds it (load_config -> SimLoop -> warmup -> run_chunked) with the GPU
     kernels live; set-up time, steady ticks/s, state finite and inside the
     arena; then navigation with the success gate live reaches its goal;
  3. kernel parity at full widths: the ``gpu``-marked tests of
     tests/test_pallas.py (compiled Triton kernels vs the XLA reference under
     highest matmul precision, batched vs serial, k0 shard offsets);
  4. one fused tick on the GPU (kernels) vs the same tick on the CPU (plain
     XLA path), same state and seed;
  5. panda, albert and a B=20 point seed batch: one full-width chunk each on
     their XLA paths, state finite and views unpacked.
  6. (--four-cards) the seed-axis fleet (B=8 over 4 cards) vs the same seeds
     unsharded on card 0, and the K-axis mesh (K=200 over 4 cards, rollout
     kernel under shard_map) vs the unsharded command.

The last line of stdout is one JSON object:
    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}
"""
import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
POINT_MAIN = ["task=push_pull", "multi_modal=True", "goal=[-3.75,-3.75]"]
ARENA = 3.8  # |x|, |y| bound of the robot and box (tests/test_tamp_integration.py)


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def card_stamp() -> str:
    """Name and power limit of each card, from a child that stays off JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


def finite_tree(tree) -> bool:
    import jax
    import numpy as np

    return all(
        bool(np.all(np.isfinite(np.asarray(x))))
        for x in jax.tree_util.tree_leaves(tree)
        if np.issubdtype(np.asarray(x).dtype, np.floating)
    )


def finite_view(view: dict) -> bool:
    import numpy as np

    return all(bool(np.all(np.isfinite(np.asarray(v)))) for v in view.values())


# ----------------------------------------------------------------- phase 2
def phase_main_path(card: str):
    import jax
    import numpy as np

    from m3p2i_aip_tpu.config.config_store import load_config
    from m3p2i_aip_tpu.tamp.sim_loop import SimLoop

    cfg = load_config("config_point", POINT_MAIN)
    t0 = time.perf_counter()
    loop = SimLoop(cfg)
    mp = loop.tamp.motion_planner
    check(mp.K == 200 and mp.T == 15, f"main path is K={mp.K} x T={mp.T}")
    check(
        mp.use_pallas and mp.rollout_override is not None,
        "the GPU kernels are not live on the main path",
    )
    loop.warmup(50)
    # sustained replanning: both success gates off, every tick a full replan
    loop.tamp.task_planner.check_task_success = lambda view: False
    loop.tamp.device_gate = False
    chunk = 100
    loop.run_chunked(chunk, chunk=chunk)  # compiles the chunk program
    jax.block_until_ready(loop.state)
    setup = time.perf_counter() - t0
    n = 400
    t1 = time.perf_counter()
    done = 0
    while done < n:
        loop.run_chunked(chunk, chunk=chunk)
        done += chunk
    jax.block_until_ready(loop.state)
    rate = n / (time.perf_counter() - t1)
    log(f"main path point push_pull K=200 x T=15: set-up {setup:.1f} s, "
        f"steady {rate:.1f} ticks/s (chunks of {chunk}) on {card}")

    check(finite_tree(loop.state), "main path state is not finite")
    pos = np.asarray(loop.log.robot_pos + loop.log.box_pos)
    check(np.all(np.isfinite(pos)), "non-finite robot/box position in the log")
    worst = float(np.max(np.abs(pos)))
    log(f"main path: {loop.log.steps} ticks logged, max |x|,|y| of robot "
        f"and box {worst:.3f} (bound {ARENA})")
    check(worst <= ARENA, f"robot or box left the arena: {worst:.3f}")

    # navigation with the success gate live must reach its goal
    cfg = load_config("config_point", ["task=navigation", "goal=[-3,3]"])
    nav = SimLoop(cfg)
    nav.warmup(50)
    t2 = time.perf_counter()
    nav.run_chunked(cfg.n_steps, chunk=25)
    final = np.asarray(nav.log.robot_pos[-1])
    log(f"navigation goal [-3, 3]: success at tick {nav.log.success_step} of "
        f"{cfg.n_steps}, final robot position {final.round(3).tolist()} "
        f"({time.perf_counter() - t2:.1f} s incl. compile)")
    check(nav.log.success_step is not None, "navigation did not reach its goal")
    return loop


# ----------------------------------------------------------------- phase 3
def phase_kernel_parity() -> None:
    import pytest

    class Count:
        passed = skipped = 0

        def pytest_runtest_logreport(self, report):
            if report.when == "call" and report.passed:
                self.passed += 1
            if report.skipped:
                self.skipped += 1

    count = Count()
    rc = pytest.main(
        ["-q", "-s", "-m", "gpu", "-p", "no:cacheprovider",
         os.path.join(ROOT, "tests", "test_pallas.py")],
        plugins=[count],
    )
    log(f"kernel parity tests: rc={int(rc)} passed={count.passed} "
        f"skipped={count.skipped}")
    check(rc == 0 and count.passed >= 2 and count.skipped == 0,
          "kernel parity tests failed or did not run")


# ----------------------------------------------------------------- phase 4
def phase_gpu_vs_cpu_tick(loop) -> None:
    """``loop``: the main-path SimLoop after its 500 ticks (a scene in
    motion, box in contact)."""
    import jax
    import numpy as np

    from m3p2i_aip_tpu.config.config_store import load_config
    from m3p2i_aip_tpu.tamp.reactive_tamp import ReactiveTAMP

    gpu = loop.tamp
    state, ms = loop.state, gpu.mppi_state
    task = gpu.tamp_interface_view(loop._view)
    a_gpu, _, _ = gpu.motion_planner.command(ms, state, task)

    cpu_dev = jax.devices("cpu")[0]
    to_cpu = lambda t: jax.device_put(jax.device_get(t), cpu_dev)
    with jax.default_device(cpu_dev):
        cpu = ReactiveTAMP(
            load_config("config_point", POINT_MAIN + ["mppi.use_pallas=False"])
        )
        check(cpu.motion_planner.rollout_override is None, "CPU tick uses a kernel")
        a_cpu, _, _ = cpu.motion_planner.command(
            to_cpu(ms), to_cpu(state), to_cpu(task)
        )
    a_gpu, a_cpu = np.asarray(a_gpu), np.asarray(a_cpu)
    err = float(np.max(np.abs(a_gpu - a_cpu)))
    # both paths run the same f32 math with contractions pinned to HIGHEST;
    # what remains is summation order (kernel vs XLA contact sums, GPU vs
    # CPU reductions) through one weighted mean of 200 samples.  1e-3 on
    # actions bounded by |u| <= 3 catches TF32 (~1e-3 relative per
    # contraction, compounding) and any semantic drift.
    tol = 1e-3
    log(f"fused tick GPU (kernels) vs CPU (XLA): action plan [{a_gpu.shape[0]} x "
        f"{a_gpu.shape[1]}] max abs diff {err:.3e} (tol {tol:g}); first action "
        f"gpu {a_gpu[0].round(4).tolist()} cpu {a_cpu[0].round(4).tolist()}")
    check(np.all(np.isfinite(a_gpu)) and err <= tol, "GPU and CPU ticks disagree")


# ----------------------------------------------------------------- phase 5
def phase_families() -> None:
    import jax

    from m3p2i_aip_tpu.config.config_store import load_config_from_argv
    from m3p2i_aip_tpu.tamp.batch_loop import BatchSimLoop
    from m3p2i_aip_tpu.tamp.sim_loop import SimLoop

    runs = [
        ("panda pick-place K=200 x T=12 refine_iters=3", ["-cn", "config_panda"]),
        ("albert push_reach K=128 x T=12",
         ["-cn", "config_albert", "task=push_reach", "goal=[3.0,0.0,0.6]"]),
    ]
    for name, argv in runs:
        cfg = load_config_from_argv(argv)
        t0 = time.perf_counter()
        loop = SimLoop(cfg)
        loop.warmup(20)
        loop.run_chunked(20, chunk=20)
        jax.block_until_ready(loop.state)
        check(finite_tree(loop.state), f"{name}: state is not finite")
        check(finite_view(loop._view), f"{name}: view is not finite")
        log(f"{name}: {loop.log.steps} ticks, view keys "
            f"{sorted(loop._view)}, {time.perf_counter() - t0:.1f} s incl. compile")

    cfg = load_config_from_argv(POINT_MAIN)
    t0 = time.perf_counter()
    batch = BatchSimLoop(cfg, seeds=list(range(20)))
    check(batch.tamp.motion_planner.rollout_override is not None,
          "seed batch lost the rollout kernel")
    batch.warmup(20)
    logs = batch.run_chunked(20, chunk=20)
    jax.block_until_ready(batch.state)
    check(len(logs) == 20 and finite_tree(batch.state), "seed batch state")
    check(all(finite_view(v) for v in batch.views), "seed batch views")
    log(f"point seed batch B=20 K=200 x T=15: {sum(l.steps for l in logs)} "
        f"seed-ticks, {time.perf_counter() - t0:.1f} s incl. compile")


# ----------------------------------------------------------------- phase 6
def phase_four_cards() -> None:
    import jax
    import numpy as np

    from m3p2i_aip_tpu.config.config_store import load_config
    from m3p2i_aip_tpu.parallel import make_mesh, shard_planner
    from m3p2i_aip_tpu.tamp.batch_loop import BatchSimLoop
    from m3p2i_aip_tpu.tamp.reactive_tamp import ReactiveTAMP

    devs = jax.devices()
    check(len(devs) == 4, f"--four-cards needs 4 GPUs, JAX sees {len(devs)}")

    # seed-axis fleet: B=8 over the 4 cards vs the same seeds on card 0.
    # Sharded mode runs the XLA rollout (GSPMD cannot partition a kernel
    # call), so the unsharded reference runs it too: only the placement
    # differs between the two.
    cfg = load_config("config_point", ["task=push"])
    seeds = list(range(8))
    ref = BatchSimLoop(cfg, seeds=seeds)
    ref.tamp.motion_planner.set_rollout_override(None)
    ref.tamp.motion_planner.use_pallas = False
    fleet = BatchSimLoop(cfg, seeds=seeds, shard=True)  # over jax.devices()
    outs = []
    for b in (ref, fleet):
        t0 = time.perf_counter()
        b.warmup(20)
        b.run_chunked(20, chunk=10)
        jax.block_until_ready(b.state)
        outs.append((np.asarray(jax.device_get(b.state.q)), time.perf_counter() - t0))
    placement = {d.id for d in fleet.state.q.sharding.device_set}
    err = float(np.max(np.abs(outs[0][0] - outs[1][0])))
    tol = 1e-3
    log(f"seed fleet B=8 K=200 x T=15 over cards {sorted(placement)}: robot q "
        f"max abs diff vs unsharded {err:.3e} (tol {tol:g}); "
        f"{outs[1][1]:.1f} s vs {outs[0][1]:.1f} s incl. compile")
    check(len(placement) == 4 and err <= tol, "seed fleet disagrees with card 0")

    # K-axis mesh: K=200 over the 4 cards, the rollout kernel under
    # shard_map, vs the unsharded command on card 0
    point = load_config("config_point", POINT_MAIN)
    un = ReactiveTAMP(point)
    sh = ReactiveTAMP(point)
    shard_planner(sh.motion_planner, make_mesh(devs))
    check(sh.motion_planner.rollout_override is not None, "mesh lost the kernel")
    state = un.env.init_state()
    a_un = np.asarray(un.run_tamp(state))
    a_sh = np.asarray(sh.run_tamp(state))
    err = float(np.max(np.abs(a_un - a_sh)))
    tol = 1e-4
    log(f"K-axis mesh K=200 over 4 cards (kernel under shard_map): action max "
        f"abs diff vs unsharded {err:.3e} (tol {tol:g})")
    check(np.all(np.isfinite(a_sh)) and err <= tol, "K-axis mesh disagrees")


# ------------------------------------------------------------------- main
def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card sharded phase")
    args = ap.parse_args()

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs an NVIDIA GPU, JAX found {dev.platform!r}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        from m3p2i_aip_tpu.utils import compile_cache
    except ImportError as e:
        print(f"chip_smoke: the m3p2i_aip_tpu package is missing: {e}",
              file=sys.stderr)
        return 2

    card = card_stamp()
    log(f"card (name, power limit): {card}")
    log(f"jax {jax.__version__}: {len(jax.devices())} x {dev.device_kind}")
    log(f"compile cache: {compile_cache.enable()}")

    def run(name, fn, *a):
        t0 = time.perf_counter()
        log(f"--- phase {name}")
        out = fn(*a)
        log(f"--- phase {name} ok ({time.perf_counter() - t0:.1f} s)")
        return out

    if args.four_cards:
        run("four cards", phase_four_cards)
    else:
        loop = run("main path", phase_main_path, card)
        run("kernel parity", phase_kernel_parity)
        run("gpu vs cpu tick", phase_gpu_vs_cpu_tick, loop)
        run("families", phase_families)

    log(f"card (name, power limit): {card}")
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": dev.platform,
            "kind": dev.device_kind,
            "count": len(jax.devices()),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
