"""End-to-end TAMP integration tests on CPU with small sample counts.

These are the automated versions of the reference's manual scenario runs
(README.md:74-143; SURVEY.md §4): each canonical task must reach its goal
within a generous step budget.  K is kept small for CI speed — the planner is
deterministic (halton-spline cached deltas), so these are stable.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from m3p2i_aip_tpu.config.config_store import load_config
from m3p2i_aip_tpu.tamp.sim_loop import SimLoop


def _run(overrides, max_steps, warmup=10):
    cfg = load_config("config_point", overrides)
    loop = SimLoop(cfg)
    loop.warmup(warmup)
    for i in range(max_steps):
        if loop.tick(i):
            return loop, i
    return loop, None


@pytest.mark.slow
def test_navigation_reaches_goal():
    loop, done = _run(
        ["task=navigation", "goal=[-3,3]", "mppi.num_samples=128"], 120
    )
    assert done is not None, f"nav failed; final pos {loop.log.robot_pos[-1]}"


@pytest.mark.slow
def test_push_reaches_goal():
    loop, done = _run(["task=push", "goal=[-1,-1]", "mppi.num_samples=128"], 200)
    assert done is not None, f"push failed; box at {loop.log.box_pos[-1]}"


@pytest.mark.slow
def test_pull_reaches_goal():
    loop, done = _run(["task=pull", "goal=[0,0]", "mppi.num_samples=128"], 200)
    assert done is not None, f"pull failed; box at {loop.log.box_pos[-1]}"


@pytest.mark.slow
def test_push_pull_multimodal_corner():
    loop, done = _run(
        [
            "task=push_pull",
            "multi_modal=True",
            "goal=[-3.75,-3.75]",
            "mppi.num_samples=128",
        ],
        300,
    )
    assert done is not None, f"push_pull failed; box at {loop.log.box_pos[-1]}"


@pytest.mark.slow
def test_heijn_navigation():
    """3-dof omni base (heijn.urdf robot family) reaches the nav goal."""
    cfg = load_config("config_heijn", ["goal=[-3,3]", "mppi.num_samples=128"])
    loop = SimLoop(cfg)
    loop.warmup(10)
    done = None
    for i in range(150):
        if loop.tick(i):
            done = i
            break
    assert done is not None, f"heijn nav failed at {loop.log.robot_pos[-1]}"


@pytest.mark.slow
def test_boxer_navigation():
    """Differential-drive base (boxer.urdf family, wheel-speed control)."""
    cfg = load_config("config_boxer", ["goal=[-3,3]", "mppi.num_samples=128"])
    loop = SimLoop(cfg)
    loop.warmup(10)
    done = None
    for i in range(600):
        if loop.tick(i):
            done = i
            break
    assert done is not None, f"boxer nav failed at {loop.log.robot_pos[-1]}"


@pytest.mark.slow
def test_boxer_staged_pure_push():
    """Pure push on the diff-drive base: the nonholonomic robot parks beside
    the box (fixed point, 1/20 without staging); the stall latch must fire,
    reposition behind the box, and the push must then reach the goal."""
    cfg = load_config(
        "config_boxer", ["task=push", "goal=[-1,-1]", "mppi.num_samples=128"]
    )
    loop = SimLoop(cfg)
    loop.warmup(10)
    done = None
    for i in range(900):
        if loop.tick(i):
            done = i
            break
    tpl = loop.tamp.task_planner
    assert tpl._pocket_stage == 2, "the staged repositioning never engaged"
    assert done is not None, f"boxer push failed; box at {loop.log.box_pos[-1]}"


@pytest.mark.slow
def test_panda_pick_place_sequence():
    """Full AIP-driven reach -> pick (grasp) -> place on the panda env.

    The automated version of the reference's `-cn config_panda` scenario
    (README.md:119-127): success = cube within 0.04 m of the goal during
    place (task_planner.py:100-107 semantics).
    """
    cfg = load_config("config_panda", ["mppi.num_samples=128"])
    loop = SimLoop(cfg)
    loop.warmup(20)
    attached_ever = False
    for i in range(900):
        done = loop.tick(i)
        attached_ever = attached_ever or float(loop.state.attached) > 0.5
        if done:
            break
    assert attached_ever, "cube was never grasped"
    assert done, (
        f"pick-place did not finish; task={loop.tamp.task_planner.task}, "
        f"cube={loop.state.body_pos[1]}"
    )


@pytest.mark.slow
def test_panda_reactive_pick_with_disturbance():
    """The 'reactive' scenario: the cube is shoved mid-reach (the scripted
    analogue of the reference's play_with_cube interaction) and the planner
    must re-reach and still complete the pick-place."""
    cfg = load_config("config_panda", ["mppi.num_samples=128"])
    loop = SimLoop(cfg)
    loop.warmup(20)
    done = False
    perturbed = False
    for i in range(900):
        if i == 40 and not perturbed:
            loop.perturb_body("cubeA", [0.0, 0.15, 0.0])
            perturbed = True
        done = loop.tick(i)
        if done:
            break
    assert perturbed and done, (
        f"reactive pick failed; task={loop.tamp.task_planner.task}, "
        f"cube={loop.state.body_pos[1]}"
    )


@pytest.mark.slow
def test_panda_multimodal_shelf_pick():
    """The reference's flagship multi-modal scenario: `-cn config_panda
    multi_modal=True cube_on_shelf=True` (README.md:128-137) — side-grasp
    mode wins on the shelf and the cube ends at the goal."""
    cfg = load_config(
        "config_panda",
        ["multi_modal=True", "cube_on_shelf=True", "mppi.num_samples=128"],
    )
    loop = SimLoop(cfg)
    loop.warmup(20)
    done = False
    for i in range(700):
        done = loop.tick(i)
        if done:
            break
    assert done, (
        f"shelf pick did not finish; task={loop.tamp.task_planner.task}, "
        f"cube={loop.state.body_pos[1]}"
    )


def test_box_never_tunnels_through_walls():
    """Physics sanity: hard shoves can't carry the box past the arena walls."""
    from m3p2i_aip_tpu.envs import make_env

    cfg = load_config("config_point")
    env = make_env(cfg)
    step = jax.jit(env.step)
    s = env.init_state()
    u = jnp.asarray([0.0, 3.0])
    for _ in range(120):
        s = step(s, u, env.zero_ext())
    pos = np.asarray(s.dyn_pos)
    assert np.all(np.abs(pos) < 3.85), f"tunneled: {pos}"
    assert np.all(np.isfinite(np.asarray(s.q)))


@pytest.mark.slow
def test_update_cov_adapts_and_is_consumed():
    """Covariance adaptation (reference mppi.py:508-516): cov_action must
    both adapt away from the pure-kappa drift AND change the sampled actions
    (i.e. _command_halton consumes sqrt(cov_action))."""
    from m3p2i_aip_tpu.tamp.reactive_tamp import ReactiveTAMP

    def build(update_cov):
        cfg = load_config(
            "config_point",
            [
                "task=navigation",
                "goal=[-3,3]",
                "mppi.num_samples=32",
                "mppi.exploration_noise=0",  # isolate the cov effect
                f"mppi.update_cov={update_cov}",
            ],
        )
        return ReactiveTAMP(cfg)

    on, off = build(True), build(False)
    state = on.env.init_state()
    a_on = a_off = None
    for i in range(4):
        a_on = np.asarray(on.run_tamp(state))
        a_off = np.asarray(off.run_tamp(state))
    cov = np.asarray(on.mppi_state.cov_action)
    # pure-drift prediction if the weighted update were broken (cov_update=0):
    # cov_t = 0.3^t * cov_0 + kappa * sum(0.3^i) — far below the initial 3.0
    drift_only = 0.3**4 * 3.0 + 0.005 * sum(0.3**i for i in range(4))
    assert not np.allclose(cov, drift_only, atol=0.05), cov
    assert not np.allclose(cov, 3.0), "covariance did not adapt"
    # the adapted scale must actually change the planned actions
    assert not np.allclose(a_on, a_off, atol=1e-5)
    # and the flag is rejected where it would be silently inert
    with pytest.raises(ValueError):
        load_cfg = load_config(
            "config_point",
            ["multi_modal=True", "mppi.update_cov=True", "mppi.num_samples=32"],
        )
        ReactiveTAMP(load_cfg)


def test_domain_randomization_friction_and_size():
    """Friction/size noise parity (isaacgym_wrapper.py:311-326,
    actor_utils.py:64-69): seeded noise perturbs the built params."""
    import numpy as np

    from m3p2i_aip_tpu.models import point_env
    from m3p2i_aip_tpu.sim.sim_config import load_env_cfgs

    cfg = load_config("config_point")
    actors = load_env_cfgs("point_env")
    for a in actors:
        if a.name == "box":
            a.noise_percentage_friction = 0.3
            a.noise_sigma_size = [0.005, 0.005, 0.0]
    base = point_env.build_params(actors, cfg.sim, rng=None)
    noised = point_env.build_params(
        actors, cfg.sim, rng=np.random.default_rng(0)
    )
    names = list(base.actor_names)
    slot = base.dyn_actor_idx.index(names.index("box"))
    assert float(base.dyn_friction[slot]) != float(noised.dyn_friction[slot])
    assert not np.allclose(
        np.asarray(base.dyn_half[slot]), np.asarray(noised.dyn_half[slot])
    )
    # noise must stay within the configured envelope
    assert abs(float(noised.dyn_friction[slot]) - 0.5) <= 0.3 * 0.5 + 1e-6


def test_fric_noise_cli_shorthand():
    """`fric_noise=0.3` on the CLI arms domain randomization end-to-end
    without YAML edits: the built scene carries per-actor noise amplitudes,
    and the planner draws per-sample friction scales."""
    import numpy as np

    from m3p2i_aip_tpu.envs import make_env
    from m3p2i_aip_tpu.tamp.reactive_tamp import ReactiveTAMP

    cfg = load_config(
        "config_point",
        ["task=push", "fric_noise=0.3", "mppi.num_samples=16", "mppi.horizon=8"],
    )
    env = make_env(cfg)
    noise = np.asarray(env.params.dyn_fric_noise)
    assert np.any(noise == 0.3), noise  # box + dyn-obs armed
    tamp = ReactiveTAMP(cfg, env=env)
    assert tamp.motion_planner.fric_inject is not None
    fs = np.asarray(tamp.motion_planner.init_state().fric_scale_k)
    assert fs.shape[0] == 16 and len(np.unique(fs)) > 1


def test_boxer_parity_ablation_flags():
    """mppi=boxer_parity restores pure reference behavior for the diff-drive
    base: beta adaptation off (the reference gates it panda-only,
    mppi.py:446-454) and the one-sided max(cos, 0) push align
    (cost_functions.py:57-58) — while the default boxer config keeps both
    extensions on and the point/panda autos stay untouched."""
    import jax.numpy as jnp

    from m3p2i_aip_tpu.tamp.reactive_tamp import ReactiveTAMP

    base = ReactiveTAMP(
        load_config("config_boxer", ["mppi.num_samples=16", "mppi.horizon=12"])
    )
    parity = ReactiveTAMP(
        load_config(
            "config_boxer",
            ["mppi=boxer_parity", "mppi.num_samples=16", "mppi.horizon=12"],
        )
    )
    assert base.motion_planner.beta_adapt is True
    assert base.objective.boxer_continuous_align is True
    assert parity.motion_planner.beta_adapt is False
    assert parity.objective.boxer_continuous_align is False
    assert parity.motion_planner.exploration_noise == 0.0

    # the ablated push cost really is the reference formula: parked BESIDE
    # the box (cos ~ 0) it reads flat (align term 0), while the continuous
    # extension still pays ~1.5 there
    state0 = base.env.init_state()
    box = state0.dyn_pos[base.objective.box_dyn_slot]
    # robot due north of the box, goal due west: cos(theta) is exactly 0
    state = state0.replace(
        q=jnp.concatenate([box + jnp.asarray([0.0, 1.0]), jnp.zeros(1)]),
        qd=jnp.zeros(3),
    )
    goal = box + jnp.asarray([-2.0, 0.0])
    align_base = float(base.objective._push(state, goal)) - float(
        3.0 * base.objective._dist_terms(state, goal)[0]
    )
    align_parity = float(parity.objective._push(state, goal)) - float(
        3.0 * parity.objective._dist_terms(state, goal)[0]
    )
    assert abs(align_parity) < 1e-5
    assert align_base > 1.0

    # point keeps beta adaptation off, panda on (reference auto gates)
    assert (
        ReactiveTAMP(
            load_config(
                "config_point", ["mppi.num_samples=16", "mppi.horizon=12"]
            )
        ).motion_planner.beta_adapt
        is False
    )


def test_per_sample_friction_randomization():
    """Per-rollout friction draws (isaacgym_wrapper.py:313-319):
    with noise_percentage_friction set, each of the K rollout states carries
    a DISTINCT friction scale, reseeding redraws them without a rebuild, and
    identical push actions physically diverge across samples."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from m3p2i_aip_tpu.envs import _make_point_env
    from m3p2i_aip_tpu.sim.sim_config import load_env_cfgs
    from m3p2i_aip_tpu.tamp.reactive_tamp import ReactiveTAMP

    cfg = load_config(
        "config_point",
        ["task=push", "goal=[-1,-1]", "mppi.num_samples=16", "mppi.horizon=8"],
    )
    actors = load_env_cfgs("point_env")
    for a in actors:
        if a.name == "box":
            a.noise_percentage_friction = 0.5
    env = _make_point_env(cfg, actors)
    tamp = ReactiveTAMP(cfg, env=env)
    mp = tamp.motion_planner
    assert mp.fric_inject is not None

    st = mp.init_state()
    fs = np.asarray(st.fric_scale_k)  # [K, D]
    slot = env.params.dyn_actor_idx.index(
        list(env.params.actor_names).index("box")
    )
    assert len(np.unique(fs[:, slot])) == mp.K, "K rollouts share a friction"
    assert np.all(np.abs(fs[:, slot] - 1.0) <= 0.5 + 1e-6)
    mp.reseed(5)
    assert not np.allclose(np.asarray(mp.init_state().fric_scale_k), fs)

    # identical actions through box contact must diverge across samples
    state = env.init_state().replace(q=jnp.asarray([0.0, 1.55]))  # at the box
    task = tamp.tamp_interface(state)
    sK = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (mp.K,) + x.shape), state
    )
    acts = jnp.broadcast_to(
        jnp.asarray([0.0, 2.0]), (mp.K, mp.T, 2)
    ).astype(jnp.float32)
    rollout = jax.jit(lambda s, a: mp._rollout(s, a, task))
    ch_rand, _ = rollout(mp.fric_inject(sK, jnp.asarray(fs)), acts)
    ch_ones, _ = rollout(
        mp.fric_inject(sK, jnp.ones_like(st.fric_scale_k)), acts
    )
    final_rand = np.asarray(ch_rand[:, -1])
    final_ones = np.asarray(ch_ones[:, -1])
    assert np.std(final_rand) > 1e-6, "friction draws did not affect physics"
    assert np.std(final_ones) < 1e-6, "nominal scales must keep rollouts equal"


def test_panda_device_gate_matches_host_planner():
    """The on-device AIF gate (ReactiveTAMP._panda_gate_device) must make the
    same reach/pick/place decisions as the host PLANNER_AIF_PANDA at every
    tick of a full episode (the gate is what lets the panda loop chunk)."""
    import jax.numpy as jnp

    cfg = load_config("config_panda", ["mppi.num_samples=64"])
    loop = SimLoop(cfg)
    loop.warmup(20)
    gate = jax.jit(loop.tamp._panda_gate_device)
    stage = jnp.asarray(0, jnp.int32)
    zs = loop.tamp.zup_zs0()
    stage_task = ("reach", "pick", "place")
    dev_seq, host_seq = [], []
    dev_zup, host_zup = [], []
    for i in range(400):
        # device gate BEFORE the host tick mutates the latches
        task_dev, stage, success_dev, zs = gate(loop.state, stage, zs)
        done = loop.tick(i)
        dev_seq.append(stage_task[int(stage)])
        host_seq.append(loop.tamp.task_planner.task)
        dev_zup.append(float(task_dev.zup_gate))
        host_zup.append(float(loop.tamp.task_planner.zup_gate))
        if done:
            assert bool(success_dev) or host_seq[-1] == "place", i
            break
    assert done
    # same switch sequence; the gate may LEAD the host AIF by one tick at
    # each switch (the AIF's belief update adds one tick of inertia after
    # the observation threshold flips), so compare with a <=2-tick slack
    mismatches = sum(d != h for d, h in zip(dev_seq, host_seq))
    assert mismatches <= 2 * 2, (mismatches, list(zip(dev_seq, host_seq)))

    def switches(seq):
        return [s for i, s in enumerate(seq) if i == 0 or seq[i - 1] != s]

    assert switches(dev_seq) == switches(host_seq), (
        switches(dev_seq), switches(host_seq)
    )
    # wedged-pick stall detector agrees too (both all-zero on a clean
    # table pick, same <=2-tick switch slack otherwise)
    zup_mismatch = sum(d != h for d, h in zip(dev_zup, host_zup))
    assert zup_mismatch <= 4, (zup_mismatch, dev_zup, host_zup)


def test_panda_chunked_completes_pick_place():
    """Chunked panda execution (on-device gate, scan of N ticks per dispatch)
    completes the pick-place task like the per-tick path."""
    cfg = load_config("config_panda", ["mppi.num_samples=64"])
    loop = SimLoop(cfg)
    loop.warmup(20)
    log = loop.run_chunked(600, chunk=10)
    assert log.success_step is not None, (
        f"chunked panda did not finish; task={loop.tamp.task_planner.task}"
    )


def test_simloop_reset_matches_fresh_build():
    """SimLoop.reset(seed) must reproduce a fresh SimLoop(cfg) bit-for-bit:
    the sampler seed lives in traced MPPIState data (MPPI.reseed), so a
    reset run shares the compiled program but not the trajectory."""
    import jax.numpy as jnp

    cfg = load_config(
        "config_point", ["task=navigation", "goal=[-3,3]", "mppi.num_samples=32"]
    )
    cfg.mppi.seed_val = 7
    fresh = SimLoop(cfg)
    fresh.warmup(5)
    for i in range(5):
        fresh.tick(i)
    ref_pos = np.asarray(fresh._view["robot_pos"])

    cfg2 = load_config(
        "config_point", ["task=navigation", "goal=[-3,3]", "mppi.num_samples=32"]
    )
    cfg2.mppi.seed_val = 3  # build with a DIFFERENT seed...
    loop = SimLoop(cfg2)
    loop.warmup(5)
    loop.tick(0)
    loop.reset(7)  # ...then reset to the reference seed
    loop.warmup(5)
    for i in range(5):
        loop.tick(i)
    assert np.allclose(np.asarray(loop._view["robot_pos"]), ref_pos, atol=1e-6)


@pytest.mark.slow
def test_point_chunked_early_exit_matches_per_tick():
    """The on-device early-exit chunk (lax.while_loop success latch,
    ReactiveTAMP._run_chunk_impl) must report the SAME success tick as the
    per-tick path — chunked task-time stats are exact, not quantized to the
    chunk length — and must not run past the latch."""
    overrides = ["task=push", "goal=[-1,-1]", "mppi.num_samples=64"]

    loop_a = SimLoop(load_config("config_point", overrides))
    loop_a.warmup(10)
    for i in range(300):
        if loop_a.tick(i):
            break
    assert loop_a.log.success_step is not None

    loop_b = SimLoop(load_config("config_point", overrides))
    loop_b.warmup(10)
    log_b = loop_b.run_chunked(300, chunk=10)
    assert log_b.success_step == loop_a.log.success_step, (
        log_b.success_step,
        loop_a.log.success_step,
    )
    # the chunked log stops at the success tick: no post-goal replans logged
    assert log_b.steps == log_b.success_step + 1


@pytest.mark.slow
def test_per_mode_cov_adapts_and_diverges():
    """update_cov_per_mode (extension over the reference's single-mode
    update_cov): each mode's sampling covariance adapts from its own masked
    weights, the two diverge under asymmetric costs (push vs pull see
    different landscapes), and the adapted scales change the planned
    actions."""
    from m3p2i_aip_tpu.tamp.reactive_tamp import ReactiveTAMP

    def build(per_mode):
        cfg = load_config(
            "config_point",
            [
                "task=push_pull",
                "multi_modal=True",
                "goal=[-3.75,-3.75]",
                "mppi.num_samples=32",
                "mppi.exploration_noise=0",
                f"mppi.update_cov_per_mode={per_mode}",
            ],
        )
        return ReactiveTAMP(cfg)

    on, off = build(True), build(False)
    state = on.env.init_state()
    a_on = a_off = None
    for i in range(6):
        a_on = np.asarray(on.run_tamp(state))
        a_off = np.asarray(off.run_tamp(state))
    c1 = np.asarray(on.mppi_state.cov_action_1)
    c2 = np.asarray(on.mppi_state.cov_action_2)
    assert np.all(np.isfinite(c1)) and np.all(c1 > 0)
    assert not np.allclose(c1, 3.0) and not np.allclose(c2, 3.0), (c1, c2)
    assert not np.allclose(c1, c2, rtol=0.05), "modes did not diverge"
    assert not np.allclose(a_on, a_off, atol=1e-5)
    # rejected where inert (single-mode planner never reads the per-mode covs)
    with pytest.raises(ValueError):
        ReactiveTAMP(
            load_config(
                "config_point",
                ["mppi.update_cov_per_mode=True", "mppi.num_samples=32"],
            )
        )


@pytest.mark.slow
def test_heijn_push_reaches_goal():
    """Heijn (3-dof omni base) pushes the box to the goal — the contact
    family beyond navigation for this robot."""
    cfg = load_config(
        "config_heijn", ["task=push", "goal=[-1,-1]", "mppi.num_samples=128"]
    )
    loop = SimLoop(cfg)
    loop.warmup(10)
    done = None
    for i in range(300):
        if loop.tick(i):
            done = i
            break
    assert done is not None, f"heijn push failed; box at {loop.log.box_pos[-1]}"


@pytest.mark.slow
def test_boxer_pull_reaches_goal():
    """Boxer (diff drive) pulls the box via suction — exercises the
    wheel-speed -> world-velocity conversion in the suction alignment gate
    (a raw wheel-channel dot product never engaged suction)."""
    cfg = load_config(
        "config_boxer", ["task=pull", "goal=[0,0]", "mppi.num_samples=128"]
    )
    loop = SimLoop(cfg)
    loop.warmup(10)
    done = None
    for i in range(400):
        if loop.tick(i):
            done = i
            break
    assert done is not None, f"boxer pull failed; box at {loop.log.box_pos[-1]}"


def test_zup_stall_detector_host_device_twins():
    """The on-device stall detector (ReactiveTAMP._zup_update) and the host
    mirror (PLANNER_AIF_PANDA._zup_update) must emit the SAME gate sequence
    on a synthetic wedge episode: approach (progress), wedge (stall ->
    latch), climb-out (d increases, gate holds), recovery (release).  The
    full-episode equivalence test only exercises all-zero gates on a clean
    table pick; this drives every transition."""
    import jax.numpy as jnp

    from m3p2i_aip_tpu.planners.task_planner.task_planner import (
        ZUP_STALL_TICKS,
    )

    cfg = load_config("config_panda", ["mppi.num_samples=64"])
    loop = SimLoop(cfg)
    tamp = loop.tamp
    host = tamp.task_planner  # PLANNER_AIF_PANDA
    host._zup_reset()

    # synthetic (d, in_pick, att) tick sequence
    seq = (
        [(0.5 - 0.01 * k, True, 1.0) for k in range(10)]     # approach
        + [(0.41, True, 1.0)] * (ZUP_STALL_TICKS + 3)        # wedge: latch
        + [(0.44, True, 1.0)] * 10                           # climb: holds
        + [(0.41 - 0.006 * k, True, 1.0) for k in range(12)] # recover
        + [(0.2, False, 0.0)] * 3                            # leave pick
    )
    zs = tamp.zup_zs0()
    dev_gates, host_gates = [], []
    for d, in_pick, att in seq:
        zs = tamp._zup_update(
            zs, jnp.asarray(d, jnp.float32), jnp.asarray(in_pick), jnp.asarray(att)
        )
        dev_gates.append(float(zs[2]))
        host._zup_update(d, in_pick, att)
        host_gates.append(host.zup_gate)
    assert dev_gates == host_gates, list(zip(dev_gates, host_gates))
    # the episode actually latched and released
    assert max(dev_gates) == 1.0
    assert dev_gates[-1] == 0.0
    # climb-out (d above the latch distance) did NOT release the gate
    climb_idx = 10 + ZUP_STALL_TICKS + 3 + 5
    assert dev_gates[climb_idx] == 1.0


@pytest.mark.slow
def test_point_chunked_pipelined_matches_serial():
    """Double-buffered chunking (SimLoop._run_chunked_pipelined) must land
    the same success tick and trajectory as the serial chunked path on a
    fixed-plan task: with PLANNER_SIMPLE the task params are constant, so
    hiding the fetch round trip behind the next chunk's compute must not
    change a single tick's math."""
    overrides = ["task=push", "goal=[-1,-1]", "mppi.num_samples=64"]

    loop_a = SimLoop(load_config("config_point", overrides))
    loop_a.warmup(10)
    log_a = loop_a.run_chunked(300, chunk=10)
    assert log_a.success_step is not None

    loop_b = SimLoop(load_config("config_point", overrides))
    loop_b.warmup(10)
    log_b = loop_b.run_chunked(300, chunk=10, pipelined=True)
    assert log_b.success_step == log_a.success_step, (
        log_b.success_step,
        log_a.success_step,
    )
    assert log_b.steps == log_a.steps
    assert np.allclose(
        np.asarray(log_a.robot_pos), np.asarray(log_b.robot_pos), atol=1e-6
    )
    assert np.allclose(
        np.asarray(log_a.box_pos), np.asarray(log_b.box_pos), atol=1e-6
    )


@pytest.mark.slow
def test_point_two_corner_hybrid():
    """The reference's corner2 scenario: the box STARTS in a corner (pushing
    out of a corner is impossible, README.md:96) and the goal sits in the
    diagonally opposite pocket.  The pull mode must extract and drag the box
    across the arena; the drag backs the robot into the goal pocket where
    the boundary-crush veto freezes the pull ~0.33 m short (measured), and
    the stall latch must then reposition for the final push.  Reference
    envelope: hybrid 9.95±3.46 s vs push 36.4 s (fails) / pull 32.9 s
    (BASELINE.md two-corner row)."""
    cfg = load_config(
        "config_point",
        [
            "task=push_pull",
            "multi_modal=True",
            "goal=[-3.75,-3.75]",
            'actors=["box"]',
            "initial_actor_positions=[[3.75,3.75]]",
            "mppi.num_samples=128",
        ],
    )
    loop = SimLoop(cfg)
    loop.warmup(10)
    log = loop.run_chunked(1000, chunk=4)
    assert log.success_step is not None, (
        f"two-corner hybrid failed; box at {log.box_pos[-1]}"
    )
    # NOTE: whether the stall latch fires is seed/K dependent (at K=200 the
    # drag backs the robot into the pocket and freezes — 0/2 without the
    # latch, 2/2 with; at CI's K=128 some seeds finish unstaged).  The latch
    # MECHANICS are covered by test_task_planner's staged-latch tests; this
    # test pins the scenario outcome.
