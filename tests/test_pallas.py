"""Parity tests of the Pallas/Triton kernels against the plain XLA paths.

Three tiers:
- interpret-mode goldens — run in the DEFAULT CPU suite through the Pallas
  interpreter, so any drift between the kernels' cost/physics semantics and
  the XLA reference paths fails without a GPU;
- lowering checks — the Triton lowering of both kernels at full widths runs
  on the CPU (``lowering_platforms=("cuda",)``), so a primitive or a block
  shape the Triton route refuses fails here, not on the card;
- ``gpu``-marked tests — the compiled kernels on the card at full widths
  (``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``; ``chip_smoke.py``
  runs them).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from m3p2i_aip_tpu.planners.motion_planner.mppi import TaskParams


def _build_tamp(K=32, T=12, config_name="config_point", overrides=()):
    from m3p2i_aip_tpu.config.config_store import load_config
    from m3p2i_aip_tpu.tamp.reactive_tamp import ReactiveTAMP

    cfg = load_config(
        config_name,
        [
            *overrides,
            "task=push_pull",
            "multi_modal=True",
            "goal=[-3.75,-3.75]",
            f"mppi.num_samples={K}",
            f"mppi.horizon={T}",
            f"mppi.u_per_command={T}",
        ],
    )
    return cfg, ReactiveTAMP(cfg)


def _reduced(params):
    """Reduced physics (substeps=1, pos_iters=1, 2 statics): every code path
    — drive, cap, all 5 contact passes, suction carry, every task cost — is
    still exercised, but the interpret-mode program is ~8x smaller.  Both
    sides of a parity check are built from the SAME reduced params, so any
    formula drift still fails."""
    return params.replace(
        substeps=1,
        pos_iters=1,
        stat_pos=params.stat_pos[:2],
        stat_yaw=params.stat_yaw[:2],
        stat_half=params.stat_half[:2],
        stat_friction=params.stat_friction[:2],
        stat_actor_idx=params.stat_actor_idx[:2],
    )


def _xla_rollout_fn(params, cfg, K):
    """MPPI._rollout semantics (scan over T of the vmapped env step + the
    PointObjective cost) on explicit ``params``."""
    from m3p2i_aip_tpu.models import point_env
    from m3p2i_aip_tpu.planners.motion_planner.cost_functions import (
        PointObjective,
    )

    obj = PointObjective(params, cfg)
    mode = (jnp.arange(K) >= K // 2).astype(jnp.int32)

    def rollout(state_k, acts, task):
        ext0 = jax.vmap(lambda _: point_env.zero_ext(params))(jnp.arange(K))

        def step_t(carry, u_t):
            s, ext = carry
            s = jax.vmap(lambda st, u, e: point_env.step(params, st, u, e))(
                s, u_t, ext
            )
            cost, ext = jax.vmap(obj.compute, in_axes=(0, 0, None, 0))(
                s, u_t, task, mode
            )
            return (s, ext), (cost, s.q[:, :2])

        (_, _), (costs, tps) = jax.lax.scan(
            step_t, (state_k, ext0), jnp.swapaxes(acts, 0, 1)
        )
        return jnp.swapaxes(costs, 0, 1), jnp.swapaxes(tps, 0, 1)

    return rollout


def _bcast(state, K):
    return jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (K,) + x.shape), state
    )


def _task(task_id, goal):
    return TaskParams(
        task_id=jnp.asarray(task_id, jnp.int32),
        goal=jnp.concatenate([jnp.asarray(goal), jnp.zeros(5)]).astype(jnp.float32),
        gripper=jnp.asarray(0, jnp.int32),
        zup_gate=jnp.asarray(0.0, jnp.float32),
    )


def _stack(xs):
    return jax.tree_util.tree_map(lambda *l: jnp.stack(l), *xs)


# start states with multi-contact configurations: open space, the arena
# wall JUNCTION (two simultaneous wall contacts), pressed against the box
# near a wall, and suction-active at 7 m/s (the robot speed cap under pull)
_STARTS = [
    (jnp.asarray([-0.3, 1.4]), jnp.asarray([0.5, 0.5])),
    (jnp.asarray([-3.7, -3.7]), jnp.asarray([-2.0, -2.0])),
    (jnp.asarray([-0.05, 1.75]), jnp.asarray([0.0, 2.0])),
    (jnp.asarray([0.0, 1.55]), jnp.asarray([0.0, 7.0])),
]


# ---------------------------------------------------------------------------
# interpret-mode goldens: run on CPU in the default suite
# ---------------------------------------------------------------------------


def test_multimodal_weights_interpret_matches_jax_cpu():
    """K=32: one tile, padded K and T."""
    _check_weights_interpret(32)


def test_multimodal_weights_interpret_multi_tile():
    """K=700: two 512-sample tiles with a padded tail, so the in-kernel
    tile loop is covered."""
    _check_weights_interpret(700)


def _check_weights_interpret(K):
    from m3p2i_aip_tpu.ops.pallas_kernels import multimodal_weights_pallas

    _, tamp = _build_tamp(K=K)
    mp = tamp.motion_planner
    rng = np.random.default_rng(0)
    ch = jnp.asarray(rng.uniform(0, 50, size=(mp.K, mp.T)).astype(np.float32))

    mp.use_pallas = False
    ref = jax.jit(mp._multi_modal_exp_util)(ch)
    got = multimodal_weights_pallas(
        ch, mp.gamma_seq, mp.half_K, 10.0, 3.0, interpret=True
    )
    for r, g in zip(ref, got):
        assert np.allclose(np.asarray(r), np.asarray(g), atol=1e-6)
        assert abs(float(jnp.sum(g)) - 1.0) < 1e-5


@pytest.mark.slow
@pytest.mark.parametrize(
    "config_name,overrides",
    [
        ("config_point", ()),
        ("config_heijn", ()),
        ("config_boxer", ()),
        # reference-parity ablation config: one-sided push align + no beta
        # adaptation — the kernel must track the ablated cost formula too
        ("config_boxer", ("mppi=boxer_parity",)),
    ],
)
def test_fused_rollout_interpret_matches_xla_cpu(config_name, overrides):
    """Kernel-vs-XLA rollout parity on CPU (interpret mode), all three
    point-family robot bases (2-dof omni / 3-dof omni / diff-drive), on
    reduced physics (see _reduced), from multi-contact start states."""
    from m3p2i_aip_tpu.ops.pallas_rollout import make_point_rollout

    cfg, tamp = _build_tamp(config_name=config_name, overrides=overrides)
    mp = tamp.motion_planner
    full = tamp.env.params
    red = _reduced(full)
    ov = make_point_rollout(
        red, float(cfg.kp_suction), mp.K, mp.T,
        bool(cfg.multi_modal), interpret=True,
        boxer_continuous_align=bool(cfg.mppi.boxer_continuous_align),
    )
    K, T = mp.K, mp.T
    starts = _STARTS + [
        # corner sprint above the cap with suction range of nothing
        (jnp.asarray([-3.3, -3.3]), jnp.asarray([-6.0, -6.0])),
        # box parked at the pocket mouth (d_bg < 1 of the corner goal):
        # the diff-drive pocket-goal pull veto and the at_edge margin
        (
            jnp.asarray([-2.6, -2.9]),
            jnp.asarray([-1.0, -1.0]),
            jnp.asarray([-3.3, -3.2]),
        ),
    ]
    n_q = 3 if full.robot_type in ("heijn", "boxer") else 2
    n_u = 3 if full.robot_type == "heijn" else 2
    ref_fn = jax.jit(_xla_rollout_fn(red, cfg, K))
    pl_fn = jax.jit(lambda s, a, t: ov(s, a, t))
    box_slot = tamp.objective.box_dyn_slot
    rng = np.random.default_rng(0)
    for entry in starts:
        q0, qd0 = entry[0], entry[1]
        if n_q == 3:  # 3-dof bases carry yaw in q[2]
            q0 = jnp.concatenate([q0, jnp.asarray([0.3])])
            qd0 = jnp.concatenate([qd0, jnp.asarray([0.5])])
        state = tamp.env.init_state().replace(q=q0, qd=qd0)
        if len(entry) == 3:  # box position override
            state = state.replace(dyn_pos=state.dyn_pos.at[box_slot].set(entry[2]))
        tp = tamp.tamp_interface(state)
        sK = _bcast(state, K)
        acts = jnp.asarray(rng.uniform(-3, 3, size=(K, T, n_u)).astype(np.float32))
        ch_ref, tps_ref = ref_fn(sK, acts, tp)
        ch_pl, tps_pl = pl_fn(sK, acts, tp)
        assert np.allclose(np.asarray(ch_ref), np.asarray(ch_pl), atol=1e-2), q0
        assert np.allclose(np.asarray(tps_ref), np.asarray(tps_pl), atol=1e-3), q0


def test_multimodal_weights_vmap_matches_serial():
    """jax.vmap of the fused weights kernel must equal B serial kernel calls
    (the custom_vmap rule dispatches one grid=(B,) program — this is what the
    vmapped multi-seed runner hits, tamp/batch_loop.py)."""
    from m3p2i_aip_tpu.ops.pallas_kernels import multimodal_weights_pallas

    _, tamp = _build_tamp()
    mp = tamp.motion_planner
    rng = np.random.default_rng(3)
    B = 3
    ch = jnp.asarray(rng.uniform(0, 50, size=(B, mp.K, mp.T)).astype(np.float32))

    def one(c):
        return multimodal_weights_pallas(
            c, mp.gamma_seq, mp.half_K, 10.0, 3.0, interpret=True
        )

    got = jax.jit(jax.vmap(one))(ch)
    for b in range(B):
        ref = one(ch[b])
        for r, g in zip(ref, got):
            assert np.allclose(np.asarray(r), np.asarray(g[b]), atol=1e-6), b


def test_point_rollout_vmap_matches_serial():
    """jax.vmap of the fused point rollout == B serial kernel rollouts with
    DIFFERENT per-batch start states and task goals (each program loads its
    own batch element's task scalars).  Interpret mode, reduced physics."""
    from m3p2i_aip_tpu.ops.pallas_rollout import make_point_rollout

    cfg, tamp = _build_tamp(K=16, T=4)
    mp = tamp.motion_planner
    red = _reduced(tamp.env.params)
    ov = make_point_rollout(
        red, float(cfg.kp_suction), mp.K, mp.T, True, interpret=True
    )
    K, T = mp.K, mp.T
    rng = np.random.default_rng(0)
    starts = [_STARTS[0], _STARTS[2]]
    tasks = [_task(3, [-3.75, -3.75]), _task(1, [2.0, 1.0])]
    sKs = [
        _bcast(tamp.env.init_state().replace(q=q, qd=qd), K) for q, qd in starts
    ]
    acts = [
        jnp.asarray(rng.uniform(-3, 3, size=(K, T, 2)).astype(np.float32))
        for _ in starts
    ]
    ch_b, tps_b = jax.jit(jax.vmap(lambda s, a, t: ov(s, a, t)))(
        _stack(sKs), jnp.stack(acts), _stack(tasks)
    )
    for b in range(len(starts)):
        ch_s, tps_s = jax.jit(lambda s, a, t: ov(s, a, t))(sKs[b], acts[b], tasks[b])
        assert np.allclose(np.asarray(ch_s), np.asarray(ch_b[b]), atol=1e-5), b
        assert np.allclose(np.asarray(tps_s), np.asarray(tps_b[b]), atol=1e-5), b


def test_point_rollout_interpret_fric_scale_parity():
    """Kernel vs XLA with per-sample friction randomization live: the
    fric_scale state rows must steer the kernel's contact/ground friction
    exactly like PointEnvState.fric_scale steers point_env.step."""
    from m3p2i_aip_tpu.ops.pallas_rollout import make_point_rollout

    cfg, tamp = _build_tamp(K=16, T=4)
    mp = tamp.motion_planner
    red = _reduced(tamp.env.params)
    ov = make_point_rollout(
        red, float(cfg.kp_suction), mp.K, mp.T, True, interpret=True
    )
    K, T = mp.K, mp.T
    rng = np.random.default_rng(7)
    D = red.dyn_half.shape[0]
    fs = jnp.asarray(rng.uniform(0.5, 1.5, size=(K, D)).astype(np.float32))

    # pressed against the box, pushing: contact friction is live every step
    state = tamp.env.init_state().replace(
        q=jnp.asarray([0.0, 1.55]), qd=jnp.asarray([0.0, 2.0])
    )
    tp = tamp.tamp_interface(state)
    sK = _bcast(state, K).replace(fric_scale=fs)
    acts = jnp.asarray(rng.uniform(-3, 3, size=(K, T, 2)).astype(np.float32))

    ch_ref, tps_ref = jax.jit(_xla_rollout_fn(red, cfg, K))(sK, acts, tp)
    ch_pl, tps_pl = jax.jit(lambda s, a: ov(s, a, tp))(sK, acts)
    assert np.allclose(np.asarray(ch_ref), np.asarray(ch_pl), atol=1e-2)
    assert np.allclose(np.asarray(tps_ref), np.asarray(tps_pl), atol=1e-3)
    # and the randomization really bites: per-sample final costs differ
    assert np.std(np.asarray(ch_pl[:, -1])) > 1e-6


def test_point_rollout_wrapper_padding_interpret():
    """The wrapper's padding and offsets: K=40 is not a multiple of the
    32-sample block (two programs, a padded tail), T=5 pads to 8 output rows
    and 10 action rows to 16, B=2 runs a (2, 2) grid, and two half-K calls
    with k0 = 0 and k0 = K/2 (what shard_map runs) equal the full call."""
    from m3p2i_aip_tpu.ops.pallas_rollout import BLOCK, make_point_rollout

    K, T = 40, 5
    assert K % BLOCK != 0
    cfg, tamp = _build_tamp(K=K, T=T)
    red = _reduced(tamp.env.params)
    ov = make_point_rollout(red, float(cfg.kp_suction), K, T, True, interpret=True)
    rng = np.random.default_rng(5)
    sKs = [
        _bcast(tamp.env.init_state().replace(q=q, qd=qd), K)
        for q, qd in (_STARTS[0], _STARTS[3])
    ]
    acts = [
        jnp.asarray(rng.uniform(-3, 3, size=(K, T, 2)).astype(np.float32))
        for _ in sKs
    ]
    tp = _task(3, [-3.75, -3.75])

    ref = jax.jit(_xla_rollout_fn(red, cfg, K))
    ch_b, tps_b = jax.jit(jax.vmap(lambda s, a: ov(s, a, tp)))(
        _stack(sKs), jnp.stack(acts)
    )
    assert ch_b.shape == (2, K, T) and tps_b.shape == (2, K, T, 2)
    for b in range(2):
        ch_r, tps_r = ref(sKs[b], acts[b], tp)
        assert np.allclose(np.asarray(ch_r), np.asarray(ch_b[b]), atol=1e-2), b
        assert np.allclose(np.asarray(tps_r), np.asarray(tps_b[b]), atol=1e-3), b

    half = K // 2
    full = jax.jit(lambda s, a: ov(s, a, tp))(sKs[0], acts[0])
    lo = jax.jit(lambda s, a: ov(s, a, tp, k0=0))(
        jax.tree.map(lambda x: x[:half], sKs[0]), acts[0][:half]
    )
    hi = jax.jit(lambda s, a: ov(s, a, tp, k0=half))(
        jax.tree.map(lambda x: x[half:], sKs[0]), acts[0][half:]
    )
    for f, a, b in zip(full, lo, hi):
        assert np.allclose(np.asarray(f), np.concatenate([a, b]), atol=1e-6)


def test_kernel_choice_on_cpu_and_unsupported_scene():
    """Off the GPU the planner takes its XLA path (no interpret fallback);
    a scene the rollout kernel does not cover is refused loudly."""
    from m3p2i_aip_tpu.ops import pallas_rollout

    cfg, tamp = _build_tamp()
    mp = tamp.motion_planner
    assert jax.default_backend() == "cpu"
    assert not mp.use_pallas and mp.rollout_override is None
    params = tamp.env.params
    assert pallas_rollout.rollout_kernel_supported(params)
    names = tuple("crate" if n == "box" else n for n in params.actor_names)
    no_box = params.replace(actor_names=names)
    assert not pallas_rollout.rollout_kernel_supported(no_box)
    with pytest.raises(ValueError):
        pallas_rollout.make_point_rollout(no_box, 400.0, mp.K, mp.T, True)


def test_triton_kernels_lower_for_cuda():
    """The Triton lowering accepts both kernels at full width (K=200 x T=15,
    full physics), batched, and inside the whole planner command — checked
    on the CPU by lowering for the CUDA platform."""
    from m3p2i_aip_tpu.ops.pallas_kernels import multimodal_weights_pallas
    from m3p2i_aip_tpu.ops.pallas_rollout import make_point_rollout

    cfg, tamp = _build_tamp(K=200, T=15)
    mp = tamp.motion_planner
    K, T = mp.K, mp.T
    ov = make_point_rollout(tamp.env.params, float(cfg.kp_suction), K, T, True)
    state = tamp.env.init_state()
    tp = tamp.tamp_interface(state)
    sK = _bcast(state, K)
    acts = jnp.zeros((K, T, 2), jnp.float32)

    def n_kernels(fn, *args):
        low = jax.jit(fn).trace(*args).lower(lowering_platforms=("cuda",))
        return low.as_text().count("__gpu$xla.gpu.triton")

    B = 4
    batch = lambda x: jnp.broadcast_to(x[None], (B,) + x.shape)
    assert n_kernels(jax.vmap(lambda s, a, t: ov(s, a, t)),
                     jax.tree.map(batch, sK), batch(acts), jax.tree.map(batch, tp)) == 1
    # K=10^4 x T=30: the weight kernel's tile loop, not a bigger block
    assert n_kernels(
        lambda c: multimodal_weights_pallas(c, jnp.ones(30), 5000),
        jnp.zeros((10000, 30)),
    ) == 1
    mp.use_pallas = True
    mp.set_rollout_override(ov)
    assert n_kernels(mp._command_impl, tamp.mppi_state, state, tp) == 2


# ---------------------------------------------------------------------------
# on the card: compiled kernels at full widths vs the XLA reference
# ---------------------------------------------------------------------------


def _report(name, ref, got, atol):
    ref, got = np.asarray(ref), np.asarray(got)
    err = np.abs(ref - got)
    rel = err / np.maximum(np.abs(ref), 1e-6)
    print(
        f"parity {name}: max_abs={err.max():.3e} max_rel={rel.max():.3e} "
        f"atol={atol:g}"
    )
    return bool(np.all(np.isfinite(got)) and err.max() <= atol)


# Tolerances: the kernel sums the Jacobi contact corrections per lane in
# another order than XLA's vectorized reductions, so f32 rounding differs
# and grows through 15 steps of contact; 1e-2 on costs (values up to ~10^3)
# and 1e-3 m on positions.  Weights are one reduction deep: 1e-6.
_COST_ATOL, _TRAJ_ATOL, _W_ATOL = 1e-2, 1e-3, 1e-6


@pytest.mark.gpu
def test_rollout_kernel_matches_xla_gpu():
    """Compiled point rollout kernel vs the XLA rollout (mppi.py _rollout)
    at K=200 x T=15 with full physics, from multi-contact starts; then the
    batched call (B=20) vs 20 serial calls, and two K/2 shards with their
    k0 offsets vs the full call."""
    cfg, tamp = _build_tamp(K=200, T=15)
    mp = tamp.motion_planner
    ov = mp.rollout_override
    assert ov is not None and mp.use_pallas
    # the reference: the same planner built on its plain XLA path
    _, ref_tamp = _build_tamp(K=200, T=15, overrides=("mppi.use_pallas=False",))
    assert ref_tamp.motion_planner.rollout_override is None
    K, T = mp.K, mp.T
    rng = np.random.default_rng(0)
    ok = True
    ref_fn = jax.jit(ref_tamp.motion_planner._rollout)
    kern_fn = jax.jit(lambda s, a, t: ov(s, a, t))
    cases = []
    for q0, qd0 in _STARTS:
        state = tamp.env.init_state().replace(q=q0, qd=qd0)
        tp = tamp.tamp_interface(state)
        acts = jnp.asarray(rng.uniform(-3, 3, size=(K, T, 2)).astype(np.float32))
        cases.append((_bcast(state, K), acts, tp))
        with jax.default_matmul_precision("highest"):
            ch_ref, tps_ref = ref_fn(_bcast(state, K), acts, tp)
        ch, tps = kern_fn(_bcast(state, K), acts, tp)
        q = np.asarray(q0).tolist()
        ok &= _report(f"rollout cost q0={q}", ch_ref, ch, _COST_ATOL)
        ok &= _report(f"rollout traj q0={q}", tps_ref, tps, _TRAJ_ATOL)

    B = 20
    sel = [cases[b % len(cases)] for b in range(B)]
    acts_b = jnp.stack([
        jnp.asarray(rng.uniform(-3, 3, size=(K, T, 2)).astype(np.float32))
        for _ in range(B)
    ])
    ch_b, tps_b = jax.jit(jax.vmap(lambda s, a, t: ov(s, a, t)))(
        _stack([c[0] for c in sel]), acts_b, _stack([c[2] for c in sel])
    )
    serial = [kern_fn(sel[b][0], acts_b[b], sel[b][2]) for b in range(B)]
    ok &= _report("batched B=20 vs serial cost", np.stack([s[0] for s in serial]), ch_b, 1e-5)
    ok &= _report("batched B=20 vs serial traj", np.stack([s[1] for s in serial]), tps_b, 1e-5)

    sK, acts, tp = cases[2]
    half = K // 2
    full = kern_fn(sK, acts, tp)
    shard = jax.jit(lambda s, a, k0: ov(s, a, tp, k0=k0))
    lo = shard(jax.tree.map(lambda x: x[:half], sK), acts[:half], 0)
    hi = shard(jax.tree.map(lambda x: x[half:], sK), acts[half:], half)
    ok &= _report("k0 shards vs full cost", full[0], np.concatenate([lo[0], hi[0]]), 1e-5)
    ok &= _report("k0 shards vs full traj", full[1], np.concatenate([lo[1], hi[1]]), 1e-5)
    assert ok


@pytest.mark.gpu
def test_weights_kernel_matches_xla_gpu():
    """Compiled weight kernel vs the XLA while-loop path at K=200 x T=15 and
    at K=1000 (two tiles), plus the batched call (B=20) vs serial calls."""
    from m3p2i_aip_tpu.ops.pallas_kernels import multimodal_weights_pallas

    ok = True
    rng = np.random.default_rng(1)
    for K in (200, 1000):
        _, tamp = _build_tamp(K=K, T=15)
        mp = tamp.motion_planner
        ch = jnp.asarray(rng.uniform(0, 50, size=(K, mp.T)).astype(np.float32))
        mp.use_pallas = False
        with jax.default_matmul_precision("highest"):
            ref = jax.jit(mp._multi_modal_exp_util)(ch)
        got = jax.jit(
            lambda c: multimodal_weights_pallas(c, mp.gamma_seq, mp.half_K)
        )(ch)
        for name, r, g in zip(("w0", "w1", "w"), ref, got):
            ok &= _report(f"weights K={K} {name}", r, g, _W_ATOL)
        if K == 200:
            chs = jnp.asarray(rng.uniform(0, 50, size=(20, K, mp.T)).astype(np.float32))
            one = lambda c: multimodal_weights_pallas(c, mp.gamma_seq, mp.half_K)
            got_b = jax.jit(jax.vmap(one))(chs)
            serial = [jax.jit(one)(chs[b]) for b in range(20)]
            for i, name in enumerate(("w0", "w1", "w")):
                ok &= _report(
                    f"weights batched B=20 {name}",
                    np.stack([s[i] for s in serial]), got_b[i], 1e-7,
                )
    assert ok
