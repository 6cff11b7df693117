"""MPPI (Model Predictive Path Integral) control — functional JAX core.

Re-design of the reference's torch implementation
(``src/m3p2i_aip/planners/motion_planner/mppi.py``, itself derived from
pytorch_mppi and NVlabs/storm) as a pure-functional, jit-once planner:

  * the per-command mutable state (means, best trajectories, adaptive inverse
    temperatures, RNG key) lives in an explicit :class:`MPPIState` pytree;
  * the K rollouts are ``jax.vmap`` of the injected dynamics over the sample
    axis and a ``lax.scan`` over the horizon (replacing K Isaac envs stepped
    in a python loop, mppi.py:296-315);
  * Halton-spline sampling is precomputed once at init as a basis-matrix
    matmul (replacing the K*nu scipy spline fits at mppi.py:458-478);
  * Savitzky–Golay smoothing is a precomputed [T, T] operator applied
    on-device (replacing the host round-trip at mppi.py:256-263);
  * the whole ``command`` is one jitted function — task switches arrive as
    traced data (task id / goal / gripper / modes), never causing a retrace.

Both reference modes are supported: ``mppi_mode='simple'`` (resample Gaussian
noise each step, Williams-style update, mppi.py:335-363) and
``'halton-spline'`` (cached Halton spline noise, STORM-style gradient mean
update, mppi.py:381-428).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from functools import partial
from typing import Callable, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from m3p2i_aip_tpu.ops import (
    bspline_interp_matrix,
    discounted_traj_cost,
    ensure_non_zero,
    gaussian_halton_samples,
    savgol_matrix,
    scale_ctrl,
)
from m3p2i_aip_tpu.utils import struct

# f32 contractions that feed the plan run at full f32 precision: on a GPU
# the default may be TF32 (~3 decimal digits), which drifts the plan away
# from the CPU result
_HIGHEST = jax.lax.Precision.HIGHEST


@dataclass
class MPPIConfig:
    """Planner hyper-parameters. Parity: MPPIConfig (mppi.py:9-59)."""

    num_samples: int = 200
    horizon: int = 12
    nx: int = 4
    mppi_mode: str = "halton-spline"
    sampling_method: str = "halton"
    noise_sigma: Optional[List[List[float]]] = None
    noise_mu: Optional[List[float]] = None
    device: str = "gpu"  # accepted for YAML schema parity; JAX picks the device
    lambda_: float = 1.0
    # Accepted for YAML schema parity but intentionally ignored: the
    # reference declares it and never reads it either (its lambda adaptation
    # was never implemented — mppi.py:42 and the orphaned lambda_mult at
    # :198 are dead upstream).
    update_lambda: bool = False
    update_cov: bool = False
    # Per-mode diagonal covariance adaptation for the multi-modal path
    # (extension; the reference's update_cov lives only in the single-mode
    # update, mppi.py:508-516).  Each mode's sampling scale tracks its own
    # weighted second moment, so e.g. the losing mode keeps exploring wide
    # while the winning mode sharpens.
    update_cov_per_mode: bool = False
    u_min: Optional[List[float]] = None
    u_max: Optional[List[float]] = None
    u_init: float = 0.0
    U_init: Optional[List[List[float]]] = None
    u_scale: float = 1.0
    u_per_command: int = 1
    rollout_var_discount: float = 0.95
    sample_null_action: bool = False
    sample_previous_plan: bool = True
    sample_other_priors: bool = False
    # Single-mode elite injection (extension): keep the best-weighted action
    # sequence alive verbatim at sample slot 0, like the multi-modal path's
    # per-mode elites at slots 0 and K/2 (mppi.py:407-409).  Rescues
    # nonholonomic bases whose left/right-arc samples otherwise average to a
    # straight-at-obstacle mean (observed: boxer push parks beside the box).
    sample_best_traj: bool = False
    noise_abs_cost: bool = False
    filter_u: bool = False
    use_priors: bool = False
    fine_noise_scale: float = 0.05  # scale of the fine-sampling quartile (extension)
    use_pallas: bool = True  # fused Triton kernels on an NVIDIA GPU (extension)
    # Gradient refinement of the mean plan (extension): the JAX physics
    # rollout is differentiable end-to-end, so after the importance-weighted
    # update the mean action sequence can take a few first-order steps on the
    # true discounted cost.  Closes the last centimetres on narrow kinematic
    # manifolds (e.g. shelf-side grasps at full arm extension) where random
    # sampling stalls.  0 = off (pure sampling, reference behavior).
    grad_refine_steps: int = 0
    grad_refine_lr: float = 0.02
    # Annealed resampling refinement (extension; the data-parallel
    # alternative to grad_refine): after the importance-weighted update,
    # re-run the K-lane rollout ``refine_iters`` more times with the cached
    # Halton deltas shrunk to refine_scale * refine_decay^i around the
    # updated means, re-applying the importance update each time.  Same
    # goal as grad_refine (millimetre convergence on narrow manifolds) but
    # each iteration is one full-width rollout instead of a sequential
    # 3-lane differentiable rollout chain.
    refine_iters: int = 0
    refine_scale: float = 0.1
    refine_decay: float = 0.5
    # Final refine iteration picks the argmin sample per mode instead of the
    # softmax-weighted mean.  The weighted mean's effective-sample-size floor
    # (eta in [eta_l, eta_u]) leaves a ~sigma-sized bias off the cost
    # optimum — measured: the shelf reach equilibrates at 0.0555 m from the
    # cube against a 0.055 m stage latch.  Greedy is monotone by
    # construction: the pure per-mode means ride in the refine batch, so the
    # argmin can never rank the incumbent plan out.
    refine_greedy: bool = True
    # unroll the refinement's T-step rollout scan (fwd + induced reverse):
    # faster per tick for small T, at added compile time
    grad_refine_unroll: bool = False
    # per-tick jitter on the cached Halton deltas (extension; breaks
    # deterministic replanning fixed points — see _command_halton)
    exploration_noise: float = 0.05
    seed_val: int = 0
    eta_u_bound: float = 10.0  # multi-modal eta upper bound (m3p2i.py:58-60)
    eta_l_bound: float = 3.0  # multi-modal eta lower bound
    # Single-mode beta adaptation gate (parity-ablation knob).  None = auto:
    # on for the panda (the reference's panda-only gate, mppi.py:446-454)
    # AND the boxer (extension — the reference ships no boxer tasks; with
    # fixed beta=1 the near-goal weights collapse to argmax and the
    # nonholonomic base parks ~0.2 m out).  ``mppi=boxer_parity`` sets False
    # to measure that divergence.
    beta_adapt: Optional[bool] = None
    # Continuous side-alignment push cost for the diff-drive base
    # (extension over the reference's one-sided max(cos, 0) penalty,
    # cost_functions.py:57-58 — see PointObjective._push).  False restores
    # the reference formula for ablation; no effect on non-boxer robots.
    boxer_continuous_align: bool = True


@struct.dataclass
class TaskParams:
    """Per-tick task data swapped into the jitted planner (never a retrace).

    Encodes the reference's Objective.update_objective(task, goal)
    (cost_functions.py:15-17) + gripper command (m3p2i.py:10-14) as traced
    values.  ``task_id``: 0 navigation, 1 push, 2 pull, 3 push_pull, 4 reach,
    5 pick, 6 place.
    """

    task_id: jnp.ndarray  # int32 scalar
    goal: jnp.ndarray  # [7] pos(3) + quat(4); 2D goals use [:2]
    gripper: jnp.ndarray  # int32: 0 none, 1 open, 2 close
    # f32 scalar, 1.0 while the symbolic layer flags the pick as WEDGED
    # (goal progress stalled with the cube attached): activates the z-up
    # clearance shaping in the pick cost.  Traced data so the planner can
    # flip it without a retrace; computed host-side per tick
    # (PLANNER_AIF_PANDA.update_plan) or on-device in the chunked gate
    # (ReactiveTAMP._panda_gate_device) — same stall/release thresholds
    zup_gate: jnp.ndarray


TASK_IDS = {
    "navigation": 0,
    "push": 1,
    "pull": 2,
    "push_pull": 3,
    "reach": 4,
    "pick": 5,
    "place": 6,
    "ee_reach": 7,  # albert mobile manipulation (no reference equivalent)
    # diff-drive pocket-endgame standoff drive (PLANNER_SIMPLE latch):
    # navigation cost, but never a success state
    "reposition": 8,
    # albert mobile manipulation WITH contact: base pushes the box to
    # goal[:2] while the arm holds the EE over the moving box at goal[2]
    "push_reach": 9,
    # non-planning tasks map to a safe default cost (the reference degrades
    # to motion-cost-only for unknown tasks, cost_functions.py:19-36)
    "idle": 0,
    "idle_success": 0,
    "idle_fail": 0,
    "reactive_pick": 4,
}


def make_task_params(
    task: str, goal, gripper_command: str = "none", zup_gate: float = 0.0
) -> TaskParams:
    g = np.zeros(7, dtype=np.float32)
    goal = np.asarray(goal, dtype=np.float32).reshape(-1)
    g[: goal.shape[0]] = goal
    grip = {"none": 0, "open": 1, "close": 2}[gripper_command]
    return TaskParams(
        task_id=jnp.asarray(TASK_IDS[task], dtype=jnp.int32),
        goal=jnp.asarray(g),
        gripper=jnp.asarray(grip, dtype=jnp.int32),
        zup_gate=jnp.asarray(zup_gate, dtype=jnp.float32),
    )


@struct.dataclass
class MPPIState:
    """Mutable planner state threaded through ``command`` calls."""

    mean_action: jnp.ndarray  # [T, nu]
    mean_action_1: jnp.ndarray
    mean_action_2: jnp.ndarray
    best_traj: jnp.ndarray
    best_traj_1: jnp.ndarray
    best_traj_2: jnp.ndarray
    U: jnp.ndarray  # [T, nu] simple-mode nominal sequence
    beta: jnp.ndarray  # adaptive inverse temperature (persistent, mppi.py:446-454)
    weights: jnp.ndarray  # [K] last importance weights
    cov_action: jnp.ndarray  # [nu] diagonal sampling covariance (mppi.py:175, 508-516)
    cov_action_1: jnp.ndarray  # [nu] mode-0 covariance (update_cov_per_mode)
    cov_action_2: jnp.ndarray  # [nu] mode-1 covariance (update_cov_per_mode)
    rng: jax.Array  # PRNG key for 'random' sampling
    # Seeded Halton-spline deltas [K, T, nu] as a TRACED leaf, not a
    # closed-over constant: baked-in deltas made every seed a different HLO
    # constant -> a full XLA recompile per seeded run (dominated experiment-
    # batch wall time; the persistent cache can't help when the program
    # itself changes).
    halton_delta: jnp.ndarray = None
    # Per-sample domain-randomization friction scales [K, D] (ones when the
    # actor YAMLs set no noise_percentage_friction).  Traced for the same
    # reason as halton_delta; drawn per reseed so each of the K rollout
    # "envs" keeps a distinct friction for the whole run — the reference's
    # per-env creation-time draw (isaacgym_wrapper.py:311-326).
    fric_scale_k: jnp.ndarray = None


class MPPI:
    """MPPI planner. Construction parity: MPPI.__init__ (mppi.py:82-203).

    ``dynamics(sim_state, u, ext) -> sim_state`` and
    ``running_cost(sim_state, u, task, mode) -> (cost, ext)`` operate on a
    SINGLE env; the planner vmaps them over K samples.  ``ext`` is the
    external-force pytree threaded from the cost into the next step —
    the functional inversion of the reference's suction side effect
    (cost_functions.py:71-76 mutating the live sim).
    """

    def __init__(
        self,
        cfg,
        dynamics: Callable,
        running_cost: Callable,
        zero_ext: Callable,
        traj_point: Optional[Callable] = None,
        state_vector: Optional[Callable] = None,
        fric_noise=None,
        fric_inject: Optional[Callable] = None,
    ):
        self.env_type = cfg.env_type
        self.multi_modal = bool(cfg.multi_modal)
        mcfg = cfg.mppi
        self.cfg = mcfg
        self.mppi_mode = mcfg.mppi_mode
        self.sampling_method = mcfg.sampling_method

        self.K = mcfg.num_samples
        self.half_K = self.K // 2
        self.T = mcfg.horizon
        self.filter_u = mcfg.filter_u
        self.lambda_ = mcfg.lambda_
        self.sample_null_action = mcfg.sample_null_action
        self.u_per_command = mcfg.u_per_command
        self.u_scale = mcfg.u_scale

        noise_sigma = mcfg.noise_sigma
        if not noise_sigma:
            noise_sigma = np.identity(int(mcfg.nx / 2)).tolist()
        self.noise_sigma = np.asarray(noise_sigma, dtype=np.float32)
        self.nu = self.noise_sigma.shape[0]
        self.noise_mu = np.asarray(
            mcfg.noise_mu or [0.0] * self.nu, dtype=np.float32
        )
        self.noise_sigma_inv = np.linalg.inv(self.noise_sigma)

        u_max = mcfg.u_max
        u_min = mcfg.u_min
        if u_max and not u_min:
            u_min = [-v for v in u_max]
        if u_min and not u_max:
            u_max = [-v for v in u_min]
        if u_min is None:  # unbounded controls (reference _bound_action no-op)
            u_min = [-np.inf] * self.nu
            u_max = [np.inf] * self.nu
        self.u_min = jnp.asarray(u_min, dtype=jnp.float32)
        self.u_max = jnp.asarray(u_max, dtype=jnp.float32)

        self.nx = mcfg.nx
        self.gamma = mcfg.rollout_var_discount
        self.gamma_seq = jnp.asarray(
            np.cumprod([1.0] + [self.gamma] * (self.T - 1)), dtype=jnp.float32
        )
        self.fine_noise_scale = getattr(mcfg, "fine_noise_scale", 0.05)
        self.exploration_noise = float(getattr(mcfg, "exploration_noise", 0.05))
        _ba = getattr(mcfg, "beta_adapt", None)
        self.beta_adapt = (
            self.env_type in ("panda_env", "boxer_env")
            if _ba is None
            else bool(_ba)
        )
        # STORM-lineage constants (mppi.py:168-203)
        self.knot_scale = 4
        self.n_knots = self.T // self.knot_scale
        self.ndims = self.n_knots * self.nu
        self.degree = 2
        self.step_size_mean = 0.98
        self.eta_u = float(mcfg.eta_u_bound)
        self.eta_l = float(mcfg.eta_l_bound)
        self.step_size_cov = 0.7  # (mppi.py:202)
        self.kappa = 0.005  # additive per-tick covariance drift (mppi.py:203)
        if mcfg.update_cov and (self.multi_modal or mcfg.mppi_mode == "simple"):
            raise ValueError(
                "update_cov only applies to single-mode halton-spline MPPI "
                "(the reference's covariance update lives in "
                "_update_distribution, mppi.py:508-516, which the multi-modal "
                "and simple paths never reach); for the multi-modal path use "
                "update_cov_per_mode"
            )
        if mcfg.update_cov_per_mode and not self.multi_modal:
            raise ValueError("update_cov_per_mode requires multi_modal=True")
        self.squash_fn = "clamp"
        self.scale_tril = jnp.asarray(
            np.sqrt(np.diagonal(self.noise_sigma)), dtype=jnp.float32
        )
        self.seed_val = mcfg.seed_val

        # Savitzky–Golay operator (window 9 order 2, mppi.py:190-193)
        sgf_window = min(9, self.T if self.T % 2 == 1 else self.T - 1)
        self._sgf = jnp.asarray(
            savgol_matrix(self.T, sgf_window, 2), dtype=jnp.float32
        )

        # Cached Halton-spline deltas [K, T, nu] (mppi.py:388-389, 458-478):
        # gaussian-Halton knots -> spline basis matmul, zero-noise row at K-1
        # (mppi.py:391-392).
        self._delta = jnp.asarray(self._make_halton_spline_deltas())

        # mode id per sample: first half mode 0, second half mode 1
        self.sample_mode = jnp.asarray(
            (np.arange(self.K) >= self.half_K).astype(np.int32)
        )

        self.F = dynamics
        self.running_cost = running_cost
        self.zero_ext = zero_ext
        self.traj_point = traj_point
        self.state_vector = state_vector
        # Per-sample friction domain randomization (isaacgym_wrapper.py:313-319
        # parity): ``fric_noise`` [D] = per-dyn-actor noise percentage from
        # the actor YAMLs; ``fric_inject(sim_state_k, fric_scale_k)`` writes
        # the [K, D] scales into the broadcast rollout states (env-specific —
        # the point family stores them in PointEnvState.fric_scale).
        self.fric_noise = None if fric_noise is None else np.asarray(fric_noise)
        self.fric_inject = fric_inject
        self._fric_scale = jnp.asarray(self._make_fric_scales())

        from m3p2i_aip_tpu.ops.pallas_kernels import gpu_kernels_available

        # the Triton kernels compile only for a GPU; elsewhere the planner
        # runs its plain XLA path (no interpret-mode fallback)
        self.use_pallas = gpu_kernels_available() and getattr(mcfg, "use_pallas", True)
        # Optional fused rollout (ops/pallas_rollout.py): set via
        # set_rollout_override, NOT by assigning the attribute — the value is
        # captured at jit trace time of `command`.
        self.rollout_override = None
        self.mesh = None  # optional device mesh; see parallel/mesh.py
        self._command = jax.jit(self._command_impl)

    def set_rollout_override(self, fn) -> None:
        """Install/remove a fused rollout (re-jits: the override is baked
        into the compiled ``command``).  ``fn(sim_state_k, scaled_acts, task)
        -> (cost_horizon [K, T], traj_points [K, T, d])``; fused rollouts
        assume all K start states are identical (the planner broadcasts the
        real state — reactive_tamp.py:45-48 parity), unlike the generic
        per-sample-state `_rollout` contract."""
        self.rollout_override = fn
        self._command = jax.jit(self._command_impl)

    def set_mesh(self, mesh) -> None:
        """Shard the K sample axis over ``mesh`` (re-jits the command).

        One ``with_sharding_constraint`` on the [K, T, nu] action tensor is
        enough: GSPMD partitions the vmapped rollout per chip and inserts the
        all-reduces for the weight computation's global min/sum/argmax.
        """
        self.mesh = mesh
        self._command = jax.jit(self._command_impl)

    def _constrain_samples(self, x: jnp.ndarray) -> jnp.ndarray:
        if self.mesh is None:
            return x
        from jax.sharding import NamedSharding, PartitionSpec

        return jax.lax.with_sharding_constraint(
            x, NamedSharding(self.mesh, PartitionSpec("samples"))
        )

    # ------------------------------------------------------------------ init
    def _make_halton_spline_deltas(self) -> np.ndarray:
        knots = gaussian_halton_samples(
            self.K, self.ndims, scramble=True, seed_val=self.seed_val
        ).astype(np.float32)
        knots = knots.reshape(self.K, self.nu, self.n_knots)
        M = bspline_interp_matrix(
            self.n_knots, self.T, degree=self.degree, smoothing=0.5
        ).astype(np.float32)
        # [K, nu, n_knots] @ [n_knots, T] -> [K, nu, T] -> [K, T, nu]
        samples = np.einsum("kun,tn->ktu", knots, M)
        # Multi-scale sampling (extension over the reference): the last
        # quarter of each mode's half-batch is scaled down to fine noise.
        # A single coarse scale (scale_tril ~ sqrt(10) rad/s for the panda)
        # leaves a ~2 cm terminal-positioning floor — below what the panda
        # task planner's reach->pick gate needs (pre_height_diff + 5 mm,
        # task_planner.py:58-76).  Fine rows let the importance weights
        # resolve millimetre corrections near convergence at zero runtime
        # cost (the deltas are precomputed).
        for start in (0, self.half_K):
            half = self.half_K if self.K > 1 else self.K
            fine_lo = start + (3 * half) // 4
            samples[fine_lo : start + half] *= self.fine_noise_scale
        samples[-1] = 0.0  # zero-noise sequence so the mean is always sampled
        return samples

    def _make_fric_scales(self) -> np.ndarray:
        """[K, D] per-sample friction multipliers, 1 + U(-pct, pct) per
        (sample, actor) — the per-env creation-time draw of the reference
        (friction + uniform(+-pct * friction), isaacgym_wrapper.py:313-319),
        expressed multiplicatively.  All ones when no actor sets noise."""
        D = 0 if self.fric_noise is None else int(self.fric_noise.shape[0])
        if D == 0 or not np.any(self.fric_noise):
            return np.ones((self.K, max(D, 1)), dtype=np.float32)
        rng = np.random.default_rng(self.seed_val + 7919)  # decorrelated
        u = rng.uniform(-1.0, 1.0, size=(self.K, D)).astype(np.float32)
        return 1.0 + u * self.fric_noise[None, :].astype(np.float32)

    def reseed(self, seed_val: int) -> None:
        """Re-seed the sampler WITHOUT retracing: the Halton deltas, the
        domain-randomization scales and the PRNG key live in MPPIState
        (traced data), so a fresh ``init_state()`` after this reuses the
        compiled program — one XLA compile serves a whole seeded experiment
        batch."""
        self.seed_val = int(seed_val)
        self._delta = jnp.asarray(self._make_halton_spline_deltas())
        self._fric_scale = jnp.asarray(self._make_fric_scales())

    def init_state(self, rng: Optional[jax.Array] = None) -> MPPIState:
        z = jnp.zeros((self.T, self.nu), dtype=jnp.float32)
        rng = rng if rng is not None else jax.random.PRNGKey(self.seed_val)
        rng, sub = jax.random.split(rng)
        if self.cfg.U_init is not None:
            U0 = jnp.asarray(self.cfg.U_init, dtype=jnp.float32)
        else:
            # reference initializes U by sampling the noise dist (mppi.py:134)
            U0 = jax.random.multivariate_normal(
                sub, jnp.asarray(self.noise_mu), jnp.asarray(self.noise_sigma),
                shape=(self.T,),
            )
        return MPPIState(
            mean_action=z,
            mean_action_1=z,
            mean_action_2=z,
            best_traj=z,
            best_traj_1=z,
            best_traj_2=z,
            U=U0.astype(jnp.float32),
            # strong-typed scalar: a weak-typed init would change the jit
            # signature after the first update and force a full recompile
            beta=jnp.ones((), dtype=jnp.float32),
            weights=jnp.full((self.K,), 1.0 / self.K, dtype=jnp.float32),
            cov_action=jnp.asarray(
                np.diagonal(self.noise_sigma), dtype=jnp.float32
            ),
            cov_action_1=jnp.asarray(
                np.diagonal(self.noise_sigma), dtype=jnp.float32
            ),
            cov_action_2=jnp.asarray(
                np.diagonal(self.noise_sigma), dtype=jnp.float32
            ),
            rng=rng,
            halton_delta=self._delta,
            fric_scale_k=self._fric_scale,
        )

    # --------------------------------------------------------------- helpers
    @staticmethod
    def _shift(seq: jnp.ndarray) -> jnp.ndarray:
        """Time-shift an action sequence, repeating the last action.

        Parity: MPPI._shift_action (mppi.py:266-273).
        """
        return jnp.roll(seq, -1, axis=0).at[-1].set(seq[-1])

    def _gripper_override(self, acts: jnp.ndarray, task: TaskParams) -> jnp.ndarray:
        """Panda gripper channels 7,8 forced to +/-1.5 (mppi.py:346-350, 412-416)."""
        if self.nu < 9:
            return acts
        val = jnp.where(task.gripper == 1, 1.5, jnp.where(task.gripper == 2, -1.5, 0.0))
        use = task.gripper > 0
        grip = jnp.where(use, val, acts[..., 7])
        acts = acts.at[..., 7].set(grip)
        grip8 = jnp.where(use, val, acts[..., 8])
        return acts.at[..., 8].set(grip8)

    def _sharded_override_rollout(self, sim_state0, acts, task):
        """Fused rollout kernel under ``shard_map``: each device runs the
        kernel on its K/n sample slice (rollouts are embarrassingly parallel
        through the dynamics — SURVEY.md §2.2).  The kernel receives its
        shard's global sample offset so the M3P2I half-batch mode split stays
        global-index based."""
        from jax import shard_map
        from jax.sharding import PartitionSpec

        n = int(self.mesh.devices.size)
        K_loc = self.K // n
        sample = PartitionSpec("samples")
        rep = PartitionSpec()

        def body(s, a, t):
            k0 = jax.lax.axis_index("samples") * K_loc
            return self.rollout_override(s, a, t, k0=k0)

        return shard_map(
            body,
            mesh=self.mesh,
            in_specs=(sample, sample, rep),
            out_specs=(sample, sample),
            # pallas_call outputs carry no varying-mesh-axis annotation;
            # correctness is covered by the sharded==unsharded equality test
            check_vma=False,
        )(sim_state0, acts, task)

    def _rollout(self, sim_state0, acts: jnp.ndarray, task: TaskParams):
        """Roll all K sampled sequences through the dynamics.

        Parity: _compute_rollout_costs (mppi.py:275-332) — but as
        vmap(dynamics) inside lax.scan over the horizon.
        Returns (cost_horizon [K, T], traj_points [K, T, d]).
        """
        if self.rollout_override is not None:
            if self.mesh is None:
                return self.rollout_override(sim_state0, acts, task)
            return self._sharded_override_rollout(sim_state0, acts, task)
        ext0 = jax.vmap(lambda _: self.zero_ext())(jnp.arange(self.K))
        mode = self.sample_mode

        def step_t(carry, u_t):
            sim_state, ext = carry
            sim_state = jax.vmap(self.F)(sim_state, u_t, ext)
            cost, ext = jax.vmap(self.running_cost, in_axes=(0, 0, None, 0))(
                sim_state, u_t, task, mode
            )
            tp = (
                jax.vmap(self.traj_point)(sim_state)
                if self.traj_point is not None
                else jnp.zeros((self.K, 2))
            )
            return (sim_state, ext), (cost, tp)

        acts_t = jnp.swapaxes(acts, 0, 1)  # [T, K, nu]
        (_, _), (costs, tps) = jax.lax.scan(step_t, (sim_state0, ext0), acts_t)
        return jnp.swapaxes(costs, 0, 1), jnp.swapaxes(tps, 0, 1)

    # ---------------------------------------------------- weight computation
    def _exp_util(self, cost_horizon, beta):
        """Single-mode weights. Parity: MPPI._exp_util (mppi.py:430-456)."""
        traj_costs = discounted_traj_cost(cost_horizon, self.gamma_seq)
        total = traj_costs - jnp.min(traj_costs)
        exp_ = jnp.exp((-1.0 / beta) * total)
        eta = jnp.sum(exp_)
        weights = exp_ / eta
        if self.beta_adapt:
            # single-step beta adaptation, bounds 20/10 (mppi.py:446-454).
            # Auto-enabled for panda (reference gate) AND boxer (extension —
            # see MPPIConfig.beta_adapt); mppi=boxer_parity ablates it.
            beta = jnp.where(eta > 20.0, beta * 0.9, jnp.where(eta < 10.0, beta * 1.2, beta))
        return weights, beta

    def _multi_modal_exp_util(self, cost_horizon):
        """Per-mode + global adaptive-beta weights.

        Parity: M3P2I._multi_modal_exp_util (m3p2i.py:46-64).  Note the
        reference passes self.beta_* but never persists the tuned values —
        each call starts from beta=1; replicated here.

        On a GPU this dispatches to the fused Triton kernel
        (ops/pallas_kernels.py): cost-to-go + all three masked adaptive-beta
        softmaxes in one program, with no host-polled loop.
        """
        if self.use_pallas and self.mesh is None:  # single-chip fast path
            from m3p2i_aip_tpu.ops.pallas_kernels import multimodal_weights_pallas

            return multimodal_weights_pallas(
                cost_horizon, self.gamma_seq, self.half_K, self.eta_u, self.eta_l
            )
        traj_costs = discounted_traj_cost(cost_horizon, self.gamma_seq)
        m0 = self.sample_mode == 0
        inf = jnp.asarray(jnp.inf)
        min0 = jnp.min(jnp.where(m0, traj_costs, inf))
        min1 = jnp.min(jnp.where(~m0, traj_costs, inf))
        tc0 = traj_costs - min0
        tc1 = traj_costs - min1
        tc = traj_costs - jnp.min(traj_costs)

        one = jnp.asarray(1.0)
        # masked etas: exclude the other mode's samples from the sums
        def masked_beta(costs, mask, eta_u, eta_l):
            big = jnp.where(mask, costs, jnp.inf)  # exp(-inf) = 0

            def cond(c):
                beta, it = c
                eta = jnp.sum(jnp.exp((-1.0 / beta) * big))
                return ((eta > eta_u) | (eta < eta_l)) & (it < 64)

            def body(c):
                beta, it = c
                eta = jnp.sum(jnp.exp((-1.0 / beta) * big))
                beta = jnp.where(eta > eta_u, beta * 0.9, jnp.where(eta < eta_l, beta * 1.2, beta))
                return beta, it + 1

            beta, _ = jax.lax.while_loop(cond, body, (one, jnp.asarray(0)))
            exp_ = jnp.where(mask, jnp.exp((-1.0 / beta) * big), 0.0)
            return jnp.sum(exp_), exp_

        eta0, exp0 = masked_beta(tc0, m0, self.eta_u, self.eta_l)
        eta1, exp1 = masked_beta(tc1, ~m0, self.eta_u, self.eta_l)
        eta, exp_ = masked_beta(tc, jnp.ones_like(m0), self.eta_u, self.eta_l)
        return exp0 / eta0, exp1 / eta1, exp_ / eta

    # ---------------------------------------------------------------- update
    def _update_halton(self, state: MPPIState, cost_horizon, actions):
        """Distribution updates for halton-spline mode.

        Parity: _update_distribution (mppi.py:485-503) and
        _update_multi_modal_distribution (m3p2i.py:66-92).
        """
        if self.multi_modal:
            w0, w1, w = self._multi_modal_exp_util(cost_horizon)
            best0 = actions[jnp.argmax(w0)]
            best1 = actions[jnp.argmax(w1)]
            mean0 = jnp.einsum("k,ktu->tu", w0, actions, precision=_HIGHEST)
            mean1 = jnp.einsum("k,ktu->tu", w1, actions, precision=_HIGHEST)
            new_mean = jnp.einsum("k,ktu->tu", w, actions, precision=_HIGHEST)
            mean = (
                (1.0 - self.step_size_mean) * state.mean_action
                + self.step_size_mean * new_mean
            )
            state = state.replace(
                mean_action=mean,
                mean_action_1=mean0,
                mean_action_2=mean1,
                best_traj_1=best0,
                best_traj_2=best1,
                weights=w,
            )
            if self.cfg.update_cov_per_mode:
                # Per-mode analogue of the single-mode update below: each
                # mode's masked weights (already normalized over the mode)
                # drive its own second-moment EMA.  These EMAs are consumed
                # as RELATIVE exploration allocation (see _command_halton),
                # never as absolute scales: the raw reference formula's
                # steady state is kappa / step_size_cov ~ 0.007, measured to
                # collapse sampling to ~0.1x of nominal within 25 ticks and
                # park the corner hybrid 0.5 m short of the pocket.  The
                # ratio between the two modes is the signal worth keeping —
                # the sharpening winner vs the still-exploring loser.
                def mode_cov(cov, w_m, mean_m):
                    delta = actions - mean_m[None]
                    second = jnp.mean(
                        jnp.einsum("k,ktu->tu", w_m, delta**2, precision=_HIGHEST), axis=0
                    )
                    return (
                        (1.0 - self.step_size_cov) * cov
                        + self.step_size_cov * second
                        + self.kappa
                    )

                state = state.replace(
                    cov_action_1=mode_cov(state.cov_action_1, w0, mean0),
                    cov_action_2=mode_cov(state.cov_action_2, w1, mean1),
                )
            return state
        w, beta = self._exp_util(cost_horizon, state.beta)
        best = actions[jnp.argmax(w)]
        new_mean = jnp.einsum("k,ktu->tu", w, actions, precision=_HIGHEST)
        mean = (
            (1.0 - self.step_size_mean) * state.mean_action
            + self.step_size_mean * new_mean
        )
        state = state.replace(mean_action=mean, best_traj=best, weights=w, beta=beta)
        if self.cfg.update_cov:
            # Optional diagonal covariance adaptation (mppi.py:508-516):
            # weighted second moment of the action deviations, smoothed by
            # step_size_cov, plus the additive kappa drift (steady-state
            # minimum kappa / step_size_cov, not a hard floor).
            delta = actions - mean[None]
            cov_update = jnp.mean(
                jnp.einsum("k,ktu->tu", w, delta**2, precision=_HIGHEST), axis=0
            )
            cov = (
                (1.0 - self.step_size_cov) * state.cov_action
                + self.step_size_cov * cov_update
                + self.kappa
            )
            state = state.replace(cov_action=cov)
        return state

    # --------------------------------------------------------------- command
    def command(self, state: MPPIState, sim_state, task: TaskParams):
        """One replanning step.  ``sim_state`` is the single real-env state
        (the planner broadcasts it over K, parity reactive_tamp.py:45-48).

        Returns (action_sequence [u_per_command, nu], new_state, aux dict).
        """
        return self._command(state, sim_state, task)

    def _command_impl(self, state: MPPIState, sim_state, task: TaskParams):
        sim_state_k = jax.tree_util.tree_map(
            lambda x: jnp.broadcast_to(x, (self.K,) + x.shape), sim_state
        )
        if self.fric_inject is not None:
            # per-sample domain randomization: overwrite the broadcast
            # friction scales with this seed's [K, D] draws (traced data)
            sim_state_k = self.fric_inject(sim_state_k, state.fric_scale_k)

        if self.mppi_mode == "simple":
            state, action, tps = self._command_simple(state, sim_state_k, task)
        else:
            state, action, tps = self._command_halton(state, sim_state_k, task)

        if self.filter_u:
            action = jnp.matmul(
                self._sgf[: action.shape[0], : action.shape[0]], action,
                precision=_HIGHEST,
            )

        # top-20 rollout positions for visualization (mppi.py:248-254)
        k = min(20, self.K)
        top_vals, top_idx = jax.lax.top_k(state.weights, k)
        aux = {
            "weights": state.weights,
            "top_trajs": tps[top_idx],
            "top_values": top_vals,
        }
        return action, state, aux

    def _command_halton(self, state: MPPIState, sim_state_k, task: TaskParams):
        # shift nominal sequences one step (mppi.py:236-242)
        state = state.replace(
            mean_action=self._shift(state.mean_action),
            mean_action_1=self._shift(state.mean_action_1),
            mean_action_2=self._shift(state.mean_action_2),
            best_traj=self._shift(state.best_traj),
            best_traj_1=self._shift(state.best_traj_1),
            best_traj_2=self._shift(state.best_traj_2),
        )

        if self.sampling_method == "random":
            rng, sub = jax.random.split(state.rng)
            delta = jax.random.multivariate_normal(
                sub, jnp.asarray(self.noise_mu), jnp.asarray(self.noise_sigma),
                shape=(self.K, self.T),
            ).astype(jnp.float32)
            delta = delta.at[-1].set(0.0)
            state = state.replace(rng=rng)
        else:
            delta = state.halton_delta
            if self.exploration_noise > 0.0:
                # Tiny per-tick jitter on the cached Halton deltas.  The
                # reference's planner is equally deterministic but rides a
                # nondeterministic physics engine with randomized friction
                # (isaacgym_wrapper.py:311-326); a fully deterministic
                # planner+sim pair can park in a replanning fixed point
                # (observed on corner push_pull).  This breaks such fixed
                # points while leaving the low-discrepancy structure intact.
                rng, sub = jax.random.split(state.rng)
                delta = delta + self.exploration_noise * jax.random.normal(
                    sub, delta.shape, dtype=jnp.float32
                )
                delta = delta.at[-1].set(0.0)  # keep the pure-mean sample
                state = state.replace(rng=rng)

        # (mppi.py:394); with update_cov the scale adapts per tick (:516)
        if self.cfg.update_cov:
            scale = jnp.sqrt(state.cov_action)
        elif self.multi_modal and self.cfg.update_cov_per_mode:
            # Each mode's half-batch samples at the NOMINAL scale times its
            # relative share of the two second-moment EMAs, clamped to
            # [0.5x, 2x].  Normalizing by the cross-mode mean cancels the
            # common-mode collapse of the raw EMAs (both shrink toward
            # kappa / step_size_cov as weights concentrate) while keeping
            # the useful signal: the winning mode sharpens, the losing mode
            # keeps exploring wide.
            ref = 0.5 * (state.cov_action_1 + state.cov_action_2)
            base = self.scale_tril**2
            s1 = jnp.sqrt(
                jnp.clip(state.cov_action_1 / ref, 0.25, 4.0) * base
            )
            s2 = jnp.sqrt(
                jnp.clip(state.cov_action_2 / ref, 0.25, 4.0) * base
            )
            scale = jnp.where(
                (self.sample_mode == 0)[:, None, None],
                s1[None, None],
                s2[None, None],
            )
        else:
            scale = self.scale_tril
        scaled_delta = delta * scale
        if self.multi_modal:
            mean_m = jnp.where(
                (self.sample_mode == 0)[:, None, None],
                state.mean_action_1[None],
                state.mean_action_2[None],
            )
            act_seq = mean_m + scaled_delta
        else:
            act_seq = state.mean_action[None] + scaled_delta
        act_seq = scale_ctrl(act_seq, self.u_min, self.u_max, self.squash_fn)

        if self.multi_modal:
            # inject per-mode elite sequences at slots 0 and K/2 (mppi.py:407-409)
            act_seq = act_seq.at[0].set(state.best_traj_1)
            act_seq = act_seq.at[self.half_K].set(state.best_traj_2)
        elif self.cfg.sample_best_traj:
            act_seq = act_seq.at[0].set(state.best_traj)

        act_seq = self._gripper_override(act_seq, task)
        if self.sample_null_action:
            act_seq = act_seq.at[self.K - 1].set(0.0)  # braking sample (mppi.py:300-302)
        act_seq = self._constrain_samples(act_seq)

        cost_horizon, tps = self._rollout(sim_state_k, self.u_scale * act_seq, task)
        actions = act_seq  # u_scale divided back out (mppi.py:420)

        state = self._update_halton(state, cost_horizon, actions)
        state = self._sample_refine(state, sim_state_k, task)
        state = self._grad_refine(state, sim_state_k, task)
        action = state.mean_action  # (mppi.py:245)
        return state, action, tps

    def _sample_refine(self, state: MPPIState, sim_state_k, task: TaskParams):
        """Annealed resampling refinement of the mean plan(s) — see
        MPPIConfig.refine_iters.  Each iteration re-samples the cached
        Halton deltas at a shrinking scale around the CURRENT means, rolls
        them through the fused kernel, and re-applies the importance-
        weighted distribution update.  The K-1 zero-noise row keeps the
        pure mean in every refine batch, so the update always sees the
        incumbent plan's own cost."""
        iters = int(getattr(self.cfg, "refine_iters", 0) or 0)
        if iters <= 0:
            return state
        # NOTE: each softmax refine iteration runs the full distribution
        # update, so a persistent single-mode beta (beta_adapt) takes its
        # one-step adaptation once per ITERATION, not once per tick — i.e.
        # 1 + refine_iters steps/tick.  The albert family (beta_adapt=True,
        # refine_iters=3) is quality-gated at exactly this cadence
        # (RESULTS.md albert envelope rows); changing the cadence is a
        # behavior change those envelopes must re-validate.
        scale0 = float(getattr(self.cfg, "refine_scale", 0.1))
        decay = float(getattr(self.cfg, "refine_decay", 0.5))
        for i in range(iters):  # trace-time unrolled (iters is small)
            scale = scale0 * (decay**i) * self.scale_tril
            delta = state.halton_delta * scale
            if self.multi_modal:
                mean_m = jnp.where(
                    (self.sample_mode == 0)[:, None, None],
                    state.mean_action_1[None],
                    state.mean_action_2[None],
                )
                act_seq = mean_m + delta
            else:
                act_seq = state.mean_action[None] + delta
            act_seq = scale_ctrl(act_seq, self.u_min, self.u_max, self.squash_fn)
            if self.multi_modal:
                # keep the per-mode elites alive through the refine ladder,
                # and ride the PURE per-mode means at slots 1 / half_K+1 so
                # the greedy final pick is monotone per mode
                act_seq = act_seq.at[0].set(state.best_traj_1)
                act_seq = act_seq.at[self.half_K].set(state.best_traj_2)
                act_seq = act_seq.at[1].set(state.mean_action_1)
                act_seq = act_seq.at[self.half_K + 1].set(state.mean_action_2)
            elif self.cfg.sample_best_traj:
                act_seq = act_seq.at[0].set(state.best_traj)
            act_seq = self._gripper_override(act_seq, task)
            # NOTE: no null-action overwrite here — the K-1 zero-noise row
            # must stay the pure mean so refinement can never rank the
            # incumbent plan out of its own update
            act_seq = self._constrain_samples(act_seq)
            cost_horizon, _tps = self._rollout(
                sim_state_k, self.u_scale * act_seq, task
            )
            greedy = bool(getattr(self.cfg, "refine_greedy", True)) and (
                i == iters - 1
            )
            if greedy:
                state = self._greedy_pick(state, cost_horizon, act_seq)
            else:
                state = self._update_halton(state, cost_horizon, act_seq)
        return state

    def _greedy_pick(self, state: MPPIState, cost_horizon, actions):
        """Set the mean plan(s) to the argmin sample (per mode) — the final
        rung of the refine ladder.  See MPPIConfig.refine_greedy."""
        traj_costs = discounted_traj_cost(cost_horizon, self.gamma_seq)
        if self.multi_modal:
            m0 = self.sample_mode == 0
            inf = jnp.asarray(jnp.inf)
            i0 = jnp.argmin(jnp.where(m0, traj_costs, inf))
            i1 = jnp.argmin(jnp.where(~m0, traj_costs, inf))
            ig = jnp.argmin(traj_costs)
            return state.replace(
                mean_action=actions[ig],
                mean_action_1=actions[i0],
                mean_action_2=actions[i1],
            )
        return state.replace(mean_action=actions[jnp.argmin(traj_costs)])

    def _grad_refine(self, state: MPPIState, sim_state_k, task: TaskParams):
        """First-order refinement of the mean plan on the differentiable
        rollout (see MPPIConfig.grad_refine_steps)."""
        steps = int(getattr(self.cfg, "grad_refine_steps", 0) or 0)
        if steps <= 0:
            return state
        lr = float(getattr(self.cfg, "grad_refine_lr", 0.02))
        sim_state0 = jax.tree_util.tree_map(lambda x: x[0], sim_state_k)

        def plan_cost(mean, mode):
            mean = self._gripper_override(mean, task)

            def step_t(carry, u_t):
                s, ext = carry
                s = self.F(s, self.u_scale * u_t, ext)
                c, ext = self.running_cost(s, u_t, task, mode)
                return (s, ext), c

            # unroll: T is small (12) and each step is tiny sequential elementwise
            # work — unrolling lets XLA fuse across steps in both the
            # forward and the induced reverse pass instead of paying loop
            # overhead per step (flag-gated: costs compile time)
            unroll = bool(getattr(self.cfg, "grad_refine_unroll", False))
            (_, _), costs = jax.lax.scan(
                step_t, (sim_state0, self.zero_ext()), mean,
                unroll=True if unroll else 1,
            )
            return jnp.sum(costs * self.gamma_seq)

        grad_fn = jax.grad(plan_cost)

        def refine_chain(mean, mode):
            def refine(mean, _):
                g = grad_fn(mean, mode)
                # contact/branch discontinuities can yield non-finite grads
                # (where-branch trap); treat them as zero descent direction
                g = jnp.where(jnp.isfinite(g), g, 0.0)
                # normalized step: robust to the 1000-scale collision penalties
                g = g / jnp.maximum(jnp.linalg.norm(g), 1e-6)
                mean = jnp.clip(mean - lr * g, self.u_min, self.u_max)
                return mean, None

            return jax.lax.scan(refine, mean, None, length=steps)[0]

        if self.multi_modal:
            # the global mean is refined under the currently-winning mode.
            # All three chains run as ONE vmapped scan: sequential depth is
            # inherent to gradient descent, but the per-mode axis is not —
            # batching it removes two of the three sequential chains.
            win = (
                jnp.sum(state.weights[self.half_K :])
                > jnp.sum(state.weights[: self.half_K])
            ).astype(jnp.int32)
            means = jnp.stack(
                [state.mean_action, state.mean_action_1, state.mean_action_2]
            )
            modes = jnp.stack(
                [win, jnp.zeros_like(win), jnp.ones_like(win)]
            )
            refined = jax.vmap(refine_chain)(means, modes)
            return state.replace(
                mean_action=self._gripper_override(refined[0], task),
                mean_action_1=self._gripper_override(refined[1], task),
                mean_action_2=self._gripper_override(refined[2], task),
            )
        mode0 = self.sample_mode[0]
        mean = self._gripper_override(refine_chain(state.mean_action, mode0), task)
        return state.replace(mean_action=mean)

    def _command_simple(self, state: MPPIState, sim_state_k, task: TaskParams):
        """Parity: _compute_total_cost_batch_simple + U update (mppi.py:220-233,
        335-363)."""
        U = jnp.roll(state.U, -1, axis=0)  # plain roll (mppi.py:221)
        rng, sub = jax.random.split(state.rng)
        noise = jax.random.multivariate_normal(
            sub, jnp.asarray(self.noise_mu), jnp.asarray(self.noise_sigma),
            shape=(self.K, self.T),
        ).astype(jnp.float32)
        perturbed = scale_ctrl(U[None] + noise, self.u_min, self.u_max, "clamp")
        perturbed = self._gripper_override(perturbed, task)
        if self.sample_null_action:
            perturbed = perturbed.at[self.K - 1].set(0.0)
        perturbed = self._constrain_samples(perturbed)

        cost_horizon, tps = self._rollout(sim_state_k, self.u_scale * perturbed, task)
        cost_total = jnp.sum(cost_horizon, axis=-1)

        noise_b = perturbed - U[None]  # post-bounding noise (mppi.py:356)
        action_cost = self.lambda_ * jnp.matmul(
            jnp.abs(noise_b) if self.cfg.noise_abs_cost else noise_b,
            jnp.asarray(self.noise_sigma_inv),
            precision=_HIGHEST,
        )
        cost_total = cost_total + jnp.sum(U[None] * action_cost, axis=(1, 2))

        beta = jnp.min(cost_total)
        nz = ensure_non_zero(cost_total, beta, 1.0 / self.lambda_)
        weights = nz / jnp.sum(nz)
        U = U + jnp.einsum("k,ktu->tu", weights, noise_b, precision=_HIGHEST)
        state = state.replace(U=U, weights=weights, rng=rng)
        # full sequence returned; the SG filter then acts on the whole [T]
        # window and the caller slices u_per_command (reference filters the
        # truncated slice instead -- identical when u_per_command == T, and
        # free of filter edge bias when it is shorter)
        return state, U, tps
