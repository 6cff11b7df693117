"""Pallas (Triton route) kernel for the M3P2I weight computation.

Discounted cost-to-go over the horizon plus THREE masked
adaptive-inverse-temperature softmaxes (mode 0, mode 1, global; parity
target ``m3p2i.py:24-64`` / SURVEY.md §5 "per-mode masked softmax
reductions").

In XLA this is three sequential data-dependent ``lax.while_loop``s; on a GPU
each iteration of such a loop reads its predicate back to the host.  Here
one program per batch element runs all three beta searches together
(bounded at ``_BETA_ITERS``, the reference's 0.9x / 1.2x update rule) with
no host round trip.  For K beyond one tile the program loops over K tiles
of ``block_k`` samples inside every pass instead of growing the block.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

_BETA_ITERS = 64  # matches the bounded while_loop in mppi._multi_modal_exp_util
MAX_BLOCK_K = 512  # samples per tile; larger K loops over tiles
NUM_WARPS = 4


def _next_pow2(x: int) -> int:
    return 1 << max(int(x) - 1, 0).bit_length()


def gpu_kernels_available() -> bool:
    """The Triton kernels compile only for an NVIDIA GPU backend."""
    return jax.default_backend() == "gpu"


def _weights_kernel(
    cost_ref,  # [Tp, Kp] f32 (K on the minor axis)
    gamma_ref,  # [Tp] f32 (zero on padded rows)
    w0_ref,  # out [Kp]: mode-0 weights
    w1_ref,  # out [Kp]: mode-1 weights
    w_ref,  # out [Kp]: global weights
    *,
    K: int,
    half_K: int,
    eta_u: float,
    eta_l: float,
    n_tiles: int,
    block_k: int,
):
    gamma = gamma_ref[:]
    inf = jnp.float32(jnp.inf)

    def tile(j):
        """(cost-to-go [block_k], group masks) of tile j."""
        start = pl.multiple_of(j * block_k, block_k)
        tc = jnp.sum(cost_ref[:, pl.ds(start, block_k)] * gamma[:, None], axis=0)
        cols = start + jax.lax.broadcasted_iota(jnp.int32, (block_k,), 0)
        valid = cols < K
        return start, tc, (valid & (cols < half_K), valid & (cols >= half_K), valid)

    def min_body(j, mins):
        _, tc, masks = tile(j)
        return tuple(
            jnp.minimum(m, jnp.min(jnp.where(mask, tc, inf)))
            for m, mask in zip(mins, masks)
        )

    mins = jax.lax.fori_loop(0, n_tiles, min_body, (inf, inf, inf))

    def exps(tc, masks, betas):
        return tuple(
            jnp.where(mask, jnp.exp((-1.0 / beta) * (tc - m)), 0.0)
            for mask, m, beta in zip(masks, mins, betas)
        )

    def etas(betas):
        def body(j, acc):
            _, tc, masks = tile(j)
            return tuple(a + jnp.sum(e) for a, e in zip(acc, exps(tc, masks, betas)))

        zero = jnp.float32(0.0)
        return jax.lax.fori_loop(0, n_tiles, body, (zero, zero, zero))

    # one beta search over all three groups, early-exit like the
    # reference's unbounded while (m3p2i.py:24-44), bounded at _BETA_ITERS;
    # the carry holds eta at the current beta
    def cond(carry):
        _, eta, it = carry
        out = [(e > eta_u) | (e < eta_l) for e in eta]
        return (out[0] | out[1] | out[2]) & (it < _BETA_ITERS)

    def body(carry):
        betas, eta, it = carry
        betas = tuple(
            jnp.where(e > eta_u, b * 0.9, jnp.where(e < eta_l, b * 1.2, b))
            for b, e in zip(betas, eta)
        )
        return betas, etas(betas), it + 1

    one = jnp.float32(1.0)
    betas0 = (one, one, one)
    betas, eta, _ = jax.lax.while_loop(
        cond, body, (betas0, etas(betas0), jnp.int32(0))
    )

    def write(j, carry):
        start, tc, masks = tile(j)
        e0, e1, e = exps(tc, masks, betas)
        w0_ref[pl.ds(start, block_k)] = e0 / eta[0]
        w1_ref[pl.ds(start, block_k)] = e1 / eta[1]
        w_ref[pl.ds(start, block_k)] = e / eta[2]
        return carry

    jax.lax.fori_loop(0, n_tiles, write, 0)


_MMW_FNS = {}  # (K, T, half_K, eta_u, eta_l, interpret) -> custom_vmap callable


def _build_mmw(K: int, T: int, half_K: int, eta_u: float, eta_l: float,
               interpret: bool):
    """Build the (vmap-able) fused weights callable for one static shape."""
    from jax.custom_batching import custom_vmap

    block_k = min(_next_pow2(K), MAX_BLOCK_K)
    n_tiles = -(-K // block_k)
    Kp, Tp = n_tiles * block_k, _next_pow2(T)

    def _pack(cost_horizon):
        # [Tp, Kp]: K on the minor axis; padded samples are masked in-kernel
        cost_p = jnp.zeros((Tp, Kp), dtype=jnp.float32)
        return cost_p.at[:T, :K].set(cost_horizon.astype(jnp.float32).T)

    # named closure, NOT functools.partial — a partial's repr embeds a memory
    # address, destabilizing the persistent-compilation-cache key across
    # processes (see pallas_rollout.py)
    def weights_kernel(*refs):
        return _weights_kernel(
            *refs, K=K, half_K=half_K, eta_u=eta_u, eta_l=eta_l,
            n_tiles=n_tiles, block_k=block_k,
        )

    calls = {}

    def call(cost_p, gamma_p):
        B = cost_p.shape[0]
        if B not in calls:
            out = jax.ShapeDtypeStruct((B, Kp), jnp.float32)
            out_spec = pl.BlockSpec((None, Kp), lambda b: (b, 0))
            calls[B] = pl.pallas_call(
                weights_kernel,
                grid=(B,),
                out_shape=(out, out, out),
                in_specs=[
                    pl.BlockSpec((None, Tp, Kp), lambda b: (b, 0, 0)),
                    pl.BlockSpec((Tp,), lambda b: (0,)),
                ],
                out_specs=(out_spec, out_spec, out_spec),
                backend="triton",
                compiler_params=pl_triton.CompilerParams(
                    num_warps=NUM_WARPS, num_stages=1
                ),
                interpret=interpret,
            )
        return calls[B](cost_p, gamma_p)

    def gamma_pad(gamma_seq):
        return jnp.zeros((Tp,), jnp.float32).at[:T].set(
            gamma_seq.astype(jnp.float32)
        )

    @custom_vmap
    def mmw(cost_horizon, gamma_seq):
        w0, w1, w = call(_pack(cost_horizon)[None], gamma_pad(gamma_seq))
        return w0[0, :K], w1[0, :K], w[0, :K]

    @mmw.def_vmap
    def _mmw_vmap(axis_size, in_batched, cost_horizon, gamma_seq):
        # Batched variant: the SAME kernel body over a grid=(B,), one padded
        # [Tp, Kp] cost block per batch element (the vmapped multi-seed
        # runner, tamp/batch_loop.py, hits this under jax.vmap).  gamma is a
        # planner constant, never batched in practice.
        if in_batched[1]:
            raise NotImplementedError("batched gamma_seq")
        if not in_batched[0]:
            cost_horizon = jnp.broadcast_to(
                cost_horizon[None], (axis_size,) + cost_horizon.shape
            )
        w0, w1, w = call(jax.vmap(_pack)(cost_horizon), gamma_pad(gamma_seq))
        return (w0[:, :K], w1[:, :K], w[:, :K]), (True, True, True)

    return mmw


def multimodal_weights_pallas(
    cost_horizon: jnp.ndarray,
    gamma_seq: jnp.ndarray,
    half_K: int,
    eta_u: float = 10.0,
    eta_l: float = 3.0,
    interpret: bool = False,
):
    """Fused (w_mode0, w_mode1, w_global) from [K, T] rollout costs.

    Drop-in for MPPI._multi_modal_exp_util's three masked adaptive-beta
    softmaxes (m3p2i.py:46-64 semantics).  Returns three [K] weight vectors.
    ``interpret=True`` runs the kernel in the Pallas interpreter (CPU tests
    only).  vmap-able: a batched call dispatches one grid=(B,) kernel.
    """
    K, T = cost_horizon.shape[-2], cost_horizon.shape[-1]
    key = (K, T, half_K, float(eta_u), float(eta_l), bool(interpret))
    if key not in _MMW_FNS:
        _MMW_FNS[key] = _build_mmw(K, T, half_K, eta_u, eta_l, interpret)
    return _MMW_FNS[key](cost_horizon, gamma_seq)
