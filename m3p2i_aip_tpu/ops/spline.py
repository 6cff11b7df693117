"""B-spline knot interpolation as a precomputed linear operator (one matmul).

The reference interpolates Halton knot samples to a full horizon with a scipy
smoothing spline, one host-side fit per (sample, action-dim) — K*nu calls to
``si.splrep``/``si.splev`` (``src/m3p2i_aip/utils/skill_utils.py:9-22``, invoked
in a python double loop at ``mppi.py:474-478``).

For a fixed knot vector the knots -> horizon map is LINEAR, so we
precompute a single basis matrix M [T, n_knots] once at init and evaluate all
K*nu splines as one batched matmul ``samples = knots @ M.T`` (zero host
work).  The smoothing parameter plays the role of scipy's ``s``:
a small second-difference penalty on the control points.
"""
from __future__ import annotations

import numpy as np


def _bspline_basis(x: np.ndarray, knot_vector: np.ndarray, degree: int) -> np.ndarray:
    """Cox–de Boor evaluation of all basis functions at points ``x``.

    Returns [len(x), n_basis] with n_basis = len(knot_vector) - degree - 1.
    """
    kv = knot_vector
    n_basis = len(kv) - degree - 1
    x = np.asarray(x, dtype=np.float64)
    # Degree-0: indicator functions (half-open, last interval closed).
    B = np.zeros((x.size, len(kv) - 1))
    for i in range(len(kv) - 1):
        if kv[i + 1] > kv[i]:
            B[:, i] = (x >= kv[i]) & (x < kv[i + 1])
    last = np.max(kv)
    # Close the final non-empty interval so x == last is covered.
    for i in range(len(kv) - 2, -1, -1):
        if kv[i + 1] >= last and kv[i] < kv[i + 1]:
            B[x == last, i] = 1.0
            break
    for d in range(1, degree + 1):
        Bn = np.zeros((x.size, len(kv) - d - 1))
        for i in range(len(kv) - d - 1):
            left = 0.0
            if kv[i + d] > kv[i]:
                left = (x - kv[i]) / (kv[i + d] - kv[i]) * B[:, i]
            right = 0.0
            if kv[i + d + 1] > kv[i + 1]:
                right = (kv[i + d + 1] - x) / (kv[i + d + 1] - kv[i + 1]) * B[:, i + 1]
            Bn[:, i] = left + right
        B = Bn
    return B[:, :n_basis]


def bspline_interp_matrix(
    n_knots: int,
    horizon: int,
    degree: int = 2,
    smoothing: float = 0.5,
) -> np.ndarray:
    """Matrix M [horizon, n_knots] with ``traj = M @ knot_values``.

    Mirrors the reference's parameterization (skill_utils.bspline:9-22):
    knot values sit at t = linspace(0, n_knots, n_knots), the trajectory is
    evaluated at linspace(0, n_knots, horizon), degree defaults to 2
    (mppi.py:173) and smoothing to scipy's s=0.5.

    Construction: clamped knot vector with enough interior knots to represent
    every knot value; control points solved by least squares.  scipy's ``s`` is
    a residual *budget*: splrep adds knots until the lsq residual drops below
    ``s``.  For the planner's standard-normal (gaussian-Halton) knot values the
    expected residual with fewer-than-interpolating knots exceeds 0.5, so
    splrep ends at (near-)interpolation — which is what we build directly.
    ``smoothing`` is interpreted as that same residual budget: we drop
    ``floor(smoothing)`` control points' worth of freedom (0 for s=0.5).
    """
    if n_knots < degree + 1:
        # Too few points for the requested degree: fall back to the highest
        # degree the data supports (scipy would raise; the reference always
        # uses n_knots >= 3 with degree 2).
        degree = max(1, n_knots - 1)
    t_knots = np.linspace(0.0, n_knots, n_knots)
    t_eval = np.linspace(0.0, n_knots, horizon)

    n_interior = max(0, n_knots - degree - 1 - int(smoothing))
    if n_interior > 0:
        interior = np.linspace(0.0, n_knots, n_interior + 2)[1:-1]
    else:
        interior = np.array([])
    kv = np.concatenate(
        [np.zeros(degree + 1), interior, np.full(degree + 1, float(n_knots))]
    )

    A = _bspline_basis(t_knots, kv, degree)  # [n_knots, n_ctrl]
    E = _bspline_basis(t_eval, kv, degree)  # [horizon, n_ctrl]
    n_ctrl = A.shape[1]

    # ctrl = (A^T A)^-1 A^T @ knot_values  ->  traj = E @ ctrl
    solve = np.linalg.solve(A.T @ A + 1e-10 * np.eye(n_ctrl), A.T)
    return E @ solve  # [horizon, n_knots]
