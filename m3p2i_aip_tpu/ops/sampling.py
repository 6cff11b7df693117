"""Quasi-random (Halton) sampling for MPPI control perturbations.

Replacement for the reference's sampling stack
(``src/m3p2i_aip/utils/mppi_utils.py:50-104``), which relied on the C++
``ghalton`` package for generalized (scrambled) Halton sequences plus a pure
van-der-Corput fallback.  Here everything is vectorized numpy, computed ONCE at
planner init (the reference caches the samples too, mppi.py:388-389), so there
is no per-step host work.  A native C accelerator is provided in
``m3p2i_aip_tpu/native`` and used transparently when built (see
``_native_halton``); results are identical by construction.

The unscrambled sequence matches the reference's ``use_ghalton=False`` path
exactly.  Scrambling uses deterministic seeded digit permutations (same idea
as generalized Halton).  The ghalton ``use_ghalton=True`` path is NOT
bit-reproduced, deliberately: its per-base permutations are the output of
Faure & Lemieux's evolutionary search (ACM TOMS 2009) — opaque constant
tables shipped inside the C++ package, not derivable from an algorithm — so
bit parity would require vendoring the tables verbatim.  Statistical
equivalence (low-discrepancy scrambled Halton) is what MPPI consumes; the
sampler goldens in tests/test_ops.py pin OUR permutations so the sequence is
reproducible run-to-run and seed-to-seed.
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "generate_prime_numbers",
    "van_der_corput",
    "halton_samples",
    "gaussian_halton_samples",
]


def generate_prime_numbers(num: int) -> list:
    """First ``num`` primes. Parity: mppi_utils.generate_prime_numbers:50-67."""
    return _primes(num).tolist()


def _primes(num: int) -> np.ndarray:
    # Simple sieve — robust and fast for the few hundred dims we ever need.
    if num == 0:
        return np.array([], dtype=np.int64)
    limit = max(16, int(num * (np.log(num + 2) + np.log(np.log(num + 3))) + 10))
    while True:
        sieve = np.ones(limit, dtype=bool)
        sieve[:2] = False
        for i in range(2, int(limit**0.5) + 1):
            if sieve[i]:
                sieve[i * i :: i] = False
        primes = np.flatnonzero(sieve)
        if primes.size >= num:
            return primes[:num]
        limit *= 2  # estimate undershot: grow the sieve and retry


def van_der_corput(indices: np.ndarray, base: int, permutation=None) -> np.ndarray:
    """Radical-inverse of ``indices`` in ``base``.

    Vectorized equivalent of mppi_utils.generate_van_der_corput_samples_batch
    (:69-78).  ``permutation`` optionally scrambles digits (generalized Halton);
    it must be a permutation of range(base) with permutation[0] == 0 so that the
    implicit trailing zero digits stay zero.
    """
    idx = np.asarray(indices, dtype=np.int64).copy()
    result = np.zeros(idx.shape, dtype=np.float64)
    f = 1.0
    while np.any(idx > 0):
        f /= base
        digits = idx % base
        if permutation is not None:
            digits = permutation[digits]
        result += f * digits
        idx //= base
    return result


def _scramble_perms(bases: np.ndarray, seed: int) -> list:
    rng = np.random.default_rng(seed)
    perms = []
    for b in bases:
        p = np.concatenate([[0], 1 + rng.permutation(int(b) - 1)])
        perms.append(p)
    return perms


def halton_samples(
    num_samples: int,
    ndims: int,
    bases=None,
    scramble: bool = True,
    seed_val: int = 123,
) -> np.ndarray:
    """[num_samples, ndims] generalized-Halton points in (0, 1).

    Parity: mppi_utils.generate_halton_samples:80-96.  ``scramble=True``
    corresponds to the reference's ``use_ghalton=True`` (scrambled / generalized
    sequence); ``scramble=False`` reproduces its pure-python fallback exactly.
    """
    if bases is None:
        bases = _primes(ndims)
    else:
        bases = np.asarray(bases)
    perms = _scramble_perms(bases, seed_val) if scramble else [None] * ndims

    from m3p2i_aip_tpu.native import native_halton  # C++ core (ghalton parity)

    native = native_halton(num_samples, bases, perms)
    if native is not None:
        return native

    idx = np.arange(1, num_samples + 1, dtype=np.int64)
    out = np.empty((num_samples, ndims), dtype=np.float64)
    for d in range(ndims):
        out[:, d] = van_der_corput(idx, int(bases[d]), perms[d])
    return out


def gaussian_halton_samples(
    num_samples: int,
    ndims: int,
    bases=None,
    scramble: bool = True,
    seed_val: int = 123,
) -> np.ndarray:
    """Standard-normal quasi-random samples via the inverse error function.

    Parity: mppi_utils.generate_gaussian_halton_samples:99-104
    (sqrt(2) * erfinv(2u - 1)).
    """
    u = halton_samples(num_samples, ndims, bases, scramble, seed_val)
    # Guard the open interval: erfinv(±1) = ±inf.
    u = np.clip(u, 1e-12, 1.0 - 1e-12)
    from scipy.special import erfinv  # host-side, init-time only

    return np.sqrt(2.0) * erfinv(2.0 * u - 1.0)
