#!/usr/bin/env python3
"""Capture the reference's OWN Halton sampler output as a committed golden.

Without it the repo's samplers would be tested only against each other,
not against the reference's ``generate_gaussian_halton_samples``
(``/root/reference/src/m3p2i_aip/utils/mppi_utils.py:80-104``).  This script
EXECUTES the reference module's pure fallback path (``use_ghalton=False`` —
van-der-Corput radical inverses over prime bases, then sqrt(2)*erfinv(2u-1))
with the ``ghalton`` C++ dependency stubbed out, and writes the values to
``tests/goldens/reference_halton_gauss.npy``.  No reference code is copied:
the fixture is data produced by running the reference itself.

The ghalton path (``use_ghalton=True``) is intentionally NOT captured: its
per-base permutations are opaque constant tables inside the C++ package
(Faure & Lemieux 2009 evolutionary search), see ops/sampling.py's module
docstring for the documented delta.

Run from the repo root (needs /root/reference present + torch):
    python scripts/capture_reference_halton.py
"""
import os
import sys
import types

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

REFERENCE_SRC = "/root/reference/src"

N_SAMPLES, NDIMS = 64, 9  # covers the panda's ndims (n_knots*nu = 3*9 = 27
# is exercised by a second row set below); 9 keeps the fixture small
SHAPES = [(64, 9), (200, 27)]  # (reference point / panda workloads)


def main() -> None:
    # stub ghalton so the reference module imports without the C++ package;
    # the captured path never touches it (use_ghalton=False)
    sys.modules.setdefault("ghalton", types.SimpleNamespace(EA_PERMS=[]))
    sys.path.insert(0, REFERENCE_SRC)
    import numpy as np
    from m3p2i_aip.utils import mppi_utils as ref  # noqa: E402

    out = {}
    for n, d in SHAPES:
        vals = ref.generate_gaussian_halton_samples(
            n, d, use_ghalton=False
        ).numpy()
        out[f"gauss_{n}x{d}"] = vals
        print(f"captured gauss_{n}x{d}: mean={vals.mean():.6f}")

    dest = os.path.join(REPO, "tests", "goldens")
    os.makedirs(dest, exist_ok=True)
    path = os.path.join(dest, "reference_halton_gauss.npz")
    np.savez(path, **out)
    print("wrote", path)


if __name__ == "__main__":
    main()
