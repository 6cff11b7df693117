"""m3p2i_aip_tpu — Multi-Modal MPPI + Active Inference TAMP framework in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of tud-amr/m3p2i-aip
(RA-L 2024, "Multi-Modal MPPI and Active Inference for Reactive Task and Motion
Planning").  Instead of the reference's two-process torch/Isaac-Gym architecture,
everything here is a single device-resident jitted loop:

  * ``sim``      — pure-functional batched rigid-body simulator (replaces Isaac Gym)
  * ``models``   — robot/scene models (point robot, boxer, heijn, albert, panda)
  * ``ops``      — math kernels: quaternions, Halton sampling, B-splines,
                   Savitzky–Golay, discounted cost-to-go (+ Pallas/Triton GPU kernels)
  * ``planners`` — MPPI / M3P2I motion planners + active-inference task planner
  * ``parallel`` — multi-chip sharding of the sample/mode axes over a device Mesh
  * ``config``   — hydra-compatible structured-config system (YAML + CLI overrides)
  * ``utils``    — serialization, paths, run logging

Reference parity citations in docstrings use paths relative to the upstream repo
root (e.g. ``src/m3p2i_aip/planners/motion_planner/mppi.py:82``).
"""

__version__ = "0.1.0"
