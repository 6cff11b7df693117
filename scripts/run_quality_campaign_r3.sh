#!/bin/bash
# Round-3 quality-envelope campaign: the new
# rows this round — shelf pick at the productized horizon-20 default (BOTH
# seed batches), heijn/boxer push/pull/corner-hybrid envelopes, and the
# per-mode covariance ablation on the corner hybrid.
# Run on the accelerator host (one JAX process per card); results land in plot/
set -x
cd "$(dirname "$0")/.."

# shelf pick, horizon-20 default via cube_on_shelf: two
# independent seed batches
python scripts/run_experiments.py -cn config_panda multi_modal=True \
    cube_on_shelf=True n_runs=20 chunked=10 out=plot/panda/shelf_pick_mm.npy
python scripts/run_experiments.py -cn config_panda multi_modal=True \
    cube_on_shelf=True n_runs=20 chunked=10 seed_offset=100 \
    out=plot/panda/shelf_pick_mm_b.npy

# heijn family
python scripts/run_experiments.py -cn config_heijn task=push goal="[-1,-1]" \
    n_runs=20 chunked=10 out=plot/point/heijn_push.npy
python scripts/run_experiments.py -cn config_heijn task=pull goal="[0,0]" \
    n_runs=20 chunked=10 out=plot/point/heijn_pull.npy
python scripts/run_experiments.py -cn config_heijn task=push_pull \
    multi_modal=True goal="[-3.75,-3.75]" n_runs=20 chunked=10 \
    out=plot/point/heijn_corner_hybrid.npy

# boxer family.  Pure push on the nonholonomic base runs at
# DEFAULT config: the staged pocket endgame (task_planner.py) latches
# reposition->push when the base parks beside the box, which is what makes
# pure push viable on a diff drive (1/20 without staging)
python scripts/run_experiments.py -cn config_boxer task=push goal="[-1,-1]" \
    n_runs=20 chunked=10 out=plot/point/boxer_push.npy
python scripts/run_experiments.py -cn config_boxer task=pull goal="[0,0]" \
    n_runs=20 chunked=10 out=plot/point/boxer_pull.npy
python scripts/run_experiments.py -cn config_boxer task=push_pull \
    multi_modal=True goal="[-3.75,-3.75]" n_runs=20 chunked=10 \
    out=plot/point/boxer_corner_hybrid.npy

# per-mode covariance ablation on the corner hybrid
python scripts/run_experiments.py task=push_pull multi_modal=True \
    mppi.update_cov_per_mode=True goal="[-3.75,-3.75]" n_runs=20 chunked=10 \
    out=plot/point/corner1_hybrid_permode_cov.npy

# albert mobile manipulation envelope: coordinated base+arm
# reach, n=20 seeds
python scripts/run_experiments.py -cn config_albert n_runs=20 \
    out=plot/albert/ee_reach.npy
