#!/bin/bash
# Full quality-envelope campaign: n>=20 seeded
# batches for every headline scenario, plus reference-parity ablation rows.
# Run on the accelerator host; results land in plot/{panda,point}/*.npy.
set -x
cd "$(dirname "$0")/.."

# panda family (chunked: on-device AIF gate)
python scripts/run_experiments.py -cn config_panda n_runs=20 chunked=10 \
    out=plot/panda/normal_pick.npy
python scripts/run_experiments.py -cn config_panda n_runs=20 chunked=10 \
    reactive_perturb=0.15 out=plot/panda/reactive_pick.npy
python scripts/run_experiments.py -cn config_panda multi_modal=True \
    cube_on_shelf=True n_runs=20 chunked=10 out=plot/panda/shelf_pick_mm.npy
# ablation: extensions off (reference-parity planner)
python scripts/run_experiments.py -cn config_panda mppi=panda_parity \
    n_runs=20 chunked=10 out=plot/panda/normal_pick_parity.npy

# point family
python scripts/run_experiments.py task=push goal="[-1,-1]" n_runs=20 \
    chunked=10 out=plot/point/case2_push.npy
python scripts/run_experiments.py task=pull goal="[0,0]" n_runs=20 \
    chunked=10 out=plot/point/case2_pull.npy
python scripts/run_experiments.py task=push_pull multi_modal=True \
    goal="[-3.75,-3.75]" n_runs=20 chunked=10 out=plot/point/corner1_hybrid.npy
python scripts/run_experiments.py task=push_pull multi_modal=True \
    goal="[-3.75,-3.75]" n_runs=20 chunked=10 seed_offset=100 \
    out=plot/point/corner1_hybrid_b.npy
# ablation: extensions off
python scripts/run_experiments.py task=push_pull multi_modal=True \
    mppi=point_parity goal="[-3.75,-3.75]" n_runs=20 chunked=10 \
    out=plot/point/corner1_hybrid_parity.npy
