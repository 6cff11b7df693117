"""Point-family cost-surface pins.

The corner-pull honest negative is a
GEOMETRIC floor, not a planner bug — these tests pin the mechanism so a
future cost change that silently moves it fails loudly.

Measured failure anatomy (seed-13 trace, plot/point/corner1_pull.npy era):
the pull drags the box to ~0.22 m from the pocket goal and stalls; every
recovery cycle (reposition -> re-pull) returns to the same equilibrium.
Completing the last 0.22 m would need the robot INSIDE the zero-clearance
strip between box and wall — the boundary-contact crush veto (cost 1000)
excludes exactly those states, because a physical robot cannot stand in a
zero-clearance pocket.  Seeds that succeed do so when the drag momentum
slides the box the last centimetres after the veto stops the robot.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from m3p2i_aip_tpu.config.config_store import load_config
from m3p2i_aip_tpu.planners.motion_planner.mppi import make_task_params
from m3p2i_aip_tpu.tamp.reactive_tamp import ReactiveTAMP


@pytest.fixture(scope="module")
def point_pull():
    cfg = load_config("config_point", ["task=pull", "goal=[-3.75,-3.75]"])
    tamp = ReactiveTAMP(cfg)
    return tamp


def _pull_cost_at(tamp, robot_xy, box_xy):
    state = tamp.env.init_state()
    p = tamp.env.params
    box_slot = tamp.objective.box_dyn_slot
    state = state.replace(
        q=state.q.at[:2].set(jnp.asarray(robot_xy)),
        dyn_pos=state.dyn_pos.at[box_slot].set(jnp.asarray(box_xy)),
    )
    task = make_task_params("pull", [-3.75, -3.75])
    cost, _ext = tamp.objective.compute(
        state, jnp.zeros(tamp.env.nu), task, jnp.asarray(1)
    )
    return float(cost)


def test_pull_pocket_completion_is_vetoed(point_pull):
    """Robot poses deep enough to finish a pocket pull sit past the
    boundary-contact veto line — the pull cost must carry the 1000 crush
    penalty there (the floor is arena_bound - robot_radius - 0.05)."""
    tamp = point_pull
    p = tamp.env.params
    veto_line = float(p.arena_bound) - float(p.robot_radius) - 0.05
    box = [-3.75, -3.53]  # the measured stall equilibrium
    # to pull the box to the goal the robot must lead it: deeper than the
    # box, i.e. |y| >= 3.75 > veto_line -> vetoed
    deep = _pull_cost_at(tamp, [-3.6, -(veto_line + 0.02)], box)
    shallow = _pull_cost_at(tamp, [-3.35, -3.60], box)
    assert deep >= 1000.0, f"deep pull pose not vetoed (cost {deep})"
    assert shallow < 1000.0, f"working pull pose wrongly vetoed ({shallow})"


def test_pull_pocket_floor_exceeds_success_tolerance(point_pull):
    """The geometric floor itself: the deepest box position a non-vetoed
    pull can HOLD (robot at the veto line, box trailing one suction-hold
    distance behind) is farther from the pocket goal than the 0.1 m
    success tolerance — pull-only pocket completion relies on post-stall
    slide, which is per-seed friction luck.  This inequality is WHY
    corner-pull stays an honest negative (16/20 with the recovery cycle)
    and the hybrid (push finish) is the designed answer."""
    p = point_pull.env.params
    veto_line = float(p.arena_bound) - float(p.robot_radius) - 0.05
    hold = float(p.robot_radius) + float(
        p.dyn_half[point_pull.objective.box_dyn_slot, 0]
    )
    deepest_held_box = veto_line - hold  # box center depth while held
    goal_depth = 3.75
    assert goal_depth - deepest_held_box > 0.1, (
        "geometry changed: pull-only pocket completion is now reachable — "
        "update the corner-pull RESULTS row and retire this pin"
    )
