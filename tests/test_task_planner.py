"""Task-planner tests: golden AIP action sequences + planner state machines.

The golden sequence comes from the reference's scripted demo
(``examples/example_aip_panda.py:17-49``): obs 0 -> reach, obs 1 (pref top) ->
pick, obs 2 -> place, obs 3 with goal pref -> idle_success.
"""
import numpy as np
import pytest

from m3p2i_aip_tpu.planners.task_planner import (
    adaptive_action_selection,
    ai_agent,
    parallel_action_selection,
    state_action_templates,
)
from m3p2i_aip_tpu.planners.task_planner.task_planner import (
    PLANNER_AIF_PANDA,
    PLANNER_PATROLLING,
    PLANNER_SIMPLE,
    set_task_planner,
)


def _agent():
    return [ai_agent.AiAgent(state_action_templates.MDPIsCubeAtReal())]


def test_aip_golden_sequence():
    agents = _agent()
    script = [
        (0, np.array([[0], [1], [0], [0]]), "reach"),
        (0, np.array([[0], [1], [0], [0]]), "reach"),
        (1, np.array([[1], [0], [0], [0]]), "pick"),
        (1, np.array([[1], [0], [0], [0]]), "pick"),
        (2, np.array([[1], [0], [0], [0]]), "place"),
        (3, np.array([[0], [0], [0], [1]]), "idle_success"),
    ]
    for obs, pref, expected in script:
        agents[0].set_preferences(pref)
        _, action = adaptive_action_selection.adapt_act_sel(agents, [obs])
        assert action == expected, f"obs={obs}: got {action}, want {expected}"


def test_parallel_action_selection_two_agents():
    agents = [
        ai_agent.AiAgent(state_action_templates.MDPIsAt()),
        ai_agent.AiAgent(state_action_templates.MDPIsCloseTo()),
    ]
    agents[0].set_preferences(np.array([[1.0], [0.0]]))
    agents[1].set_preferences(np.array([[1.0], [0.0]]))
    outcome, plans = parallel_action_selection.par_act_sel(agents, [1, 1])
    assert outcome in ("running", "success")
    assert plans, "expected at least one plan"
    flat = {a for plan in plans for a in (plan if isinstance(plan, list) else [plan])}
    assert "move_to" in flat or "approach_obj" in flat or "idle_success" in flat


class _Cfg:
    env_type = "point_env"
    task = "navigation"
    goal = [1.0, 2.0]
    pre_height_diff = 0.05


def test_planner_simple_success_logic():
    p = set_task_planner(_Cfg())
    assert isinstance(p, PLANNER_SIMPLE)
    view = {"robot_pos": np.array([1.05, 2.0]), "box_pos": np.array([0.0, 0.0])}
    assert p.check_task_success(view)
    view["robot_pos"] = np.array([0.0, 0.0])
    assert not p.check_task_success(view)

    p.task = "push"
    view["box_pos"] = np.array([1.0, 2.05])
    assert p.check_task_success(view)


def test_planner_aif_panda_progression():
    cfg = _Cfg()
    cfg.env_type = "panda_env"
    p = set_task_planner(cfg)
    assert isinstance(p, PLANNER_AIF_PANDA)

    cube = np.array([0.2, -0.2, 1.06, 0, 0, 0, 1], dtype=np.float32)
    goal = np.array([0.5, 0.3, 1.06, 0, 0, 0, 1], dtype=np.float32)
    ee_far = np.array([0.0, 0.0, 1.6, 0, 0, 0, 1], dtype=np.float32)
    p.update_plan({"cube_state": cube, "cube_goal": goal, "ee_state": ee_far})
    assert p.task == "reach"

    ee_close = cube.copy()
    ee_close[2] += 0.03  # within pre_pick_place_threshold=0.055
    p.update_plan({"cube_state": cube, "cube_goal": goal, "ee_state": ee_close})
    assert p.task == "pick"
    assert p.pick_always
    # goal switched to pre-place location above cubeB
    assert np.allclose(p.curr_goal[:2], goal[:2])

    # cube arrives at the pre-place location -> place (hysteresis keeps it)
    cube_at_goal = goal.copy()
    p.update_plan(
        {"cube_state": cube_at_goal, "cube_goal": goal, "ee_state": ee_close}
    )
    assert p.task == "place"
    assert p.place_always
    assert p.check_task_success(
        {"cube_state": cube_at_goal, "cube_goal": goal, "ee_state": ee_close}
    )


def test_planner_patrolling_cycles():
    p = PLANNER_PATROLLING([[0.0, 0.0], [1.0, 1.0]])
    assert np.allclose(p.curr_goal, [0, 0])
    p.update_plan({"robot_pos": np.array([0.01, 0.01])})
    assert np.allclose(p.curr_goal, [1, 1])
    p.update_plan({"robot_pos": np.array([1.0, 1.0])})
    assert np.allclose(p.curr_goal, [0, 0])
    p.reset_plan()
    assert p.goal_id == 0


def test_pocket_endgame_staged_latches():
    """Diff-drive pocket endgame (PLANNER_SIMPLE): proximity latch,
    box-stall latch, reposition -> push transition, and the bounded
    push -> reposition re-latch."""
    cfg = _Cfg()
    cfg.task = "push_pull"
    cfg.goal = [-3.75, -3.75]
    p = set_task_planner(cfg)
    p.configure_pocket_endgame(3.15)

    # box far from goal and MOVING: no latch
    robot = np.array([0.0, 0.5])
    for k in range(40):
        view = {"box_pos": np.array([0.0, 2.0 - 0.01 * k]), "robot_pos": robot}
        p.update_plan(view)
    assert p.task == "push_pull" and p._pocket_stage == 0

    # box stalled with the robot ADJACENT (vetoed-pull freeze): stall latch
    box = np.array([-3.4, -1.6])
    robot = np.array([-3.65, -2.04])
    for _ in range(p._STALL_CALLS + 1):
        p.update_plan({"box_pos": box, "robot_pos": robot})
    assert p.task == "reposition" and p._pocket_stage == 1
    # standoff goal sits past the box on the box->goal ray, away from the
    # goal, clamped into the reachable arena (pocket_lim)
    assert np.all(np.abs(p.curr_goal[:2]) <= 3.15 + 1e-5)
    away = p.curr_goal[:2] - box
    to_goal = np.array(cfg.goal) - box
    assert float(np.dot(away, to_goal)) < 0.0
    assert np.linalg.norm(p.curr_goal[:2] - np.array(cfg.goal)) > np.linalg.norm(
        box - np.array(cfg.goal)
    )

    # robot reaches the standoff -> push at the base goal
    p.update_plan({"box_pos": box, "robot_pos": p.curr_goal[:2].copy()})
    assert p.task == "push" and p._pocket_stage == 2
    assert np.allclose(p.curr_goal[:2], cfg.goal)

    # push stalls -> bounded re-latch back to reposition
    for _ in range(p._STALL_CALLS + 1):
        p.update_plan({"box_pos": box, "robot_pos": robot})
    assert p.task == "reposition" and p._pocket_stage == 1
    assert p._relatch_left == 4

    # reset restores the base plan and stall state
    p.reset_plan()
    assert p.task == "push_pull" and p._pocket_stage == 0
    assert p._relatch_left == 5 and p._stall_n == 0

    # proximity latch fires without any stall
    p.update_plan(
        {"box_pos": np.array([-3.0, -3.0]), "robot_pos": np.array([0.0, 0.0])}
    )
    assert p.task == "reposition" and p._pocket_stage == 1


def test_aif_panda_zup_gate_stall_and_release():
    """Host wedge-gate mirror: flips on after ZUP_STALL_TICKS attached
    ticks with no new best progress, stays off for unattached stalls, and
    releases after ZUP_RELEASE_M of recovery progress."""
    from m3p2i_aip_tpu.planners.task_planner.task_planner import (
        ZUP_RELEASE_M,
        ZUP_STALL_TICKS,
    )

    cfg = _Cfg()
    cfg.env_type = "panda_env"
    p = set_task_planner(cfg)
    goal = np.array([0.5, 0.3, 1.06, 0, 0, 0, 1], dtype=np.float32)
    cube = np.array([0.2, -0.2, 1.2, 0, 0, 0, 1], dtype=np.float32)
    ee_close = cube.copy()
    ee_close[2] += 0.03  # trips the pick threshold

    def tick(att):
        p.update_plan(
            {
                "cube_state": cube,
                "cube_goal": goal,
                "ee_state": ee_close,
                "attached": att,
            }
        )

    # unattached stall (missed grasp): gate must NOT fire
    for _ in range(ZUP_STALL_TICKS + 5):
        tick(0.0)
    assert p.task == "pick" and p.zup_gate == 0.0

    # attached stall: gate fires after the threshold
    for _ in range(ZUP_STALL_TICKS):
        tick(1.0)
    assert p.zup_gate == 1.0

    # recovery progress past the latch distance releases it
    cube[:3] = cube[:3] + (goal[:3] - cube[:3]) * (
        (ZUP_RELEASE_M + 0.02)
        / np.linalg.norm(goal[:3] - cube[:3])
    )
    tick(1.0)
    assert p.zup_gate == 0.0


def test_pocket_endgame_holonomic_stall_only():
    """Holonomic arming (proximity_latch=False, the point/heijn corner2
    path): the proximity latch must NOT fire when the box nears the pocket
    goal, but the vetoed-pull stall latch must."""
    cfg = _Cfg()
    cfg.task = "push_pull"
    cfg.goal = [-3.75, -3.75]
    p = set_task_planner(cfg)
    p.configure_pocket_endgame(3.15, proximity_latch=False)

    # box MOVING just outside the pocket radius: no proximity latch
    robot = np.array([-2.0, -2.0])
    for k in range(40):
        view = {
            "box_pos": np.array([-3.0 - 0.005 * k, -3.0 - 0.005 * k]),
            "robot_pos": robot,
        }
        p.update_plan(view)
    assert p.task == "push_pull" and p._pocket_stage == 0

    # box stalled with the robot adjacent: stall latch still armed
    box = np.array([-3.44, -3.62])
    robot = np.array([-3.75, -3.75])
    for _ in range(p._STALL_CALLS + 1):
        p.update_plan({"box_pos": box, "robot_pos": robot})
    assert p.task == "reposition" and p._pocket_stage == 1
    assert np.all(np.abs(p.curr_goal[:2]) <= 3.15 + 1e-5)


def test_stall_latch_tick_granular_under_chunking():
    """The stall latch must fire on STALL TICKS, not update_plan calls:
    chunked loops call update_plan once per chunk but feed every drained
    per-tick view through PLANNER_SIMPLE.observe (sim_loop._drain_chunk /
    batch_loop._drain_seed).  Without observe(), a chunk=10 run waited
    _STALL_CALLS chunks = 150 ticks per latch — the albert push_reach
    chunked envelope timed out 8/20 seeds on exactly that latency."""
    cfg = _Cfg()
    cfg.task = "push_reach"
    cfg.goal = [3.0, 0.0, 0.6]
    p = set_task_planner(cfg)
    p.configure_pocket_endgame(10.0, proximity_latch=False)

    box = np.array([2.6, 0.4])
    robot = np.array([2.2, 0.0])
    chunk = 10
    # chunk-cadence driving: observe() per tick, update_plan per chunk.
    # The latch must fire at the first plan boundary AFTER _STALL_CALLS
    # stall ticks (here: boundary 2, i.e. tick 20) — not after 15 chunks.
    boundaries_to_latch = 0
    for _ in range(4):  # 4 chunks = 40 ticks >> _STALL_CALLS
        for _ in range(chunk):
            p.observe({"box_pos": box, "robot_pos": robot})
        p.update_plan({"box_pos": box, "robot_pos": robot})
        boundaries_to_latch += 1
        if p.task == "reposition":
            break
    assert p.task == "reposition" and p._pocket_stage == 1
    assert boundaries_to_latch == 2  # ceil(_STALL_CALLS / chunk)

    # per-tick driving (no observe feed): update_plan self-observes, same
    # 15-tick latch as before the refactor
    p.reset_plan()
    calls = 0
    while p.task != "reposition":
        p.update_plan({"box_pos": box, "robot_pos": robot})
        calls += 1
        assert calls <= p._STALL_CALLS + 2
    # +1: the first call after reset only establishes the motion baseline
    assert calls == p._STALL_CALLS + 1

    # a MOVING box resets the tick counter even when update_plan never sees
    # the motion (it happened mid-chunk)
    p.reset_plan()
    for k in range(3 * p._STALL_CALLS):
        moving_box = box + np.array([0.01 * k, 0.0])
        p.observe({"box_pos": moving_box, "robot_pos": robot})
        if (k + 1) % chunk == 0:
            p.update_plan({"box_pos": moving_box, "robot_pos": robot})
    assert p.task == "push_reach" and p._pocket_stage == 0


def test_pocket_endgame_pull_recovery_cycle():
    """Round-5 pull recovery: a pocket-goal PURE pull
    arms the stall latch; on a mid-drag freeze the planner repositions to a
    standoff on the GOAL side of the box (a puller drags the box toward
    itself) and then RESUMES PULL — never push — so the ablation stays
    within pull semantics."""
    cfg = _Cfg()
    cfg.task = "pull"
    cfg.goal = [-3.75, -3.75]
    p = set_task_planner(cfg)
    p.configure_pocket_endgame(3.15, min_clearance=0.6)

    # wall-hugging drag freeze: box stalled, robot adjacent
    box = np.array([-3.4, -1.6])
    robot = np.array([-3.65, -2.04])
    for _ in range(p._STALL_CALLS + 1):
        p.update_plan({"box_pos": box, "robot_pos": robot})
    assert p.task == "reposition" and p._pocket_stage == 1
    # standoff sits on the GOAL side: moving box->standoff points TOWARD
    # the goal (opposite of the push staging, which goes behind the box)
    away = p.curr_goal[:2] - box
    to_goal = np.array(cfg.goal) - box
    assert float(np.dot(away, to_goal)) > 0.0
    # ... within the arena and off the box (min_clearance)
    assert np.all(np.abs(p.curr_goal[:2]) <= 3.15 + 1e-5)
    assert np.linalg.norm(p.curr_goal[:2] - box) >= 0.6 - 1e-6

    # robot reaches the standoff -> resumes PULL at the base goal
    p.update_plan({"box_pos": box, "robot_pos": p.curr_goal[:2].copy()})
    assert p.task == "pull" and p._pocket_stage == 2
    assert np.allclose(p.curr_goal[:2], cfg.goal)


def test_open_floor_pull_never_arms_stall_latch():
    """Open-floor pulls (e.g. the case2 dyn-obstacle scenario, goal at the
    center) must NOT arm the recovery cycle — the published n=60 rows ride
    on unmodified pure-pull behavior."""
    cfg = _Cfg()
    cfg.task = "pull"
    cfg.goal = [0.0, 0.0]
    p = set_task_planner(cfg)
    p.configure_pocket_endgame(3.15)
    box = np.array([1.0, 1.0])
    robot = np.array([1.3, 1.3])
    for _ in range(p._STALL_CALLS + 5):
        p.update_plan({"box_pos": box, "robot_pos": robot})
    assert p.task == "pull" and p._pocket_stage == 0
