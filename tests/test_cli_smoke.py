"""CLI-surface smoke test: the six canonical reference
command pairs (``/root/reference/README.md:74-143``) must parse, build, and
tick through scripts/run_tamp.py's exact entry path
(``load_config_from_argv`` -> SimLoop -> tick) at tiny K/T.

This guards the whole override grammar end to end — defaults lists, ``-cn``
config switching, ``task=``/``goal=``/flag overrides — in the fast
(`-m "not slow"`) gate, so a config/orchestrator regression can't hide
behind the slow envelope suite.
"""
import numpy as np
import pytest

from m3p2i_aip_tpu.config.config_store import load_config_from_argv
from m3p2i_aip_tpu.tamp.sim_loop import SimLoop

# the six README pairs, at reduced K (and min horizon for the panda's
# halton-spline knots) so each builds + ticks in seconds on the CPU suite
_TINY = ["mppi.num_samples=16"]
_TINY_PANDA = ["mppi.num_samples=16", "mppi.refine_iters=1"]
_COMMANDS = [
    ["task=navigation", 'goal=[-3, 3]'],
    ["task=push", 'goal=[-1, -1]'],
    ["task=pull", 'goal=[0, 0]'],
    ["task=push_pull", "multi_modal=True", 'goal=[-3.75, -3.75]'],
    ["-cn", "config_panda"],
    ["-cn", "config_panda", "multi_modal=True", "cube_on_shelf=True"],
]


@pytest.mark.parametrize(
    "argv", _COMMANDS, ids=lambda a: " ".join(a).replace(" ", "_")
)
def test_readme_command_parses_builds_ticks(argv):
    extra = _TINY_PANDA if "config_panda" in argv else _TINY
    cfg = load_config_from_argv(list(argv) + extra, default_config="config_point")
    loop = SimLoop(cfg)
    loop.warmup(2)
    loop.tick(0)
    view = loop._view
    for v in view.values():
        assert np.isfinite(np.asarray(v, dtype=np.float64)).all()
