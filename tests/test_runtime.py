"""What the program needs to start: its own YAML reader and pytree
dataclasses (no PyYAML, no flax), the compile-cache placement, and the chip
smoke script's refusal to report without a GPU."""
import dataclasses
import os
import pathlib
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from m3p2i_aip_tpu.utils import compile_cache, struct, yaml_lite

REPO = pathlib.Path(__file__).resolve().parents[1]
CONFIG = REPO / "m3p2i_aip_tpu" / "config"


def _run(args, cwd, env_extra=None, timeout=300):
    env = dict(os.environ, JAX_PLATFORMS="cpu", **(env_extra or {}))
    return subprocess.run(
        [sys.executable, *args], cwd=cwd, env=env, capture_output=True,
        text=True, timeout=timeout,
    )


# ------------------------------------------------------------- chip smoke
@pytest.mark.parametrize("where", ["repo", "lone"])
def test_chip_smoke_refuses_without_gpu(where, tmp_path):
    """No accelerator (and, for ``lone``, no package beside the script):
    non-zero exit and no ``ok`` line."""
    cwd = REPO
    if where == "lone":
        shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
        cwd = tmp_path
    out = _run(["chip_smoke.py"], cwd)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "needs an NVIDIA GPU" in out.stderr


# ------------------------------------------------- no flax, no PyYAML needed
def test_main_path_builds_without_flax_and_yaml():
    code = """
import sys
sys.modules["flax"] = None
sys.modules["yaml"] = None
from m3p2i_aip_tpu.config.config_store import load_config
from m3p2i_aip_tpu.tamp.reactive_tamp import ReactiveTAMP
cfg = load_config("config_point", ["task=push_pull", "multi_modal=True",
                                   "goal=[-3.75,-3.75]", "mppi.num_samples=16"])
tamp = ReactiveTAMP(cfg)
mods = sorted({m.split(".")[0] for m in sys.modules if sys.modules[m] is not None})
print("MODULES", " ".join(mods))
"""
    out = _run(["-c", code], REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    mods = set(out.stdout.split("MODULES", 1)[1].split())
    assert "flax" not in mods and "yaml" not in mods


# -------------------------------------------------------------- YAML reader
def test_yaml_reader_reads_every_shipped_config():
    files = sorted(CONFIG.rglob("*.yaml"))
    assert len(files) == 58
    try:
        import yaml  # the reference parser, where installed
    except ImportError:
        yaml = None
    for f in files:
        data = yaml_lite.load(f)
        assert isinstance(data, dict) and data, f
        if yaml is not None:
            assert data == yaml.safe_load(f.read_text()), f


def test_yaml_reader_spot_values():
    panda = yaml_lite.load(CONFIG / "mppi" / "panda.yaml")
    sigma = panda["noise_sigma"]  # multi-line flow list
    assert len(sigma) == 9 and all(len(r) == 9 for r in sigma)
    assert sigma[0][0] == 10.0 and sigma[8][8] == 0.8
    assert panda["exploration_noise"] == 0.15  # trailing comment stripped
    assert panda["device"] == "gpu" and panda["refine_iters"] == 3
    top = yaml_lite.load(CONFIG / "config_panda.yaml")
    assert top["defaults"] == [{"mppi": "panda"}, {"isaacgym": "panda"}]
    assert top["pre_height_diff"] == 0.05 and top["cube_on_shelf"] is False
    box = yaml_lite.load(CONFIG / "point_env" / "7_box.yaml")
    assert box["init_pos"] == [0.0, 2.0, 0.0] and box["fixed"] is False
    assert box["name"] == "box"
    robot = yaml_lite.load(CONFIG / "boxer_env" / "0_boxer_robot.yaml")
    assert robot["urdf_file"] == "boxer/boxer.urdf" and robot["fixed"] is True
    assert yaml_lite.loads("a: null\nb: 'x # y'  # c\nc: [1, [2, -3.5e2]]\n") == {
        "a": None, "b": "x # y", "c": [1, [2, -350.0]]
    }
    assert yaml_lite.loads("# only a comment\n") is None
    with pytest.raises(ValueError):
        yaml_lite.loads("a: [1, 2\n")
    with pytest.raises(ValueError):
        yaml_lite.loads("a: {b: 1}\n")


@pytest.mark.parametrize("name", ["config_point", "config_panda"])
def test_composed_config_schema(name):
    from m3p2i_aip_tpu.config.config_store import load_config

    cfg = load_config(name)
    if name == "config_point":
        assert cfg.env_type == "point_env" and cfg.task == "push"
        assert cfg.goal == [-3.75, -3.75] and cfg.kp_suction == 400
        assert (cfg.mppi.num_samples, cfg.mppi.horizon) == (200, 15)
        assert cfg.mppi.u_max == [3.0, 3.0] and cfg.isaacgym.dt == 0.05
    else:
        assert cfg.env_type == "panda_env" and cfg.task == "reactive_pick"
        assert (cfg.mppi.num_samples, cfg.mppi.horizon) == (200, 12)
        assert cfg.mppi.refine_iters == 3 and cfg.isaacgym.dt == 0.01
        assert np.asarray(cfg.mppi.noise_sigma).shape == (9, 9)
    assert cfg.mppi.device == "gpu"


# ------------------------------------------------------- pytree dataclasses
@struct.dataclass
class _Probe:
    x: jnp.ndarray
    y: jnp.ndarray = struct.field(default=None)
    tag: str = struct.field(pytree_node=False, default="a")


def test_struct_dataclass_replace_flatten_and_no_retrace():
    p = _Probe(x=jnp.ones(3), y=jnp.zeros(()))
    leaves, treedef = jax.tree_util.tree_flatten(p)
    assert len(leaves) == 2  # the static field is not a leaf
    q = jax.tree_util.tree_unflatten(treedef, [l + 1 for l in leaves])
    assert isinstance(q, _Probe) and q.tag == "a"
    assert np.allclose(q.x, 2.0) and float(q.y) == 1.0
    r = p.replace(tag="b")
    assert r.tag == "b" and p.tag == "a"  # frozen: replace returns a copy
    with pytest.raises(dataclasses.FrozenInstanceError):
        p.x = jnp.zeros(3)
    assert jax.tree_util.tree_structure(r) != treedef  # static field keys jit

    traces = []

    @jax.jit
    def step(s):
        traces.append(1)
        return s.replace(x=s.x * 2.0, y=s.y + 1.0)

    s = step(p)
    s = step(s)  # strong-typed leaves: the updated state reuses the trace
    assert len(traces) == 1 and float(s.y) == 2.0


def test_planner_state_is_in_repo_dataclass():
    from m3p2i_aip_tpu.models.point_env import PointEnvParams
    from m3p2i_aip_tpu.planners.motion_planner.mppi import MPPIState

    for cls in (MPPIState, PointEnvParams):
        assert dataclasses.is_dataclass(cls) and hasattr(cls, "replace")
    meta = {f.name for f in dataclasses.fields(PointEnvParams)
            if not f.metadata.get("pytree_node", True)}
    assert {"robot_type", "substeps", "actor_names"} <= meta


# ------------------------------------------------------------ compile cache
@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_placement(env_set, monkeypatch):
    default = str(REPO / ".jax_cache")
    assert compile_cache.default_dir() == default
    if env_set:
        env = {compile_cache.ENV_VAR: "/somewhere/cache"}
        assert compile_cache.resolve_dir(env) == "/somewhere/cache"
        monkeypatch.setenv(compile_cache.ENV_VAR, "/somewhere/cache")
        before = jax.config.jax_compilation_cache_dir
        assert compile_cache.enable() == "/somewhere/cache"
        # the variable wins and the code sets no directory of its own
        assert jax.config.jax_compilation_cache_dir == before
    else:
        assert compile_cache.resolve_dir({}) == default
        monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
        old = jax.config.jax_compilation_cache_dir
        old_min = jax.config.jax_persistent_cache_min_compile_time_secs
        try:
            assert compile_cache.enable() == default
            assert jax.config.jax_compilation_cache_dir == default
        finally:
            jax.config.update("jax_compilation_cache_dir", old)
            jax.config.update("jax_persistent_cache_min_compile_time_secs", old_min)
