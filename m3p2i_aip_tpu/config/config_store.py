"""Structured configs + a minimal hydra-compatible composition engine.

The reference registers dataclass schemas in a hydra ConfigStore
(``src/m3p2i_aip/config/config_store.py:25-29``) and composes YAML defaults
lists with CLI overrides (``config_point.yaml:1-3``, README.md:74-143 grammar
like ``task=push_pull multi_modal=True goal="[-3.75,-3.75]"`` and
``-cn config_panda``).  hydra is not a dependency here; this module implements
the same schema + defaults-list + dotted-override grammar in ~150 lines so the
README commands work unchanged.
"""
from __future__ import annotations

import ast
import dataclasses
from dataclasses import dataclass, field
from typing import List, Optional

from m3p2i_aip_tpu.planners.motion_planner.mppi import MPPIConfig
from m3p2i_aip_tpu.sim.sim_config import SimConfig
from m3p2i_aip_tpu.utils import path_utils, yaml_lite


@dataclass
class ExampleConfig:
    """Top-level run config. Parity: config_store.ExampleConfig (:7-23)."""

    render: bool = False
    n_steps: int = 1000
    mppi: MPPIConfig = field(default_factory=MPPIConfig)
    isaacgym: SimConfig = field(default_factory=SimConfig)  # name kept for CLI parity
    env_type: str = "point_env"
    task: str = "navigation"
    goal: List[float] = field(default_factory=lambda: [0.0, 0.0])
    nx: int = 4
    actors: List[str] = field(default_factory=list)
    initial_actor_positions: List[List[float]] = field(default_factory=list)
    kp_suction: int = 0
    suction_active: bool = False
    multi_modal: bool = False
    pre_height_diff: float = 0.0
    cube_on_shelf: bool = False
    # CLI shorthand for domain randomization: > 0 sets
    # noise_percentage_friction on every movable (non-fixed, non-robot)
    # actor without forking the per-actor YAML scene.  The real env then
    # draws a per-seed friction at build time and the planner draws K
    # per-rollout friction scales per reseed — the reference's per-env
    # creation-time noise (isaacgym_wrapper.py:313-319).
    fric_noise: float = 0.0

    @property
    def sim(self) -> SimConfig:
        return self.isaacgym


_GROUP_SCHEMAS = {"mppi": MPPIConfig, "isaacgym": SimConfig}


def _coerce(value: str):
    """Parse a CLI override value the way hydra/omegaconf would."""
    try:
        return ast.literal_eval(value)
    except (ValueError, SyntaxError):
        lowered = value.lower()
        if lowered == "true":
            return True
        if lowered == "false":
            return False
        if lowered in ("null", "none"):
            return None
        return value


def _apply_dict(obj, data: dict):
    """Recursively set dataclass fields from a dict (unknown keys rejected)."""
    names = {f.name for f in dataclasses.fields(obj)}
    for key, val in data.items():
        if key == "defaults":
            continue
        if key not in names:
            raise KeyError(f"unknown config key {key!r} for {type(obj).__name__}")
        cur = getattr(obj, key)
        if dataclasses.is_dataclass(cur) and isinstance(val, dict):
            _apply_dict(cur, val)
        else:
            setattr(obj, key, val)


def _set_dotted(cfg, dotted: str, value):
    parts = dotted.split(".")
    obj = cfg
    for p in parts[:-1]:
        obj = getattr(obj, p)
    names = {f.name for f in dataclasses.fields(obj)}
    if parts[-1] not in names:
        raise KeyError(f"unknown override key {dotted!r}")
    setattr(obj, parts[-1], value)


def _load_group_yaml(group: str, name: str) -> dict:
    path = path_utils.get_config_path() / group / f"{name}.yaml"
    return yaml_lite.load(path) or {}


def load_config(config_name: str = "config_point", overrides=None) -> ExampleConfig:
    """Compose ``<config_name>.yaml`` + defaults groups + CLI-style overrides.

    ``overrides`` is a list of strings like ``["task=push", "goal=[-1,-1]",
    "mppi.num_samples=512"]`` — the README's override grammar.
    """
    cfg = ExampleConfig()
    path = path_utils.get_config_path() / f"{config_name}.yaml"
    top = yaml_lite.load(path) or {}

    for entry in top.get("defaults", []):
        if isinstance(entry, dict):
            for group, name in entry.items():
                group = str(group)
                if group.startswith("_"):
                    continue
                data = _load_group_yaml(group, str(name))
                data.pop("defaults", None)
                _apply_dict(getattr(cfg, group), data)
    _apply_dict(cfg, top)

    for ov in overrides or []:
        if ov.startswith("-"):
            continue
        key, _, raw = ov.partition("=")
        key, raw = key.strip(), raw.strip()
        if key in _GROUP_SCHEMAS:
            # hydra group selection (e.g. ``mppi=panda_parity`` picks
            # config/mppi/panda_parity.yaml), same grammar as the defaults list
            data = _load_group_yaml(key, raw)
            data.pop("defaults", None)
            _apply_dict(getattr(cfg, key), data)
        else:
            _set_dotted(cfg, key, _coerce(raw))
    return cfg


def load_config_from_argv(argv, default_config: str = "config_point") -> ExampleConfig:
    """Parse ``[-cn NAME] key=value ...`` exactly like the reference's CLIs."""
    argv = list(argv)
    config_name = default_config
    overrides = []
    i = 0
    while i < len(argv):
        a = argv[i]
        if a in ("-cn", "--config-name"):
            config_name = argv[i + 1]
            i += 2
        elif a.startswith("--config-name="):
            config_name = a.split("=", 1)[1]
            i += 1
        elif "=" in a and not a.startswith("-"):
            overrides.append(a)
            i += 1
        else:
            i += 1
    return load_config(config_name, overrides)
