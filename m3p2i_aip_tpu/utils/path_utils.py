"""Package/asset/config path helpers. Parity: utils/path_utils.py:4-26."""
from __future__ import annotations

import pathlib

import m3p2i_aip_tpu


def get_package_path() -> pathlib.Path:
    return pathlib.Path(m3p2i_aip_tpu.__file__).parent


def get_assets_path() -> pathlib.Path:
    return get_package_path() / "assets"


def get_config_path() -> pathlib.Path:
    return get_package_path() / "config"


def get_plot_path() -> pathlib.Path:
    return get_package_path().parent / "plot"


def load_yaml(file_path):
    from m3p2i_aip_tpu.utils import yaml_lite

    return yaml_lite.load(file_path)
