"""Bundled data files: the default configuration, the preferred dialects of
the phoneme inventories, and the flagship's frozen plan."""

from importlib import resources


def _resource(name: str):
    return resources.files(__name__) / name


DEFAULT_CONFIG_PATH = str(_resource("default_config.toml"))
DEFAULT_DIALECTS_PATH = _resource("default_dialects.json")
