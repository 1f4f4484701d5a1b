"""Bundled data files: the default configuration, the preferred dialects of
the phoneme inventories, eSpeak NG's phoneme replacements and the
flagship's frozen plan."""

from importlib import resources


def _resource(name: str):
    return resources.files(__name__) / name


DEFAULT_CONFIG_PATH = str(_resource("default_config.toml"))
DEFAULT_DIALECTS_PATH = _resource("default_dialects.json")
PHONEME_REPLACEMENTS_PATH = _resource("espeakng_phoneme_replacements.json")
