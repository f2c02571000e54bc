"""mmcv-style config system with ``_base_`` inheritance.

Port of ``convnet_approximater_tpu/utils/config.py`` with the same semantics:
``.py`` (module namespace, dunders stripped) or ``.yaml`` files, recursive
``_base_`` inheritance with list-of-bases merge, deep merge with a ``_cover_``
key that replaces instead of merging a subtree, attribute access returning
``None`` for missing keys, auto ``name``/``work_dir`` defaults, and a
process-global singleton behind ``init_cfg/get_cfg/update_cfg/save_cfg/print_cfg``.

PyYAML is imported only where a ``.yaml`` config is read or written; the saved
config of a run is JSON.
"""

from __future__ import annotations

import copy
import importlib.util
import inspect
import json
import os
from collections import OrderedDict

__all__ = ["Config", "get_cfg", "init_cfg", "save_cfg", "print_cfg", "update_cfg"]

BASE_KEY = "_base_"
COVER_KEY = "_cover_"


class Config(OrderedDict):
    """Dict with attribute access (missing keys -> ``None``)."""

    def __init__(self, *args):
        super().__init__()
        if len(args) == 1:
            if isinstance(args[0], dict):
                self.update(self.dfs(args[0]))
            else:
                self.load_from_file(args[0])
        elif args:
            raise TypeError(f"Config takes at most one argument, got {len(args)}")

    def __getattr__(self, name):
        if name in self:
            return self[name]
        return None

    def __setattr__(self, name, value):
        self[name] = value

    # ---- file loading -------------------------------------------------
    @staticmethod
    def _load_dict_from_file_no_base(filename):
        ext = os.path.splitext(filename)[1]
        if ext in (".yaml", ".yml"):
            import yaml

            with open(filename, "r") as f:
                cfg = yaml.safe_load(f.read()) or {}
        elif ext == ".py":
            spec = importlib.util.spec_from_file_location("_cfg_module_", filename)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            cfg = {
                name: value
                for name, value in vars(mod).items()
                if not name.startswith("__") and not inspect.ismodule(value)
            }
        else:
            raise ValueError(f"unsupported config type: {filename}")
        return cfg

    @staticmethod
    def _load_dict_from_file(filename):
        cfg = Config._load_dict_from_file_no_base(filename)
        cfg_dir = os.path.dirname(filename)
        if BASE_KEY in cfg:
            bases = cfg.pop(BASE_KEY)
            if isinstance(bases, str):
                bases = [bases]
            cfg_base: dict = {}
            for bfn in bases:
                Config.merge_dict_b2a(
                    cfg_base, Config._load_dict_from_file(os.path.join(cfg_dir, bfn))
                )
            Config.merge_dict_b2a(cfg_base, cfg)
            cfg = cfg_base
        return cfg

    # ---- deep merge ---------------------------------------------------
    @staticmethod
    def merge_dict_b2a(a: dict, b: dict):
        """Deep-merge ``b`` into ``a``. A dict carrying ``_cover_`` replaces
        the corresponding subtree of ``a`` entirely instead of merging."""

        def clear_cover_key(v):
            if not isinstance(v, dict):
                return v
            return {k: clear_cover_key(vv) for k, vv in v.items() if k != COVER_KEY}

        if COVER_KEY in b:
            a.clear()
            a.update(clear_cover_key(copy.deepcopy(b)))
            return
        for k, v in b.items():
            if (
                k not in a
                or (isinstance(v, dict) and v.get(COVER_KEY, False))
                or not isinstance(v, dict)
                or not isinstance(a[k], dict)
            ):
                a[k] = clear_cover_key(copy.deepcopy(v))
            else:
                Config.merge_dict_b2a(a[k], v)

    def load_from_file(self, filename):
        cfg = Config._load_dict_from_file(filename)
        self.clear()
        self.update(self.dfs(cfg))
        if self.name is None:
            self.name = os.path.splitext(os.path.basename(filename))[0]
        if self.work_dir is None:
            self.work_dir = f"work_dirs/{self.name}"

    def dfs(self, other):
        """Recursively convert nested dicts to Config, dropping modules."""
        if isinstance(other, dict):
            now = Config()
            for k, d in other.items():
                if inspect.ismodule(d):
                    continue
                now[k] = self.dfs(d)
            return now
        if isinstance(other, list):
            return [self.dfs(d) for d in other if not inspect.ismodule(d)]
        return copy.deepcopy(other)

    def dump(self):
        """Convert to a plain dict of plain values."""
        now = {}
        for k, d in self.items():
            if isinstance(d, Config):
                d = d.dump()
            elif isinstance(d, (list, tuple)):
                d = [dd.dump() if isinstance(dd, Config) else dd for dd in d]
            now[k] = d
        return now


_cfg = Config()


def init_cfg(filename):
    _cfg.load_from_file(filename)


def get_cfg() -> Config:
    return _cfg


def update_cfg(**kwargs):
    _cfg.update(kwargs)


def _dumps() -> str:
    return json.dumps(_cfg.dump(), indent=2, default=str)


def save_cfg(save_file):
    """Write the global config as JSON, or as YAML for a ``.yaml``/``.yml`` path."""
    with open(save_file, "w") as f:
        if os.path.splitext(save_file)[1] in (".yaml", ".yml"):
            import yaml

            f.write(yaml.dump(_cfg.dump()))
        else:
            f.write(_dumps())


def print_cfg():
    print(_dumps())
