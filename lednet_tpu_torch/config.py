"""mmseg-dialect config loader for the PyTorch port.

The port's own copy of ``lednet_tpu.config`` (``ConfigDict``, the ``_base_``
deep merge with ``_delete_``, ``Config.fromfile`` and dotted
``merge_from_dict`` overrides), so that the files under ``configs/`` load
unchanged without importing the JAX package.
"""
from __future__ import annotations

import ast
import copy
import os
from typing import Any, Dict, Optional, Union

DELETE_KEY = '_delete_'
BASE_KEY = '_base_'


class ConfigDict(dict):
    """dict with attribute access, applied recursively on the way in."""

    def __init__(self, *args, **kwargs):
        super().__init__()
        for src in list(args) + [kwargs]:
            for k, v in dict(src).items():
                self[k] = v

    @staticmethod
    def _wrap(value):
        if isinstance(value, dict) and not isinstance(value, ConfigDict):
            return ConfigDict(value)
        if isinstance(value, (list, tuple)):
            return type(value)(ConfigDict._wrap(v) for v in value)
        return value

    def __setitem__(self, key, value):
        super().__setitem__(key, self._wrap(value))

    def __setattr__(self, key, value):
        self[key] = value

    def __getattr__(self, key):
        try:
            return self[key]
        except KeyError as e:
            raise AttributeError(key) from e

    def __delattr__(self, key):
        try:
            del self[key]
        except KeyError as e:
            raise AttributeError(key) from e

    def __deepcopy__(self, memo):
        out = ConfigDict()
        for k, v in self.items():
            dict.__setitem__(out, copy.deepcopy(k, memo), copy.deepcopy(v, memo))
        return out

    def setdefault(self, key, default=None):
        if key not in self:
            self[key] = default
        return self[key]

    def update(self, *args, **kwargs):
        for src in list(args) + [kwargs]:
            for k, v in dict(src).items():
                self[k] = v

    def copy(self):
        return ConfigDict(dict(self))

    def get(self, key, default=None):
        return super().get(key, default)


def merge_a_into_b(a: Dict, b: Dict) -> Dict:
    """Recursively merge dict ``a`` (child) into ``b`` (base); returns new dict."""
    b = copy.deepcopy(dict(b))
    for key, value in a.items():
        if isinstance(value, dict) and key in b and isinstance(b[key], dict) \
                and not value.get(DELETE_KEY, False):
            merged = merge_a_into_b(value, b[key])
            merged.pop(DELETE_KEY, None)  # `_delete_=False` must not leak
            b[key] = merged
        else:
            if isinstance(value, dict):
                value = {k: v for k, v in value.items() if k != DELETE_KEY}
            b[key] = copy.deepcopy(value)
    return b


def _exec_pyfile(filename: str) -> Dict[str, Any]:
    filename = os.path.abspath(os.path.expanduser(filename))
    with open(filename, encoding='utf-8') as f:
        code = f.read()
    # validate syntax with a helpful error
    ast.parse(code, filename=filename)
    namespace: Dict[str, Any] = {'__file__': filename}
    exec(compile(code, filename, 'exec'), namespace)
    return {k: v for k, v in namespace.items()
            if not k.startswith('__') and not callable(v)
            and not isinstance(v, type(os))}


def _load_cfg_dict(filename: str) -> Dict[str, Any]:
    if not filename.endswith('.py'):
        raise ValueError(f'Only python configs are supported, got {filename}')
    raw = _exec_pyfile(filename)
    base_files = raw.pop(BASE_KEY, [])
    if isinstance(base_files, str):
        base_files = [base_files]
    merged: Dict[str, Any] = {}
    cfg_dir = os.path.dirname(os.path.abspath(os.path.expanduser(filename)))
    for base in base_files:
        base_path = base if os.path.isabs(base) else os.path.join(cfg_dir, base)
        merged = merge_a_into_b(_load_cfg_dict(base_path), merged)
    merged = merge_a_into_b(raw, merged)
    return merged


def _parse_scalar(value: str) -> Any:
    """Parse a CLI override value: literals, bools, None, tuples/lists."""
    try:
        return ast.literal_eval(value)
    except (ValueError, SyntaxError):
        pass
    lowered = value.lower()
    if lowered in ('true', 'false'):
        return lowered == 'true'
    if lowered in ('none', 'null'):
        return None
    if ',' in value:
        return [_parse_scalar(v) for v in value.split(',') if v]
    return value


class Config:
    """Loaded configuration with attribute access and CLI-override merging."""

    def __init__(self, cfg_dict: Optional[Dict] = None, filename: Optional[str] = None):
        self._cfg_dict = ConfigDict(cfg_dict or {})
        self._filename = filename

    # -- construction ------------------------------------------------------
    @staticmethod
    def fromfile(filename: Union[str, os.PathLike]) -> 'Config':
        filename = str(filename)
        return Config(_load_cfg_dict(filename), filename=filename)

    # -- access ------------------------------------------------------------
    @property
    def filename(self) -> Optional[str]:
        return self._filename

    def __getattr__(self, name):
        if name.startswith('_'):
            raise AttributeError(name)
        try:
            return self._cfg_dict[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name, value):
        if name.startswith('_'):
            super().__setattr__(name, value)
        else:
            self._cfg_dict[name] = value

    def __getitem__(self, key):
        return self._cfg_dict[key]

    def __setitem__(self, key, value):
        self._cfg_dict[key] = value

    def __contains__(self, key):
        return key in self._cfg_dict

    def get(self, key, default=None):
        return self._cfg_dict.get(key, default)

    def keys(self):
        return self._cfg_dict.keys()

    def items(self):
        return self._cfg_dict.items()

    def to_dict(self) -> Dict:
        return copy.deepcopy(dict(self._cfg_dict))

    def copy(self) -> 'Config':
        return Config(copy.deepcopy(dict(self._cfg_dict)), self._filename)

    def __repr__(self) -> str:
        return f'Config(file={self._filename}): {dict(self._cfg_dict)}'

    # -- CLI overrides ------------------------------------------------------
    def merge_from_dict(self, options: Dict[str, Any]) -> None:
        """Merge dotted-key overrides, mmengine ``--cfg-options`` style."""
        nested: Dict[str, Any] = {}
        for full_key, value in options.items():
            if isinstance(value, str):
                value = _parse_scalar(value)
            d = nested
            parts = full_key.split('.')
            for part in parts[:-1]:
                d = d.setdefault(part, {})
            d[parts[-1]] = value
        merged = merge_a_into_b(nested, dict(self._cfg_dict))
        self._cfg_dict = ConfigDict(merged)

    def dump(self, file: str) -> None:
        """Write the merged config as a pretty-printed python literal."""
        import pprint
        with open(file, 'w', encoding='utf-8') as f:
            for key, value in self._cfg_dict.items():
                f.write(f'{key} = {pprint.pformat(value, width=100)}\n')
