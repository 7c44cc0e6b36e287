"""Name -> constructor registries for the PyTorch port.

The port's own copy of ``lednet_tpu.registry.Registry``: configs name
components by string ``type=``, and :meth:`Registry.build` instantiates the
registered class with the remaining keys as keyword arguments.  The port keeps
its own registry instances so that it never imports the JAX package.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional


class Registry:
    """A minimal string -> callable registry with a recursive builder."""

    def __init__(self, name: str):
        self.name = name
        self._module_dict: Dict[str, Callable] = {}

    def __contains__(self, key: str) -> bool:
        return key in self._module_dict

    def __repr__(self) -> str:
        return f'Registry({self.name}, {sorted(self._module_dict)})'

    def get(self, key: str) -> Optional[Callable]:
        return self._module_dict.get(key)

    def register_module(self, name: Optional[str] = None, module: Optional[Callable] = None,
                        force: bool = False):
        """Register a class/function, usable as a decorator or a call."""
        if module is not None:
            self._register(module, name, force)
            return module

        def _decorator(mod):
            self._register(mod, name, force)
            return mod

        return _decorator

    def _register(self, module: Callable, name: Optional[str], force: bool) -> None:
        key = name or module.__name__
        if not force and key in self._module_dict and self._module_dict[key] is not module:
            raise KeyError(f'{key} is already registered in {self.name}')
        self._module_dict[key] = module

    def build(self, cfg: Dict[str, Any], **default_args) -> Any:
        """Instantiate ``cfg['type']`` with the remaining keys as kwargs;
        ``default_args`` fill in missing keys."""
        if not isinstance(cfg, dict):
            raise TypeError(f'cfg must be a dict, got {type(cfg)}')
        if 'type' not in cfg:
            raise KeyError(f"cfg must contain the key 'type': {cfg}")
        args = dict(cfg)
        obj_type = args.pop('type')
        for k, v in default_args.items():
            args.setdefault(k, v)
        if isinstance(obj_type, str):
            obj_cls = self.get(obj_type)
            if obj_cls is None:
                raise KeyError(f'{obj_type} is not registered in {self.name}. '
                               f'Available: {sorted(self._module_dict)}')
        elif callable(obj_type):
            obj_cls = obj_type
        else:
            raise TypeError(f'type must be a str or callable, got {type(obj_type)}')
        try:
            return obj_cls(**args)
        except TypeError as e:
            raise TypeError(f'Failed to build {obj_type} from {self.name}: {e}') from e


MODELS = Registry('models')
DATASETS = Registry('datasets')
TRANSFORMS = Registry('transforms')
METRICS = Registry('metrics')
