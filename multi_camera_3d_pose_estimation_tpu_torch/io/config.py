"""YAML-over-introspected-defaults configs, as the JAX package's ``io/config.py``.

YAML values are merged over a function's signature defaults; the string
".inf" becomes ``np.inf`` and a ``betas`` list becomes a tuple.  PyYAML is
imported only when a YAML file is read, so the rest works without it.
"""

from __future__ import annotations

import inspect

import numpy as np

__all__ = ["load_config", "get_function_defaults", "prepare_kwargs"]


def load_config(config_path: str | None = None) -> dict:
    """The YAML file's mapping ({} for no path or an empty file)."""
    if config_path is None:
        return {}
    import yaml

    with open(config_path) as f:
        return yaml.safe_load(f) or {}


def get_function_defaults(func) -> dict:
    """{parameter: default} of ``func``'s parameters that have one."""
    sig = inspect.signature(func)
    return {k: v.default for k, v in sig.parameters.items()
            if v.default is not inspect.Parameter.empty}


def prepare_kwargs(func, user_kwargs: dict | None) -> dict:
    """``func``'s defaults updated by ``user_kwargs``, with ".inf" -> inf and
    a ``betas`` list -> tuple."""
    kwargs = get_function_defaults(func)
    kwargs.update(user_kwargs or {})
    for k, v in kwargs.items():
        if v == ".inf":
            kwargs[k] = np.inf
        if k == "betas" and isinstance(v, list):
            kwargs[k] = tuple(v)
    return kwargs
