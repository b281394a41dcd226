"""YAML experiment-config loader with the default/override schema.

The port's own copy of ``adjointnonlinearraytracing_tpu/experiments/config.py``:
``load_params(path, name)`` returns the ``default`` section deep-merged with
the named section, as a plain dict that the experiments consume with
``params.get(...)``.  ``yaml`` is imported where a file is read, so importing
this module does not need it.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, List, Optional


def load_yaml(path: str) -> Dict[str, Any]:
    import yaml

    with open(path) as f:
        return yaml.safe_load(f)


def experiment_names(path: str) -> List[str]:
    """All named override sections in the file (everything but 'default')."""
    return [k for k in load_yaml(path).keys() if k != "default"]


def load_params(path: str, name: Optional[str] = None) -> Dict[str, Any]:
    """default section merged with the named override section.

    ``name=None`` returns just the defaults.  Override values win; nested
    dicts merge recursively.
    """
    doc = load_yaml(path)
    params = copy.deepcopy(doc.get("default", {}) or {})
    if name is not None:
        if name not in doc:
            raise KeyError(
                f"experiment {name!r} not in {path}; available: "
                f"{[k for k in doc if k != 'default']}")
        _merge(params, doc[name] or {})
    params.setdefault("exp_name", name or "default")
    return params


def _merge(base: Dict[str, Any], override: Dict[str, Any]) -> None:
    for k, v in override.items():
        if isinstance(v, dict) and isinstance(base.get(k), dict):
            _merge(base[k], v)
        else:
            base[k] = v
