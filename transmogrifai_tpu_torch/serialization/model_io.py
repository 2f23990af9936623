"""Fitted-state encoding of workflow stages.

Counterpart of the encoder half of ``transmogrifai_tpu/serialization/
model_io.py``: ``stage_state`` lists a stage's fitted state, and
``_encode``/``_decode`` map it to and from a JSON document plus named
arrays.  ``workflow.dag.validate_dag`` dry-runs the encoder at train()
time, and ``interop.load_reference_state`` reads states in this form.
Saving and loading whole models come with a later slice (ROADMAP queue 1,
item 1).
"""
from __future__ import annotations

from typing import Any

import numpy as np


def _encode(value: Any, arrays: dict[str, np.ndarray], path: str) -> Any:
    if isinstance(value, np.ndarray):
        arrays[path] = value
        return {"__npz__": path}
    if isinstance(value, (np.floating, np.integer)):
        return value.item()
    if isinstance(value, dict):
        return {
            "__dict__": {
                k: _encode(v, arrays, f"{path}.{k}") for k, v in value.items()
            }
        }
    if isinstance(value, (list, tuple)):
        enc = [_encode(v, arrays, f"{path}[{i}]") for i, v in enumerate(value)]
        return {"__list__": enc, "__tuple__": isinstance(value, tuple)}
    if isinstance(value, (set, frozenset)):
        try:
            items = sorted(value)
        except TypeError:
            items = list(value)
        enc = [_encode(v, arrays, f"{path}{{{i}}}") for i, v in enumerate(items)]
        return {"__set__": enc, "__frozen__": isinstance(value, frozenset)}
    if value is None or isinstance(value, (bool, int, float, str)):
        return value
    raise TypeError(
        f"cannot serialize {type(value).__name__} at {path}; stages must keep "
        "fitted state as arrays/scalars/dicts/lists"
    )


def _decode(value: Any, arrays) -> Any:
    if isinstance(value, dict):
        if "__npz__" in value:
            return arrays[value["__npz__"]]
        if "__dict__" in value:
            return {k: _decode(v, arrays) for k, v in value["__dict__"].items()}
        if "__list__" in value:
            items = [_decode(v, arrays) for v in value["__list__"]]
            return tuple(items) if value.get("__tuple__") else items
        if "__set__" in value:
            items = [_decode(v, arrays) for v in value["__set__"]]
            return frozenset(items) if value.get("__frozen__") else set(items)
    return value


# attributes owned by the stage machinery, not fitted state
_SKIP_ATTRS = {
    "input_features", "_output", "uid", "operation_name", "params",
    "metadata", "estimator_ref", "selector", "validator", "models",
    "splitter", "evaluators", "validation_result", "fn", "predicate",
    "model", "output_type", "input_types", "prefer_numpy",
    # per-process transform memoizations (vectorizer_base/combiner/
    # sanity_checker): identity-keyed, must never persist
    "_meta_cache", "_combine_cache", "_select_cache",
    "_metas_memo", "_pivot_helpers",
}


def stage_state(stage) -> dict[str, Any]:
    out = {}
    for k, v in vars(stage).items():
        if k in _SKIP_ATTRS:
            continue
        out[k] = v
    return out
