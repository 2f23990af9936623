"""Helpers shared by the tests/test_torch_*.py parity tests.

The torch package mirrors the JAX package's module paths, so one builder
drives either package by name: ``pkg`` is ``"transmogrifai_tpu"`` or
``"transmogrifai_tpu_torch"``.
"""
import importlib

import numpy as np
import torch

REF, PORT = "transmogrifai_tpu", "transmogrifai_tpu_torch"

# parity tests compare float32 arithmetic: no TF32 anywhere
torch.set_float32_matmul_precision("highest")


def mod(pkg: str, path: str):
    return importlib.import_module(f"{pkg}.{path}")


def reset_uids(pkg: str) -> None:
    mod(pkg, "utils.uid").reset_uids()


def workflow(pkg: str, result, data, **params):
    """OpWorkflow of ``pkg`` over ``data``; the torch package's runs on
    the CPU."""
    kw = {"device": "cpu"} if pkg == PORT else {}
    wf = mod(pkg, "workflow.workflow").OpWorkflow(**kw)
    wf = wf.set_result_features(result).set_input_dataset(data)
    if params:
        wf.set_parameters(**params)
    return wf


def passenger_features(pkg: str):
    """(label, predictors) of the passenger slice: age, height, weight
    (Real) and gender (PickList) against survived (RealNN)."""
    fb = mod(pkg, "features.feature_builder").FeatureBuilder
    survived = fb.RealNN("survived").as_response()
    preds = [fb.Real(c).as_predictor() for c in ("age", "height", "weight")]
    preds.append(fb.PickList("gender").as_predictor())
    return survived, preds


def passenger_slice(pkg: str, sanity_kw=None, lr_kw=None):
    """transmogrify -> SanityChecker -> OpLogisticRegression of ``pkg``;
    returns (label, checked vector, prediction) features."""
    survived, preds = passenger_features(pkg)
    vec = mod(pkg, "ops.transmogrifier").transmogrify(preds)
    kw = {"device": "cpu"} if pkg == PORT else {}
    checker = mod(pkg, "preparators.sanity_checker").SanityChecker(
        **(sanity_kw or {}), **kw
    )
    checked = checker.set_input(survived, vec).get_output()
    lr = mod(pkg, "models.logistic_regression").OpLogisticRegression(
        **(lr_kw or {}), **kw
    )
    pred = lr.set_input(survived, checked).get_output()
    return survived, checked, pred


def passengers(pkg: str, n: int, seed: int = 42):
    return mod(pkg, "examples.synthetic").synthetic_passengers(
        n, seed=seed, with_text=False
    )


def stage_of(model, cls_name: str):
    (st,) = [s for s in model.stages if type(s).__name__ == cls_name]
    return st


def probabilities(scored, pred_name: str) -> np.ndarray:
    return np.asarray(scored[pred_name].probability, dtype=np.float64)


def identified(model, scored, checked_name: str):
    """The fitted LR's (beta, intercept) with each one-hot group whose kept
    columns sum to 1 on every row centred to mean 0 (the shift moves into
    the intercept).  Such a group is collinear with the intercept, so an
    unregularized fit pins its common level only by float32 rounding."""
    params = model.stages[-1].model_params
    beta = np.asarray(params["beta"], np.float64).copy()
    b0 = float(params["intercept"])
    col = scored[checked_name]
    x = np.asarray(col.values)
    for idx in col.metadata.grouping_indices().values():
        idx = list(idx)
        if len(idx) > 1 and np.all(x[:, idx].sum(axis=1) == 1.0):
            shift = beta[idx].mean()
            beta[idx] -= shift
            b0 += shift
    return beta, b0
