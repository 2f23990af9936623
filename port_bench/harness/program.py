"""The system under test: the port's public entry points, and what a train
produced.

Builds the cell's workflow as a user would (typed raw features ->
``transmogrify(preds, label=...)`` -> ``SanityChecker`` ->
``BinaryClassificationModelSelector.with_cross_validation`` at the mix's
families and the factory's own grids -> ``OpWorkflow(device=...)``),
turns the generator's columns into the port's ``Dataset``, and takes from a trained model what the
correctness check judges: the design matrix the SanityChecker fitted on,
its statistics and kept columns, every candidate's fold metrics, the
winner, and the winner's scores on the holdout rows.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from transmogrifai_tpu_torch import Dataset, FeatureBuilder, OpWorkflow
from transmogrifai_tpu_torch.ops.transmogrifier import transmogrify
from transmogrifai_tpu_torch.preparators.sanity_checker import SanityChecker
from transmogrifai_tpu_torch.selector import factories
from transmogrifai_tpu_torch.selector.splitters import DataBalancer
from transmogrifai_tpu_torch.types import feature_types as ft
from transmogrifai_tpu_torch.types.columns import NumericColumn, TextColumn

_TYPES = {"Real": ft.Real, "RealNN": ft.RealNN, "Integral": ft.Integral,
          "PickList": ft.PickList}


def to_dataset(raw: dict, config: dict) -> Dataset:
    """The generator's columns as the port's host columns."""
    cols = {}
    for spec in config["columns"] + [config["label"]]:
        r = raw[spec["name"]]
        t = _TYPES[spec["type"]]
        if r.numeric:
            cols[spec["name"]] = NumericColumn(r.values, r.mask, t)
        else:
            cols[spec["name"]] = TextColumn(r.values, t)
    return Dataset(cols)


@dataclass
class Built:
    workflow: OpWorkflow
    label: object
    vector: object
    checked: object
    prediction: object


def build(config: dict, mix: dict, device: str) -> Built:
    """A new workflow of the cell: a new selector and new stages."""
    label = getattr(FeatureBuilder, config["label"]["type"])(
        config["label"]["name"]).as_response()
    preds = [getattr(FeatureBuilder, c["type"])(c["name"]).as_predictor()
             for c in config["columns"]]
    vec = transmogrify(preds, label=label)
    checked = SanityChecker().set_input(label, vec).get_output()
    sel = mix["selector"]
    sp = sel["splitter"]
    if sp["kind"] != "DataBalancer":
        raise ValueError(f"unknown splitter {sp['kind']!r}")
    selector = factories.BinaryClassificationModelSelector.with_cross_validation(
        num_folds=int(sel["num_folds"]), seed=int(sel["seed"]),
        model_types_to_use=[f["model_type"] for f in sel["families"]],
        splitter=DataBalancer(
            sample_fraction=float(sp["sample_fraction"]),
            reserve_test_fraction=float(sp["reserve_test_fraction"]),
            seed=int(sp["seed"])),
        device=device,
    )
    pred = selector.set_input(label, checked).get_output()
    wf = OpWorkflow(device=device).set_result_features(pred)
    return Built(wf, label, vec, checked, pred)


@dataclass
class Outputs:
    """What one train produced, as the check reads it."""

    design: np.ndarray                    # [n_train, d] float32
    columns: list                          # (parent, grouping, indicator)
    keep: list
    stats: dict                            # mean / variance / corr [d]
    candidates: list                       # dicts: family, params, folds, mode
    winner: tuple                          # (family, params)
    holdout_scores: np.ndarray             # [n_holdout] float64
    train_fused: Optional[dict] = None
    meta: dict = field(default_factory=dict)


def extract(model, built: Built) -> Outputs:
    train = model._train_data_cache
    holdout = model._holdout_data_cache
    vec = train[built.vector.name]
    checker = next(s for s in model.stages
                   if type(s).__name__ == "SanityCheckerModel")
    selected = next(s for s in model.stages
                    if type(s).__name__ == "SelectedModel")
    summ = checker.metadata["sanity_checker_summary"]
    cs = summ["column_stats"]
    nan = float("nan")
    stats = {
        "mean": np.array([c["mean"] for c in cs], np.float64),
        "variance": np.array([c["variance"] for c in cs], np.float64),
        "corr": np.array([nan if c["corr_label"] is None else c["corr_label"]
                          for c in cs], np.float64),
    }
    md = selected.metadata["model_selector_summary"]
    cands = [{"family": r["model_type"], "params": dict(r["params"]),
              "folds": list(r["fold_metrics"]),
              "mode": r.get("rank_metric_mode", "exact")}
             for r in md["validation_results"]]
    pc = holdout[built.prediction.name]
    scores = (pc.probability[:, 1] if pc.probability is not None
              else pc.prediction)
    return Outputs(
        design=np.asarray(vec.values),
        columns=[(c.parent_feature_name, c.grouping, c.indicator_value)
                 for c in vec.metadata.columns],
        keep=list(checker.indices_to_keep),
        stats=stats,
        candidates=cands,
        winner=(md["best_model_type"], dict(md["best_params"])),
        holdout_scores=np.asarray(scores, np.float64),
        train_fused=md.get("train_fused"),
        meta={"n_train": int(len(train)), "n_holdout": int(len(holdout)),
              "width": int(vec.values.shape[1]), "kept": len(checker.indices_to_keep)},
    )


def stage_modules(model) -> dict:
    """uid -> the module of the fitted stage with that uid."""
    return {s.uid: type(s).__module__ for s in model.stages}
