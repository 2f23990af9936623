"""Model selector factories with default candidate grids.

Counterpart of ``transmogrifai_tpu/selector/factories.py``
(BinaryClassificationModelSelector + DefaultSelectorParams; reference:
core/.../impl/classification/BinaryClassificationModelSelector.scala:
46-100, impl/selector/DefaultSelectorParams.scala:36-61 - MaxDepth
{3,6,12}, Regularization {0.001,0.01,0.1,0.2}, ElasticNet {0.1,0.5},
MaxTrees {50}, MinInfoGain {0.001,0.01,0.1}, MinInstancesPerNode
{10,100}).  The grids are the JAX package's, constant for constant.

The binary registry builds every family of the JAX package's:
``OpLogisticRegression``, ``OpRandomForestClassifier``,
``OpGBTClassifier``, ``OpLinearSVC`` (the parameterless default four) and
``OpNaiveBayes``.  The multiclass and regression selectors raise
``NotImplementedError`` naming their ROADMAP.md queue 1 item.  Every estimator a factory builds
takes the selector's ``device`` (``"cuda"`` by default; ``OpWorkflow``
overrides it with its own).
"""
from __future__ import annotations

from itertools import product
from typing import Optional, Sequence

from ..evaluators.binary import OpBinaryClassificationEvaluator
from .model_selector import ModelSelector
from .splitters import DataBalancer, Splitter
from .validator import OpCrossValidation, OpTrainValidationSplit

REGULARIZATION = [0.001, 0.01, 0.1, 0.2]
ELASTIC_NET = [0.1, 0.5]
MAX_DEPTH = [3, 6, 12]
MAX_TREES = [50]
MIN_INFO_GAIN = [0.001, 0.01, 0.1]
MIN_INSTANCES_PER_NODE = [10, 100]


def lr_grid() -> list[dict]:
    return [
        {"reg_param": r, "elastic_net_param": e}
        for r, e in product(REGULARIZATION, ELASTIC_NET)
    ]


def linreg_grid() -> list[dict]:
    return lr_grid()


def rf_grid() -> list[dict]:
    return [
        {
            "max_depth": d,
            "num_trees": t,
            "min_info_gain": g,
            "min_instances_per_node": m,
        }
        for d, t, g, m in product(
            MAX_DEPTH, MAX_TREES, MIN_INFO_GAIN, MIN_INSTANCES_PER_NODE
        )
    ]


def gbt_grid() -> list[dict]:
    return [
        {"max_depth": d, "num_trees": 20, "min_info_gain": g}
        for d, g in product(MAX_DEPTH, MIN_INFO_GAIN)
    ]


def _not_ported(what: str, item) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to the torch package yet "
        f"(ROADMAP.md queue 1, item {item})"
    )


def _binary_models(model_types: Optional[Sequence[str]], device: str):
    from ..models.linear_svc import OpLinearSVC
    from ..models.logistic_regression import OpLogisticRegression
    from ..models.naive_bayes import OpNaiveBayes
    from ..models.trees import OpGBTClassifier, OpRandomForestClassifier

    registry = {
        "OpLogisticRegression": lambda: (
            OpLogisticRegression(device=device), lr_grid()),
        "OpRandomForestClassifier": lambda: (
            OpRandomForestClassifier(device=device), rf_grid()),
        "OpGBTClassifier": lambda: (OpGBTClassifier(device=device), gbt_grid()),
        "OpLinearSVC": lambda: (OpLinearSVC(device=device), lr_grid()),
        "OpNaiveBayes": lambda: (OpNaiveBayes(device=device), [{}]),
    }
    # reference defaults: LR, RF, GBT, LinearSVC
    # (BinaryClassificationModelSelector.scala:46-100)
    wanted = model_types or [
        "OpLogisticRegression",
        "OpRandomForestClassifier",
        "OpGBTClassifier",
        "OpLinearSVC",
    ]
    return [registry[m]() for m in wanted]


def _selector(validator, model_types, splitter, seed, models_and_parameters,
              device) -> ModelSelector:
    return ModelSelector(
        validator=validator,
        models=models_and_parameters or _binary_models(model_types, device),
        splitter=splitter
        if splitter is not None
        else DataBalancer(sample_fraction=0.1, reserve_test_fraction=0.1, seed=seed),
        evaluators=[OpBinaryClassificationEvaluator()],
        device=device,
    )


class BinaryClassificationModelSelector:
    """Factory (reference: BinaryClassificationModelSelector cv/ts
    constructors); with no ``model_types_to_use`` it cross-validates
    logistic regression, the random forest, the GBT and the linear SVM at
    their default grids."""

    @staticmethod
    def with_cross_validation(
        num_folds: int = 3,
        validation_metric=None,
        model_types_to_use: Optional[Sequence[str]] = None,
        splitter: Optional[Splitter] = None,
        seed: int = 42,
        models_and_parameters=None,
        autotune=None,
        device: str = "cuda",
    ) -> ModelSelector:
        ev = validation_metric or OpBinaryClassificationEvaluator()
        return _selector(
            OpCrossValidation(
                num_folds=num_folds, evaluator=ev, seed=seed, stratify=True,
                autotune=autotune, device=device,
            ),
            model_types_to_use, splitter, seed, models_and_parameters, device,
        )

    @staticmethod
    def with_train_validation_split(
        train_ratio: float = 0.75,
        validation_metric=None,
        model_types_to_use: Optional[Sequence[str]] = None,
        splitter: Optional[Splitter] = None,
        seed: int = 42,
        models_and_parameters=None,
        autotune=None,
        device: str = "cuda",
    ) -> ModelSelector:
        ev = validation_metric or OpBinaryClassificationEvaluator()
        return _selector(
            OpTrainValidationSplit(
                train_ratio=train_ratio, evaluator=ev, seed=seed,
                stratify=True, autotune=autotune, device=device,
            ),
            model_types_to_use, splitter, seed, models_and_parameters, device,
        )

    # parameterless call mirrors the reference's `BinaryClassificationModelSelector()`
    def __new__(cls, *args, **kw) -> ModelSelector:  # type: ignore[misc]
        return cls.with_cross_validation(*args, **kw)


class MultiClassificationModelSelector:
    """Not ported: multiclass logistic regression (softmax, one-vs-rest)
    comes with ROADMAP.md queue 1, item 5."""

    @staticmethod
    def with_cross_validation(*args, **kw):
        raise _not_ported("MultiClassificationModelSelector (multiclass LR)", 5)

    with_train_validation_split = with_cross_validation

    def __new__(cls, *args, **kw):  # type: ignore[misc]
        return cls.with_cross_validation(*args, **kw)


class RegressionModelSelector:
    """Not ported: linear regression comes with ROADMAP.md queue 1,
    item 8."""

    @staticmethod
    def with_cross_validation(*args, **kw):
        raise _not_ported("RegressionModelSelector (linear regression)", 8)

    with_train_validation_split = with_cross_validation

    def __new__(cls, *args, **kw):  # type: ignore[misc]
        return cls.with_cross_validation(*args, **kw)
