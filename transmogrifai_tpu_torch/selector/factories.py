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
``OpNaiveBayes``.  ``MultiClassificationModelSelector`` (LR, the forest,
the decision tree, naive Bayes) and ``RegressionModelSelector`` (linear
regression, the forest and GBT regressors) mirror the JAX package's
entry points: ``with_cross_validation`` and the parameterless call.
Every estimator a factory builds takes the selector's ``device``
(``"cuda"`` by default; ``OpWorkflow`` overrides it with its own).
"""
from __future__ import annotations

from itertools import product
from typing import Optional, Sequence

from ..evaluators.binary import OpBinaryClassificationEvaluator
from ..evaluators.multiclass import OpMultiClassificationEvaluator
from ..evaluators.regression import OpRegressionEvaluator
from .model_selector import ModelSelector
from .splitters import DataBalancer, DataCutter, DataSplitter, Splitter
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


def _multiclass_models(model_types: Optional[Sequence[str]], device: str):
    from ..models.logistic_regression import OpLogisticRegression
    from ..models.naive_bayes import OpNaiveBayes
    from ..models.trees import OpDecisionTreeClassifier, OpRandomForestClassifier

    registry = {
        "OpLogisticRegression": lambda: (
            OpLogisticRegression(device=device), lr_grid()),
        "OpRandomForestClassifier": lambda: (
            OpRandomForestClassifier(device=device), rf_grid()),
        "OpDecisionTreeClassifier": lambda: (
            OpDecisionTreeClassifier(device=device),
            [{"max_depth": d, "min_info_gain": g}
             for d, g in product(MAX_DEPTH, MIN_INFO_GAIN)],
        ),
        "OpNaiveBayes": lambda: (OpNaiveBayes(device=device), [{}]),
    }
    # reference defaults: LR, RF, DT, NB
    wanted = model_types or [
        "OpLogisticRegression",
        "OpRandomForestClassifier",
        "OpDecisionTreeClassifier",
        "OpNaiveBayes",
    ]
    return [registry[m]() for m in wanted]


class MultiClassificationModelSelector:
    """Factory (reference: MultiClassificationModelSelector); with no
    ``model_types_to_use`` it cross-validates (stratified folds) logistic
    regression (softmax, or one-vs-rest past 2048 parameters), the random
    forest, the decision tree over depth x min_info_gain and naive Bayes,
    after a ``DataCutter`` holdout of 10%, by weighted F1."""

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
        ev = validation_metric or OpMultiClassificationEvaluator()
        return ModelSelector(
            validator=OpCrossValidation(
                num_folds=num_folds, evaluator=ev, seed=seed, stratify=True,
                autotune=autotune, device=device,
            ),
            models=models_and_parameters
            or _multiclass_models(model_types_to_use, device),
            splitter=splitter
            if splitter is not None
            else DataCutter(reserve_test_fraction=0.1, seed=seed),
            evaluators=[OpMultiClassificationEvaluator()],
            device=device,
        )

    def __new__(cls, *args, **kw) -> ModelSelector:  # type: ignore[misc]
        return cls.with_cross_validation(*args, **kw)


def _regression_models(model_types: Optional[Sequence[str]], device: str):
    from ..models.linear_regression import OpLinearRegression
    from ..models.trees import OpGBTRegressor, OpRandomForestRegressor

    registry = {
        "OpLinearRegression": lambda: (
            OpLinearRegression(device=device), linreg_grid()),
        "OpRandomForestRegressor": lambda: (
            OpRandomForestRegressor(device=device), rf_grid()),
        "OpGBTRegressor": lambda: (OpGBTRegressor(device=device), gbt_grid()),
    }
    # reference defaults: LinReg, RF, GBT
    wanted = model_types or [
        "OpLinearRegression",
        "OpRandomForestRegressor",
        "OpGBTRegressor",
    ]
    return [registry[m]() for m in wanted]


class RegressionModelSelector:
    """Factory (reference: RegressionModelSelector); with no
    ``model_types_to_use`` it cross-validates (unstratified folds) linear
    regression, the random forest regressor and the GBT regressor, after a
    ``DataSplitter`` holdout of 10%, by RMSE (smaller is better)."""

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
        ev = validation_metric or OpRegressionEvaluator()
        return ModelSelector(
            validator=OpCrossValidation(num_folds=num_folds, evaluator=ev,
                                        seed=seed, autotune=autotune,
                                        device=device),
            models=models_and_parameters
            or _regression_models(model_types_to_use, device),
            splitter=splitter
            if splitter is not None
            else DataSplitter(reserve_test_fraction=0.1, seed=seed),
            evaluators=[OpRegressionEvaluator()],
            device=device,
        )

    def __new__(cls, *args, **kw) -> ModelSelector:  # type: ignore[misc]
        return cls.with_cross_validation(*args, **kw)
