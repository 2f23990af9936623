"""transmogrifai_tpu_torch: the AutoML workflow on PyTorch and CUDA.

The PyTorch/CUDA counterpart of ``transmogrifai_tpu``, module for module
(``transmogrifai_tpu/X/y.py`` -> ``transmogrifai_tpu_torch/X/y.py``).  It
imports torch and numpy, never jax and never the JAX package.  Device work
runs on the ``device`` a workflow or stage is given, ``"cuda"`` by default;
the CPU is used only when asked for.

What is ported so far is the main path: typed raw features ->
``transmogrify`` (with ``label=``, one decision-tree bucketizer per numeric
column) -> ``SanityChecker`` (on the hand-written CUDA kernel
``fused_moments``) -> ``OpLogisticRegression`` or the histogram tree
learner (``models/trees.py``: GBT, XGBoost-style GBT, decision trees and
forests without per-node feature subsets, binning on the hand-written CUDA
kernel ``bin_matrix``) -> ``OpWorkflow.train()`` /
``OpWorkflowModel.score()`` -> ``OpBinaryClassificationEvaluator``, and
README.md's example: ``CSVReader`` (the C++ CSV scanner, built by
``utils/native.py`` into ``_build/``) -> the ``dsl`` feature math and
scalers -> the model selectors -> ``summary_pretty()``; and serving:
``model.save()``, ``OpWorkflowModel.load()`` and ``score_function()``, whose
local scorer runs one torch program on the card per batch
(``local/fused_torch.py``), behind the bucketed serving endpoint and
micro-batching scheduler (``serving/``), the versioned model registry
with hot swap, canary and rollback (``registry/``) and the runner's
``serve`` and ``deploy`` run types (``workflow/runner.py``).  ROADMAP.md
lists what is still to come.
"""
from .features.feature import Feature
from .features.feature_builder import FeatureBuilder, from_dataframe, from_schema
from .stages.base import Estimator, LambdaTransformer, PipelineStage, Transformer
from .types import feature_types as types
from .types.dataset import Dataset
from .workflow.workflow import OpWorkflow, OpWorkflowModel

__version__ = "0.1.0"

__all__ = [
    "Feature",
    "FeatureBuilder",
    "from_dataframe",
    "from_schema",
    "PipelineStage",
    "Transformer",
    "Estimator",
    "LambdaTransformer",
    "Dataset",
    "OpWorkflow",
    "OpWorkflowModel",
    "types",
    "__version__",
]
