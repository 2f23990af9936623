"""Engine-free local scoring (the reference's ``local`` module analog).

Counterpart of ``transmogrifai_tpu/local/``: the numpy-fused program
(``fused``), the torch device program (``fused_torch``, the JAX package's
``fused_xla``) and the :class:`LocalScorer` that picks between them."""
from .fused import (
    FusedPipeline,
    FusionError,
    PipelineCompiler,
    RecordDecoder,
    compile_pipeline,
)
from .fused_torch import TorchFusedPipeline, compile_torch_pipeline
from .scorer import FUSED_BACKENDS, LocalScorer, score_function

__all__ = [
    "FUSED_BACKENDS",
    "FusedPipeline",
    "FusionError",
    "LocalScorer",
    "PipelineCompiler",
    "RecordDecoder",
    "TorchFusedPipeline",
    "compile_pipeline",
    "compile_torch_pipeline",
    "score_function",
]
