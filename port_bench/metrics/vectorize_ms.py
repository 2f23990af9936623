"""vectorize_ms: the vectorizers' (``ops/``, via ``ops/transmogrifier.py``)
fit and transform walls per train, from the program's own ``stage.fit``
and ``stage.transform`` spans (``utils/tracing.py``, through
``obs/trace.py``), summed over every stage whose class lives in ``ops/``."""

SHIMS = []
KERNELS = {}


def read(rec):
    if not rec.stage_spans:
        return None
    return rec.per_train_ms(rec.stage_seconds("transmogrifai_tpu_torch.ops."))
