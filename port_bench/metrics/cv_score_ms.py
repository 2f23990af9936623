"""cv_score_ms: the validator's scoring per train (``selector/
validator.py``, ``evaluators/binary.py``): the program's own ``cv.score``
spans, each around one candidate-fold's validation predictions and metric
(or the device rank-metric block), summed.  The inside twin of
``cv_scoring_ms``, with no synchronising shim around it."""

from port_bench.harness import attribution

SHIMS = []
KERNELS = {}


def read(rec):
    spans = attribution.program_spans(rec) or []
    walls = [s.t1 - s.t0 for s in spans if s.name == "cv.score"]
    if not walls:
        return None
    return rec.per_train_ms(sum(walls))
