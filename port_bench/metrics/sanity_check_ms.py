"""sanity_check_ms: the SanityChecker's (``preparators/sanity_checker.py``)
fit and transform walls per train, from the program's own ``stage.fit``
and ``stage.transform`` spans."""

SHIMS = []
KERNELS = {}


def read(rec):
    s = rec.stage_seconds("transmogrifai_tpu_torch.preparators.sanity_checker")
    return rec.per_train_ms(s) if s > 0 else None
