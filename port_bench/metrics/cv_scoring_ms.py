"""cv_scoring_ms: the validator and evaluators (``selector/validator.py``,
``evaluators/binary.py``) per train: a benchmark span around
``OpValidator.validate`` less the fits inside it (the fit spans of
``linear_fits_ms`` and ``tree_fits_ms``), the card synchronised at the
ends of each."""

import importlib.util
from pathlib import Path


def _shims(name):
    path = Path(__file__).with_name(name)
    spec = importlib.util.spec_from_file_location(f"_pb_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.SHIMS


SHIMS = [("transmogrifai_tpu_torch.selector.validator", "OpValidator",
          "validate", "validate")] + _shims("linear_fits_ms.py") \
    + _shims("tree_fits_ms.py")
KERNELS = {}


def read(rec):
    total = rec.span_seconds("validate")
    if total <= 0:
        return None
    return rec.per_train_ms(total - rec.span_seconds("fit.", within="validate"))
