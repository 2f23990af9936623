"""linear_fits_ms: the linear models' fits per train (``models/
logistic_regression.py``, ``models/linear_svc.py``, ``models/
packed_newton.py``, ``local/fused_train.py`` ``run_linear``): benchmark
spans around the fold x grid fit entries and the winner's refit, the card
synchronised at both ends; a fit inside another counts once."""

_LR = "transmogrifai_tpu_torch.models.logistic_regression"
_SVC = "transmogrifai_tpu_torch.models.linear_svc"
SHIMS = [
    ("transmogrifai_tpu_torch.local.fused_train", None, "run_linear",
     "fit.linear"),
    (_LR, "OpLogisticRegression", "fit_arrays_batched", "fit.linear"),
    (_LR, "OpLogisticRegression", "fit_arrays_folds", "fit.linear"),
    (_LR, "OpLogisticRegression", "fit_arrays", "fit.linear"),
    (_SVC, "OpLinearSVC", "fit_arrays_batched", "fit.linear"),
    (_SVC, "OpLinearSVC", "fit_arrays", "fit.linear"),
]
KERNELS = {}


def read(rec):
    if not any(s.group == "fit.linear" for s in rec.spans):
        return None
    return rec.per_train_ms(rec.span_seconds("fit.linear"))
