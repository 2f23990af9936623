"""tree_fits_ms: the tree learner's fits per train (``models/
tree_kernel.py``, ``models/trees.py``, ``local/fused_train.py``
``run_tree``): benchmark spans around the GBT's grid x fold fit (which the
winner's refit also takes) and the fused tree dispatch, the card
synchronised at both ends; a fit inside another counts once."""

SHIMS = [
    ("transmogrifai_tpu_torch.local.fused_train", None, "run_tree",
     "fit.tree"),
    ("transmogrifai_tpu_torch.models.trees", "_GBT", "fit_arrays_folds_grid",
     "fit.tree"),
]
KERNELS = {}


def read(rec):
    if not any(s.group == "fit.tree" for s in rec.spans):
        return None
    return rec.per_train_ms(rec.span_seconds("fit.tree"))
