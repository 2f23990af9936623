"""The faults a cell can have, planted in the program underneath the timed
path, for the CPU test and for readings on the card at a cell's own size.

* ``newton_state_unchanged``: the Newton fit returns its state unchanged.
* ``boosting_state_unchanged``: boosting's trees add nothing.
* ``sanity_half_the_rows``: the SanityChecker's moments over half the
  rows, the mean taken over the rest.
* ``fits_half_the_rows``: every linear and tree fit, the CV's and the
  winner's refit, leaves out half of its rows (their weights zero), the
  mean taken over the rest.
* ``answers_altered``: the winner's holdout answers altered where they
  are produced.

The cells run on one chip, so no exchange between chips can be left out.

On the card, the check's numbers of the program with one fault planted,
one line a seed, as ``--readings`` prints them::

    python3 port_bench/tests/pb_faults.py <fault> --workload <cell> \\
        --seed <n> --readings <seeds>
"""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

FAULTS = ("newton_state_unchanged", "boosting_state_unchanged",
          "sanity_half_the_rows", "fits_half_the_rows", "answers_altered")


def _broken_newton(step, init, length, fixed_point=False, rows=None):
    return init


def _flat_tree(bins, stats_row, w_row, feat_mask, max_depth, max_bins,
               impurity_kind, n_stats, *a, **kw):
    import torch

    M = 2 ** (max_depth + 1) - 1
    dev = bins.device
    return (torch.zeros(M, dtype=torch.int32, device=dev),
            torch.full((M,), max_bins, dtype=torch.int32, device=dev),
            torch.ones(M, dtype=torch.bool, device=dev),
            torch.zeros((M, n_stats), dtype=stats_row.dtype, device=dev))


def _half_moments(real):
    def moments(x, y):
        h = x.shape[0] // 2
        out = real(x[:h], y[:h])
        return tuple(v * 2 if i < 5 else v for i, v in enumerate(out))
    return moments


def _half_weights(w, n: int):
    """A copy of the weights (a row [n] or rows [k, n]; none: all ones)
    with the second half of the rows at zero."""
    import torch

    if w is None:
        w = np.ones(n, np.float32)
    elif torch.is_tensor(w):
        w = w.clone()
    else:
        w = np.array(w, copy=True)
    w[..., n // 2:] = 0
    return w


def _fit_on_half(real):
    def fit(self, X, y, W=None, *a, **kw):
        return real(self, X, y, _half_weights(W, len(y)), *a, **kw)
    return fit


def _altered_answers(real):
    def transform_columns(self, cols, ds):
        out = real(self, cols, ds)
        if out.probability is not None:
            p = np.clip(out.probability[:, 1] + 0.05, 0.0, 1.0)
            out.probability[:, 1] = p
            out.probability[:, 0] = 1.0 - p
        return out
    return transform_columns


def plant(fault: str, setattr_) -> None:
    """Plant ``fault`` with ``setattr_(owner, name, value)`` (pytest's
    ``monkeypatch.setattr``, or ``setattr`` in a process of its own)."""
    from transmogrifai_tpu_torch.models import base, logistic_regression
    from transmogrifai_tpu_torch.models import tree_kernel, trees
    from transmogrifai_tpu_torch.preparators import sanity_checker

    if fault == "newton_state_unchanged":
        setattr_(logistic_regression, "run_newton", _broken_newton)
    elif fault == "boosting_state_unchanged":
        setattr_(tree_kernel, "fit_tree", _flat_tree)
    elif fault == "sanity_half_the_rows":
        setattr_(sanity_checker, "fused_moments",
                 _half_moments(sanity_checker.fused_moments))
    elif fault == "fits_half_the_rows":
        lr = logistic_regression.OpLogisticRegression
        for owner, name in ((lr, "fit_arrays"), (lr, "fit_arrays_batched"),
                            (trees._GBT, "fit_arrays_folds_grid")):
            setattr_(owner, name, _fit_on_half(getattr(owner, name)))
    elif fault == "answers_altered":
        setattr_(base.PredictorModel, "transform_columns",
                 _altered_answers(base.PredictorModel.transform_columns))
    else:
        raise ValueError(f"unknown fault {fault!r} (one of {FAULTS})")


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    fault, rest = argv[0], argv[1:]
    root = Path(__file__).resolve().parents[2]
    sys.path.insert(0, str(root))
    from port_bench import run as entry   # the entry's caches and environment
    from port_bench.harness import cell

    plant(fault, setattr)
    print(f"[fault] {fault} planted", file=sys.stderr, flush=True)
    return cell.main(rest, t_start=entry.T_START)


if __name__ == "__main__":
    sys.exit(main())
