"""Helpers shared by the tests/test_torch_*.py parity tests.

The torch package mirrors the JAX package's module paths, so one builder
drives either package by name: ``pkg`` is ``"transmogrifai_tpu"`` or
``"transmogrifai_tpu_torch"``.
"""
import importlib

import numpy as np
import torch

REF, PORT = "transmogrifai_tpu", "transmogrifai_tpu_torch"

# parity tests compare float32 arithmetic: no TF32 anywhere
torch.set_float32_matmul_precision("highest")


def mod(pkg: str, path: str):
    return importlib.import_module(f"{pkg}.{path}")


def reset_uids(pkg: str) -> None:
    mod(pkg, "utils.uid").reset_uids()


def workflow(pkg: str, result, data, **params):
    """OpWorkflow of ``pkg`` over ``data``; the torch package's runs on
    the CPU."""
    kw = {"device": "cpu"} if pkg == PORT else {}
    wf = mod(pkg, "workflow.workflow").OpWorkflow(**kw)
    wf = wf.set_result_features(result).set_input_dataset(data)
    if params:
        wf.set_parameters(**params)
    return wf


def passenger_features(pkg: str):
    """(label, predictors) of the passenger slice: age, height, weight
    (Real) and gender (PickList) against survived (RealNN)."""
    fb = mod(pkg, "features.feature_builder").FeatureBuilder
    survived = fb.RealNN("survived").as_response()
    preds = [fb.Real(c).as_predictor() for c in ("age", "height", "weight")]
    preds.append(fb.PickList("gender").as_predictor())
    return survived, preds


def passenger_slice(pkg: str, sanity_kw=None, lr_kw=None):
    """transmogrify -> SanityChecker -> OpLogisticRegression of ``pkg``;
    returns (label, checked vector, prediction) features."""
    survived, preds = passenger_features(pkg)
    vec = mod(pkg, "ops.transmogrifier").transmogrify(preds)
    kw = {"device": "cpu"} if pkg == PORT else {}
    checker = mod(pkg, "preparators.sanity_checker").SanityChecker(
        **(sanity_kw or {}), **kw
    )
    checked = checker.set_input(survived, vec).get_output()
    lr = mod(pkg, "models.logistic_regression").OpLogisticRegression(
        **(lr_kw or {}), **kw
    )
    pred = lr.set_input(survived, checked).get_output()
    return survived, checked, pred


def passenger_tree_slice(pkg: str, gbt_kw=None):
    """transmogrify(label=survived) -> SanityChecker -> OpGBTClassifier of
    ``pkg`` (the reference's tree learner on its JAX backend); returns
    (label, vector, checked vector, prediction) features."""
    survived, preds = passenger_features(pkg)
    vec = mod(pkg, "ops.transmogrifier").transmogrify(preds, label=survived)
    kw = {"device": "cpu"} if pkg == PORT else {}
    checked = mod(pkg, "preparators.sanity_checker").SanityChecker(
        **kw).set_input(survived, vec).get_output()
    gbt_kw = dict(gbt_kw or {}, **(kw or {"backend": "jax"}))
    gbt = mod(pkg, "models.trees").OpGBTClassifier(**gbt_kw)
    pred = gbt.set_input(survived, checked).get_output()
    return survived, vec, checked, pred


def passengers(pkg: str, n: int, seed: int = 42):
    return mod(pkg, "examples.synthetic").synthetic_passengers(
        n, seed=seed, with_text=False
    )


def stage_of(model, cls_name: str):
    (st,) = [s for s in model.stages if type(s).__name__ == cls_name]
    return st


def probabilities(scored, pred_name: str) -> np.ndarray:
    return np.asarray(scored[pred_name].probability, dtype=np.float64)


def identified(model, scored, checked_name: str):
    """The fitted LR's (beta, intercept) with each one-hot group whose kept
    columns sum to 1 on every row centred to mean 0 (the shift moves into
    the intercept).  Such a group is collinear with the intercept, so an
    unregularized fit pins its common level only by float32 rounding."""
    params = model.stages[-1].model_params
    beta = np.asarray(params["beta"], np.float64).copy()
    b0 = float(params["intercept"])
    col = scored[checked_name]
    x = np.asarray(col.values)
    for idx in col.metadata.grouping_indices().values():
        idx = list(idx)
        if len(idx) > 1 and np.all(x[:, idx].sum(axis=1) == 1.0):
            shift = beta[idx].mean()
            beta[idx] -= shift
            b0 += shift
    return beta, b0



def leaf_index(bins: np.ndarray, heap, depth: int, stop=()) -> np.ndarray:
    """Heap slot each row of ``bins`` lands in (the flat-heap walk); a row
    stops early at a slot in ``stop``."""
    hf, ht, hl = (np.asarray(h) for h in heap[:3])
    idx = np.zeros(bins.shape[0], dtype=np.int64)
    rows = np.arange(bins.shape[0])
    halt = np.zeros(len(hf), bool)
    halt[list(stop)] = True
    for _ in range(depth):
        nxt = idx * 2 + 1 + (bins[rows, hf[idx]] > ht[idx])
        idx = np.where(hl[idx] | halt[idx], idx, nxt)
    return idx


def compare_trees(got, want, bins, depth, rtol=0.0, atol=0.0):
    """One tree grown by each package on the same bins.  Walking down from
    the root, every node reached must have the same leaf flag, split and
    stats (within rtol, atol) - except at an exact tie: both packages
    split the node, on different (feature, bin) pairs whose two children
    hold the same stats (as a pair, in either order), so the gains are
    equal and float32 rounding picked the winner.  Below a tie the
    subtrees grow on different rows and are not compared.  Heaps that
    differ only by ties between splits that route every row alike (two
    complementary one-hot columns) put the rows into the same leaves:
    then the leaves' stats are compared row by row instead.

    Returns (tie nodes, mask of the rows whose path in either tree passes
    a tie node); ties are logged in ROADMAP.md queue 3."""
    got = [np.asarray(h) for h in got]
    want = [np.asarray(h) for h in want]
    if not all(np.array_equal(g, v) for g, v in zip(got[:3], want[:3])):
        # a tie between splits that send every row the same way (e.g. two
        # complementary one-hot columns) leaves the same leaves
        lg, lw = leaf_index(bins, got, depth), leaf_index(bins, want, depth)
        pairs = set(zip(lw.tolist(), lg.tolist()))
        if len(pairs) == len(set(lw.tolist())) == len(set(lg.tolist())):
            np.testing.assert_allclose(got[3][lg], want[3][lw],
                                       rtol=rtol, atol=atol)
            return [], np.zeros(bins.shape[0], bool)
    ties, todo = [], [0]
    while todo:
        i = todo.pop()
        np.testing.assert_allclose(got[3][i], want[3][i], rtol=rtol, atol=atol)
        assert got[2][i] == want[2][i], f"node {i}: leaf flags differ"
        if want[2][i] or 2 * i + 2 >= len(want[0]):
            continue
        kids = [2 * i + 1, 2 * i + 2]
        if (got[0][i], got[1][i]) == (want[0][i], want[1][i]):
            todo.extend(kids)
            continue
        g, w = got[3][kids], want[3][kids]
        same = np.allclose(g, w, rtol=rtol, atol=atol)
        mirrored = np.allclose(g, w[::-1], rtol=rtol, atol=atol)
        assert same or mirrored, f"node {i}: different splits, not a tie"
        ties.append(i)
    lg = leaf_index(bins, got, depth, stop=ties)
    lw = leaf_index(bins, want, depth, stop=ties)
    return ties, np.isin(lg, ties) | np.isin(lw, ties)
