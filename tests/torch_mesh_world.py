"""Spawned gloo worlds for the torch package's multi-process tests.

``run_world(suite, world, tmp_path)`` starts ``world`` processes of this
file, one per rank (``python tests/torch_mesh_world.py <suite> <rank>
<world> <init url> <out dir>``).  Each rank imports the torch package with
jax blocked, caps torch at one thread, joins a gloo group over a
``FileStore`` under ``tmp_path`` (so two xdist workers never share a
rendezvous), runs every check of the suite, and pickles
``{check name: result or the traceback}`` to ``<out dir>/rank<r>.pkl``.
The parent waits with a timeout - the hang detector of a world whose
ranks disagreed - kills what is left, and returns the ranks' dicts.

A check is a function of no arguments that returns numpy results; the
tests compare them across ranks, against the port's world-1 answer
(``single_process()``: ``TX_PRODUCT_MESH=0`` in the rank) and against the
JAX package, which the parent runs.  Only the parent imports the JAX
package.
"""
import os
import pickle
import subprocess
import sys
import time
import traceback

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# -- the data every rank and the parent build alike ---------------------------

def cv_data(n: int = 1999, d: int = 12, seed: int = 42):
    """The reference mesh tests' LR data (``n % world != 0``)."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    beta = rng.randn(d)
    y = (rng.rand(n) < 1 / (1 + np.exp(-(X @ beta)))).astype(np.float64)
    return X, y


def sanity_data(n: int = 999, d: int = 7, seed: int = 42):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d)
    y = (X[:, 0] > 0).astype(np.float64)
    return X, y


def tree_data(n: int = 403, d: int = 6, seed: int = 42):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d)
    y = (X @ np.linspace(1, -1, d) + 0.4 * rng.randn(n) > 0).astype(float)
    return X, y


class single_process:
    """Within a rank: the port's world-1 route (``TX_PRODUCT_MESH=0``)."""

    def __enter__(self):
        self._old = os.environ.get("TX_PRODUCT_MESH")
        os.environ["TX_PRODUCT_MESH"] = "0"

    def __exit__(self, *exc):
        if self._old is None:
            os.environ.pop("TX_PRODUCT_MESH", None)
        else:
            os.environ["TX_PRODUCT_MESH"] = self._old


# -- the port's runs, shared by the rank checks ----------------------------------

def port_cv(X, y):
    from transmogrifai_tpu_torch.evaluators.binary import (
        OpBinaryClassificationEvaluator)
    from transmogrifai_tpu_torch.models.logistic_regression import (
        OpLogisticRegression)
    from transmogrifai_tpu_torch.selector.factories import lr_grid
    from transmogrifai_tpu_torch.selector.validator import OpCrossValidation

    cv = OpCrossValidation(num_folds=3,
                           evaluator=OpBinaryClassificationEvaluator(),
                           stratify=True, device="cpu")
    res = cv.validate([(OpLogisticRegression(device="cpu"), lr_grid())], X, y)
    return {
        "best_params": res.best_params,
        "best_metric": float(res.best_metric),
        "fold_metrics": np.array([r["fold_metrics"] for r in res.all_results]),
        "train_fused": cv.last_train_fused,
    }


def port_sanity(X, y):
    from transmogrifai_tpu_torch.preparators.sanity_checker import SanityChecker
    from transmogrifai_tpu_torch.types.columns import NumericColumn, VectorColumn
    from transmogrifai_tpu_torch.types.dataset import Dataset
    from transmogrifai_tpu_torch.types.feature_types import RealNN
    from transmogrifai_tpu_torch.types.vector_metadata import (
        VectorColumnMeta, VectorMetadata)

    n, d = X.shape
    meta = VectorMetadata(
        "features", tuple(VectorColumnMeta(f"f{j}", "Real") for j in range(d))
    ).reindexed()
    label = NumericColumn(y, np.ones(n, bool), RealNN)
    vec = VectorColumn(X, meta)
    ds = Dataset({"label": label, "features": vec})
    sc = SanityChecker(remove_bad_features=False, device="cpu")
    sc.fit_model([label, vec], ds)
    stats = sc.metadata["sanity_checker_summary"]["column_stats"]
    return {k: np.array([c[k] for c in stats], dtype=np.float64)
            for k in ("mean", "variance", "corr_label")}


def heaps_equal(a, b) -> bool:
    """Two fold params' heaps (and a GBT's f0) equal bit for bit."""
    return (all(np.array_equal(x, y) for x, y in zip(a["heaps"], b["heaps"]))
            and a.get("f0") == b.get("f0"))


def port_tree_fits(X, y):
    from transmogrifai_tpu_torch.models.trees import (
        OpGBTClassifier, OpRandomForestClassifier)
    from transmogrifai_tpu_torch.selector.validator import stratified_kfold_masks

    W = stratified_kfold_masks(y, 3, seed=0, stratify=True).astype(float)
    out = {}
    for name, est in (
        ("rf", OpRandomForestClassifier(num_trees=5, max_depth=3,
                                        device="cpu")),
        ("gbt", OpGBTClassifier(num_trees=4, max_depth=3, device="cpu")),
    ):
        fits = est.fit_arrays_folds(X, y, W)
        out[name] = {
            "params": [fits],
            "prob": [[est.predict_arrays(p, X)[2] for p in fits]],
        }
    est = OpRandomForestClassifier(num_trees=4, max_depth=3, device="cpu")
    grid = [{"min_info_gain": 0.0}, {"min_info_gain": 0.1}]
    g = est.fit_arrays_folds_grid(X, y, W, grid)
    out["rf_grid"] = {
        "params": g,
        "prob": [[est.with_params(**grid[j]).predict_arrays(p, X)[2]
                  for p in g[j]] for j in range(len(grid))],
    }
    est = OpGBTClassifier(num_trees=3, max_depth=2, device="cpu")
    grid = [{"step_size": 0.1}, {"step_size": 0.3}]
    g = est.fit_arrays_folds_grid(X, y, W, grid)
    out["gbt_grid"] = {
        "params": g,
        "prob": [[est.with_params(**grid[j]).predict_arrays(p, X)[2]
                  for p in g[j]] for j in range(len(grid))],
    }
    return out


def sharded_and_single(fn, *args):
    """``fn`` on the mesh, then on this rank alone (world 1)."""
    sharded = fn(*args)
    with single_process():
        single = fn(*args)
    return {"sharded": sharded, "single": single}


# -- suites ----------------------------------------------------------------------

def _suite_distributed():
    import torch

    from transmogrifai_tpu_torch.parallel import distributed as dist
    from transmogrifai_tpu_torch.parallel.mesh import LocalMesh

    def global_mesh_and_all_reduce():
        mesh = dist.global_mesh(("data",))
        X = np.arange(64, dtype=np.float32).reshape(16, 4)
        s, ss = dist.all_reduce_stats(
            lambda x: (x.sum(axis=0), (x * x).sum(axis=0)), mesh, X)
        return {"size": mesh.size(), "s": s.numpy(), "ss": ss.numpy(),
                "want_s": X.sum(0), "want_ss": (X * X).sum(0)}

    def host_local_to_global():
        mesh = dist.global_mesh(("data",))
        rank, world = torch.distributed.get_rank(), mesh.size()
        n = world * 3 + 1  # unequal blocks
        X = np.random.RandomState(0).randn(n, 5).astype(np.float32)
        from transmogrifai_tpu_torch.parallel.mesh import block_bounds

        lo, hi = block_bounds(n, world, rank)
        g = dist.host_local_to_global(X[lo:hi], mesh)
        return {"shape": g.shape, "offset": g.offset, "lo": lo,
                "rows_equal": bool(np.array_equal(g.local, X[lo:hi]))}

    def rejects_mismatched_leading_axes():
        mesh = dist.global_mesh(("data",))
        n = mesh.size() * 2
        try:
            dist.all_reduce_stats(lambda a, b: (a.sum(), b.sum()), mesh,
                                  np.zeros((n, 3), np.float32),
                                  np.zeros((n + 1,), np.float32))
        except dist.MeshShapeError as e:
            return {"raised": str(e)}
        return {"raised": None}

    def unequal_blocks_reduce_exactly():
        # the reference's "indivisible rows" raise is gone: blocks may be
        # unequal, so rows not divisible by the mesh reduce exactly
        mesh = dist.global_mesh(("data",))
        X = np.arange((mesh.size() * 2 + 1) * 3,
                      dtype=np.float32).reshape(-1, 3)
        s = dist.all_reduce_stats(lambda a: a.sum(axis=0), mesh, X)
        return {"s": s.numpy(), "want": X.sum(0)}

    def rejects_scalar_and_bad_axis():
        mesh = dist.global_mesh(("data",))
        out = {}
        try:
            dist.all_reduce_stats(lambda a: a, mesh, np.float32(3.0))
        except dist.MeshShapeError as e:
            out["scalar"] = str(e)
        try:
            dist.all_reduce_stats(lambda a: a.sum(), mesh,
                                  np.zeros((mesh.size(), 2), np.float32),
                                  axis="rows")
        except dist.MeshShapeError as e:
            out["axis"] = str(e)
        return out

    def host_local_to_global_rejects():
        mesh = dist.global_mesh(("data",))
        out = {}
        try:
            dist.host_local_to_global(np.float32(1.0), mesh)
        except dist.MeshShapeError as e:
            out["scalar"] = str(e)
        try:
            dist.host_local_to_global(np.zeros((3, 4), np.float32), mesh,
                                      axis="rows")
        except dist.MeshShapeError as e:
            out["axis"] = str(e)
        return out

    def local_mesh_reduces_locally():
        X = np.arange(12, dtype=np.float32).reshape(4, 3)
        s = dist.all_reduce_stats(lambda a: a.sum(axis=0), LocalMesh(), X)
        return {"s": s.numpy(), "want": X.sum(0)}

    return [global_mesh_and_all_reduce, host_local_to_global,
            rejects_mismatched_leading_axes, unequal_blocks_reduce_exactly,
            rejects_scalar_and_bad_axis, host_local_to_global_rejects,
            local_mesh_reduces_locally]


def _suite_integration():
    from transmogrifai_tpu_torch.parallel.mesh import (
        cv_mesh_or_none, data_mesh_or_none)

    def mesh_helpers_shape():
        m = data_mesh_or_none()
        m2 = cv_mesh_or_none(24)
        m3 = cv_mesh_or_none(3)
        with single_process():
            off = data_mesh_or_none(), cv_mesh_or_none(24)
        return {
            "data": dict(zip(m.mesh_dim_names, m.shape)),
            "cv24": dict(zip(m2.mesh_dim_names, m2.shape)),
            "cv3": dict(zip(m3.mesh_dim_names, m3.shape)),
            "disabled": [o is None for o in off],
        }

    def cv_sharded():
        return sharded_and_single(port_cv, *cv_data())

    def sanity_checker_sharded():
        return sharded_and_single(port_sanity, *sanity_data())

    def tree_fold_fits_sharded():
        return sharded_and_single(port_tree_fits, *tree_data())

    def tree_fits_on_an_empty_block():
        # fewer rows than ranks: a rank with no rows still joins every
        # level's histogram
        X, y = tree_data(n=3)
        return sharded_and_single(port_tree_fits_small, X, y)

    def workflow_sharded():
        return sharded_and_single(port_workflow)

    return [mesh_helpers_shape, cv_sharded, sanity_checker_sharded,
            tree_fold_fits_sharded, tree_fits_on_an_empty_block,
            workflow_sharded]


def port_tree_fits_small(X, y):
    from transmogrifai_tpu_torch.models.trees import OpGBTClassifier

    W = np.ones((1, len(y)))
    est = OpGBTClassifier(num_trees=2, max_depth=1, device="cpu")
    return est.fit_arrays_folds(X, y, W)


def port_workflow(n: int = 1200):
    """The passenger selector workflow (SanityChecker, LR grid and a
    small GBT grid under CV) through ``OpWorkflow.train()``: the winner,
    the SanityChecker's drops and the scored probabilities."""
    from torch_parity import (
        PORT, passenger_selector_slice, passengers, probabilities, reset_uids,
        small_gbt_grid, workflow)

    reset_uids(PORT)
    _, checked, pred = passenger_selector_slice(
        PORT, gbt_grid=small_gbt_grid(num_trees=3, depths=(2,)))
    data = passengers(PORT, n)
    model = workflow(PORT, pred, data).train()
    summary = model.summary_json()
    sel = [s for s in summary["stages"]
           if "best_model" in str(s["metadata"])][0]["metadata"]
    dropped = [s for s in summary["stages"]
               if "sanity_checker_summary" in s["metadata"]][0]["metadata"][
                   "sanity_checker_summary"]["dropped"]
    sel = sel.get("model_selector_summary", sel)
    return {"prob": probabilities(model.score(data), pred.name),
            "selected": (sel["best_model_type"], sel["best_params"]),
            "metric": float(sel["validation_metric"]["value"]),
            "dropped": list(dropped),
            "mesh_resilience": "meshResilience" in summary}


def _suite_multiprocess2():
    import torch

    from transmogrifai_tpu_torch.models.logistic_regression import (
        lr_fit_batched_core)
    from transmogrifai_tpu_torch.models.tree_kernel import (
        bin_data, fit_forest_folds, quantile_bin_edges)
    from transmogrifai_tpu_torch.parallel import distributed as dist
    from transmogrifai_tpu_torch.parallel.kernels import (
        fused_moments, fused_moments_sharded)

    rank = torch.distributed.get_rank()
    rng = np.random.RandomState(0)
    X_full = rng.randn(40, 5).astype(np.float32)
    y_full = (rng.rand(40) > 0.5).astype(np.float32)
    lo, hi = (0, 20) if rank == 0 else (20, 40)

    def mesh_and_row_hand_off():
        mesh = dist.global_mesh(("data",))
        Xg = dist.host_local_to_global(X_full[lo:hi], mesh)
        col_sums = dist.all_reduce_stats(lambda a: a.sum(axis=0), mesh, Xg)
        return {"shape": Xg.shape, "offset": Xg.offset,
                "col_sums": col_sums.numpy(), "want": X_full.sum(axis=0)}

    def fused_moments_on_rank_blocks():
        mesh = dist.global_mesh(("data",))
        Xg = dist.host_local_to_global(torch.from_numpy(X_full[lo:hi]), mesh)
        yg = dist.host_local_to_global(torch.from_numpy(y_full[lo:hi]), mesh)
        got = fused_moments_sharded(Xg, yg, mesh)
        want = fused_moments(torch.from_numpy(X_full), torch.from_numpy(y_full))
        return {"got": [g.numpy() for g in got],
                "want": [w.numpy() for w in want]}

    def host_input_guard():
        mesh = dist.global_mesh(("data",))
        try:
            fused_moments_sharded(X_full[lo:hi], y_full[lo:hi], mesh,
                                  device="cpu")
        except ValueError as e:
            return {"raised": str(e)}
        return {"raised": None}

    def replicated_host_input():
        mesh = dist.global_mesh(("data",))
        got = fused_moments_sharded(X_full, y_full, mesh, device="cpu")
        want = fused_moments(torch.from_numpy(X_full), torch.from_numpy(y_full))
        return {"got": [g.numpy() for g in got],
                "want": [w.numpy() for w in want]}

    def forest_fold_fits_across_ranks():
        mesh = dist.global_mesh(("data",))
        edges = quantile_bin_edges(X_full, 8)
        bins_full = torch.from_numpy(bin_data(X_full, edges).astype(np.int8))
        onehot = (y_full[:, None] == np.array([0.0, 1.0])[None, :])
        stats = torch.from_numpy(np.concatenate(
            [np.ones((40, 1)), onehot], axis=1).astype(np.float32))
        W = torch.from_numpy(np.stack([
            np.r_[np.ones(30), np.zeros(10)],
            np.r_[np.zeros(10), np.ones(30)]]).astype(np.float32))
        boot = torch.ones((3, 40))
        feat = torch.ones((3, 5), dtype=torch.bool)
        kw = dict(max_depth=3, max_bins=8, impurity_kind="gini", n_stats=3,
                  min_instances_per_node=1.0, min_info_gain=0.0)
        sharded = fit_forest_folds(
            bins_full[lo:hi], stats[lo:hi], W[:, lo:hi], boot[:, lo:hi], feat,
            rows=dist.RowReducer(mesh, n_rows=40), **kw)
        single = fit_forest_folds(bins_full, stats, W, boot, feat, **kw)
        return {"sharded": [h.numpy() for h in sharded],
                "single": [h.numpy() for h in single]}

    def lr_core_across_ranks():
        mesh = dist.global_mesh(("data",))
        X, y = torch.from_numpy(X_full), torch.from_numpy(y_full)
        W = torch.from_numpy(np.stack([
            np.r_[np.ones(30), np.zeros(10)],
            np.r_[np.zeros(10), np.ones(30)]]).astype(np.float32))
        regs = torch.tensor([0.01, 0.1])
        ens = torch.tensor([0.0, 0.5])
        out = {}
        for fp in (False, True):
            red = dist.RowReducer(mesh, n_rows=40)
            b, b0 = lr_fit_batched_core(X[lo:hi], y[lo:hi], W[:, lo:hi],
                                        regs, ens, iters=6, fixed_point=fp,
                                        rows=red)
            sb, sb0 = lr_fit_batched_core(X, y, W, regs, ens, iters=6,
                                          fixed_point=fp)
            out[fp] = {"sharded": (b.numpy(), b0.numpy()),
                       "single": (sb.numpy(), sb0.numpy()),
                       "collectives": red.collectives}
        return out

    return [mesh_and_row_hand_off, fused_moments_on_rank_blocks,
            host_input_guard, replicated_host_input,
            forest_fold_fits_across_ranks, lr_core_across_ranks]


def _suite_multiprocess4():
    import torch

    from transmogrifai_tpu_torch.models.linear_regression import (
        linreg_fit_batched_core)
    from transmogrifai_tpu_torch.models.linear_svc import _svc_batched_core
    from transmogrifai_tpu_torch.models.logistic_regression import (
        lr_fit_batched_core)
    from transmogrifai_tpu_torch.models.packed_newton import (
        fit_batched_sharded)
    from transmogrifai_tpu_torch.models.tree_kernel import (
        bin_data, fit_gbt_folds, quantile_bin_edges)
    from transmogrifai_tpu_torch.parallel import distributed as dist

    rank = torch.distributed.get_rank()
    rng = np.random.RandomState(0)
    X_full = rng.randn(40, 6).astype(np.float32)
    y_full = (rng.rand(40) > 0.5).astype(np.float32)
    W_lr = torch.from_numpy(np.stack([
        np.r_[np.ones(30), np.zeros(10)], np.r_[np.zeros(10), np.ones(30)],
        np.r_[np.ones(20), np.zeros(20)], np.ones(40)]).astype(np.float32))
    regs = torch.tensor([0.003, 0.01, 0.03, 0.1])
    ens = torch.tensor([0.0, 0.2, 0.0, 0.5])

    def mesh_2x2_from_env():
        mesh = dist.global_mesh(("replica", "data"), shape=(2, 2))
        return {"shape": tuple(mesh.shape), "rank": rank,
                "coords": (mesh.get_local_rank("replica"),
                           mesh.get_local_rank("data"))}

    def linear_cores_on_the_2x2_mesh():
        mesh = dist.global_mesh(("replica", "data"), shape=(2, 2))
        X, y = torch.from_numpy(X_full), torch.from_numpy(y_full)
        out = {}
        for name, core, kw in (
                ("lr", lr_fit_batched_core, {"iters": 6}),
                ("svc", _svc_batched_core, {"iters": 6}),
                ("linreg", linreg_fit_batched_core, {})):
            b, b0 = fit_batched_sharded(core, X, y, W_lr, regs, ens, mesh, **kw)
            sb, sb0 = core(X, y, W_lr, regs, ens, **kw)
            out[name] = {"sharded": (b.numpy(), b0.numpy()),
                         "single": (sb.numpy(), sb0.numpy())}
        return out

    def gbt_fold_fits_on_four_ranks():
        mesh = dist.global_mesh(("data",))
        qlo, qhi = rank * 10, (rank + 1) * 10
        edges = quantile_bin_edges(X_full, 8)
        bins = torch.from_numpy(bin_data(X_full, edges).astype(np.int8))
        y = torch.from_numpy(y_full)
        W = torch.from_numpy(np.stack([
            np.r_[np.ones(30), np.zeros(10)],
            np.r_[np.zeros(10), np.ones(30)]]).astype(np.float32))
        kw = dict(num_trees=4, max_depth=3, max_bins=8, is_classification=True,
                  step_size=0.3, min_instances_per_node=1.0, min_info_gain=0.0)
        f0_g, heaps_g = fit_gbt_folds(bins[qlo:qhi], y[qlo:qhi], W[:, qlo:qhi],
                                      rows=dist.RowReducer(mesh, n_rows=40),
                                      **kw)
        f0_l, heaps_l = fit_gbt_folds(bins, y, W, **kw)
        return {"sharded": (f0_g.numpy(), [h.numpy() for h in heaps_g]),
                "single": (f0_l.numpy(), [h.numpy() for h in heaps_l])}

    return [mesh_2x2_from_env, linear_cores_on_the_2x2_mesh,
            gbt_fold_fits_on_four_ranks]


def _suite_resilience():
    import torch

    from transmogrifai_tpu_torch.faults import injection as faults
    from transmogrifai_tpu_torch.parallel import resilience

    def validator_mesh_fit_shrinks_to_survivor_parity():
        X, y = cv_data()
        with single_process():
            single = port_cv(X, y)
        resilience.reset_mesh_telemetry()
        # the dying peer marks itself and stalls briefly; the default
        # deadline never fires early, so this is timing-insensitive
        faults.configure("mesh.peer_die:on=1:delay=0.1")
        try:
            shrunk = port_cv(X, y)
        finally:
            faults.reset()
        snap = resilience.mesh_telemetry().snapshot()
        return {"single": single, "shrunk": shrunk,
                "shrinks": snap["shrinks"], "events": snap["events"],
                "watchdog": resilience.watchdog_enabled(),
                "world": torch.distributed.get_world_size()}

    def undisturbed_mesh_fit_is_guarded():
        resilience.reset_mesh_telemetry()
        res = port_cv(*cv_data())
        snap = resilience.mesh_telemetry().snapshot()
        return {"res": res, "ok": snap["collectives_ok"],
                "detections": snap["detections"]}

    return [validator_mesh_fit_shrinks_to_survivor_parity,
            undisturbed_mesh_fit_is_guarded]


SUITES = {
    "distributed": _suite_distributed,
    "integration": _suite_integration,
    "multiprocess2": _suite_multiprocess2,
    "multiprocess4": _suite_multiprocess4,
    "resilience": _suite_resilience,
}


# -- the rank ----------------------------------------------------------------------

def _rank_main(argv) -> None:
    suite, rank, world, init_url, out_dir = argv[:5]
    rank, world = int(rank), int(world)
    sys.modules["jax"] = None  # the port must never need it
    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.join(REPO, "tests"))
    import torch

    torch.set_num_threads(1)
    torch.set_float32_matmul_precision("highest")
    from transmogrifai_tpu_torch.parallel import distributed as dist

    t0 = time.perf_counter()
    if os.environ.get("TX_WORLD_ENV_BOOTSTRAP") == "1":
        dist.initialize(backend="gloo")  # MASTER_ADDR etc. from the env
    else:
        dist.initialize(coordinator_address=init_url, num_processes=world,
                        process_id=rank, backend="gloo")
    results = {"_init_s": time.perf_counter() - t0,
               "_world": torch.distributed.get_world_size(),
               "_rank": torch.distributed.get_rank()}
    for check in SUITES[suite]():
        try:
            results[check.__name__] = {"ok": check()}
        except BaseException:  # noqa: BLE001 - reported to the parent
            results[check.__name__] = {"error": traceback.format_exc()}
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)
    dist.shutdown()


def run_world(suite: str, world: int, tmp_path, timeout: float = 240.0,
              env_extra=None) -> list[dict]:
    """Run ``suite`` on a spawned gloo world of ``world`` ranks; returns
    each rank's ``{check: {"ok": result} | {"error": traceback}}``."""
    out_dir = os.path.join(str(tmp_path), f"world-{suite}")
    os.makedirs(out_dir, exist_ok=True)
    init_url = "file://" + os.path.join(out_dir, "store")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    env.pop("TX_PRODUCT_MESH", None)
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
              "LOCAL_RANK", "TX_FAULTS"):
        env.pop(k, None)
    procs = []
    for r in range(world):
        renv = dict(env, **(env_extra(r) if callable(env_extra)
                            else env_extra or {}))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), suite, str(r),
             str(world), init_url, out_dir],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=renv, cwd=REPO,
        ))
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
            outs.append(out)
    finally:
        for p in procs:  # a wedged rank must not outlive the test
            if p.poll() is None:
                p.kill()
                p.wait()
    results = []
    for r, (p, out) in enumerate(zip(procs, outs)):
        path = os.path.join(out_dir, f"rank{r}.pkl")
        assert p.returncode == 0 and os.path.exists(path), (
            f"rank {r} of the {suite} world failed (rc {p.returncode}):\n"
            f"{out[-4000:]}")
        with open(path, "rb") as f:
            results.append(pickle.load(f))
    return results


def check_result(results: list[dict], name: str) -> list:
    """Every rank's result of check ``name``; fails with the first
    rank's traceback when a rank raised."""
    out = []
    for r, res in enumerate(results):
        entry = res[name]
        assert "error" not in entry, f"rank {r}: {entry['error']}"
        out.append(entry["ok"])
    return out


if __name__ == "__main__":
    _rank_main(sys.argv[1:])
