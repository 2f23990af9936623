"""Whole-pipeline fused serving compilation: the numpy-fused backend.

Host copy of ``transmogrifai_tpu/local/fused.py``.  Flare-style native
compilation of the fitted stage DAG (Flare, arXiv 1703.08219 compiles
whole Spark query plans instead of interpreting operators): every fitted
stage that implements the ``lower()`` seam (stages/base.Lowering)
contributes one pure array function, and the :class:`PipelineCompiler`
fuses the topologically-ordered plan into ONE closed-over program -
raw record dicts decode straight into dense input arrays, flow through
the fused steps as a flat ``dict[str, np.ndarray]`` environment, and
come out as result dicts.  No Column/Dataset boxing, no per-stage
``to_list``/``column_from_list`` round trips (this module stays columnar
end to end: the only per-record python is the single-pass
decode/assembly comprehensions at the boundary).  The device backend,
``local/fused_torch.py``, reuses this compiler, its decoder and its
result assembly.

Compilation is per shape bucket: the first batch of a given length
through :meth:`FusedPipeline.score_batch` warms every stage closure
(one-hot code memos, native-kernel dispatch) for exactly that shape
and records the compile/warm wall time, which serving telemetry
surfaces per bucket.  A pipeline with any non-lowerable stage raises
:class:`FusionError` at compile time and the caller (LocalScorer)
serves through the interpreted path for the life of the pipeline -
the fused/interpreted choice is per-pipeline, never per-batch.
"""
from __future__ import annotations

import threading
import time
from functools import lru_cache, reduce
from operator import itemgetter
from typing import Any, Mapping, Sequence

import numpy as np

from ..stages.base import MASK_SUFFIX, PROB_SUFFIX, RAW_SUFFIX
from ..types.columns import (
    ListColumn,
    NumericColumn,
    TextColumn,
    decode_numeric,
    decode_text,
    list_values,
    present_nan_slots,
    text_values,
)
from ..types.feature_types import Prediction

#: raw-feature kinds the fused decoder can turn into env arrays
DECODABLE_KINDS = ("numeric", "text", "textlist", "datelist",
                   "multipicklist")

#: compiled shape-bucket entries kept per pipeline (endpoints pad to a
#: handful of buckets; a caller submitting arbitrary batch lengths must
#: not grow the program cache without bound)
_MAX_SHAPE_PROGRAMS = 64


class FusionError(Exception):
    """The fitted pipeline cannot be compiled into one fused program;
    carries the human-readable reason (surfaced in serving telemetry)."""


# -- record decoding --------------------------------------------------------
# decode_numeric / decode_text / text_values / present_nan_slots live in
# types/columns.py next to the from_list semantics they mirror (and so
# schema/drift.py can share them without importing this package).

_NAN = float("nan")


def _object_array(values: list) -> np.ndarray:
    """list -> object [n] without numpy's auto-2D collapse of
    equal-length tuples."""
    out = np.empty(len(values), dtype=object)
    out[:] = values
    return out


def _list_values(values, as_set: bool) -> np.ndarray:
    """Raw values -> object [n] of tuples (order kept) or frozensets,
    through the canonical ``list_values`` conversion in types/columns.py
    that column_from_list also uses, so the two can never drift apart."""
    return _object_array(list_values(values, as_set))


class RecordDecoder:
    """Per-pipeline compiled decoder: raw record dicts -> env arrays
    (fused path) or Columns (the interpreted path reuses the same
    extraction, skipping the per-element ``column_from_list`` loop).

    The env hot path extracts ALL features from the batch in one
    C-speed ``itemgetter`` pass (tuple rows, then ``zip(*rows)`` to
    per-feature columns), and converts every numeric feature together
    as one [k, n] object matrix - the per-feature ``dict.get``
    comprehensions were the top line of the fused profile at ~2.6us
    of a 3.6us/row total."""

    def __init__(self, features: Sequence) -> None:
        self.features = tuple(features)
        self._names = tuple(f.name for f in self.features)
        self._numeric = tuple(
            (i, f.name) for i, f in enumerate(self.features)
            if f.ftype.kind == "numeric"
        )
        self._other = tuple(
            (i, f) for i, f in enumerate(self.features)
            if f.ftype.kind != "numeric"
        )
        self._getter = (
            itemgetter(*self._names) if self._names else None
        )

    # -- env arrays (fused hot path) ----------------------------------------
    def _columns(self, records: Sequence[Mapping[str, Any]]) -> list:
        """Per-feature value tuples, order matching ``self.features``."""
        if all(type(r) is dict for r in records):
            try:
                rows = list(map(self._getter, records))
            except KeyError:
                rows = None  # records missing keys: tolerant path below
            if rows is not None:
                if len(self._names) == 1:  # itemgetter returns bare values
                    return [tuple(rows)]
                return list(zip(*rows))
        # Mapping subtypes (a defaultdict's __missing__ would fabricate a
        # present value AND insert it into the caller's record under
        # itemgetter) and key-missing records: per-key Mapping.get, same
        # None-as-missing semantics as the interpreted decode
        return [tuple(r.get(nm) for r in records) for nm in self._names]

    def decode_env(self, records: Sequence[Mapping[str, Any]]) -> dict:
        if not self._names:
            return {}
        cols = self._columns(records)
        env: dict = {}
        if self._numeric:
            sub = np.array([cols[i] for i, _ in self._numeric],
                           dtype=object)
            if sub.ndim != 2:  # equal-length list values would build 3D
                raise TypeError("numeric feature values are not scalars")
            mask2d = sub != None  # noqa: E711 - elementwise over objects
            sub[~mask2d] = _NAN
            vals2d = sub.astype(np.float64)
            nan2d = np.isnan(vals2d) & mask2d
            mask2d &= ~nan2d
            if nan2d.any():
                # from_list parity: NaN-valued non-float inputs (str
                # "nan", np.float32 NaN) stay PRESENT as NaN for the
                # output guard; only python-float NaN is missing
                flat = np.flatnonzero(nan2d.ravel()).tolist()
                present = present_nan_slots(flat, sub.ravel())
                mask2d.ravel()[present] = True
            vals2d = np.where(mask2d, vals2d, 0.0)
            env.update({
                key: arr
                for j, (_, name) in enumerate(self._numeric)
                for key, arr in ((name, vals2d[j]),
                                 (name + MASK_SUFFIX, mask2d[j]))
            })
        env.update({
            key: val
            for i, f in self._other
            for key, val in self._env_other(cols[i], f)
        })
        return env

    @staticmethod
    def _env_other(values: tuple, f) -> tuple:
        kind = f.ftype.kind
        if kind == "text":
            return ((f.name, text_values(values)),)
        if kind in ("textlist", "datelist"):
            return ((f.name, _list_values(values, as_set=False)),)
        if kind == "multipicklist":
            return ((f.name, _list_values(values, as_set=True)),)
        raise FusionError(  # pragma: no cover - compiler rejects upfront
            f"raw feature {f.name!r} has undecodable kind {kind!r}"
        )

    # -- Columns (interpreted path) -----------------------------------------
    def decode_columns(self, records: Sequence[Mapping[str, Any]]) -> dict:
        return {f.name: self._column_one(records, f) for f in self.features}

    def _column_one(self, records, f):
        kind = f.ftype.kind
        if kind == "numeric":
            vals, mask = decode_numeric(records, f.name)
            return NumericColumn(vals, mask, f.ftype)
        if kind == "text":
            return TextColumn(decode_text(records, f.name), f.ftype)
        if kind in ("textlist", "datelist"):
            return ListColumn(
                list(_list_values([r.get(f.name) for r in records],
                                  as_set=False)), f.ftype
            )
        if kind == "multipicklist":
            return ListColumn(
                list(_list_values([r.get(f.name) for r in records],
                                  as_set=True)), f.ftype
            )
        # map/geolocation/vector kinds ride the caller's column_from_list
        # slow path - duplicating those per-element builds here bought no
        # speedup and risked semantic drift from the canonical versions
        raise TypeError(f"cannot decode column for kind {kind!r}")


# -- result assembly --------------------------------------------------------

@lru_cache(maxsize=256)
def _prediction_keys(raw_w: int, prob_w: int) -> tuple:
    """PredictionColumn.to_list's key layout for given raw/prob widths,
    memoized (key-list rebuild showed up at ~2us/batch x every batch)."""
    return (
        (Prediction.KEY_PREDICTION,)
        + tuple(f"{Prediction.KEY_RAW}_{j}" for j in range(raw_w))
        + tuple(f"{Prediction.KEY_PROB}_{j}" for j in range(prob_w))
    )


@lru_cache(maxsize=256)
def _row_builder(name: str, keys: tuple):
    """Compile a per-row result constructor for one (feature, keys)
    signature: a generated dict-literal lambda builds both dict levels
    in ONE python call (dict(zip(...)) allocated a 2-tuple per key per
    row - measured ~0.9us/row on the RF-winner batch surface).  The
    generated source contains no interpolated VALUES: feature/key
    strings bind through the eval globals."""
    binds = {f"_k{i}": k for i, k in enumerate(keys)}
    binds["_nm"] = name
    body = ", ".join(f"_k{i}: r[{i}]" for i in range(len(keys)))
    return eval(  # noqa: S307 - generated from our own constants
        f"lambda r: {{_nm: {{{body}}}}}", binds
    )


def _prediction_stack_arrays(env: dict, name: str) -> tuple:
    """Prediction env arrays -> (key layout, [n, k] float array): the
    ONE place the prediction column order (prediction, raw_*, prob_*)
    is stacked, shared by _assemble_prediction, the score_batch
    single-result fast path and the bulk job's columnar line encoder
    so the three can never diverge."""
    pred = env[name]
    raw = env.get(name + RAW_SUFFIX)
    prob = env.get(name + PROB_SUFFIX)
    keys = _prediction_keys(
        raw.shape[1] if raw is not None else 0,
        prob.shape[1] if prob is not None else 0,
    )
    parts = [pred[:, None]] + [a for a in (raw, prob) if a is not None]
    return keys, np.concatenate(parts, axis=1)


def _prediction_stack(env: dict, name: str) -> tuple:
    """:func:`_prediction_stack_arrays` with per-row value lists."""
    keys, stacked = _prediction_stack_arrays(env, name)
    return keys, stacked.tolist()


def _assemble_prediction(env: dict, name: str) -> list:
    """Prediction env arrays -> per-row dicts matching
    PredictionColumn.to_list exactly (same keys, same float values)."""
    keys, stacked = _prediction_stack(env, name)
    return [dict(zip(keys, row)) for row in stacked]


def _assemble_numeric(env: dict, name: str) -> list:
    vals = env[name].tolist()
    mask = env[name + MASK_SUFFIX].tolist()
    return [v if m else None for v, m in zip(vals, mask)]


def _assemble_vector(env: dict, name: str) -> list:
    return env[name].tolist()


def _assemble_text(env: dict, name: str) -> list:
    return list(env[name])


_ASSEMBLERS = {
    "prediction": _assemble_prediction,
    "numeric": _assemble_numeric,
    "vector": _assemble_vector,
    "text": _assemble_text,
}


# -- the fused program ------------------------------------------------------

def _apply_step(env: dict, fn) -> dict:
    env.update(fn(env))
    return env


def _nonfinite_mask(env: dict, name: str, n: int) -> np.ndarray:
    """Per-row bool [n]: any non-finite float among this result
    feature's arrays (pred + raw + prob for predictions; mask-aware for
    numerics - a masked slot serves as None, never as a bad float)."""
    arrays = [a for a in (
        env.get(name), env.get(name + RAW_SUFFIX),
        env.get(name + PROB_SUFFIX),
    ) if isinstance(a, np.ndarray) and a.dtype.kind == "f"]
    if not arrays:
        return np.zeros(n, dtype=bool)
    masks = [
        ~np.isfinite(a) if a.ndim == 1 else (~np.isfinite(a)).any(axis=1)
        for a in arrays
    ]
    bad = reduce(np.logical_or, masks)
    present = env.get(name + MASK_SUFFIX)
    return bad & present if present is not None else bad


class FusedPipeline:
    """One compiled array program over the whole fitted plan.

    ``score_batch`` is the hot path: decode -> fused steps -> assemble.
    The first batch of each distinct length is that shape bucket's
    compile/warm execution; its wall time is kept in ``compile_ms``
    keyed by batch length (serving telemetry exports it per bucket).
    """

    def __init__(self, decoder: RecordDecoder, step_fns: Sequence,
                 result_plan: Sequence, describe: Sequence) -> None:
        self._decoder = decoder
        self._step_fns = tuple(step_fns)
        #: (feature name, assembler) per result feature, in result order
        self._result_plan = tuple(result_plan)
        #: per-stage (uid, operation_name, inputs, outputs, signature)
        self.plan = tuple(describe)
        #: shape bucket (batch length) -> first-execution wall ms
        self.compile_ms: dict[int, float] = {}
        #: single-Prediction-result fast path marker (score_batch)
        self._single_prediction = (
            result_plan[0][0]
            if len(result_plan) == 1
            and result_plan[0][1] is _assemble_prediction
            else None
        )
        # row indices of the last scored batch whose float results are
        # non-finite, computed columnar (np.isfinite over the result
        # arrays) so the serving NaN/Inf guard need not re-walk every
        # result dict in python.  Thread-local: the scheduler worker and
        # any number of direct endpoint callers each read back the mask
        # of THEIR batch (valid between their score_batch return and
        # their next call), never a concurrent caller's.
        self._nonfinite_tl = threading.local()

    @property
    def last_nonfinite_rows(self) -> tuple:
        """Non-finite row indices of the calling thread's last batch."""
        return getattr(self._nonfinite_tl, "rows", ())

    @last_nonfinite_rows.setter
    def last_nonfinite_rows(self, rows: tuple) -> None:
        self._nonfinite_tl.rows = rows

    def score_batch(
        self, records: Sequence[Mapping[str, Any]]
    ) -> list[dict[str, Any]]:
        n = len(records)
        if n == 0:
            self.last_nonfinite_rows = ()
            return []
        # beyond the cap, new shapes run fine but are no longer timed:
        # evicting would both break the endpoint's len()-based new-
        # bucket push detection and re-record a warm bucket's next
        # ordinary execution as compile cost
        cold = (n not in self.compile_ms
                and len(self.compile_ms) < _MAX_SHAPE_PROGRAMS)
        t0 = time.perf_counter() if cold else 0.0
        out = self.score_env(self._decoder.decode_env(records), n)
        if cold:
            self.compile_ms[n] = (time.perf_counter() - t0) * 1e3
        return out

    def score_env(self, env: dict, n: int) -> list[dict[str, Any]]:
        """Columnar entry: run the fused steps + assembly
        over a PRE-BUILT decode env - the bulk job feeds pipelined
        chunk columns here directly, skipping per-record decode.  The
        env must hold every decoder feature's keys (``name`` +
        ``name@mask`` for numerics) with the decode_env missing-value
        conventions; ``score_batch`` is exactly this after decode."""
        if n == 0:
            self.last_nonfinite_rows = ()
            return []
        env = reduce(_apply_step, self._step_fns, env)
        if self._single_prediction is not None:
            # the dominant serving shape (one Prediction result): build
            # the row dicts in ONE pass instead of column-then-wrap
            name = self._single_prediction
            keys, stacked = _prediction_stack(env, name)
            out = list(map(_row_builder(name, keys), stacked))
        elif len(self._result_plan) == 1:
            (name, fn), = self._result_plan
            out = [{name: v} for v in fn(env, name)]
        else:
            names = [name for name, _ in self._result_plan]
            columns = [fn(env, name) for name, fn in self._result_plan]
            out = [dict(zip(names, row)) for row in zip(*columns)]
        self.last_nonfinite_rows = tuple(
            np.flatnonzero(
                reduce(
                    np.logical_or,
                    [_nonfinite_mask(env, name, n) for name, _ in
                     self._result_plan],
                    np.zeros(n, dtype=bool),
                )
            ).tolist()
        )
        return out

    def score_env_prediction(self, env: dict, n: int):
        """Columnar bulk fast path: run the fused steps over a
        pre-built decode env and hand back the single-Prediction
        result as raw arrays ``(name, keys, stacked [n, k] float64)``
        instead of per-row dicts, so the bulk job can line-encode the
        output without ever materialising n python dicts.  None when
        the plan has any other result shape (or n == 0) - the caller
        falls back to :meth:`score_env`.  ``last_nonfinite_rows`` is
        set exactly as score_env would."""
        if self._single_prediction is None or n == 0:
            return None
        env = reduce(_apply_step, self._step_fns, env)
        name = self._single_prediction
        keys, stacked = _prediction_stack_arrays(env, name)
        self.last_nonfinite_rows = tuple(
            np.flatnonzero(_nonfinite_mask(env, name, n)).tolist())
        return name, keys, stacked

    def __call__(self, record: Mapping[str, Any]) -> dict[str, Any]:
        return self.score_batch([record])[0]


class PipelineCompiler:
    """Trace a fitted (stage, inputs, output) plan and fuse every
    lowered stage into one FusedPipeline, or raise FusionError naming
    the first stage/feature that cannot be compiled."""

    def __init__(self, steps: Sequence, raw_features: Sequence,
                 result_features: Sequence) -> None:
        self.steps = tuple(steps)
        self.raw_features = tuple(raw_features)
        self.result_features = tuple(result_features)

    def compile(self) -> FusedPipeline:
        raw_by_name = {f.name: f for f in self.raw_features}
        lowered = [
            (stage, out_name, self._lower_or_raise(stage))
            for stage, _, out_name in self.steps
        ]
        produced = {out_name for _, out_name, _ in lowered}
        # env-key granularity: a consumer's declared input (including
        # @mask companions) must be an env key some producer DECLARES,
        # not merely a feature name it is associated with - a producer
        # omitting a mask key must fail here, at compile time, not as a
        # KeyError on every serve-time batch
        produced_keys = {
            key for _, _, lw in lowered for key in lw.outputs
        }
        # _input_base_or_raise always returns a non-empty name (or
        # raises FusionError), so the walrus only binds - it never filters
        needed = {
            base
            for stage, _, lw in lowered
            for key in lw.inputs
            if key not in produced_keys
            and (base := self._input_base_or_raise(
                stage, key, produced, raw_by_name
            ))
        }
        # raw features served straight through as results must decode too
        needed |= {
            f.name for f in self.result_features if f.name not in produced
        }
        # numeric results assemble from value + @mask pairs: a stage-
        # produced numeric result must declare its mask key as well
        missing_masks = [
            f.name
            for f in self.result_features
            if f.ftype.kind == "numeric" and f.name in produced
            and f.name + MASK_SUFFIX not in produced_keys
        ]
        if missing_masks:
            raise FusionError(
                f"numeric result features {missing_masks} are produced "
                "without their @mask companion keys"
            )
        needed_raws = [self._raw_or_raise(raw_by_name, b) for b in
                       sorted(needed)]
        result_plan = [
            (f.name, self._assembler_or_raise(f, produced, raw_by_name))
            for f in self.result_features
        ]
        describe = [
            (stage.uid, stage.operation_name, lw.inputs, lw.outputs,
             dict(lw.signature))
            for stage, _, lw in lowered
        ]
        return FusedPipeline(
            decoder=RecordDecoder(needed_raws),
            step_fns=[lw.fn for _, _, lw in lowered],
            result_plan=result_plan,
            describe=describe,
        )

    @staticmethod
    def _input_base_or_raise(stage, key: str, produced: set,
                             raw_by_name: dict):
        """Resolve an undeclared-producer env input key to the raw
        feature it must decode from, or raise FusionError when the key
        can never exist at serve time."""
        base = (key[: -len(MASK_SUFFIX)]
                if key.endswith(MASK_SUFFIX) else key)
        if base in produced:
            raise FusionError(
                f"stage {stage.uid} consumes env key {key!r}, which "
                "its producing stage does not declare"
            )
        if base is not key and (
            base in raw_by_name
            and raw_by_name[base].ftype.kind != "numeric"
        ):
            raise FusionError(
                f"env mask key {key!r} requested for non-numeric raw "
                f"feature {base!r}"
            )
        return base

    @staticmethod
    def _lower_or_raise(stage):
        lw = stage.lower()
        if lw is None:
            raise FusionError(
                f"stage {stage.uid} ({type(stage).__name__}) does not "
                "lower to an array kernel"
            )
        return lw

    @staticmethod
    def _raw_or_raise(raw_by_name: dict, base: str):
        f = raw_by_name.get(base)
        if f is None:
            raise FusionError(
                f"fused program input {base!r} is neither a stage output "
                "nor a servable raw feature"
            )
        if f.ftype.kind not in DECODABLE_KINDS:
            raise FusionError(
                f"raw feature {f.name!r} has kind {f.ftype.kind!r}, which "
                "the fused decoder does not handle"
            )
        return f

    @staticmethod
    def _assembler_or_raise(f, produced: set, raw_by_name: dict):
        if f.name not in produced and f.name not in raw_by_name:
            raise FusionError(
                f"result feature {f.name!r} is not produced by any "
                "lowered stage"
            )
        fn = _ASSEMBLERS.get(f.ftype.kind)
        if fn is None:
            raise FusionError(
                f"result feature {f.name!r} has kind {f.ftype.kind!r}, "
                "which the fused path cannot assemble"
            )
        return fn


def compile_pipeline(steps, raw_features, result_features) -> FusedPipeline:
    """Fuse a fitted plan into one array program (raises FusionError
    when any stage, raw input, or result feature cannot be compiled)."""
    return PipelineCompiler(steps, raw_features, result_features).compile()
