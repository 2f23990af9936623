"""Torch device backend for whole-pipeline fused serving.

Counterpart of ``transmogrifai_tpu/local/fused_xla.py``.  Every stage with
a :class:`~..stages.base.TorchLowering` contributes one torch step, and
:func:`compile_torch_pipeline` chains them into ONE device program over a
float64 env on the scorer's device.  The tree heads' first step is kernel
K2 (``parallel/kernels.bin_matrix``), so every batch of a forest or GBT
launches it at the batch's shape.

Stages without a device lowering (the one-hot pivot: strings cannot become
tensors) run their numpy :class:`~..stages.base.Lowering` as HOST
PRE-STEPS whose numeric outputs are copied to the device once per batch; a
host stage that would need a device-produced key raises
:class:`~.fused.FusionError`, and the scorer degrades the WHOLE pipeline
to the numpy-fused path (per-pipeline, never per-batch).

A batch pads to the next power of two with zero rows (``_exec_bucket``),
so the shapes the device sees stay logarithmic in the largest batch; the
padding is sliced off, and the NaN/Inf guard runs on the device over the
real rows of the result arrays.  The first run of each bucket holds a
lock and is timed: ``bucket_stats[m]`` keeps its ``compile_ms`` (the
first call's whole wall, the honest torch analog of a trace and compile:
there is no trace step) and ``first_exec_ms`` (the device program's part
of it, from the first host-to-device copy to the last copy back).

There is no executable cache: a torch program is plain ops and kernel
launches, nothing is serialized into the model artifact, and ``cache`` is
``"none"`` (the JAX package's ``XlaExecutableCache`` and its hit/miss
counters have no twin here).
"""
from __future__ import annotations

import hashlib
import json
import threading
import time
from functools import reduce
from typing import Any, Mapping, Sequence

import numpy as np
import torch

from ..stages.base import MASK_SUFFIX, PROB_SUFFIX, RAW_SUFFIX
from .fused import (
    _MAX_SHAPE_PROGRAMS,
    FusionError,
    PipelineCompiler,
    _assemble_prediction,
    _nonfinite_mask,
    _prediction_stack,
    _prediction_stack_arrays,
    _row_builder,
)

#: device-program output key carrying the per-row non-finite guard mask
NONFINITE_KEY = "__nonfinite@rows__"


def _exec_bucket(n: int) -> int:
    """Shape bucket: the next power of two >= n."""
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def _pad0(a: np.ndarray, m: int) -> np.ndarray:
    if a.shape[0] == m:
        return a
    pad = [(0, m - a.shape[0])] + [(0, 0)] * (a.ndim - 1)
    return np.pad(a, pad)


def _nonfinite_rows(env: dict, names: Sequence[str], n: int) -> torch.Tensor:
    """Device mirror of ``fused._nonfinite_mask`` over the result features
    the program produced, on the first ``n`` (real) rows: bool [n]."""
    total = None
    for name in names:
        arrays = [
            a[:n] for a in (env.get(name), env.get(name + RAW_SUFFIX),
                            env.get(name + PROB_SUFFIX))
            if a is not None and a.is_floating_point()
        ]
        if not arrays:
            continue
        bad = reduce(torch.logical_or, [
            ~torch.isfinite(a) if a.dim() == 1
            else (~torch.isfinite(a)).any(dim=1)
            for a in arrays
        ])
        present = env.get(name + MASK_SUFFIX)
        if present is not None:
            bad = bad & present[:n]
        total = bad if total is None else total | bad
    return total


def program_fingerprint(describe: Sequence, device_inputs: Sequence[str],
                        result_names: Sequence[str], device: str) -> str:
    """SHA-256 over (torch build, device, plan structure, program inputs,
    results): two scorers share it only when they run the same program
    on the same kind of device."""
    doc = {
        "runtime": {"torch": torch.__version__,
                    "cuda": torch.version.cuda, "device": device},
        "plan": [list(entry) for entry in describe],
        "inputs": list(device_inputs),
        "results": list(result_names),
    }
    return hashlib.sha256(
        json.dumps(doc, sort_keys=True, default=str).encode("utf-8")
    ).hexdigest()


class TorchFusedPipeline:
    """One torch program over the fitted plan, run on ``device``.

    Drop-in for :class:`~.fused.FusedPipeline` on the scorer seam (same
    ``score_batch`` / ``score_env`` / ``score_env_prediction`` /
    ``compile_ms`` / ``plan`` / ``last_nonfinite_rows`` surface) plus
    ``backend``, ``device``, ``fingerprint``, ``bucket_stats`` and
    ``cache`` (always ``"none"``)."""

    backend = "torch"
    cache = "none"

    def __init__(self, decoder, host_steps: Sequence, device_steps: Sequence,
                 device_inputs: Sequence[str], candidates: Sequence[str],
                 result_plan: Sequence, describe: Sequence,
                 device: torch.device, fingerprint: str) -> None:
        self._decoder = decoder
        self._host_steps = tuple(host_steps)
        self._device_fns = tuple(tl.fn for tl in device_steps)
        self._device_inputs = tuple(device_inputs)
        self._input_set = frozenset(device_inputs)
        self._candidates = tuple(candidates)
        self._result_plan = tuple(result_plan)
        self._result_names = tuple(name for name, _ in result_plan)
        self.plan = tuple(describe)
        self.device = device
        self.fingerprint = fingerprint
        #: shape bucket -> the first call's whole wall ms (the numpy
        #: FusedPipeline's telemetry contract)
        self.compile_ms: dict[int, float] = {}
        #: shape bucket -> {compile_ms, first_exec_ms}
        self.bucket_stats: dict[int, dict] = {}
        self._warm: set[int] = set()
        self._first_lock = threading.Lock()
        self._single_prediction = (
            result_plan[0][0]
            if len(result_plan) == 1
            and result_plan[0][1] is _assemble_prediction
            else None
        )
        self._nonfinite_tl = threading.local()

    @property
    def last_nonfinite_rows(self) -> tuple:
        """Non-finite row indices of the calling thread's last batch."""
        return getattr(self._nonfinite_tl, "rows", ())

    @last_nonfinite_rows.setter
    def last_nonfinite_rows(self, rows: tuple) -> None:
        self._nonfinite_tl.rows = rows

    # -- the device program --------------------------------------------------
    def _program(self, xenv: dict, n: int) -> dict:
        env = dict(xenv)
        for fn in self._device_fns:
            env.update(fn(env))
        out = {
            k: env[k] for k in self._candidates
            if k in env and k not in self._input_set
        }
        nf = _nonfinite_rows(
            env, [nm for nm in self._result_names if nm in out], n)
        if nf is not None:
            out[NONFINITE_KEY] = nf
        return out

    def _execute(self, m: int, env: dict, n: int) -> dict:
        """Copy the program's inputs (padded to ``m`` rows) to the device,
        run it, and copy the results back as numpy, sliced to ``n``."""
        xenv = {
            k: torch.from_numpy(
                np.ascontiguousarray(_pad0(np.asarray(env[k]), m))
            ).to(self.device)
            for k in self._device_inputs
        }
        out = self._program(xenv, n)
        return {k: v[:n].cpu().numpy() for k, v in out.items()}

    def _run(self, env: dict, n: int) -> dict:
        m = _exec_bucket(n)
        if m in self._warm:
            return self._execute(m, env, n)
        with self._first_lock:
            if m in self._warm:
                return self._execute(m, env, n)
            t0 = time.perf_counter()
            res = self._execute(m, env, n)
            # beyond the cap new buckets still run, untimed (buckets are
            # powers of two, so the warm set itself stays small)
            if len(self.bucket_stats) < _MAX_SHAPE_PROGRAMS:
                self.bucket_stats[m] = {
                    "first_exec_ms": (time.perf_counter() - t0) * 1e3}
            self._warm.add(m)
            return res

    def _score_arrays(self, env: dict, n: int) -> tuple[dict, np.ndarray]:
        t0 = time.perf_counter()
        m = _exec_bucket(n)
        cold = m not in self._warm
        for fn in self._host_steps:
            env.update(fn(env))
        out = self._run(env, n)
        nf = out.pop(NONFINITE_KEY, np.zeros(n, dtype=bool))
        env.update(out)
        if cold and m in self.bucket_stats and m not in self.compile_ms:
            wall = (time.perf_counter() - t0) * 1e3
            self.compile_ms[m] = wall
            self.bucket_stats[m]["compile_ms"] = wall
        # results served from host steps / raw passthrough still need the
        # host walk; the device program guarded its own result arrays
        host_masks = [
            _nonfinite_mask(env, name, n)
            for name in self._result_names if name not in out
        ]
        return env, reduce(np.logical_or, host_masks, nf)

    # -- scoring -------------------------------------------------------------
    def score_batch(
        self, records: Sequence[Mapping[str, Any]]
    ) -> list[dict[str, Any]]:
        n = len(records)
        if n == 0:
            self.last_nonfinite_rows = ()
            return []
        return self.score_env(self._decoder.decode_env(records), n)

    def score_env(self, env: dict, n: int) -> list[dict[str, Any]]:
        """Columnar entry: host pre-steps + the device program + assembly
        over a PRE-BUILT decode env (the numpy pipeline's contract)."""
        if n == 0:
            self.last_nonfinite_rows = ()
            return []
        env, bad = self._score_arrays(env, n)
        if self._single_prediction is not None:
            name = self._single_prediction
            keys, stacked = _prediction_stack(env, name)
            result = list(map(_row_builder(name, keys), stacked))
        elif len(self._result_plan) == 1:
            (name, fn), = self._result_plan
            result = [{name: v} for v in fn(env, name)]
        else:
            names = [name for name, _ in self._result_plan]
            columns = [fn(env, name) for name, fn in self._result_plan]
            result = [dict(zip(names, row)) for row in zip(*columns)]
        self.last_nonfinite_rows = tuple(np.flatnonzero(bad).tolist())
        return result

    def score_env_prediction(self, env: dict, n: int):
        """Columnar fast path: the single-Prediction result as raw arrays
        ``(name, keys, stacked [n, k] float64)``; None when the plan has
        any other result shape or n == 0."""
        if self._single_prediction is None or n == 0:
            return None
        env, bad = self._score_arrays(env, n)
        name = self._single_prediction
        keys, stacked = _prediction_stack_arrays(env, name)
        self.last_nonfinite_rows = tuple(np.flatnonzero(bad).tolist())
        return name, keys, stacked

    def __call__(self, record: Mapping[str, Any]) -> dict[str, Any]:
        return self.score_batch([record])[0]


def compile_torch_pipeline(steps, raw_features, result_features,
                           device: torch.device) -> TorchFusedPipeline:
    """Fuse a fitted plan into one torch program on ``device`` (plus host
    pre-steps), or raise FusionError naming the first stage that cannot
    be compiled - the scorer then degrades the whole pipeline to the
    numpy-fused backend."""
    base = PipelineCompiler(steps, raw_features, result_features)
    np_fused = base.compile()  # validates plan + builds decoder/assembly
    host_steps: list = []
    device_steps: list = []
    device_out: set[str] = set()
    routes: list[str] = []
    for stage, _ins, _out in steps:
        try:
            tl = stage.lower_torch()
        except Exception as e:  # noqa: BLE001 - open extension seam
            raise FusionError(
                f"stage {stage.uid} ({type(stage).__name__}) lower_torch "
                f"raised {type(e).__name__}: {e}"
            ) from e
        if tl is not None:
            device_steps.append(tl)
            device_out.update(tl.outputs)
            routes.append("device")
            continue
        lw = stage.lower()  # non-None: the base compile succeeded
        dev_deps = sorted(k for k in lw.inputs if k in device_out)
        if dev_deps:
            raise FusionError(
                f"stage {stage.uid} ({type(stage).__name__}) has no torch "
                f"lowering but consumes device-produced keys {dev_deps}; "
                "cannot stage it on the host"
            )
        host_steps.append(lw.fn)
        routes.append("host")
    if not device_steps:
        raise FusionError(
            "no stage lowers to torch; the numpy-fused program is the "
            "right backend for this pipeline"
        )
    device_inputs = sorted(
        {k for tl in device_steps for k in tl.inputs} - device_out
    )
    candidates: list[str] = []
    for f in result_features:
        for key in (f.name, f.name + MASK_SUFFIX, f.name + RAW_SUFFIX,
                    f.name + PROB_SUFFIX):
            if key not in candidates:
                candidates.append(key)
    describe = tuple(
        (uid, op, ins, outs, dict(sig, route=route))
        for (uid, op, ins, outs, sig), route in zip(np_fused.plan, routes)
    )
    device = torch.device(device)
    fingerprint = program_fingerprint(
        describe, device_inputs, [f.name for f in result_features],
        device.type,
    )
    return TorchFusedPipeline(
        decoder=np_fused._decoder,
        host_steps=host_steps,
        device_steps=device_steps,
        device_inputs=device_inputs,
        candidates=candidates,
        result_plan=np_fused._result_plan,
        describe=describe,
        device=device,
        fingerprint=fingerprint,
    )
