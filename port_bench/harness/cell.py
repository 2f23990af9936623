"""One run of one cell: set-up, warm-up, the measured window, the trace,
the correctness check and the result line.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up generates the cell's pool of data sets from the seed (and one more
for the warm-up, of the configuration's ``warmup_rows``), imports the port
and warms it up with whole trains of the cell's selector.  The window
then runs back-to-back trains, each a new workflow on the next data set
of the pool; a train that starts before ``--seconds`` have passed runs to
its end and counts, and the window ends when the last one returns.
``train_s`` is the window over the trains completed; ``setup_s`` runs
from the start of the process to the first timed train.  With
``--trace 1`` the trains of the first half of the window run under the
benchmark's spans and the profiler, and the line carries the per-layer
metrics instead.  After the window, one train
drawn from the seed is judged against the plain reference (``check.py``).

Two modes for measuring the check's limits print one JSON line per seed
and no result line: ``--readings N`` (the program, one train on each of
N seeds from ``--seed`` up, in one process) and ``--control N`` (the
reference in bfloat16 in the program's place, on N seeds).
"""
from __future__ import annotations

import argparse
import gc
import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np

from . import catalog, datagen

#: modules the measured process must not hold, by whole top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "transmogrifai_tpu")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    """The forbidden top-level names among the loaded modules (an entry of
    None only blocks an import)."""
    return sorted({name.split(".", 1)[0]
                   for name, mod in list(sys.modules.items())
                   if mod is not None and name.split(".", 1)[0] in FORBIDDEN})


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--readings", type=int, default=0,
                   help="print the check's numbers of the program on N seeds")
    p.add_argument("--control", type=int, default=0,
                   help="print the check's numbers of the bfloat16 control on "
                        "N seeds")
    return p.parse_args(argv)


class Run:
    """The parts of one run.  ``device`` is "cuda" for the benchmark;
    the tests drive it on "cpu" at a few rows (``rows``)."""

    def __init__(self, cell: catalog.Cell, seed: int, device: str = "cuda",
                 rows=None) -> None:
        self.cell = cell
        self.seed = int(seed)
        self.device = device
        self.rows = rows

    # -- data ---------------------------------------------------------------
    def raw(self, index: int, seed=None):
        return datagen.generate(self.cell.config,
                                self.seed if seed is None else seed,
                                index, rows=self.rows)

    def warmup_rows(self):
        """The configuration's ``warmup_rows`` (its whole row count where
        it states none), scaled to ``rows`` when the tests cut them."""
        full = int(self.cell.config["rows"])
        n = int(self.cell.config.get("warmup_rows", full))
        if self.rows is not None:
            n = round(self.rows * n / full)
        return max(1, n)

    # -- the program ----------------------------------------------------------
    def train(self, dataset):
        from . import program

        built = program.build(self.cell.config, self.cell.mix, self.device)
        built.workflow.set_input_dataset(dataset)
        model = built.workflow.train()
        self.sync()
        return model, built

    def sync(self) -> None:
        if self.device == "cuda":
            import torch

            torch.cuda.synchronize()

    def window(self, datasets, seconds: float) -> dict:
        """Back-to-back trains for ``seconds``; returns the window's
        record, with what each train produced."""
        from . import program

        outputs, failures, spans, modules = [], 0, [], {}
        t0 = time.perf_counter()
        k = 0
        while time.perf_counter() - t0 < seconds:
            ts = time.perf_counter()
            try:
                model, built = self.train(datasets[k % len(datasets)])
            except Exception:  # noqa: BLE001 - a failed train is counted
                failures += 1
                log(traceback.format_exc())
                model = None
            te = time.perf_counter()
            spans.append((ts, te))
            if model is not None:
                outputs.append((k, program.extract(model, built)))
                modules.update(program.stage_modules(model))
                del model
            log(f"[window] train {k} on data set {k % len(datasets)}: "
                f"{te - ts:.3f} s")
            k += 1
        return {"t0": t0, "t1": time.perf_counter(), "attempted": k,
                "failed": failures, "outputs": outputs, "trains": spans,
                "modules": modules}

    # -- the check ------------------------------------------------------------
    def reference(self, raw, dtype=None, tree_points=None, winner=None):
        import torch

        from port_bench.reference import pipeline

        return pipeline.run(self.cell.config, self.cell.mix, raw,
                            torch.device(self.device),
                            dtype=dtype or torch.float64,
                            tree_points=tree_points, winner=winner,
                            card_rank_rule=self.device == "cuda")

    def judge(self, prog, raw):
        from . import check

        t0 = time.perf_counter()
        points = check.tree_points(self.cell.mix, prog.winner, self.seed)
        ref = self.reference(raw, tree_points=points, winner=prog.winner)
        values = check.numbers(prog, ref)
        ok, table = check.judge(values, self.cell.limits)
        log(f"[check] reference {time.perf_counter() - t0:.1f} s, tree "
            f"points {points}, width {ref.meta['width']} kept "
            f"{ref.meta['kept']}, program winner {prog.winner}, reference "
            f"best {ref.best}")
        return ok, table


def _device_info(chips: int, peak: int) -> dict:
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips, "memory_peak_bytes": int(peak)}


def _card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


def _gap_label(t: float, rec, trains) -> str:
    best, start = None, -1.0
    for s in rec.spans:
        if s.t0 <= t < s.t1 and s.t0 > start:
            best, start = s.group, s.t0
    for module, phase, s0, wall in rec.stage_spans:
        if s0 <= t < s0 + wall and s0 > start:
            best, start = f"{phase} {module.rsplit('.', 1)[-1]}", s0
    if best is not None:
        return best
    if any(a <= t < b for a, b in trains):
        return "train, outside the spans"
    return "between trains"


def traced_window(run: Run, datasets, seconds: float) -> tuple:
    """The window under the shims and the profiler; returns (window
    record, Recording, metric readers)."""
    import torch

    from transmogrifai_tpu_torch.obs import trace as obs_trace
    from transmogrifai_tpu_torch.parallel import kernels

    from . import profile, recorder

    readers = {m["name"]: run.cell.metric_module(m["name"])
               for m in run.cell.per_layer}
    rec = recorder.Recording()
    shims = recorder.Shims(rec, torch.cuda.synchronize)
    seen = set()
    for mod in readers.values():
        for target in mod.SHIMS:
            if target[:3] not in seen:
                seen.add(target[:3])
                shims.span(*target)
        for kname, describe in mod.KERNELS.items():
            if kname not in seen:
                seen.add(kname)
                shims.kernel(getattr(kernels, kname), describe)
    obs_trace.reset_tracer(capacity=1 << 20)
    trace = profile.DeviceTrace()
    torch.cuda.synchronize()
    trace.start()
    e0, p0 = time.time(), time.perf_counter()
    try:
        win = run.window(datasets, seconds)
    finally:
        trace.stop()
        shims.remove()
    rec.trains = len(win["outputs"])
    rec.window = (win["t0"], win["t1"])
    rec.device_events = trace.events
    rec.busy_s = profile.busy_seconds(trace.events, *rec.window)
    for r in obs_trace.tracer().spans():
        if r["name"] in ("stage.fit", "stage.transform"):
            uid = (r.get("attrs") or {}).get("uid")
            rec.stage_spans.append((
                win["modules"].get(uid, ""), r["name"][6:],
                p0 + (r["t_epoch"] - e0), 1e-3 * r["wall_ms"]))
    log(f"[trace] {len(trace.events)} device events, read in "
        f"{trace.read_s:.1f} s; {len(rec.spans)} spans, "
        f"{len(rec.stage_spans)} stage spans, {len(rec.kernel_calls)} "
        f"kernel calls")
    return win, rec, readers


def run_cell(args, cell: catalog.Cell, t_start: float, device="cuda",
             rows=None) -> int:
    run = Run(cell, args.seed, device=device, rows=rows)
    if device == "cuda":
        import torch

        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < cell.chips:
            log(f"needs {cell.chips} CUDA device(s); found "
                f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
            return 3
        torch.cuda.set_device(0)
    if args.readings or args.control:
        return readings(run, args)

    from . import program

    pool = int(cell.mix["pool"])
    raws = [run.raw(i) for i in range(pool)]
    datasets = [program.to_dataset(r, cell.config) for r in raws]
    warm = program.to_dataset(
        datagen.generate(cell.config, args.seed, pool,
                         rows=run.warmup_rows()), cell.config)
    t_w = time.perf_counter()
    for _ in range(int(cell.mix["warmup"]["trains"])):
        run.train(warm)
    del warm
    # what set-up left behind is not scanned by the collections of the
    # window's trains
    gc.collect()
    gc.freeze()
    log(f"[setup] data {t_w - t_start:.1f} s, warm-up "
        f"{time.perf_counter() - t_w:.1f} s, {run.warmup_rows()} rows")
    t_first = time.perf_counter()
    setup_s = t_first - t_start
    if args.trace:
        # the first half of the window: a whole window's trace of the
        # launch-bound cell held 2.55M device events, and stopping the
        # profiler and reading them took about 150 s of the run
        win, rec, readers = traced_window(run, datasets, args.seconds / 2)
    else:
        win = run.window(datasets, args.seconds)
    peak = 0
    if device == "cuda":
        import torch

        peak = torch.cuda.max_memory_allocated(0)
    datasets.clear()

    metrics = {}
    device_info = (_device_info(cell.chips, peak) if device == "cuda"
                   else {"platform": "cpu", "kind": "cpu", "count": 0,
                         "memory_peak_bytes": 0})
    breakdown = None
    done = len(win["outputs"])
    if args.trace:
        units = {m["name"]: m["unit"] for m in cell.per_layer}
        for name, mod in readers.items():
            v = mod.read(rec)
            if v is not None:
                metrics[name] = {"value": float(v), "unit": units[name]}
        from . import profile

        lo, hi = rec.window
        device_info["busy_s"] = float(rec.busy_s)
        device_info["window_s"] = float(hi - lo)
        breakdown = {
            "device_ops": profile.top_ops(rec.device_events, 10),
            "idle_gaps": [[_gap_label(t, rec, win["trains"]), float(g)]
                          for t, g in profile.idle_gaps(
                              rec.device_events, lo, hi)[:10]],
        }
        del rec
    else:
        units = {m["name"]: m["unit"] for m in cell.end_to_end}
        if done:
            window_s = win["t1"] - win["t0"]
            metrics["train_s"] = {"value": window_s / done,
                                  "unit": units.get("train_s", "s")}
        metrics["setup_s"] = {"value": setup_s,
                              "unit": units.get("setup_s", "s")}

    correct = done > 0 and win["failed"] == 0
    table = {}
    if done:
        rng = np.random.default_rng([args.seed % (1 << 64), 1])
        k, prog = win["outputs"][int(rng.integers(done))]
        win["outputs"] = None
        ok, table = run.judge(prog, raws[k % pool])
        correct = correct and ok
    if device == "cuda":
        log(f"[card] {_card_line()}")
    bad = forbidden_modules()
    if bad:
        log(f"the measured process holds {bad}: no result")
        return 4
    result = {"correct": bool(correct), "attempted": win["attempted"],
              "failed": win["failed"], "metrics": metrics,
              "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["check"] = {k: v for k, v in table.items()}
    for k, v in table.items():
        log(f"check {k} {v['value']!r} limit {v['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


def readings(run: Run, args) -> int:
    """The check's numbers on ``--readings`` seeds of the program, then on
    ``--control`` seeds of the bfloat16 control, one JSON line each."""
    import torch

    from . import check, program

    for s in range(args.seed, args.seed + args.readings):
        raw = run.raw(0, seed=s)
        t0 = time.perf_counter()
        model, built = run.train(program.to_dataset(raw, run.cell.config))
        t1 = time.perf_counter()
        prog = program.extract(model, built)
        del model
        run.seed = s
        points = check.tree_points(run.cell.mix, prog.winner, s)
        ref = run.reference(raw, tree_points=points, winner=prog.winner)
        vals = check.numbers(prog, ref)
        print(json.dumps({"kind": "program", "seed": s, "train_s": t1 - t0,
                          "reference_s": time.perf_counter() - t1,
                          "winner": [prog.winner[0], prog.winner[1]],
                          "reference_best": [ref.best[0], ref.best[1]],
                          "meta": prog.meta, "numbers": vals,
                          "train_fused": prog.train_fused}), flush=True)
    for s in range(args.seed, args.seed + args.control):
        raw = run.raw(0, seed=s)
        t0 = time.perf_counter()
        ctrl = run.reference(raw, dtype=torch.bfloat16)
        points = check.tree_points(run.cell.mix, ctrl.winner, s)
        ref = run.reference(raw, tree_points=points, winner=ctrl.winner)
        vals = check.numbers(ctrl, ref)
        print(json.dumps({"kind": "control", "seed": s,
                          "seconds": time.perf_counter() - t0,
                          "winner": [ctrl.winner[0], ctrl.winner[1]],
                          "numbers": vals}), flush=True)
    return 0


def main(argv=None, t_start=None, root=None, bench_dir=None, device="cuda",
         rows=None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse(argv)
    cell = catalog.load_cell(args.workload,
                             root=Path(root or catalog.ROOT),
                             bench_dir=Path(bench_dir or catalog.BENCH_DIR))
    return run_cell(args, cell, t_start, device=device, rows=rows)


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
