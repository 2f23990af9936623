"""Project generator + registry CLI.

Counterpart of the reference cli module (reference: cli/src/main/scala/com/
salesforce/op/cli/ - CliExec.scala `op gen`, SchemaSource.scala auto-infer,
ProblemKind.scala, the gen/templates/simple project template): infer a
schema from CSV (or read an avro .avsc), infer the problem kind FROM THE
RESPONSE DATA (cardinality + type, ProblemKind semantics), and render a
ready-to-run multi-file python project wired to this framework:

    python -m transmogrifai_tpu_torch.cli gen --input data.csv --response y \
        --name MyApp --output ./myapp [--kind binary|multiclass|regression]
        [--override col=PickList ...] [--id-col id]

Generated project: main.py (train + summary), score.py (load + batch
score), serve.py (micro-batched serving endpoint + telemetry),
params.json (OpParams), test_smoke.py (pytest e2e on a sample),
README.md.

Model-lifecycle commands over a versioned registry (registry/; alias
``tx`` for ``python -m transmogrifai_tpu_torch.cli``):

    tx registry list     --root ./registry            # versions + stages
    tx registry verify   --root ./registry [--version vN]
    tx registry promote  --root ./registry --version vN [--to stable|canary]
    tx registry rollback --root ./registry [--version vN] [--reason ...]

Each prints one JSON document; ``verify`` exits non-zero when any
checksum fails (the prior version must still verify after a crashed
publish).

Observability commands over the unified plane (obs/; artifacts written
by the runner's ``metrics_path`` knob or ``obs.export_obs``):

    tx obs metrics --path <dir-or-metrics.json> [--format prometheus|json]
    tx obs trace   --path <dir-or-spans.jsonl> [--trace-id ID] [--slowest N]

``metrics`` renders a saved registry document as Prometheus text
exposition (the SAME renderer a live scrape uses) or JSON; ``trace``
reconstructs span trees from a JSONL export, optionally only the
slowest N roots (the profiler's p99-exemplar view, offline).

Fleet commands over the scale-out serving fleet (fleet/):

    tx fleet status --path <control-or-agg-dir>   # one fleet document
    tx fleet drain  --path <control-dir> --replica replica-1 [--undrain]

``status`` prefers the controller's atomically-published
``fleet_status.json`` (per-replica generation, heartbeat age,
in-flight, restart budget) and falls back to assembling the view from
the obs aggregation shards; ``drain`` queues a command file the live
controller applies (the router stops dispatching to the replica while
it stays warm - the manual half of a rolling deploy).  On a
multi-model fleet both paths carry per-model rows - hosted
version, residency, cold hits, any in-flight canary - and the
placement plan.

Continuous training and bulk scoring:

    tx continuous status --path <status-dir>
    tx bulk status <job-dir>                  # exit 1 on a torn journal

The generated project runs on the card by default (``OpWorkflow()``):
its ``build_workflow(device="cuda")`` takes the device, and its
``test_smoke.py`` asks for the CPU.
"""
from __future__ import annotations

import argparse
import json
import os
import re
from typing import Optional

from .readers.csv_reader import CSVReader
from .types import feature_types as ft

_SELECTOR = {
    "binary": "BinaryClassificationModelSelector",
    "multiclass": "MultiClassificationModelSelector",
    "regression": "RegressionModelSelector",
}
_EVAL = {
    "binary": ("binary", "OpBinaryClassificationEvaluator"),
    "multiclass": ("multiclass", "OpMultiClassificationEvaluator"),
    "regression": ("regression", "OpRegressionEvaluator"),
}

_EMAIL_RE = re.compile(r"^[^@\s]+@[^@\s]+\.[^@\s]+$")
_URL_RE = re.compile(r"^(https?|ftp)://\S+$", re.IGNORECASE)
_PHONE_RE = re.compile(r"^[+()\d][\d\s().-]{6,18}$")


def _refine_text_type(values: list) -> type:
    """Pattern-refine inferred Text columns (reference: SchemaSource
    auto-infer heuristics): emails/urls/phones/low-cardinality picklists."""
    sample = [v for v in values if isinstance(v, str)][:500]
    if not sample:
        return ft.Text
    if all(_EMAIL_RE.match(v) for v in sample):
        return ft.Email
    if all(_URL_RE.match(v) for v in sample):
        return ft.URL
    if sum(bool(_PHONE_RE.match(v)) for v in sample) >= 0.9 * len(sample):
        return ft.Phone
    distinct = len(set(sample))
    if distinct <= max(20, len(sample) // 20):
        return ft.PickList
    return ft.Text


def _is_missing_label(v) -> bool:
    """Shared missing-label rule for kind inference AND the dirty-response
    gate: None, or any value that PARSES to a non-finite number - which
    deliberately includes the textual placeholders 'nan'/'inf'/'1e999'
    even in otherwise-text label columns (they are missing-data markers,
    as pandas also treats them, never legitimate classes).  Text that does
    not parse as a number is never missing."""
    import math

    if v is None:
        return True
    try:
        return not math.isfinite(float(v))
    except (TypeError, ValueError):
        return False


def infer_problem_kind(values: list) -> tuple[str, list]:
    """ProblemKind.scala semantics: the response's distinct values decide.
    Returns (kind, labels) - labels non-empty when the response needs
    indexing: non-numeric classes always; numeric classes whenever they
    are not already the canonical 0..k-1 encoding (e.g. {1,2} binary or
    {1,3,7} multiclass must be re-indexed, not fed raw into log-loss)."""
    present = [v for v in values if not _is_missing_label(v)]
    numeric = []
    for v in present:
        try:
            numeric.append(float(v))
        except (TypeError, ValueError):
            numeric = None
            break
    if numeric is not None and not numeric:
        raise ValueError(
            "response column has no usable values (all missing or "
            "non-finite); cannot infer a problem kind"
        )
    if numeric is not None:
        distinct = sorted(set(numeric))
        canonical = distinct == [float(i) for i in range(len(distinct))]
        if len(distinct) == 2:
            return "binary", ([] if canonical else distinct)
        if (
            len(distinct) <= 30
            and all(float(v).is_integer() for v in distinct)
        ):
            return "multiclass", ([] if canonical else distinct)
        return "regression", []
    labels = sorted({str(v) for v in present})
    return ("binary" if len(labels) == 2 else "multiclass"), labels


# ---------------------------------------------------------------------------
# templates
# ---------------------------------------------------------------------------
_MAIN_TEMPLATE = '''"""{name}: generated by transmogrifai_tpu_torch `gen` (edit freely)."""
import json
import os

import transmogrifai_tpu_torch.dsl  # noqa: F401 - enables feature operators
from transmogrifai_tpu_torch import FeatureBuilder, OpWorkflow
from transmogrifai_tpu_torch.evaluators.{eval_mod} import {eval_cls}
from transmogrifai_tpu_torch.ops.transmogrifier import transmogrify
from transmogrifai_tpu_torch.readers.csv_reader import CSVReader
from transmogrifai_tpu_torch.selector.factories import {selector}
from transmogrifai_tpu_torch.types import feature_types as ft
from transmogrifai_tpu_torch.workflow.runner import OpWorkflowRunner

HERE = os.path.dirname(os.path.abspath(__file__))
DATA_PATH = {data_path!r}
MODEL_DIR = os.path.join(HERE, "model")
{labels_block}
# -- raw feature definitions (inferred; adjust types as needed) -------------
{feature_defs}

def build_workflow(device="cuda"):
    predictors = [{predictor_names}]
{label_wiring}
    features = transmogrify(predictors)
    checked = label.sanity_check(features, remove_bad_features=True)
    prediction = (
        {selector}.with_cross_validation(num_folds=3)
        .set_input(label, checked)
        .get_output()
    )
    with open(os.path.join(HERE, "params.json")) as f:
        run_params = json.load(f)
    wf = (
        OpWorkflow(device=device)
        .set_result_features(prediction)
        .set_reader(CSVReader(DATA_PATH))
        .set_parameters(**run_params)
    )
    return wf, prediction, {eval_cls}()


def main():
    wf, prediction, evaluator = build_workflow()
    runner = OpWorkflowRunner(wf, evaluator=evaluator)
    result = runner.run("train")
    print(result.model.summary_pretty())
    result.model.save(MODEL_DIR)
    print(f"model saved to {{MODEL_DIR}}")


if __name__ == "__main__":
    main()
'''

_SCORE_TEMPLATE = '''"""Batch scorer for {name}: loads the trained model and scores a CSV.

The scored CSV does NOT need the response column - missing raw features
(typically the label on production data) are filled as nulls.
"""
import sys

from transmogrifai_tpu_torch.readers.csv_reader import CSVReader
from transmogrifai_tpu_torch.workflow.workflow import OpWorkflowModel

from main import MODEL_DIR, build_workflow


def main():
    csv_path = sys.argv[1] if len(sys.argv) > 1 else None
    wf, prediction, _ = build_workflow()
    model = OpWorkflowModel.load(MODEL_DIR, wf)
    if csv_path:
        raw = CSVReader(csv_path).read_raw()
        n = len(next(iter(raw.values()))) if raw else 0
        data = {{f.name: raw.get(f.name, [None] * n)
                for f in wf.raw_features}}
    else:
        data = wf.generate_raw_data()
    scored = model.score(data)
    col = scored[prediction.name]
    for row in col.to_list()[:20]:
        print(row)
    print(f"... scored {{len(col)}} rows")


if __name__ == "__main__":
    main()
'''

_SERVE_TEMPLATE = '''"""Serving loop for {name}: compiled endpoint + micro-batcher.

Loads the trained model, compiles the batch-first serving endpoint
(shape-bucketed, warmed), pumps the rows of a CSV through the
micro-batching scheduler as individual requests, and prints the
latency/throughput telemetry (p50/p95/p99, rows/s, batch fill).
"""
import json
import sys

from transmogrifai_tpu_torch.serving import (
    MicroBatchScheduler,
    RowScoringError,
    compile_endpoint,
)
from transmogrifai_tpu_torch.readers.csv_reader import CSVReader
from transmogrifai_tpu_torch.workflow.workflow import OpWorkflowModel

from main import DATA_PATH, MODEL_DIR, build_workflow


def main():
    csv_path = sys.argv[1] if len(sys.argv) > 1 else DATA_PATH
    wf, prediction, _ = build_workflow()
    model = OpWorkflowModel.load(MODEL_DIR, wf)
    raw = CSVReader(csv_path).read_raw()
    n = len(next(iter(raw.values()))) if raw else 0
    records = [
        {{f.name: raw.get(f.name, [None] * n)[i] for f in wf.raw_features}}
        for i in range(n)
    ]
    endpoint = compile_endpoint(model)
    with MicroBatchScheduler(endpoint, max_wait_us=2000) as scheduler:
        results = list(scheduler.score_stream(records, window=256))
    failed = sum(isinstance(r, RowScoringError) for r in results)
    print(f"served {{len(results)}} rows ({{failed}} failed)")
    print(json.dumps(endpoint.telemetry.snapshot(), indent=1))


if __name__ == "__main__":
    main()
'''

_TEST_TEMPLATE = '''"""Smoke test for the generated {name} project."""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def test_trains_and_scores(tmp_path):
    import main as app

    wf, prediction, evaluator = app.build_workflow(device="cpu")
    model = wf.train()
    scored = model.score(wf.generate_raw_data())
    assert prediction.name in scored
    model.save(str(tmp_path / "model"))
'''

_README_TEMPLATE = """# {name}

Generated by `python -m transmogrifai_tpu_torch.cli gen` - a {kind} AutoML
project on `{data_basename}` (response: `{response}`).

## Commands

- `python main.py` - train (3-fold CV model selection), print the model
  summary, save the fitted model to `./model/`
- `python score.py [other.csv]` - load the saved model and batch-score
- `python serve.py [other.csv]` - micro-batched serving loop with
  latency/throughput telemetry (p50/p95/p99, rows/s)
- `python -m pytest test_smoke.py` - end-to-end smoke test

## Files

- `main.py` - feature definitions (edit the inferred types freely) + train
- `params.json` - OpParams run configuration (test fraction, seeds)
- `score.py` - engine-free batch scoring against the saved model
- `serve.py` - compiled serving endpoint behind the micro-batch scheduler
"""


def _avsc_to_schema(path: str) -> dict:
    with open(path) as f:
        doc = json.load(f)
    mapping = {
        "int": ft.Integral, "long": ft.Integral, "float": ft.Real,
        "double": ft.Real, "boolean": ft.Binary, "string": ft.Text,
    }
    schema = {}
    for field in doc.get("fields", []):
        t = field["type"]
        if isinstance(t, list):
            t = next((x for x in t if x != "null"), "string")
        schema[field["name"]] = mapping.get(t, ft.Text)
    return schema


# -- interactive question dialogue (reference: cli/gen/Ops.scala UserIO +
# CliParameters.answersFile) -------------------------------------------------
def load_answers(path: str) -> dict[str, str]:
    """Answers file: 'question-prefix => answer' lines (reference
    Ops.scala:90-102); prefixes match lowercased question starts, so the
    same file drives a scripted non-interactive generation."""
    out: dict[str, str] = {}
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            stripped = line.strip()
            if not stripped or stripped.startswith("#"):
                continue
            if "=>" not in stripped:
                # malformed lines must not silently vanish: a dropped
                # entry turns a scripted run interactive
                raise ValueError(
                    f"{path}:{lineno}: expected 'prefix => answer', "
                    f"got {stripped!r}"
                )
            k, v = stripped.split("=>", 1)
            out[k.strip().lower()] = v.strip()
    return out


def ask(question, options, answers=None, input_fn=input, strict=False):
    """Indexed-choice prompt (reference Ops.scala ask: 'Q? [0] a [1] b:').

    ``options``: list of (value, [aliases...]) - the first alias is
    displayed; the index or any alias (case-insensitive) is accepted;
    invalid input re-prompts.  ``answers`` short-circuits stdin by
    lowercased question prefix, exactly like the reference's answers
    file."""
    normalized: dict[str, object] = {}
    descs = []
    for i, (value, aliases) in enumerate(options):
        if not aliases:
            raise ValueError("ask needs at least one alias per option")
        descs.append(f"[{i}] {aliases[0]}")
        normalized[str(i)] = value
        for a in aliases:
            normalized[a.lower()] = value
    q = question + " " + " ".join(descs) + ": "
    ql = question.strip().lower()
    if answers is not None:  # {} is still a scripted run: strict applies
        # layered prefixes: the FIRST matching entry with a VALID answer
        # wins (an earlier broader prefix with an answer outside this
        # question's options defers to a later, more specific one)
        matched = []
        for prefix, ans in answers.items():
            if ql.startswith(prefix):
                matched.append((prefix, ans))
                key = ans.strip().lower()
                if key in normalized:
                    return normalized[key]
        if strict:
            # purely scripted runs must fail fast, not block on stdin
            if matched:
                raise ValueError(
                    f"answers file maps {matched[0][0]!r} to invalid "
                    f"answer {matched[0][1]!r} for question: {question}"
                )
            raise ValueError(
                f"answers file has no entry for question: {question}"
            )
    while True:
        try:
            resp = input_fn(q)
        except EOFError:
            raise ValueError(
                f"no answer available for question: {question}"
            ) from None
        key = str(resp).strip().lower()
        if key in normalized:
            return normalized[key]


def generate(
    input_path: str,
    response: str,
    name: str,
    output: str,
    kind: Optional[str] = None,
    overrides: Optional[dict] = None,
    id_col: Optional[str] = None,
    interactive: bool = False,
    answers: Optional[dict] = None,
    input_fn=input,
    strict_answers: Optional[bool] = None,
) -> str:
    # strict answers = fail fast on an unanswerable question rather than
    # falling through to a stdin prompt that could block a scripted run
    # forever.  Default: strict exactly when an answers map drives the
    # dialogue; callers who combine --interactive with a PARTIAL answers
    # file pass strict_answers=False to get prompted for the rest.
    if strict_answers is None:
        strict_answers = answers is not None
    raw_values: dict[str, list] = {}
    if input_path.endswith(".avsc"):
        schema = _avsc_to_schema(input_path)
        data_path = input_path[: -len(".avsc")] + ".avro"
    else:
        reader = CSVReader(input_path)
        raw_values = reader.read_raw()  # one parse: schema derives from it
        schema = reader.infer_schema(raw_values)
        data_path = input_path
        # pattern-refine text columns (emails/urls/phones/picklists)
        for col, t in list(schema.items()):
            if t is ft.Text and col in raw_values:
                schema[col] = _refine_text_type(raw_values[col])
    for col, t in (overrides or {}).items():
        if col not in schema:
            raise KeyError(f"override column {col!r} not in schema")
        schema[col] = t
    if response not in schema:
        raise KeyError(
            f"response {response!r} not found; columns: {sorted(schema)}"
        )

    if id_col is not None and id_col not in schema:
        raise KeyError(
            f"id column {id_col!r} not found; columns: {sorted(schema)}"
        )
    if id_col == response:
        raise ValueError("--id-col and --response cannot be the same column")

    # a dirty response corrupts training silently (missing / textual-nan
    # labels would collapse into class 0): demand a clean label column
    if response in raw_values:
        bad = sum(_is_missing_label(v) for v in raw_values[response])
        if bad:
            raise ValueError(
                f"response column {response!r} has {bad} missing/non-finite "
                f"values out of {len(raw_values[response])}; clean the data "
                "before generating (labels cannot be imputed)"
            )

    # interactive dialogue (reference ProblemKind.askKind + the id-field
    # question in ProblemSchema.scala): confirm the inferred kind and pick
    # the row-id column; an answers map scripts both
    if interactive:
        if kind is None:
            inferred = None
            if response in raw_values:
                inferred, _ = infer_problem_kind(raw_values[response])
            opts = []
            if inferred:
                opts.append((inferred, [inferred, "yes", "inferred"]))
            opts.extend(
                (k, [k]) for k in _SELECTOR if k != inferred
            )
            kind = ask(
                f"Problem kind for response '{response}'"
                + (f" (inferred: {inferred})" if inferred else ""),
                opts, answers=answers, input_fn=input_fn,
                strict=strict_answers,
            )
        if id_col is None:
            candidates = [c for c in schema if c != response]
            opts = [(None, ["none", "no id column"])] + [
                (c, [c]) for c in candidates
            ]
            id_col = ask(
                "Which column is the row id (excluded from predictors)?",
                opts, answers=answers, input_fn=input_fn,
                strict=strict_answers,
            )

    labels: list = []
    if kind is None:
        if response in raw_values:
            kind, labels = infer_problem_kind(raw_values[response])
        else:
            kind = "regression" if schema[response] is ft.Real else "binary"
    elif response in raw_values:
        _, labels = infer_problem_kind(raw_values[response])
        if kind == "regression":
            labels = []
    numeric_labels = bool(labels) and isinstance(labels[0], float)

    eval_mod, eval_cls = _EVAL[kind]

    # names owned by the generated module/function - feature variables must
    # never shadow them (a response column literally named 'label' is
    # common), and every emitted name must be a unique valid identifier
    import keyword

    reserved = {
        "label", "predictors", "features", "checked", "prediction", "wf",
        "run_params", "main", "build_workflow", "f", "json", "os", "ft",
        "transmogrify", "FeatureBuilder", "OpWorkflow", "CSVReader",
        "OpWorkflowRunner", "LABELS", "DATA_PATH", "MODEL_DIR", "HERE",
    }
    used: set[str] = set()

    def _var_for(col: str) -> str:
        # per-char identifier test: isalnum() admits characters like '²'
        # that are not valid in identifiers
        var = "".join(
            c if ("_" + c).isidentifier() else "_" for c in col
        ).lower()
        if not var.isidentifier():
            # leading digit or identifier-continue-only start (e.g. a
            # combining mark): a letter prefix makes every kept char legal
            var = "c_" + var
        while keyword.iskeyword(var) or var in reserved or var in used:
            var += "_"
        used.add(var)
        return var

    defs, pred_names = [], []
    response_var = None
    for col, t in sorted(schema.items()):
        if col == id_col:
            continue  # row keys never become predictors
        var = _var_for(col)
        if col == response:
            response_var = var
            rtype = "RealNN" if (not labels or numeric_labels) else "PickList"
            defs.append(
                f"{var} = FeatureBuilder(ft.{rtype}, {col!r}).as_response()"
            )
        else:
            defs.append(
                f"{var} = FeatureBuilder(ft.{t.__name__}, {col!r})"
                ".as_predictor()"
            )
            pred_names.append(var)

    if labels:
        labels_block = f"LABELS = {labels!r}\n"
        # unseen labels (absent from the generation-time sample) map to
        # None rather than crashing a retrain/score on fuller data;
        # numeric class values compare as floats
        probe = "float(v)" if numeric_labels else "v"
        label_wiring = (
            f"    label = {response_var}.map_values(\n"
            f"        lambda v: float(LABELS.index({probe}))"
            f" if v is not None and {probe} in LABELS else None,\n"
            "        ft.RealNN,\n    )"
        )
    else:
        labels_block = ""
        label_wiring = f"    label = {response_var}"

    os.makedirs(output, exist_ok=True)
    files = {
        "main.py": _MAIN_TEMPLATE.format(
            name=name,
            data_path=os.path.abspath(data_path),
            feature_defs="\n".join(defs),
            predictor_names=", ".join(pred_names),
            labels_block=labels_block,
            label_wiring=label_wiring,
            selector=_SELECTOR[kind],
            eval_mod=eval_mod,
            eval_cls=eval_cls,
        ),
        "score.py": _SCORE_TEMPLATE.format(name=name),
        "serve.py": _SERVE_TEMPLATE.format(name=name),
        "test_smoke.py": _TEST_TEMPLATE.format(name=name),
        "params.json": json.dumps(
            {"reserve_test_fraction": 0.1, "split_seed": 42}, indent=2
        ),
        "README.md": _README_TEMPLATE.format(
            name=name, kind=kind, response=response,
            data_basename=os.path.basename(data_path),
        ),
    }
    for fname, content in files.items():
        with open(os.path.join(output, fname), "w") as f:
            f.write(content)
    return os.path.join(output, "main.py")


def _parse_override(s: str) -> tuple[str, type]:
    col, _, tname = s.partition("=")
    if not tname:
        raise argparse.ArgumentTypeError(
            f"override must be col=FeatureType, got {s!r}"
        )
    try:
        t = ft.feature_type_by_name(tname)
    except KeyError as e:
        raise argparse.ArgumentTypeError(str(e)) from e
    return col, t


# ---------------------------------------------------------------------------
# observability commands (obs/: metrics exposition + span trees + SLOs)
# ---------------------------------------------------------------------------
def _obs_resolve(path: str, default_name: str) -> str:
    """Accept either the export directory (the ``metrics_path`` knob's
    output) or the file itself."""
    if os.path.isdir(path):
        return os.path.join(path, default_name)
    return path


def _is_agg_dir(path: str) -> bool:
    """A fleet aggregation dir: per-process ``*.obsshard.json`` files
    (obs.fleet shippers) rather than a single-process export."""
    from .obs.fleet import SHARD_SUFFIX

    if not os.path.isdir(path):
        return False
    try:
        return any(n.endswith(SHARD_SUFFIX) for n in os.listdir(path))
    except OSError:
        return False


def _obs_load_spans(args) -> tuple[list, int, Optional[dict]]:
    """-> (records, lines_skipped, fleet_report).  An aggregation dir
    merges every live shard's spans (dead processes age out, torn
    shards are counted); a plain export reads spans.jsonl through the
    torn-read-safe loader - a process killed mid-export truncates its
    LAST line, which must cost one span, not the whole read."""
    from .obs.fleet import FleetAggregator, read_jsonl_tolerant

    if _is_agg_dir(args.path):
        agg = FleetAggregator(args.path,
                              stale_after_s=args.stale_after_s)
        return agg.merged_spans(), 0, dict(agg.last_report)
    records, skipped = read_jsonl_tolerant(
        _obs_resolve(args.path, "spans.jsonl"))
    return records, skipped, None


def _obs_main(args) -> int:
    from .obs import build_trees, prometheus_text_from_json
    from .obs.fleet import FleetAggregator

    if args.obs_cmd == "metrics":
        if _is_agg_dir(args.path):
            agg = FleetAggregator(args.path,
                                  stale_after_s=args.stale_after_s)
            if args.format == "prometheus":
                print(agg.prometheus_text(), end="")
            else:
                print(json.dumps(agg.to_json(), indent=1, sort_keys=True,
                                 default=str))
            return 0
        path = _obs_resolve(args.path, "metrics.json")
        try:
            with open(path) as f:
                doc = json.load(f)
        except (OSError, ValueError) as e:
            print(json.dumps({"error": f"{type(e).__name__}: {e}"}))
            return 2
        if args.format == "prometheus":
            print(prometheus_text_from_json(doc), end="")
        else:
            print(json.dumps(doc, indent=1, sort_keys=True, default=str))
        return 0
    if args.obs_cmd == "trace":
        try:
            records, skipped, fleet_report = _obs_load_spans(args)
        except OSError as e:
            print(json.dumps({"error": f"{type(e).__name__}: {e}"}))
            return 2
        if args.trace_id:
            records = [r for r in records if r.get("trace") == args.trace_id]
        trees = build_trees(records)
        if args.slowest:
            trees = sorted(
                trees, key=lambda t: -float(t.get("wall_ms", 0.0))
            )[: args.slowest]
        out = {
            "spans": len(records),
            "roots": len(trees),
            "lines_skipped": skipped,
            "trees": trees,
        }
        if fleet_report is not None:
            out["fleet"] = fleet_report
        print(json.dumps(out, indent=1, sort_keys=True, default=str))
        return 0
    if args.obs_cmd == "slo":
        from .obs.slo import SLOEngine, default_objectives, load_slo_config

        try:
            objectives = (load_slo_config(args.config) if args.config
                          else default_objectives())
            if _is_agg_dir(args.path):
                agg = FleetAggregator(args.path,
                                      stale_after_s=args.stale_after_s)
                docs = agg.merged_metrics_docs()
            else:
                with open(_obs_resolve(args.path, "metrics.json")) as f:
                    docs = json.load(f)
        except (OSError, ValueError) as e:
            print(json.dumps({"error": f"{type(e).__name__}: {e}"}))
            return 2
        # one-shot evaluation: cumulative totals ARE the window (the
        # engine's baseline-less fallback), so a saved artifact whose
        # lifetime error ratio blew the objective reads as firing
        engine = SLOEngine(objectives, register=False)
        engine.observe(docs)
        report = engine.report()
        print(json.dumps(report, indent=1, sort_keys=True, default=str))
        return 1 if report["firing"] else 0
    raise AssertionError(f"unhandled obs command {args.obs_cmd}")


def _add_obs_parser(sub) -> None:
    o = sub.add_parser("obs", help="unified observability plane "
                                   "(metrics exposition, span trees, "
                                   "SLO evaluation)")
    osub = o.add_subparsers(dest="obs_cmd", required=True)
    m = osub.add_parser("metrics",
                        help="render an exported metrics document or a "
                             "fleet aggregation dir")
    m.add_argument("--path", required=True,
                   help="export dir (metrics_path knob), metrics.json, "
                        "or a fleet aggregation dir (obsshard files)")
    m.add_argument("--format", choices=("prometheus", "json"),
                   default="prometheus")
    t = osub.add_parser("trace", help="reconstruct span trees from a "
                                      "spans.jsonl export or a fleet "
                                      "aggregation dir")
    t.add_argument("--path", required=True,
                   help="export dir (metrics_path knob), spans.jsonl, "
                        "or a fleet aggregation dir")
    t.add_argument("--trace-id", default=None,
                   help="only this trace id")
    t.add_argument("--slowest", type=int, default=None, metavar="N",
                   help="only the N slowest root spans")
    s = osub.add_parser("slo", help="evaluate declarative SLOs against "
                                    "exported/aggregated metrics "
                                    "(exit 1 when any alert fires)")
    s.add_argument("--path", required=True,
                   help="export dir, metrics.json, or aggregation dir")
    s.add_argument("--config", default=None,
                   help="SLO config JSON ({'slos': [...]}); default: "
                        "the built-in serving objectives")
    for cmd in (m, t, s):
        cmd.add_argument("--stale-after-s", type=float, default=None,
                         dest="stale_after_s", metavar="S",
                         help="aggregation-dir heartbeat staleness "
                              "cutoff (default TX_OBS_FLEET_STALE_S/60)")


# ---------------------------------------------------------------------------
# autotune commands (autotune/: cost model + decision trails)
# ---------------------------------------------------------------------------
def _autotune_main(args) -> int:
    from .autotune import report_from_path

    if args.autotune_cmd == "report":
        try:
            doc = report_from_path(args.path)
        except (OSError, ValueError) as e:
            print(json.dumps({"error": f"{type(e).__name__}: {e}"}))
            return 2
        print(json.dumps(doc, indent=1, sort_keys=True, default=str))
        return 0
    raise AssertionError(f"unhandled autotune command {args.autotune_cmd}")


def _add_autotune_parser(sub) -> None:
    a = sub.add_parser(
        "autotune",
        help="cost-model-driven autotuning (selection pruning trails, "
             "cost-model state, tuned knobs)",
    )
    asub = a.add_subparsers(dest="autotune_cmd", required=True)
    r = asub.add_parser(
        "report",
        help="render the autotune decision trail: pruning rungs, "
             "predicted-vs-actual times, cost-model state, tuned knobs",
    )
    r.add_argument(
        "--path", required=True,
        help="a trained model directory (summary.json + autotune.json "
             "written by a train run with the autotune knob) or an obs "
             "export dir (metrics_path knob: metrics.json + spans.jsonl)",
    )


# ---------------------------------------------------------------------------
# fleet commands (fleet/: replica status + operator drain)
# ---------------------------------------------------------------------------
def _fleet_status_doc(path: str, stale_after_s=None) -> dict:
    """Build the fleet status document for ``path``: the controller's
    one consistent ``fleet_status.json`` when present (a control dir,
    a fleet work dir, or the file itself), else assembled from the obs
    aggregation shards (per-replica ``fleet`` info + serving views +
    heartbeat ages)."""
    from .fleet.controller import STATUS_FILENAME
    from .obs.fleet import (
        SHARD_SUFFIX,
        FleetAggregator,
        autoscaler_views,
        health_views,
        read_json_torn_safe,
        serving_views,
    )
    from .workflow.supervisor import staleness

    candidates = [path] if path.endswith(".json") else [
        os.path.join(path, STATUS_FILENAME),
        os.path.join(path, "control", STATUS_FILENAME),
    ]
    for cand in candidates:
        if os.path.exists(cand):
            doc = read_json_torn_safe(cand)
            if doc is not None:
                return {"source": cand, "status": doc}
            raise ValueError(f"{cand}: torn/unreadable status document")
    for agg_path in (path, os.path.join(path, "obs")):
        if _is_agg_dir(agg_path):
            agg = FleetAggregator(agg_path, stale_after_s=stale_after_s)
            shards = agg.shards()
            # the router's own shard (ship_router_obs) carries the
            # fleet_health view: per-replica transport-health columns
            # (ejected/probing/healthy, consecutive failures, last RTT)
            # from ONE consistent document, no shard re-reads
            health_by_replica: dict = {}
            fleet_health: dict = {}
            autoscaler: dict = {}
            for shard in shards:
                for _key, snap in health_views(
                        shard.get("metrics", {})):
                    for inst, h in (snap.get("replicas") or {}).items():
                        health_by_replica[str(inst)] = h
                    fleet_health = {k: v for k, v in snap.items()
                                    if k != "replicas"}
                # the capacity control loop ships one
                # autoscaler view from wherever it runs; fold the
                # freshest one in as its own status column
                for _key, snap in autoscaler_views(
                        shard.get("metrics", {})):
                    if snap.get("steps", 0) >= autoscaler.get(
                            "steps", -1):
                        autoscaler = snap
            replicas = {}
            for shard in shards:
                inst = str(shard.get("instance"))
                if inst == "router":
                    continue  # its health view is folded in above
                shard_file = os.path.join(agg_path,
                                          inst + SHARD_SUFFIX)
                serving = {}
                for _key, snap in serving_views(
                        shard.get("metrics", {})):
                    if snap.get("rows_scored", 0) >= serving.get(
                            "rows_scored", -1):
                        serving = {
                            "version": snap.get("model_version"),
                            "generation": snap.get("generation"),
                            "rows_scored": snap.get("rows_scored"),
                            "rows_per_s": snap.get("rows_per_s"),
                            "p99_ms": (snap.get("latency_ms")
                                       or {}).get("p99"),
                        }
                age = staleness(shard_file)
                replicas[inst] = {
                    "heartbeat_age_s": (None if age is None
                                        else round(age, 3)),
                    "fleet": shard.get("fleet"),
                    "serving": serving or None,
                    "health": health_by_replica.get(inst),
                }
            out = {"source": agg_path,
                   "shards": dict(agg.last_report),
                   "replicas": replicas}
            models = _fold_model_rows(replicas)
            if models:
                out["models"] = models
            if fleet_health:
                out["fleet_health"] = fleet_health
            if autoscaler:
                out["autoscaler"] = autoscaler
            return out
    raise ValueError(
        f"{path!r} holds neither a fleet status document nor an obs "
        "aggregation dir")


def _fold_model_rows(replicas: dict) -> dict:
    """Per-model aggregate rows from each replica's
    ``fleet.models`` table rows: where it is hosted/resident, the
    summed row/cold-hit counters, any in-flight canary."""
    models: dict = {}
    for inst in sorted(replicas):
        fleet = replicas[inst].get("fleet") or {}
        for row in fleet.get("models") or []:
            mid = str(row.get("model_id"))
            m = models.setdefault(mid, {
                "version": row.get("version"),
                "hosts": [], "resident_on": [], "evicted_on": [],
                "rows_scored": 0, "cold_hits": 0, "rehydrations": 0,
                "canary_version": None,
            })
            m["hosts"].append(inst)
            m["resident_on" if row.get("resident")
              else "evicted_on"].append(inst)
            m["rows_scored"] += int(row.get("rows_scored") or 0)
            m["cold_hits"] += int(row.get("cold_hits") or 0)
            m["rehydrations"] += int(row.get("rehydrations") or 0)
            if row.get("canary_version"):
                m["canary_version"] = row["canary_version"]
    return models


def _fleet_main(args) -> int:
    from .fleet.controller import COMMANDS_DIR

    if args.fleet_cmd == "status":
        try:
            doc = _fleet_status_doc(args.path,
                                    stale_after_s=args.stale_after_s)
        except (OSError, ValueError) as e:
            print(json.dumps({"error": f"{type(e).__name__}: {e}"}))
            return 2
        print(json.dumps(doc, indent=1, sort_keys=True, default=str))
        return 0
    if args.fleet_cmd == "drain":
        import tempfile
        import time as _time

        cdir = os.path.join(args.path, COMMANDS_DIR)
        try:
            os.makedirs(cdir, exist_ok=True)
            doc = {"replica": args.replica,
                   "drain": not args.undrain,
                   "t": _time.time()}
            # atomic drop: the controller's poll must never read a torn
            # command and apply half an intention
            fd, tmp = tempfile.mkstemp(dir=cdir, suffix=".tmp")
            with os.fdopen(fd, "w") as f:
                json.dump(doc, f)
            os.replace(tmp, os.path.join(cdir, args.replica + ".json"))
        except OSError as e:
            print(json.dumps({"error": f"{type(e).__name__}: {e}"}))
            return 2
        print(json.dumps({"queued": doc,
                          "path": os.path.join(cdir,
                                               args.replica + ".json")}))
        return 0
    raise AssertionError(f"unhandled fleet command {args.fleet_cmd}")


def _add_fleet_parser(sub) -> None:
    f = sub.add_parser(
        "fleet",
        help="scale-out serving fleet (replica status, operator drain)")
    fsub = f.add_subparsers(dest="fleet_cmd", required=True)
    s = fsub.add_parser(
        "status",
        help="one consistent fleet document: per-replica generation, "
             "heartbeat age, in-flight, router counters")
    s.add_argument("--path", required=True,
                   help="fleet control dir (fleet_status.json), fleet "
                        "work dir, or obs aggregation dir")
    s.add_argument("--stale-after-s", type=float, default=None,
                   dest="stale_after_s", metavar="S",
                   help="shard heartbeat staleness cutoff when reading "
                        "an aggregation dir")
    d = fsub.add_parser(
        "drain",
        help="queue a drain (or --undrain) command the fleet "
             "controller applies: the router stops dispatching to the "
             "replica while it stays warm")
    d.add_argument("--path", required=True,
                   help="fleet control dir (the controller polls its "
                        "commands/ subdirectory)")
    d.add_argument("--replica", required=True,
                   help="replica instance name, e.g. replica-1")
    d.add_argument("--undrain", action="store_true",
                   help="resume dispatch to the replica")


# ---------------------------------------------------------------------------
# continuous commands (continuous/: drift-triggered refit controller)
# ---------------------------------------------------------------------------
def _continuous_status_doc(path: str) -> dict:
    """The continuous trainer's atomically-published status document:
    ``path`` may be the ``continuous_status.json`` file itself or a
    directory holding one (the trainer's status dir / watch dir)."""
    from .continuous import STATUS_FILENAME
    from .obs.fleet import read_json_torn_safe

    candidates = [path] if path.endswith(".json") else [
        os.path.join(path, STATUS_FILENAME),
    ]
    for cand in candidates:
        if os.path.exists(cand):
            doc = read_json_torn_safe(cand)
            if doc is not None:
                return {"source": cand, "status": doc}
            raise ValueError(f"{cand}: torn/unreadable status document")
    raise ValueError(
        f"{path!r} holds no continuous status document "
        f"({STATUS_FILENAME})")


def _continuous_main(args) -> int:
    if args.continuous_cmd == "status":
        try:
            doc = _continuous_status_doc(args.path)
        except (OSError, ValueError) as e:
            print(json.dumps({"error": f"{type(e).__name__}: {e}"}))
            return 2
        print(json.dumps(doc, indent=1, sort_keys=True, default=str))
        return 0
    raise AssertionError(
        f"unhandled continuous command {args.continuous_cmd}")


def _add_continuous_parser(sub) -> None:
    c = sub.add_parser(
        "continuous",
        help="drift-triggered continuous training loop (cycle "
             "counters, governor state, last cycle verdict)")
    csub = c.add_subparsers(dest="continuous_cmd", required=True)
    s = csub.add_parser(
        "status",
        help="the trainer's atomically-published status document: "
             "cycles/refits/promotes/rollbacks, hysteresis + cooldown "
             "state, last cycle trace id")
    s.add_argument("--path", required=True,
                   help="continuous status dir (continuous_status.json)"
                        " or the file itself")


# ---------------------------------------------------------------------------
# bulk scoring commands (bulk/: exactly-once checkpointed batch inference)
# ---------------------------------------------------------------------------
def _bulk_main(args) -> int:
    from .bulk import BulkJournal, TornJournalError

    if args.bulk_cmd == "status":
        try:
            doc = BulkJournal.load(args.job_dir).status_doc()
        except TornJournalError as e:
            # exit 1 is the torn-journal verdict an operator scripts
            # against (both the primary and .last-good failed their
            # checksums) - everything else is a plain error (2)
            print(json.dumps({"error": f"TornJournalError: {e}"}))
            return 1
        except (OSError, ValueError) as e:
            print(json.dumps({"error": f"{type(e).__name__}: {e}"}))
            return 2
        print(json.dumps(doc, indent=1, sort_keys=True, default=str))
        return 0
    raise AssertionError(f"unhandled bulk command {args.bulk_cmd}")


def _add_bulk_parser(sub) -> None:
    b = sub.add_parser(
        "bulk",
        help="exactly-once bulk scoring jobs (checkpointed journal, "
             "kill-survivable resume)")
    bsub = b.add_subparsers(dest="bulk_cmd", required=True)
    s = bsub.add_parser(
        "status",
        help="the job journal as JSON: per-shard states, the "
             "double-entry row ledger, resume history; exit 1 when "
             "the journal (and its .last-good fallback) is torn")
    s.add_argument("job_dir", help="bulk job directory (holds journal.json)")


# ---------------------------------------------------------------------------
# registry commands (registry/: versioned store + lifecycle)
# ---------------------------------------------------------------------------
def _registry_main(args) -> int:
    from .registry import ModelRegistry, RegistryError

    try:
        reg = ModelRegistry(args.root, create=False)
    except RegistryError as e:
        print(json.dumps({"error": str(e)}))
        return 2
    try:
        if args.registry_cmd == "list":
            doc = reg.describe(lineage=args.lineage)
            print(json.dumps(doc, indent=1, sort_keys=True, default=str))
            return 0
        if args.registry_cmd == "verify":
            report = reg.verify(args.version)
            print(json.dumps(report, indent=1, sort_keys=True))
            return 0 if report["ok"] else 1
        if args.registry_cmd == "promote":
            entry = reg.promote(args.version, to=args.to)
            print(json.dumps(entry.to_json(), indent=1, sort_keys=True,
                             default=str))
            return 0
        if args.registry_cmd == "rollback":
            event = reg.rollback(version=args.version,
                                 reason=args.reason or "cli")
            print(json.dumps(event, indent=1, sort_keys=True, default=str))
            return 0
    except RegistryError as e:
        print(json.dumps({"error": str(e)}))
        return 2
    raise AssertionError(f"unhandled registry command {args.registry_cmd}")


def _add_registry_parser(sub) -> None:
    r = sub.add_parser("registry",
                       help="versioned model registry lifecycle")
    rsub = r.add_subparsers(dest="registry_cmd", required=True)
    for name, helptext in (
        ("list", "versions, stages, stable/canary pointers"),
        ("verify", "checksum-verify the index and artifacts"),
        ("promote", "candidate->canary or candidate/canary->stable"),
        ("rollback", "demote the canary (or revert stable to parent)"),
    ):
        c = rsub.add_parser(name, help=helptext)
        c.add_argument("--root", required=True,
                       help="registry root directory")
        if name == "list":
            c.add_argument("--lineage", action="store_true",
                           help="include the lineage event log")
        if name == "verify":
            c.add_argument("--version", default=None,
                           help="verify one version (default: all)")
        if name == "promote":
            c.add_argument("--version", required=True)
            c.add_argument("--to", choices=("stable", "canary"),
                           default="stable")
        if name == "rollback":
            c.add_argument("--version", default=None,
                           help="default: the live canary, else stable")
            c.add_argument("--reason", default=None)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="transmogrifai_tpu_torch.cli")
    sub = p.add_subparsers(dest="cmd", required=True)
    _add_registry_parser(sub)
    _add_obs_parser(sub)
    _add_autotune_parser(sub)
    _add_fleet_parser(sub)
    _add_continuous_parser(sub)
    _add_bulk_parser(sub)
    g = sub.add_parser("gen", help="generate a project from data")
    g.add_argument("--input", required=True, help="CSV or .avsc path")
    g.add_argument("--response", required=True)
    g.add_argument("--name", default="GeneratedApp")
    g.add_argument("--output", required=True)
    g.add_argument("--kind", choices=list(_SELECTOR), default=None,
                   help="problem kind (default: inferred from the response)")
    g.add_argument("--override", action="append", type=_parse_override,
                   default=[], metavar="COL=TYPE",
                   help="feature type override, e.g. cabin=PickList")
    g.add_argument("--id-col", default=None,
                   help="row-key column excluded from predictors")
    g.add_argument("--interactive", action="store_true",
                   help="ask the generator questions (problem kind, id "
                        "column) instead of relying on flags/inference")
    g.add_argument("--answers", default=None, metavar="FILE",
                   help="'question-prefix => answer' lines scripting the "
                        "interactive questions (reference: op gen "
                        "--answers)")
    args = p.parse_args(argv)
    if args.cmd == "registry":
        return _registry_main(args)
    if args.cmd == "obs":
        return _obs_main(args)
    if args.cmd == "autotune":
        return _autotune_main(args)
    if args.cmd == "fleet":
        return _fleet_main(args)
    if args.cmd == "continuous":
        return _continuous_main(args)
    if args.cmd == "bulk":
        return _bulk_main(args)
    answers = load_answers(args.answers) if args.answers else None
    path = generate(
        args.input, args.response, args.name, args.output, args.kind,
        overrides=dict(args.override), id_col=args.id_col,
        interactive=args.interactive or answers is not None,
        answers=answers,
        # explicit --interactive + partial --answers: prompt for the rest
        strict_answers=not args.interactive,
    )
    print(f"generated {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
