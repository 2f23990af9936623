"""The schema contract of the torch package against the JAX package's.

``SchemaContract.capture(...).to_json()`` is the same document on the same
columns (numeric, integral, picklist, text list and multi-picklist, with
missing values; below and above the capture's row cap), a document of
either package reads back in the other, ``collect_violations`` lists the
same violations on drifted records, the ``DriftMonitor`` scores the same
JS divergences, and ``OpWorkflow.train()`` captures the same contract (on
by default, off with ``schema_contract=False``).  The local scorer
enforces it under ``drift_policy="raise"``.
"""
import logging

import numpy as np
import pytest

from torch_parity import PORT, REF, mixed_pipeline, mod, reset_uids

from transmogrifai_tpu_torch.local import LocalScorer


def _columns(pkg: str, n: int, seed: int = 5):
    """(raw features, Dataset) of a mixed-type table in ``pkg``."""
    rng = np.random.RandomState(seed)
    fb = mod(pkg, "features.feature_builder").FeatureBuilder
    ft = mod(pkg, "types.feature_types")
    col = mod(pkg, "types.columns").column_from_list
    ds = mod(pkg, "types.dataset").Dataset
    values = {
        "y": (rng.rand(n) > 0.4).astype(float).tolist(),
        "x": [float(v) if rng.rand() > 0.1 else None
              for v in rng.randn(n) * 3 + 1],
        "k": [int(v) if rng.rand() > 0.2 else None
              for v in rng.randint(0, 7, n)],
        "c": [("red", "green", "blue", None)[rng.randint(4)]
              for _ in range(n)],
        "t": [tuple(rng.choice(["a", "b", "c"], rng.randint(0, 3)))
              for _ in range(n)],
        "m": [frozenset(rng.choice(["p", "q"], rng.randint(0, 2)))
              for _ in range(n)],
    }
    feats = [
        fb(ft.RealNN, "y").as_response(),
        fb(ft.Real, "x").as_predictor(),
        fb(ft.Integral, "k").as_predictor(),
        fb(ft.PickList, "c").as_predictor(),
        fb(ft.TextList, "t").as_predictor(),
        fb(ft.MultiPickList, "m").as_predictor(),
    ]
    data = ds({f.name: col(values[f.name], f.ftype) for f in feats})
    return feats, data


def _doc(contract) -> dict:
    doc = contract.to_json()
    doc.pop("captured_at")
    return doc


@pytest.mark.parametrize("n,max_rows", [(300, 100_000), (2_500, 1_000)])
def test_capture_document_matches_reference(n, max_rows):
    docs = []
    for pkg in (REF, PORT):
        feats, data = _columns(pkg, n)
        contract = mod(pkg, "schema.contract").SchemaContract.capture(
            feats, data, max_rows=max_rows)
        docs.append(_doc(contract))
    assert docs[1] == docs[0]
    assert docs[1]["sampled_rows"] == min(n, max_rows)


def test_documents_read_back_across_packages():
    docs = {}
    for pkg in (REF, PORT):
        feats, data = _columns(pkg, 400)
        docs[pkg] = mod(pkg, "schema.contract").SchemaContract.capture(
            feats, data).to_json()
    for src, dst in ((REF, PORT), (PORT, REF)):
        back = mod(dst, "schema.contract").SchemaContract.from_json(docs[src])
        assert back.to_json() == docs[src]


#: drifted serve batches: a missing predictor, an unknown key, a string in
#: a numeric feature, a number in a text feature, a conformant batch
DRIFTED = {
    "missing": [{"x": 1.0, "k": 2, "t": ("a",), "m": ("p",)}],
    "extra": [{"x": 1.0, "k": 2, "c": "red", "t": (), "m": (),
               "surprise": 3}],
    "renamed": [{"xx": 1.0, "k": 2, "c": "red", "t": (), "m": ()}],
    "numeric_flip": [{"x": 1.0, "k": 2, "c": "red", "t": (), "m": ()},
                     {"x": "1.5", "k": 2, "c": "red", "t": (), "m": ()}],
    "text_flip": [{"x": 1.0, "k": 2, "c": 7, "t": (), "m": ()}],
    "clean": [{"x": None, "k": None, "c": None, "t": None, "m": None}],
}


@pytest.mark.parametrize("case", list(DRIFTED))
def test_collect_violations_match_reference(case):
    out = []
    for pkg in (REF, PORT):
        feats, data = _columns(pkg, 300)
        cmod = mod(pkg, "schema.contract")
        contract = cmod.SchemaContract.capture(feats, data)
        violations = cmod.collect_violations(contract, DRIFTED[case])
        with pytest.raises(cmod.SchemaDriftError) if violations else \
                _nothing():
            cmod.apply_drift_policy(violations, "raise", set(),
                                    logging.getLogger("t"), "test")
        out.append(violations)
    assert out[1] == out[0]
    assert bool(out[1]) == (case != "clean")


class _nothing:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def test_drift_monitor_scores_match_reference():
    rng = np.random.RandomState(9)
    batch = [{"x": float(v), "k": int(k), "c": c, "t": (), "m": ()}
             for v, k, c in zip(rng.randn(500) * 3 + 4,
                                rng.randint(0, 7, 500),
                                rng.choice(["red", "blue", "cyan"], 500))]
    scores = []
    for pkg in (REF, PORT):
        feats, data = _columns(pkg, 600)
        contract = mod(pkg, "schema.contract").SchemaContract.capture(
            feats, data)
        mon = mod(pkg, "schema.drift").DriftMonitor(contract)
        mon.observe(batch)
        scores.append(mon.scores())
    assert scores[1] == scores[0]
    assert set(scores[1]) >= {"x", "c"}


def test_train_captures_the_reference_contract():
    docs = []
    for pkg in (REF, PORT):
        reset_uids(pkg)
        wf, _, _ = mixed_pipeline(pkg, "lr")
        docs.append(_doc(wf.train().schema_contract))
    assert docs[1] == docs[0]
    reset_uids(PORT)
    wf, _, _ = mixed_pipeline(PORT, "lr")
    wf.set_parameters(schema_contract=False)
    assert wf.train().schema_contract is None


def test_local_scorer_enforces_the_contract():
    reset_uids(PORT)
    wf, records, _ = mixed_pipeline(PORT, "lr")
    model = wf.train()
    drifted = [dict(records[0], b="oops")]
    scorer = LocalScorer(model, drift_policy="raise")
    from transmogrifai_tpu_torch.schema import SchemaDriftError

    with pytest.raises(SchemaDriftError, match="type_flip: b"):
        scorer.score_batch(drifted)
    assert len(scorer.score_batch(records[:3])) == 3
    with pytest.raises(ValueError, match="drift_policy"):
        LocalScorer(model, drift_policy="shout")
