"""The whole ported slices in both packages on the passenger data:
transmogrify -> SanityChecker -> OpLogisticRegression, and the tree slice
transmogrify(label=...) -> SanityChecker -> OpGBTClassifier, each through
train() -> score() -> AuROC; and the reference-fitted state of each scored
by the torch package.

Tolerances: kept columns identical; identified coefficients within rtol
1e-4, atol 1e-5; probabilities within 1e-5 abs and
AuROC within 1e-4 after two float32 fits that sum in different orders;
the same fitted state scored by both packages within 1e-6 abs (one
float32 dot or tree walk, no fit in between).  The tree slice: kept
columns identical, probabilities within 1e-5 abs, AuROC within 1e-4.
"""
import numpy as np
import pytest

from torch_parity import (
    PORT,
    REF,
    identified,
    mod,
    passenger_slice,
    passenger_tree_slice,
    passengers,
    probabilities,
    reset_uids,
    stage_of,
    workflow,
)

N = 2000


def _train(pkg: str, lr_kw=None):
    reset_uids(pkg)
    survived, checked, pred = passenger_slice(pkg, lr_kw=lr_kw)
    data = passengers(pkg, N)
    model = workflow(pkg, pred, data).train()
    scored = model.score(data)
    ev = mod(pkg, "evaluators.binary").OpBinaryClassificationEvaluator()
    auroc = ev.evaluate(scored, label_col=survived.name,
                        pred_col=pred.name).AuROC
    model.coefficients = identified(model, scored, checked.name)
    return model, scored, pred, auroc


@pytest.mark.parametrize(
    "lr_kw", [None, {"reg_param": 0.001, "elastic_net_param": 0.1}],
    ids=["unregularized", "grid-0.001-0.1"],
)
def test_slice_matches_reference(lr_kw):
    m_ref, s_ref, p_ref, auc_ref = _train(REF, lr_kw)
    m_port, s_port, p_port, auc_port = _train(PORT, lr_kw)
    assert (stage_of(m_port, "SanityCheckerModel").indices_to_keep
            == stage_of(m_ref, "SanityCheckerModel").indices_to_keep)
    # coefficients as the data determine them (see torch_parity.identified)
    (b_port, c_port), (b_ref, c_ref) = m_port.coefficients, m_ref.coefficients
    np.testing.assert_allclose(b_port, b_ref, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(c_port, c_ref, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(
        probabilities(s_port, p_port.name), probabilities(s_ref, p_ref.name),
        rtol=0, atol=1e-5,
    )
    assert abs(auc_port - auc_ref) <= 1e-4
    # the planted signal is learned: AuROC near the observable ceiling
    bayes = mod(PORT, "examples.synthetic").BAYES_AUROC_OBSERVED
    assert 0.70 < auc_port < bayes + 0.02


def test_reference_state_scored_by_port():
    """load_reference_state carries the JAX-fitted state over; the port's
    score() of it matches the reference's score() within 1e-6."""
    from transmogrifai_tpu.serialization.model_io import stage_state

    m_ref, _, p_ref, _ = _train(REF)
    states = [(type(s).__name__, stage_state(s)) for s in m_ref.stages]
    data_ref = passengers(REF, N, seed=7)
    want = probabilities(m_ref.score(data_ref), p_ref.name)

    reset_uids(PORT)
    _, _, pred = passenger_slice(PORT)
    data = passengers(PORT, N, seed=7)
    wf = workflow(PORT, pred, data)
    model = mod(PORT, "interop").load_reference_state(wf, states)
    got = probabilities(model.score(data), pred.name)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert (stage_of(model, "SanityCheckerModel").indices_to_keep
            == stage_of(m_ref, "SanityCheckerModel").indices_to_keep)


def test_reference_state_must_pair_with_the_workflow():
    from transmogrifai_tpu.serialization.model_io import stage_state

    m_ref, _, _, _ = _train(REF)
    states = [(type(s).__name__, stage_state(s)) for s in m_ref.stages]
    reset_uids(PORT)
    _, _, pred = passenger_slice(PORT)
    wf = workflow(PORT, pred, passengers(PORT, 10))
    load = mod(PORT, "interop").load_reference_state
    with pytest.raises(ValueError, match="stages"):
        load(wf, states[:-1])
    with pytest.raises(ValueError, match="pairs with"):
        load(wf, list(reversed(states)))


def _train_trees(pkg: str, data_seed: int = 42):
    reset_uids(pkg)
    survived, _, _, pred = passenger_tree_slice(pkg, {"num_trees": 8})
    data = passengers(pkg, N, seed=data_seed)
    model = workflow(pkg, pred, data).train()
    scored = model.score(data)
    ev = mod(pkg, "evaluators.binary").OpBinaryClassificationEvaluator()
    auroc = ev.evaluate(scored, label_col=survived.name,
                        pred_col=pred.name).AuROC
    return model, scored, pred, auroc


def test_tree_slice_matches_reference():
    m_ref, s_ref, p_ref, auc_ref = _train_trees(REF)
    m_port, s_port, p_port, auc_port = _train_trees(PORT)
    assert (stage_of(m_port, "SanityCheckerModel").indices_to_keep
            == stage_of(m_ref, "SanityCheckerModel").indices_to_keep)
    splits = [[s.splits for s in m.stages
               if type(s).__name__ == "NumericBucketizerModel"]
              for m in (m_port, m_ref)]
    assert splits[0] == splits[1] and any(splits[0])
    np.testing.assert_allclose(
        probabilities(s_port, p_port.name), probabilities(s_ref, p_ref.name),
        rtol=0, atol=1e-5,
    )
    assert abs(auc_port - auc_ref) <= 1e-4
    # scored on its own 2000 training rows, the boosted trees fit past the
    # planted observable ceiling (0.7493); at 1M rows chip_smoke.py holds
    # the card's AuROC under it
    assert auc_port > 0.70


def test_reference_tree_state_scored_by_port():
    """load_reference_state carries the JAX-fitted bucketizer splits and
    GBT heaps over; the port's score() of them matches the reference's
    score() within 1e-6."""
    from transmogrifai_tpu.serialization.model_io import stage_state

    m_ref, _, p_ref, _ = _train_trees(REF)
    states = [(type(s).__name__, stage_state(s)) for s in m_ref.stages]
    want = probabilities(m_ref.score(passengers(REF, N, seed=7)), p_ref.name)

    reset_uids(PORT)
    _, _, _, pred = passenger_tree_slice(PORT, {"num_trees": 8})
    data = passengers(PORT, N, seed=7)
    model = mod(PORT, "interop").load_reference_state(
        workflow(PORT, pred, data), states)
    got = probabilities(model.score(data), pred.name)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
