"""The torch package's text stages (``ops/text.py``, ``ops/stopwords.py``
and the exact-tokenizer route of ``utils/native.tokenize_hash_tf``)
against the JAX package's: the same tokens, stop-word lists, text stats,
smart-text plans (pivot below the cardinality cap, 512 hash columns and a
null indicator above it), text-list hashing, null indicators, count
vectors and IDF, values and metadata bit-equal; and the same text hashes
to the same slots with or without the host library, on emoji, accented
text and rows past the scanner's 4096-byte buffer."""
import string

import numpy as np
import pytest

from torch_parity import (
    PORT, REF, assert_features_match, assert_same, mod,
)

N = 300


def _texts(seed: int, k: int = 150) -> list:
    """Free text of every kind the tokenizers see: ASCII words, accented
    and multi-script text, emoji with joiners, control characters,
    punctuation, blanks and rows longer than 4096 characters."""
    rng = np.random.RandomState(seed)
    pools = [
        string.ascii_letters + "  .,-",
        string.printable,
        "αβγδεζηθικλμνξοπρστυφχψω中文字符日本語한국어 ",
        "\U0001F600\U0001F4A9\U0001F680‍​﻿ ab",
        "ÀÈÌÒÙàèìòùÄÖÜäöüßÿñçœæ Café naïve",
        "().,;:!?-_'\"@#$%^&*[]{}|\\/<>~`+= x",
    ]
    out = [None, "", " ", "\n", "a" * 5000, "word " * 1200,
           "héllo " * 900, "Ünïcödé words and ASCII ones", "\x00"]
    for _ in range(k):
        pool = pools[rng.randint(len(pools))]
        n = int(rng.randint(1, 80))
        out.append("".join(pool[rng.randint(len(pool))] for _ in range(n)))
    return out


@pytest.mark.parametrize("lower,min_len", [(True, 1), (False, 1), (True, 3)])
def test_tokenize(lower, min_len):
    texts = _texts(1)
    want = [mod(REF, "ops.text").tokenize(t, lower, min_len) for t in texts]
    got = [mod(PORT, "ops.text").tokenize(t, lower, min_len) for t in texts]
    assert_same(got, want)


@pytest.mark.parametrize("language", ["en", "fr", "de", "es", "xx"])
def test_stopwords(language):
    want = mod(REF, "ops.stopwords").stopwords_for(language)
    got = mod(PORT, "ops.stopwords").stopwords_for(language)
    assert got == want


def test_text_stats_cap_and_merge():
    outs = []
    for pkg in (REF, PORT):
        ts_cls = mod(pkg, "ops.text").TextStats
        a, b = ts_cls(max_card=5), ts_cls(max_card=5)
        for i, v in enumerate(_texts(2, 60)):
            (a if i % 2 else b).update(v)
        merged = ts_cls(max_card=5).merge(a).merge(b)
        outs.append([(dict(s.value_counts), s.n_present, s.cardinality)
                     for s in (a, b, merged)])
    assert_same(outs[1], outs[0])


@pytest.mark.parametrize("dims,binary,seed", [(512, False, 42), (64, True, 7)])
def test_native_hashing_takes_the_exact_route(dims, binary, seed):
    """Non-ASCII rows and rows past 4096 characters are recomputed on the
    python tokenizer: the same slots as the JAX package's, and as the
    pure-python route without the host library."""
    texts = _texts(3)
    native_port = mod(PORT, "utils.native")
    got = native_port.tokenize_hash_tf(texts, dims, seed=seed, binary=binary)
    assert got is not None, "the port's host library did not build"
    want = mod(REF, "utils.native").tokenize_hash_tf(
        texts, dims, seed=seed, binary=binary)
    if want is not None:
        np.testing.assert_array_equal(got, want)
    text, hashing = mod(PORT, "ops.text"), mod(PORT, "utils.hashing")
    python = hashing.hashing_tf([text.tokenize(t) for t in texts], dims,
                                seed=seed, binary=binary)
    np.testing.assert_array_equal(got, python)
    assert got[4].sum() == 1.0 and got[5].max() == (1.0 if binary else 1200.0)


def _text_data(pkg: str):
    """A free-text column (hashed), a low-cardinality text column (pivoted)
    and a text list, from the testkit."""
    rd = mod(pkg, "testkit.random_data")
    ftm = mod(pkg, "types.feature_types")
    return rd.random_dataset({
        "free": (rd.RandomText.words(seed=50).with_probability_of_empty(0.1),
                 ftm.Text),
        "few": (rd.RandomText.picklists(["Red ", "blue", "GREEN", "red"],
                                        seed=51)
                .with_probability_of_empty(0.2), ftm.TextArea),
        "mixed": (rd.RandomText.picklists(
            ["Café au lait", "naïve 😀 text", "plain words", "a" * 5000],
            seed=54).with_probability_of_empty(0.1), ftm.Text),
        "toks": (rd.RandomList(rd.RandomText.picklists(
            ["the", "cat", "and", "sat", "le", "chat"], seed=52), max_len=6,
            seed=53, probability_of_empty=0.1), ftm.TextList),
    }, N)


def _text_features(pkg: str) -> list:
    mod(pkg, "dsl")
    text = mod(pkg, "ops.text")
    fb = mod(pkg, "features.feature_builder").FeatureBuilder
    free, few = fb.Text("free").as_predictor(), fb.TextArea("few").as_predictor()
    mixed = fb.Text("mixed").as_predictor()
    toks = fb.TextList("toks").as_predictor()
    tf = text.TextListHashingVectorizer(hash_dims=32).set_input(toks).get_output()
    return [
        text.SmartTextVectorizer().set_input(free, few, mixed).get_output(),
        text.SmartTextVectorizer(max_cardinality=2, hash_dims=16,
                                 track_nulls=False, clean_text=False)
        .set_input(few, mixed).get_output(),
        text.SmartTextVectorizer(top_k=2, min_support=1).set_input(few)
        .get_output(),
        text.TextTokenizer().set_input(free).get_output(),
        text.TextTokenizer(min_token_length=4, to_lowercase=False)
        .set_input(mixed).get_output(),
        text.TextTokenizer(remove_stopwords=True, language="en")
        .set_input(free).get_output(),
        text.TextTokenizer(remove_stopwords=True).set_input(mixed).get_output(),
        text.TextListHashingVectorizer().set_input(toks).get_output(),
        tf,
        text.TextListNullTransformer().set_input(toks).get_output(),
        text.OpCountVectorizer().set_input(toks).get_output(),
        text.OpCountVectorizer(vocab_size=3, min_df=2.0, min_tf=1.0,
                               binary=True).set_input(toks).get_output(),
        text.OpIDF().set_input(tf).get_output(),
        text.OpIDF(min_doc_freq=40).set_input(tf).get_output(),
        free.tokenize(), few.smart_vectorize(), toks.tf(num_features=16),
        toks.tf().idf(min_doc_freq=2), toks.tfidf(num_features=8),
        toks.count_vec(vocab_size=4), toks.remove_stop_words(),
        toks.remove_stop_words(language="fr"), free.vectorize(),
        toks.vectorize(), mixed.vectorize(others=[free]),
    ]


def test_text_stages_match_reference():
    assert_features_match(_text_features, data=_text_data)


def test_smart_text_plans_and_width():
    """The pivot-or-hash decision: the free text hashes (512 + null), the
    four-valued text pivots (its cleaned values, OTHER and null)."""
    got = assert_features_match(
        lambda pkg: _text_features(pkg)[:1], data=_text_data)
    (_, _, values, _, metas) = got[0]
    by_parent = {}
    for m in metas:
        by_parent.setdefault(m[0], []).append(m)
    assert len(by_parent["free"]) == 513
    labels = [m[3] for m in by_parent["few"]]
    # "Red " and "red" clean to one value, the most frequent
    assert labels[0] == "red" and sorted(labels[:3]) == ["blue", "green", "red"]
    assert labels[3:] == ["OTHER", "NullIndicatorValue"]
    assert values.shape == (N, len(metas))


def test_hashing_without_the_host_library(monkeypatch):
    """The smart-text hash columns do not depend on the host library."""
    native = mod(PORT, "utils.native")
    with_lib = assert_features_match(
        lambda pkg: _text_features(pkg)[:2], data=_text_data)
    monkeypatch.setattr(native, "get_lib", lambda: None)
    from torch_parity import run_features

    without = run_features(PORT, lambda pkg: _text_features(pkg)[:2], N,
                           data=_text_data)
    assert_same(without, with_lib)


@pytest.mark.parametrize("with_lib", [True, False])
def test_contract_text_histogram(with_lib, monkeypatch):
    """The schema contract's 100-bucket histogram of a free-text column
    (one native murmur3 batch, or the memoized python murmur3 without the
    host library) is the JAX package's."""
    if not with_lib:
        monkeypatch.setattr(mod(PORT, "utils.native"), "get_lib", lambda: None)
    texts = _texts(5)
    outs = []
    for pkg in (REF, PORT):
        col = mod(pkg, "types.columns").column_from_list(
            texts, mod(pkg, "types.feature_types").Text)
        d = mod(pkg, "filters.feature_distribution").compute_distribution(
            "t", col)
        outs.append((d.count, d.nulls, d.histogram))
    assert_same(outs[1], outs[0])
    assert outs[1][2].sum() == len(texts) - outs[1][1]
