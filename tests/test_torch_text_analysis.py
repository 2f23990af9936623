"""The torch package's text-analysis stages (``ops/text_analysis.py``,
``ops/lang_data.py``, ``ops/ner.py``) against the JAX package's: text
length, language detection, named entities, MIME types, phone, email and
URL parsing, n-gram and Jaccard similarity and the map variants, on
realistic and on garbage input (the JAX package's robustness cases),
equal."""
import base64
import string

import numpy as np
import pytest

from torch_parity import PORT, REF, assert_features_match, assert_same, mod

N = 200

SENTENCES = [
    "The quick brown fox jumps over the lazy dog near the river bank.",
    "Le renard brun rapide saute par-dessus le chien paresseux.",
    "Der schnelle braune Fuchs springt über den faulen Hund.",
    "El rápido zorro marrón salta sobre el perro perezoso.",
    "Il veloce volpe marrone salta sopra il cane pigro.",
    "Быстрая коричневая лиса прыгает через ленивую собаку.",
    "敏捷的棕色狐狸跳过了懒狗。", "素早い茶色の狐が怠け者の犬を飛び越える。",
    "John Smith met Mary Johnson in Paris on Monday at Acme Corp.",
    "Dr. Alice Brown works for the United Nations in New York.",
    "call me at (415) 555-2671 or +44 20 7946 0958", "", None,
]


def _garbage(seed: int, k: int = 60) -> list:
    """The JAX package's fuzz pools: printable, control, multi-script,
    emoji with joiners, accented and punctuation strings."""
    rng = np.random.RandomState(seed)
    pools = [string.printable, "".join(chr(c) for c in range(0x20)),
             "αβγδεζηθικλμνξοπρστυφχψω中文字符日本語한국어",
             "\U0001F600\U0001F4A9\U0001F680‍​﻿",
             "ÀÈÌÒÙàèìòùÄÖÜäöüßÿñçœæ",
             "().,;:!?-_'\"@#$%^&*[]{}|\\/<>~`+="]
    out = [None, "", " ", "\n", "\t\t\t", "a" * 10_000, "\x00"]
    for _ in range(k):
        pool = pools[rng.randint(len(pools))]
        out.append("".join(pool[rng.randint(len(pool))]
                           for _ in range(int(rng.randint(1, 60)))))
    return out


def _blobs(seed: int) -> list:
    """Base64 of real file signatures, cut ones and random bytes."""
    rng = np.random.RandomState(seed)
    raw = [b"\x89PNG\r\n\x1a\n" + b"\x00" * 20, b"%PDF-1.4 hello",
           b"GIF89a" + b"\x01" * 10, b"\xff\xd8\xff\xe0" + b"\x00" * 10,
           b"PK\x03\x04" + b"\x00" * 30, b"<html><body>x</body></html>",
           b"{\"a\": 1}", b"plain text here", b"\x89PN", b"PK\x03", b""]
    raw += [bytes(rng.randint(0, 256, int(rng.randint(1, 300))).tolist())
            for _ in range(20)]
    return [base64.b64encode(r).decode("ascii") for r in raw] + \
        [None, "!!!", "not base64 at all", "ab=cd=="]


@pytest.mark.parametrize("fn", ["detect", "tag_entities", "is_valid_phone",
                                "parse_phone", "ngrams", "detect_language",
                                "detect_mime_type", "person_name_tokens"])
def test_functions_on_every_input(fn):
    where = {"detect": "ops.lang_data", "tag_entities": "ops.ner",
             "person_name_tokens": "ops.ner"}.get(fn, "ops.text_analysis")
    inputs = SENTENCES + _garbage(81) + _garbage(82)
    if fn == "detect_mime_type":
        inputs = _blobs(83) + inputs
    phones = ["415-555-2671", "+1 (650) 253-0000", "020 7946 0958",
              "12345", "+44 20 7946 0958", "555-0100", "1-800-FLOWERS"]
    if fn in ("is_valid_phone", "parse_phone"):
        inputs = phones + inputs
    outs = []
    for pkg in (REF, PORT):
        f = getattr(mod(pkg, where), fn)
        if fn in ("detect", "ngrams"):
            outs.append([f(s or "") for s in inputs])
        elif fn in ("is_valid_phone", "parse_phone"):
            outs.append([(f(s), f(s, "GB")) for s in inputs])
        else:
            outs.append([f(s) for s in inputs])
    assert_same(outs[1], outs[0], fn)


def _analysis_data(pkg: str):
    rd = mod(pkg, "testkit.random_data")
    ftm = mod(pkg, "types.feature_types")
    cols = mod(pkg, "types.columns")
    rng = np.random.RandomState(4)
    texts = [SENTENCES[rng.randint(len(SENTENCES))] for _ in range(N)]
    blobs = _blobs(5)
    b64 = [blobs[rng.randint(len(blobs))] for _ in range(N)]
    ds = rd.random_dataset({
        "email": (rd.RandomText.emails("corp.org", seed=60)
                  .with_probability_of_empty(0.1), ftm.Email),
        "url": (rd.RandomText.urls(seed=61).with_probability_of_empty(0.1),
                ftm.URL),
        "phone": (rd.RandomText.phones(seed=62).with_probability_of_empty(0.1),
                  ftm.Phone),
        "words": (rd.RandomText.words(seed=63).with_probability_of_empty(0.1),
                  ftm.Text),
        "mp1": (rd.RandomMultiPickList(list("abcde"), seed=64), ftm.MultiPickList),
        "mp2": (rd.RandomMultiPickList(list("abcxy"), seed=65), ftm.MultiPickList),
        "phones": (rd.RandomMap(rd.RandomText.phones(seed=66), ["home", "work"],
                                seed=67), ftm.PhoneMap),
    }, N)
    blob_maps = [{"a": b64[i], "b": b64[(i * 7) % N]} if i % 5 else {}
                 for i in range(N)]
    return mod(pkg, "types.dataset").Dataset({
        **{c: ds[c] for c in ds.column_names()},
        "text": cols.column_from_list(texts, ftm.Text),
        "b64": cols.column_from_list(b64, ftm.Base64),
        "b64map": cols.column_from_list(blob_maps, ftm.Base64Map),
    })


def _analysis_features(pkg: str) -> list:
    mod(pkg, "dsl")
    ta = mod(pkg, "ops.text_analysis")
    fb = mod(pkg, "features.feature_builder").FeatureBuilder
    text, words = fb.Text("text").as_predictor(), fb.Text("words").as_predictor()
    email, url = fb.Email("email").as_predictor(), fb.URL("url").as_predictor()
    phone = fb.Phone("phone").as_predictor()
    mp1 = fb.MultiPickList("mp1").as_predictor()
    mp2 = fb.MultiPickList("mp2").as_predictor()
    b64 = fb.Base64("b64").as_predictor()
    return [
        ta.TextLenTransformer().set_input(text).get_output(),
        ta.LangDetector().set_input(text).get_output(),
        ta.BestLanguageDetector().set_input(text).get_output(),
        ta.NameEntityRecognizer().set_input(text).get_output(),
        ta.MimeTypeDetector().set_input(b64).get_output(),
        ta.PhoneNumberParser().set_input(phone).get_output(),
        ta.PhoneNumberParser(region="GB").set_input(phone).get_output(),
        ta.EmailToPickList().set_input(email).get_output(),
        ta.UrlToDomain().set_input(url).get_output(),
        ta.NGramSimilarity().set_input(text, words).get_output(),
        ta.NGramSimilarity(n=2).set_input(words, words).get_output(),
        ta.JaccardSimilarity().set_input(mp1, mp2).get_output(),
        ta.SetNGramSimilarity().set_input(mp1, mp2).get_output(),
        ta.IsValidPhoneMapDefaultCountry().set_input(
            fb.PhoneMap("phones").as_predictor()).get_output(),
        ta.MimeTypeMapDetector().set_input(
            fb.Base64Map("b64map").as_predictor()).get_output(),
        text.text_len(), text.detect_languages(), text.recognize_entities(),
        email.to_email_domain(), email.to_email_prefix(), url.to_domain(),
        url.to_protocol(), url.is_valid_url(), phone.is_valid_phone(),
        phone.parse_phone(), b64.detect_mime_types(),
        text.to_ngram_similarity(words, n_gram_size=4),
        mp1.jaccard_similarity(mp2),
    ]


def test_text_analysis_stages_match_reference():
    got = assert_features_match(_analysis_features, data=_analysis_data)
    langs = got[2][2]
    assert {"en", "fr", "de"} <= set(v for v in langs if v)
