"""The string metrics of metrics_tpu_torch against metrics_tpu, on the CPU.

The same strings, drawn with seeded ``np.random.RandomState``s from a vocabulary with
punctuation, numbers, accents, CJK, kana and full-width text, with empty strings and
single words among them, go through the JAX package and the port
(``device="cpu"``):

- every functional over the arguments the JAX tests sweep, ``str`` against list
  inputs and several references a prediction: values within 1e-6 (the tolerance of
  ``tests/unittests/text/test_text.py``), sentence-level scores too;
- every class over several updates, through ``forward`` and ``reset``: count states
  exact (int64 in the port where the JAX state is a whole float32), float states and
  list states equal, values within 1e-6;
- the tokenizers and the edit distance on their own, the ``intl`` tokenizer without
  ``regex`` and ROUGE's stemmer without ``nltk``;
- the validation errors by type and message, ``load_jax_state`` of every class, and
  the root names and their warning shims.

Perplexity has its own file, ``tests/test_torch_perplexity.py``.
"""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu
import metrics_tpu.functional as jfr
import metrics_tpu.functional.text as jf
import metrics_tpu.functional.text.rouge as j_rouge
import metrics_tpu.functional.text.sacre_bleu as j_sacre
import metrics_tpu.text as jt
import metrics_tpu.text.rouge as j_rouge_cls
import metrics_tpu_torch
import metrics_tpu_torch.functional as tfr
import metrics_tpu_torch.functional.text as tf
import metrics_tpu_torch.functional.text.rouge as t_rouge
import metrics_tpu_torch.functional.text.sacre_bleu as t_sacre
import metrics_tpu_torch.text as tt
import metrics_tpu_torch.text.rouge as t_rouge_cls
from metrics_tpu.functional.text.helper import _edit_distance as j_edit_distance
from metrics_tpu_torch.convert import load_jax_state
from metrics_tpu_torch.functional.text.helper import _edit_distance as t_edit_distance

CPU = {"device": "cpu"}
ATOL = 1e-6
VOCAB = (
    "the cat sat on mat a big tree near house is there another one sample prediction reference"
    " Hello, world! don't it's 3.14 1,000 5... ?! U.S. e.g. Dr. (test) $5 #tag x-ray well-known"
    " café naïve über «quote» — 中文 猫 日本語 ｈｅｌｌｏ こんにちは カタカナ 한국어 ＡＢＣ，"
).split()


def _noisy(words, rng, rate):
    out = []
    for w in words:
        r = rng.rand()
        if r < rate / 3:
            continue  # deletion
        if r < 2 * rate / 3:
            out.append(VOCAB[rng.randint(len(VOCAB))])  # substitution
            continue
        out.append(w)
        if r < rate:
            out.append(VOCAB[rng.randint(len(VOCAB))])  # insertion
    return out


def corpus(seed: int, n: int = 12, refs: int = 1, rate: float = 0.3, sentences: bool = False):
    """``n`` predictions and, for each, ``refs`` references; the first pair has an empty
    prediction, the second a single word against an empty reference."""
    rng = np.random.RandomState(seed)
    preds, targets = [], []
    for _ in range(n):
        if sentences:
            parts = [" ".join(rng.choice(VOCAB, rng.randint(2, 8))) + "." for _ in range(rng.randint(1, 4))]
            words = " ".join(parts).split()
        else:
            words = list(rng.choice(VOCAB, rng.randint(1, 12)))
        targets.append([" ".join(words)] + [" ".join(_noisy(words, rng, rate)) for _ in range(refs - 1)])
        preds.append(" ".join(_noisy(words, rng, rate)))
    preds[0] = ""
    preds[1], targets[1][0] = "cat", ""
    return preds, targets


def batches(preds, targets, size: int = 4):
    return [(preds[i : i + size], targets[i : i + size]) for i in range(0, len(preds), size)]


def as_numpy(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_close(got, want, atol: float = ATOL):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for key in want:
            assert_close(got[key], want[key], atol)
    elif isinstance(want, (tuple, list)):
        assert isinstance(got, (tuple, list)) and len(got) == len(want)
        for g, w in zip(got, want):
            assert_close(g, w, atol)
    else:
        assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
        g, w = as_numpy(got), np.asarray(want)
        assert g.shape == w.shape, (g.shape, w.shape)
        assert g.dtype == w.dtype, (g.dtype, w.dtype)
        np.testing.assert_allclose(g, w, rtol=0, atol=atol)


def _flat(items):
    return np.concatenate([np.atleast_1d(as_numpy(v)) for v in items]) if len(items) else np.zeros(0, np.float32)


def assert_states(tm, jm):
    """Counts exact (port int64 against JAX whole float32), float sums and list states
    equal to the bit."""
    assert list(tm._defaults) == list(jm._defaults)
    for name in jm._defaults:
        tv, jv = getattr(tm, name), getattr(jm, name)
        if isinstance(jv, list):
            t_flat, j_flat = _flat(tv), _flat(jv)
            assert t_flat.dtype == j_flat.dtype == np.float32, name
            np.testing.assert_array_equal(t_flat, j_flat, err_msg=name)
            continue
        jv = np.asarray(jv)
        if tv.dtype == torch.int64:
            assert np.array_equal(jv, np.round(jv)), name
            np.testing.assert_array_equal(tv.numpy(), jv.astype(np.int64), err_msg=name)
        else:
            assert tv.dtype == torch.float32 and jv.dtype == np.float32, name
            np.testing.assert_array_equal(tv.numpy(), jv, err_msg=name)


def run_classes(name, kwargs, data, forward_every: int = 2):
    """The port's and the JAX class over ``data`` (update and forward in turns), then
    reset and one more update; states and values compared at each end."""
    tm, jm = getattr(tt, name)(**kwargs, **CPU), getattr(jt, name)(**kwargs)
    for i, (p, t) in enumerate(data):
        if i % forward_every:
            assert_close(tm(p, t), jm(p, t))
        else:
            tm.update(p, t)
            jm.update(p, t)
    assert_states(tm, jm)
    assert_close(tm.compute(), jm.compute())
    tm.reset()
    jm.reset()
    tm.update(*data[-1])
    jm.update(*data[-1])
    assert_states(tm, jm)
    assert_close(tm.compute(), jm.compute())
    return tm, jm


def single_refs(targets):
    return [t[0] for t in targets]


# ------------------------------------------------------------------ helpers


def test_edit_distance_matches_jax():
    rng = np.random.RandomState(0)
    for _ in range(200):
        a = [str(x) for x in rng.randint(0, 6, rng.randint(0, 15))]
        b = [str(x) for x in rng.randint(0, 6, rng.randint(0, 15))]
        assert t_edit_distance(a, b) == j_edit_distance(a, b)


@pytest.mark.parametrize("tokenize", ["none", "13a", "zh", "intl", "char"])
def test_sacrebleu_tokenizers_match_jax(tokenize):
    preds, targets = corpus(1, n=40)
    for line in preds + single_refs(targets) + ["a&quot;b &amp; c&lt;d&gt; <skipped>x-\ny\nz", "5...3,000.5 (x)"]:
        for lowercase in (False, True):
            assert t_sacre._SacreBLEUTokenizer.tokenize(line, tokenize, lowercase) == (
                j_sacre._SacreBLEUTokenizer.tokenize(line, tokenize, lowercase)
            ), repr(line)


def test_intl_fallback_matches_jax_and_the_regex_rules():
    rng = np.random.RandomState(2)
    pool = list("abcXYZ019.,!?'\"$%+«»-()[]@#&*;:~^|<>=/\\ ") + ["é", "ü", "中", "猫", "€", "²", "½"]
    for _ in range(300):
        line = "".join(rng.choice(pool, rng.randint(0, 40)))
        fallback = t_sacre._intl_tokenize_fallback(line)
        assert fallback == j_sacre._intl_tokenize_fallback(line)
        assert " ".join(fallback.split()) == t_sacre._SacreBLEUTokenizer._tokenize_international(line)


# --------------------------------------------------------------- functionals

WER_FAMILY = ["word_error_rate", "char_error_rate", "match_error_rate", "word_information_lost",
              "word_information_preserved"]
WER_CLASSES = ["WordErrorRate", "CharErrorRate", "MatchErrorRate", "WordInfoLost", "WordInfoPreserved"]


@pytest.mark.parametrize("name", WER_FAMILY)
def test_wer_family_functionals_match_jax(name):
    preds, targets = corpus(3)
    refs = single_refs(targets)
    assert_close(getattr(tf, name)(preds, refs, **CPU), getattr(jf, name)(preds, refs))
    assert_close(getattr(tf, name)(preds[2], refs[2], **CPU), getattr(jf, name)(preds[2], refs[2]))
    assert_close(getattr(tf, name)("one", "one two", **CPU), getattr(jf, name)("one", "one two"))


@pytest.mark.parametrize("name", WER_CLASSES)
def test_wer_family_classes_match_jax(name):
    preds, targets = corpus(4, n=16)
    tm, _ = run_classes(name, {}, batches(preds, single_refs(targets)))
    assert all(tm.metric_state[k].dtype == torch.int64 for k in tm._defaults)


@pytest.mark.parametrize("smooth", [False, True])
@pytest.mark.parametrize("n_gram,weights", [(1, None), (2, None), (4, None), (4, [0.4, 0.3, 0.2, 0.1])])
def test_bleu_matches_jax(n_gram, smooth, weights):
    preds, targets = corpus(5, n=12, refs=3, rate=0.15)
    kwargs = {"n_gram": n_gram, "smooth": smooth, "weights": weights}
    assert_close(tf.bleu_score(preds, targets, **kwargs, **CPU), jf.bleu_score(preds, targets, **kwargs))
    refs = single_refs(targets)
    assert_close(tf.bleu_score(preds, refs, **kwargs, **CPU), jf.bleu_score(preds, refs, **kwargs))
    run_classes("BLEUScore", kwargs, batches(preds, targets))


def test_bleu_of_a_string_and_a_perfect_match():
    line = "the cat is on the mat"
    assert_close(tf.bleu_score(line, [[line]], **CPU), jf.bleu_score(line, [[line]]))
    assert float(tf.bleu_score(line, [[line]], **CPU)) == 1.0


@pytest.mark.parametrize("lowercase", [False, True])
@pytest.mark.parametrize("tokenize", ["none", "13a", "zh", "intl", "char"])
def test_sacre_bleu_matches_jax(tokenize, lowercase):
    preds, targets = corpus(6, n=12, refs=2, rate=0.15)
    kwargs = {"tokenize": tokenize, "lowercase": lowercase}
    assert_close(tf.sacre_bleu_score(preds, targets, **kwargs, **CPU), jf.sacre_bleu_score(preds, targets, **kwargs))
    run_classes("SacreBLEUScore", {**kwargs, "smooth": True}, batches(preds, targets))


def test_sacre_bleu_intl_without_regex_matches_jax(monkeypatch):
    monkeypatch.setattr(t_sacre, "_REGEX_AVAILABLE", False)
    monkeypatch.setattr(j_sacre, "_REGEX_AVAILABLE", False)
    preds, targets = corpus(7, n=16, refs=2, rate=0.15)
    want = jf.sacre_bleu_score(preds, targets, tokenize="intl")
    assert_close(tf.sacre_bleu_score(preds, targets, tokenize="intl", **CPU), want)


@pytest.mark.parametrize("lowercase", [False, True])
@pytest.mark.parametrize("whitespace", [False, True])
@pytest.mark.parametrize("n_char_order,n_word_order", [(6, 2), (6, 0), (4, 1)])
def test_chrf_matches_jax(n_char_order, n_word_order, whitespace, lowercase):
    preds, targets = corpus(8, n=12, refs=2)
    kwargs = {"n_char_order": n_char_order, "n_word_order": n_word_order, "whitespace": whitespace,
              "lowercase": lowercase}
    assert_close(tf.chrf_score(preds, targets, **kwargs, **CPU), jf.chrf_score(preds, targets, **kwargs))
    got = tf.chrf_score(preds, targets, return_sentence_level_score=True, beta=1.0, **kwargs, **CPU)
    assert_close(got, jf.chrf_score(preds, targets, return_sentence_level_score=True, beta=1.0, **kwargs))
    run_classes("CHRFScore", {**kwargs, "return_sentence_level_score": lowercase}, batches(preds, targets))


TER_KWARGS = [{}, {"normalize": True}, {"lowercase": False}, {"no_punctuation": True},
              {"normalize": True, "asian_support": True}, {"no_punctuation": True, "asian_support": True}]


@pytest.mark.parametrize("kwargs", TER_KWARGS, ids=lambda k: "-".join(k) or "default")
def test_ter_matches_jax(kwargs):
    preds, targets = corpus(9, n=10, refs=2)
    assert_close(tf.translation_edit_rate(preds, targets, **kwargs, **CPU),
                 jf.translation_edit_rate(preds, targets, **kwargs))
    got = tf.translation_edit_rate(preds, targets, return_sentence_level_score=True, **kwargs, **CPU)
    assert_close(got, jf.translation_edit_rate(preds, targets, return_sentence_level_score=True, **kwargs))
    run_classes("TranslationEditRate", {**kwargs, "return_sentence_level_score": True}, batches(preds, targets))


def test_ter_shifts_match_jax():
    preds = ["a b c d e f", "hello there world", "the new law will be passed by the parliament next week"]
    targets = [["b c d a e f", "f e d c b a"], ["hello world there"],
               ["next week the parliament will pass the new law", "the new law will pass in parliament next week"]]
    assert_close(tf.translation_edit_rate(preds, targets, **CPU), jf.translation_edit_rate(preds, targets))


@pytest.mark.parametrize(
    "kwargs",
    [{}, {"alpha": 1.0}, {"rho": 0.5}, {"deletion": 0.5}, {"insertion": 0.5},
     {"alpha": 3.0, "rho": 0.1, "deletion": 0.4, "insertion": 2.0}, {"language": "ja"}],
    ids=lambda k: "-".join(f"{a}{b}" for a, b in k.items()) or "default",
)
def test_eed_matches_jax(kwargs):
    preds, targets = corpus(10, n=8, refs=2)
    assert_close(tf.extended_edit_distance(preds, targets, **kwargs, **CPU),
                 jf.extended_edit_distance(preds, targets, **kwargs))
    got = tf.extended_edit_distance(preds, targets, return_sentence_level_score=True, **kwargs, **CPU)
    assert_close(got, jf.extended_edit_distance(preds, targets, return_sentence_level_score=True, **kwargs))
    run_classes("ExtendedEditDistance", {**kwargs, "return_sentence_level_score": True}, batches(preds, targets))


def test_eed_of_full_width_text_matches_jax():
    preds, targets = ["ｈｅｌｌｏ　ｗｏｒｌｄ", "日本語のテキスト"], [["hello world"], ["日本語テキスト"]]
    assert_close(tf.extended_edit_distance(preds, targets, language="ja", **CPU),
                 jf.extended_edit_distance(preds, targets, language="ja"))


ROUGE_KEYS = [("rouge1", "rouge2", "rougeL", "rougeLsum"), "rouge1", ("rouge3", "rouge9"), ("rougeLsum", "rougeL")]


@pytest.mark.parametrize("accumulate", ["best", "avg"])
@pytest.mark.parametrize("rouge_keys", ROUGE_KEYS, ids=lambda k: k if isinstance(k, str) else "-".join(k))
def test_rouge_matches_jax(rouge_keys, accumulate):
    preds, targets = corpus(11, n=10, refs=2, sentences=True)
    kwargs = {"rouge_keys": rouge_keys, "accumulate": accumulate}
    assert_close(tf.rouge_score(preds, targets, **kwargs, **CPU), jf.rouge_score(preds, targets, **kwargs))
    refs = single_refs(targets)
    assert_close(tf.rouge_score(preds, refs, **kwargs, **CPU), jf.rouge_score(preds, refs, **kwargs))
    assert_close(tf.rouge_score(preds[3], refs[3], **kwargs, **CPU), jf.rouge_score(preds[3], refs[3], **kwargs))
    run_classes("ROUGEScore", kwargs, batches(preds, targets))


def test_rouge_with_stemmer_normalizer_and_tokenizer_matches_jax():
    preds, targets = corpus(12, n=8, refs=2, sentences=True)
    preds[2] = "The runners were running quickly. Cats jumped over the fences."
    targets[2] = ["A runner runs quick. The cat jumps over fences.", "running cats"]
    kwargs = {"use_stemmer": True, "rouge_keys": ("rouge1", "rougeL", "rougeLsum")}
    assert_close(tf.rouge_score(preds, targets, **kwargs, **CPU), jf.rouge_score(preds, targets, **kwargs))
    custom = {"normalizer": lambda s: s.upper(), "tokenizer": lambda s: s.split("A")}
    assert_close(tf.rouge_score(preds, targets, **custom, **CPU), jf.rouge_score(preds, targets, **custom))
    run_classes("ROUGEScore", kwargs, batches(preds, targets))


def test_rouge_stemmer_without_nltk_raises_as_in_jax(monkeypatch):
    for module in (t_rouge, j_rouge, t_rouge_cls, j_rouge_cls):
        monkeypatch.setattr(module, "_NLTK_AVAILABLE", False)
    message = "Stemmer requires that `nltk` is installed. Use `pip install nltk`."
    for fn in (lambda: jf.rouge_score("a", "a", use_stemmer=True), lambda: tf.rouge_score("a", "a", use_stemmer=True, **CPU),
               lambda: jt.ROUGEScore(use_stemmer=True), lambda: tt.ROUGEScore(use_stemmer=True, **CPU)):
        with pytest.raises(ModuleNotFoundError) as err:
            fn()
        assert str(err.value) == message


def squad_data(seed: int, n: int = 12):
    rng = np.random.RandomState(seed)
    preds, targets = [], []
    for i in range(n):
        answers = [" ".join(rng.choice(VOCAB, rng.randint(1, 5))) for _ in range(rng.randint(1, 4))]
        choice = rng.randint(3)
        text = answers[0] if choice == 0 else " ".join(_noisy(answers[-1].split(), rng, 0.5)) if choice == 1 else ""
        preds.append({"prediction_text": text, "id": f"q{i}"})
        targets.append({"answers": {"answer_start": [0] * len(answers), "text": answers}, "id": f"q{i}"})
    preds[1]["prediction_text"] = "The U.S.!"
    targets[1]["answers"]["text"] = ["the us", "an answer"]
    return preds, targets


def test_squad_matches_jax():
    preds, targets = squad_data(13)
    assert_close(tf.squad(preds, targets, **CPU), jf.squad(preds, targets))
    assert_close(tf.squad(preds[4], targets[4], **CPU), jf.squad(preds[4], targets[4]))
    run_classes("SQuAD", {}, batches(preds, targets))


def test_squad_unanswered_question_warns_as_in_jax():
    preds, targets = squad_data(14, n=4)
    preds = preds[:2]
    with pytest.warns(UserWarning, match="Unanswered question q3 will receive score 0."):
        got = tf.squad(preds, targets, **CPU)
    with pytest.warns(UserWarning, match="Unanswered question q3 will receive score 0."):
        want = jf.squad(preds, targets)
    assert_close(got, want)


# ------------------------------------------------------------------ errors

ERROR_CASES = {
    "wer_lengths": lambda m, kw: m.word_error_rate(["a"], ["a", "b"], **kw),
    "cer_lengths": lambda m, kw: m.char_error_rate(["a", "b"], ["a"], **kw),
    "wil_lengths": lambda m, kw: m.word_information_lost(["a"], [], **kw),
    "bleu_corpus": lambda m, kw: m.bleu_score(["a", "b"], [["a"]], **kw),
    "bleu_weights": lambda m, kw: m.bleu_score(["a"], [["a"]], n_gram=2, weights=[1.0], **kw),
    "sacre_tokenize": lambda m, kw: m.sacre_bleu_score(["a"], [["a"]], tokenize="moses", **kw),
    "sacre_corpus": lambda m, kw: m.sacre_bleu_score(["a"], [["a"], ["b"]], **kw),
    "sacre_weights": lambda m, kw: m.sacre_bleu_score(["a"], [["a"]], weights=[0.5, 0.5], **kw),
    "chrf_char_order": lambda m, kw: m.chrf_score(["a"], [["a"]], n_char_order=0, **kw),
    "chrf_word_order": lambda m, kw: m.chrf_score(["a"], [["a"]], n_word_order=-1, **kw),
    "chrf_beta": lambda m, kw: m.chrf_score(["a"], [["a"]], beta=-1.0, **kw),
    "chrf_lengths": lambda m, kw: m.chrf_score(["a", "b"], [["a"]], **kw),
    "ter_normalize": lambda m, kw: m.translation_edit_rate(["a"], [["a"]], normalize=1, **kw),
    "ter_punctuation": lambda m, kw: m.translation_edit_rate(["a"], [["a"]], no_punctuation="no", **kw),
    "ter_lowercase": lambda m, kw: m.translation_edit_rate(["a"], [["a"]], lowercase=None, **kw),
    "ter_asian": lambda m, kw: m.translation_edit_rate(["a"], [["a"]], asian_support=0, **kw),
    "eed_language": lambda m, kw: m.extended_edit_distance(["a"], ["a"], language="de", **kw),
    "eed_alpha": lambda m, kw: m.extended_edit_distance(["a"], ["a"], alpha=2, **kw),
    "eed_rho": lambda m, kw: m.extended_edit_distance(["a"], ["a"], rho=-0.1, **kw),
    "eed_not_string": lambda m, kw: m.extended_edit_distance([1], ["a"], **kw),
    "rouge_accumulate": lambda m, kw: m.rouge_score("a", "a", accumulate="max", **kw),
    "rouge_key": lambda m, kw: m.rouge_score("a", "a", rouge_keys=("rouge1", "rougeX"), **kw),
    "squad_pred_keys": lambda m, kw: m.squad([{"text": "a", "id": "1"}], [{"answers": {"text": ["a"]}, "id": "1"}], **kw),
    "squad_target_keys": lambda m, kw: m.squad([{"prediction_text": "a", "id": "1"}], [{"id": "1"}], **kw),
    "squad_answer_text": lambda m, kw: m.squad(
        [{"prediction_text": "a", "id": "1"}], [{"answers": {"answer_start": [0]}, "id": "1"}], **kw
    ),
}
CLASS_ERROR_CASES = {
    "bleu_weights": lambda m, kw: m.BLEUScore(n_gram=3, weights=[1.0], **kw),
    "bleu_update_corpus": lambda m, kw: m.BLEUScore(**kw).update(["a", "b"], [["a"]]),
    "sacre_tokenize": lambda m, kw: m.SacreBLEUScore(tokenize="moses", **kw),
    "chrf_char_order": lambda m, kw: m.CHRFScore(n_char_order=1.5, **kw),
    "chrf_word_order": lambda m, kw: m.CHRFScore(n_word_order=-2, **kw),
    "chrf_beta": lambda m, kw: m.CHRFScore(beta=-0.5, **kw),
    "ter_normalize": lambda m, kw: m.TranslationEditRate(normalize="yes", **kw),
    "ter_asian": lambda m, kw: m.TranslationEditRate(asian_support=1, **kw),
    "eed_language": lambda m, kw: m.ExtendedEditDistance(language="fr", **kw),
    "eed_insertion": lambda m, kw: m.ExtendedEditDistance(insertion=1, **kw),
    "rouge_accumulate": lambda m, kw: m.ROUGEScore(accumulate="sum", **kw),
    "rouge_key": lambda m, kw: m.ROUGEScore(rouge_keys="rouge10", **kw),
    "wer_update_lengths": lambda m, kw: m.WordErrorRate(**kw).update(["a", "b"], ["a"]),
    "squad_update_keys": lambda m, kw: m.SQuAD(**kw).update([{"id": "1"}], [{"answers": {"text": ["a"]}, "id": "1"}]),
}


def _raised(fn):
    with pytest.raises(Exception) as err:
        fn()
    return type(err.value), str(err.value)


@pytest.mark.parametrize("case", sorted(ERROR_CASES))
def test_functional_errors_match_jax(case):
    assert _raised(lambda: ERROR_CASES[case](tf, CPU)) == _raised(lambda: ERROR_CASES[case](jf, {}))


@pytest.mark.parametrize("case", sorted(CLASS_ERROR_CASES))
def test_class_errors_match_jax(case):
    assert _raised(lambda: CLASS_ERROR_CASES[case](tt, CPU)) == _raised(lambda: CLASS_ERROR_CASES[case](jt, {}))


# ------------------------------------------------------------- state loading

STATE_CASES = {
    "WordErrorRate": ({}, "plain"),
    "CharErrorRate": ({}, "plain"),
    "MatchErrorRate": ({}, "plain"),
    "WordInfoLost": ({}, "plain"),
    "WordInfoPreserved": ({}, "plain"),
    "BLEUScore": ({"n_gram": 3}, "multi"),
    "SacreBLEUScore": ({"tokenize": "intl"}, "multi"),
    "CHRFScore": ({"return_sentence_level_score": True}, "multi"),
    "TranslationEditRate": ({"return_sentence_level_score": True}, "multi"),
    "ExtendedEditDistance": ({}, "multi"),
    "ROUGEScore": ({}, "sentences"),
    "SQuAD": ({}, "squad"),
}


@pytest.mark.parametrize("name", sorted(STATE_CASES))
def test_load_jax_state_carries_each_class(name):
    kwargs, kind = STATE_CASES[name]
    if kind == "squad":
        data = batches(*squad_data(15))
    else:
        preds, targets = corpus(16, n=8, refs=1 if kind == "plain" else 2, sentences=kind == "sentences")
        data = batches(preds, single_refs(targets) if kind == "plain" else targets)
    jm = getattr(jt, name)(**kwargs)
    for p, t in data:
        jm.update(p, t)
    jm.persistent(True)
    tm = load_jax_state(getattr(tt, name)(**kwargs, **CPU), jm.state_dict())
    assert_states(tm, jm)
    assert_close(tm.compute(), jm.compute())
    tm.update(*data[0])  # and it goes on accumulating
    jm.update(*data[0])
    assert_close(tm.compute(), jm.compute())


def test_load_jax_state_refuses_a_fractional_count():
    jm = jt.WordErrorRate()
    jm.update(["a b"], ["a c"])
    jm.persistent(True)
    state = dict(jm.state_dict(), errors=np.asarray(1.5, np.float32))
    with pytest.raises(ValueError, match="non-integral"):
        load_jax_state(tt.WordErrorRate(**CPU), state)


# ------------------------------------------------------------- the engines


def test_host_side_classes_stay_eager_in_a_fused_collection():
    from metrics_tpu_torch.core.collections import MetricCollection
    from metrics_tpu_torch.core.fused import engine_for

    preds, targets = corpus(17, n=8)
    refs = single_refs(targets)
    coll = MetricCollection({"wer": tt.WordErrorRate(**CPU), "cer": tt.CharErrorRate(**CPU)}, fused=True)
    alone = tt.WordErrorRate(**CPU)
    for p, t in batches(preds, refs):
        coll.update(p, t)
        alone.update(p, t)
    assert torch.equal(coll.compute()["wer"], alone.compute())
    assert engine_for(coll).stats["launches"] == 0


# --------------------------------------------------------- names and shims


@pytest.mark.parametrize("module,port", [(jt, tt), (jf, tf)], ids=["text", "functional.text"])
def test_every_public_name_but_bertscore_and_infolm_is_ported(module, port):
    """Every public name is ported: BERTScore and InfoLM, the last two, are in too."""
    assert set(port.__all__) == set(module.__all__)
    assert {"BERTScore", "InfoLM"} <= set(port.__all__) or {"bert_score", "infolm"} <= set(port.__all__)
    assert all(hasattr(port, n) for n in port.__all__)


def test_root_exports_match_the_jax_root_for_text():
    for name in tt.__all__:
        assert (name in metrics_tpu.__all__) == (name in metrics_tpu_torch.__all__), name
    for name in tf.__all__:
        assert (name in jfr.__all__) == (name in tfr.__all__), name
    assert {"BERTScore", "InfoLM"} <= set(metrics_tpu_torch.__all__)
    assert {"bert_score", "infolm"} <= set(tfr.__all__)


def _warns(fn) -> bool:
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        fn()
    return any(issubclass(w.category, FutureWarning) for w in caught)


@pytest.mark.parametrize("name", sorted(tt.__all__))
def test_root_class_shims_warn_as_in_jax(name):
    jax_warns = _warns(lambda: getattr(metrics_tpu, name)())
    assert _warns(lambda: getattr(metrics_tpu_torch, name)(**CPU)) == jax_warns
    assert not _warns(lambda: getattr(tt, name)(**CPU))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        assert isinstance(getattr(metrics_tpu_torch, name)(**CPU), getattr(tt, name))


FUNCTIONAL_ARGS = {
    "squad": ([{"prediction_text": "a", "id": "1"}], [{"answers": {"text": ["a"]}, "id": "1"}]),
    "perplexity": (np.zeros((1, 2, 3), np.float32), np.zeros((1, 2), np.int32)),
}


def _numpy_encoder(sentences):
    """A stand-in BERTScore encoder (numpy outputs, which both packages take)."""
    n = len(sentences)
    return np.arange(n * 12, dtype=np.float32).reshape(n, 4, 3) % 5, np.ones((n, 4), np.int64), np.ones((n, 4), np.int64)


def _numpy_tokenizer(sentences, max_length):
    return np.full((len(sentences), max_length), 5, np.int64), np.ones((len(sentences), max_length), np.int64)


# the model functionals get a stand-in model: their defaults load `transformers` weights
FUNCTIONAL_KWARGS = {
    "bert_score": {"encoder": _numpy_encoder},
    "infolm": {"logits_fn": lambda ids, mask: np.ones(ids.shape + (7,), np.float32) * (ids[..., None] % 3),
               "tokenizer_fn": _numpy_tokenizer, "max_length": 4, "idf": False,
               "special_tokens_map": {"pad_token_id": 0, "sep_token_id": 1, "cls_token_id": 2, "mask_token_id": 3}},
}


@pytest.mark.parametrize("name", sorted(tf.__all__))
def test_root_functional_shims_warn_as_in_jax(name):
    args = FUNCTIONAL_ARGS.get(name, (["a b"], [["a b"]] if "bleu" in name or name in ("chrf_score",) else ["a b"]))
    kwargs = FUNCTIONAL_KWARGS.get(name, {})
    jax_args = tuple(jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args)
    jax_warns = _warns(lambda: getattr(jfr, name)(*jax_args, **kwargs))
    assert _warns(lambda: getattr(tfr, name)(*args, **kwargs, **CPU)) == jax_warns
    assert not _warns(lambda: getattr(tf, name)(*args, **kwargs, **CPU))
