"""The BERT/RoBERTa encoder, its masked-LM head, BERTScore and InfoLM of
metrics_tpu_torch against metrics_tpu, on the CPU.

Seeded numpy weights in the HF state-dict layout (both variants, both MLM head
layouts, with the ``bert.``/``roberta.`` prefixes), the tiny BERT of
``tests/unittests/text/test_bert_jax_port.py`` (hidden 64, 4 heads, 2 layers, vocab
50), and one word-level tokenizer object fed to both packages:

- the encoder's hidden states on attended positions within 2e-4, the MLM logits within
  3e-4 (the tied-decoder fallback too), the frozen ``bert_golden.npz`` within 2e-4;
- the checkpoint builders (``torch_bert_encoder``/``torch_mlm_logits_fn`` against the
  JAX ones) on the same ``.npz`` file;
- BERTScore P/R/F1 with and without idf, rescaled, and the class over updates, within
  1e-5; ``masked_lm_distribution`` within 1e-5; InfoLM's nine measures (functional and
  class) within 1e-4, and each measure's ``ValueError``s by message;
- the default ``transformers`` paths with fakes patched over ``from_pretrained``;
- ``bert_state_from_jax`` and ``load_jax_state`` of the two classes.
"""
import sys
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu.functional.text as jf
import metrics_tpu.text as jt
import metrics_tpu_torch.functional.text as tf
import metrics_tpu_torch.text as tt
import metrics_tpu.functional.text.bert as j_bert_fn
import metrics_tpu.functional.text.infolm  # noqa: F401  (the package exports a function of that name)
import metrics_tpu.models.bert as j_bert
import metrics_tpu_torch.functional.text.bert as t_bert_fn
import metrics_tpu_torch.functional.text.infolm  # noqa: F401
import metrics_tpu_torch.models.bert as t_bert
from metrics_tpu_torch.convert import bert_state_from_jax, load_jax_state

j_infolm_fn = sys.modules["metrics_tpu.functional.text.infolm"]
t_infolm_fn = sys.modules["metrics_tpu_torch.functional.text.infolm"]

CPU = {"device": "cpu"}
HIDDEN, HEADS, LAYERS, VOCAB = 64, 4, 2, 50
FIXTURES = __file__.rsplit("/", 1)[0] + "/fixtures"
WORDS = "the cat sat on a mat big tree near house is there another one dog ran far away".split()
SPECIAL = {"pad_token_id": 0, "cls_token_id": 2, "sep_token_id": 3, "mask_token_id": 4}
MEASURES = [
    ("kl_divergence", None, None), ("alpha_divergence", 0.5, None), ("beta_divergence", None, 0.5),
    ("ab_divergence", 0.5, 0.5), ("renyi_divergence", 0.5, None), ("l1_distance", None, None),
    ("l2_distance", None, None), ("l_infinity_distance", None, None), ("fisher_rao_distance", None, None),
]


def hf_bert_state(variant: str, seed: int, mlm: bool = False, prefix: str = "", positions: int = 64) -> dict:
    """A HF ``BertModel``/``RobertaModel`` (``*ForMaskedLM`` with ``mlm``) state dict of
    seeded weights, under ``prefix``."""
    rng = np.random.RandomState(seed)

    def w(*shape, scale=0.05):
        return (rng.randn(*shape) * scale).astype(np.float32)

    def ln(key):
        state[f"{key}.weight"] = (1 + w(HIDDEN, scale=0.1)).astype(np.float32)
        state[f"{key}.bias"] = w(HIDDEN, scale=0.1)

    def lin(key, i, o):
        state[f"{key}.weight"], state[f"{key}.bias"] = w(o, i), w(o, scale=0.02)

    state = {"embeddings.word_embeddings.weight": w(VOCAB, HIDDEN, scale=0.5),
             "embeddings.position_embeddings.weight": w(positions, HIDDEN, scale=0.5),
             "embeddings.token_type_embeddings.weight": w(2, HIDDEN, scale=0.5)}
    ln("embeddings.LayerNorm")
    for i in range(LAYERS):
        base = f"encoder.layer.{i}."
        for name in ("attention.self.query", "attention.self.key", "attention.self.value", "attention.output.dense"):
            lin(base + name, HIDDEN, HIDDEN)
        ln(base + "attention.output.LayerNorm")
        lin(base + "intermediate.dense", HIDDEN, 4 * HIDDEN)
        lin(base + "output.dense", 4 * HIDDEN, HIDDEN)
        ln(base + "output.LayerNorm")
    state = {prefix + k: v for k, v in state.items()}
    if mlm:
        head = "cls.predictions.transform." if variant == "bert" else "lm_head."
        lin(head + "dense", HIDDEN, HIDDEN)
        ln(head + ("LayerNorm" if variant == "bert" else "layer_norm"))
        decoder = "cls.predictions." if variant == "bert" else "lm_head."
        state[decoder + "decoder.weight"] = w(VOCAB, HIDDEN, scale=0.3)
        state[decoder + "bias"] = w(VOCAB, scale=0.1)
    return state


def rand_inputs(seed: int):
    rng = np.random.RandomState(seed)
    ids = rng.randint(5, VOCAB, (3, 12)).astype(np.int64)
    mask = np.ones((3, 12), np.int64)
    mask[0, 8:] = 0
    mask[2, 5:] = 0
    ids[mask == 0] = 1
    return ids, mask


class WordTokenizer:
    """A HF-style word tokenizer: ``[CLS] words [SEP]`` with ids from a seeded CRC of
    each word, padded to the longest row (``padding="max_length"``: to ``max_length``)."""

    def __init__(self, cls_id=2, sep_id=3, pad_id=0, first=5, seed=7):
        self.cls_token_id, self.sep_token_id, self.pad_token_id, self.mask_token_id = cls_id, sep_id, pad_id, 4
        self.first, self.seed = first, seed

    def ids(self, sentence: str, max_length: int) -> list:
        words = [self.first + zlib.crc32(w.encode(), self.seed) % (VOCAB - self.first) for w in sentence.split()]
        return [self.cls_token_id] + words[: max_length - 2] + [self.sep_token_id]

    def __call__(self, sentences, padding=True, truncation=True, max_length=512, return_tensors="np"):
        rows = [self.ids(s, max_length) for s in sentences]
        width = max_length if padding == "max_length" else max(len(r) for r in rows)
        ids = np.full((len(rows), width), self.pad_token_id, np.int64)
        mask = np.zeros((len(rows), width), np.int64)
        for r, row in enumerate(rows):
            ids[r, : len(row)] = row
            mask[r, : len(row)] = 1
        if return_tensors == "pt":
            return {"input_ids": torch.from_numpy(ids), "attention_mask": torch.from_numpy(mask)}
        return {"input_ids": ids, "attention_mask": mask}

    def tokenizer_fn(self, sentences, max_length):
        batch = self(sentences, padding="max_length", max_length=max_length)
        return batch["input_ids"], batch["attention_mask"]


def corpus(seed: int, n: int):
    rng = np.random.RandomState(seed)

    def sentence():
        return " ".join(WORDS[i] for i in rng.randint(0, len(WORDS), rng.randint(2, 9)))

    preds = [sentence() for _ in range(n)]
    target = [p if rng.rand() < 0.25 else sentence() for p in preds]
    return preds, target


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tiny forwards run op by op; more threads than one only contend (and the
    JAX side has its own pool)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def close(got, want, atol, rtol=0.0):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=rtol)


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """``.npz`` checkpoints of both variants, encoder and masked LM."""
    root = tmp_path_factory.mktemp("bert")
    paths = {}
    for variant, prefix in (("bert", "bert."), ("roberta", "roberta.")):
        for mlm in (False, True):
            path = root / f"{variant}_{'mlm' if mlm else 'enc'}.npz"
            np.savez(path, **hf_bert_state(variant, 3 if mlm else 2, mlm, prefix))
            paths[variant, mlm] = str(path)
    return paths


@pytest.fixture(scope="module")
def encoders(checkpoints):
    tok = WordTokenizer()
    return (j_bert.jax_bert_encoder(checkpoints["bert", False], tok, num_heads=HEADS),
            t_bert.torch_bert_encoder(checkpoints["bert", False], tok, num_heads=HEADS, **CPU))


@pytest.fixture(scope="module")
def logits_fns(checkpoints):
    return (j_bert.jax_mlm_logits_fn(checkpoints["bert", True], num_heads=HEADS),
            t_bert.torch_mlm_logits_fn(checkpoints["bert", True], num_heads=HEADS, **CPU))


# ------------------------------------------------------------------ the encoder


@pytest.mark.parametrize("variant", ["bert", "roberta"])
def test_encoder_matches_jax(variant):
    state = hf_bert_state(variant, 0, prefix=f"{variant}.")
    eps = 1e-5 if variant == "roberta" else 1e-12
    ids, mask = rand_inputs(0)
    pos = t_bert.bert_position_ids(mask, variant)
    np.testing.assert_array_equal(pos, j_bert.bert_position_ids(mask, variant))
    want = np.asarray(j_bert.bert_forward(j_bert.params_from_state_dict(state), jnp.asarray(ids), jnp.asarray(mask),
                                          jnp.asarray(pos), HEADS, eps))
    model = t_bert.BertEncoder.from_state(t_bert.params_from_state_dict(state), HEADS, eps, **CPU)
    got = model(*(torch.as_tensor(np.ascontiguousarray(a)) for a in (ids, mask, pos)))
    m = mask.astype(bool)
    close(got.numpy()[m], want[m], 2e-4)
    assert got.dtype == torch.float32 and got.shape == want.shape


@pytest.mark.parametrize("variant", ["bert", "roberta"])
@pytest.mark.parametrize("tied", [False, True], ids=["decoder", "tied"])
def test_mlm_head_matches_jax(variant, tied):
    state = hf_bert_state(variant, 1, mlm=True)
    if tied:  # save_pretrained strips the tied decoder weight
        state.pop("cls.predictions.decoder.weight" if variant == "bert" else "lm_head.decoder.weight")
    eps = 1e-5 if variant == "roberta" else 1e-12
    ids, mask = rand_inputs(3)
    pos = t_bert.bert_position_ids(mask, variant)
    want = np.asarray(j_bert.bert_mlm_logits(j_bert.mlm_params_from_state_dict(state), jnp.asarray(ids),
                                             jnp.asarray(mask), jnp.asarray(pos), HEADS, eps))
    model = t_bert.BertEncoder.from_state(t_bert.mlm_params_from_state_dict(state), HEADS, eps, **CPU)
    got = model.mlm_logits(*(torch.as_tensor(np.ascontiguousarray(a)) for a in (ids, mask, pos)))
    m = mask.astype(bool)
    close(got.numpy()[m], want[m], 3e-4)


def test_state_dict_errors_match_jax():
    state = hf_bert_state("bert", 0)
    for fn in ("params_from_state_dict", "mlm_params_from_state_dict"):
        bad = {k: v for k, v in state.items() if "encoder.layer" not in k} if fn == "params_from_state_dict" else state
        with pytest.raises(ValueError) as want:
            getattr(j_bert, fn)(bad)
        with pytest.raises(ValueError) as got:
            getattr(t_bert, fn)(bad)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="masked-LM head"):
        t_bert.BertEncoder.from_state(t_bert.params_from_state_dict(state), HEADS, **CPU).mlm_logits(
            *(torch.zeros((1, 4), dtype=torch.int64),) * 3)


def test_bert_frozen_golden():
    data = np.load(f"{FIXTURES}/bert_golden.npz")
    state = {k.split("::", 1)[1]: data[k] for k in data.files if k.startswith("state::")}
    model = t_bert.BertEncoder.from_state(t_bert.params_from_state_dict(state), num_heads=4, **CPU)
    got = model(*(torch.as_tensor(data[k], dtype=torch.int64) for k in ("ids", "mask", "pos_ids")))
    close(got, data["hidden"], 2e-4)


def test_bert_state_from_jax_gives_equal_outputs():
    state = hf_bert_state("roberta", 5, mlm=True, prefix="roberta.")
    ids, mask = rand_inputs(5)
    pos = torch.as_tensor(t_bert.bert_position_ids(mask, "roberta"))
    ids, mask = torch.as_tensor(ids), torch.as_tensor(mask)
    direct = t_bert.BertEncoder.from_state(t_bert.mlm_params_from_state_dict(state), HEADS, 1e-5, **CPU)
    carried = t_bert.BertEncoder.from_state(bert_state_from_jax(j_bert.mlm_params_from_state_dict(state)), HEADS,
                                            1e-5, **CPU)
    assert torch.equal(direct.mlm_logits(ids, mask, pos), carried.mlm_logits(ids, mask, pos))


@pytest.mark.parametrize("variant", ["bert", "roberta"])
def test_checkpoint_builders_match_jax(checkpoints, variant):
    tok = WordTokenizer(pad_id=1 if variant == "roberta" else 0)
    sentences = corpus(1, 5)[0]
    j_out = j_bert.jax_bert_encoder(checkpoints[variant, False], tok, variant, num_heads=HEADS)(sentences)
    t_out = t_bert.torch_bert_encoder(checkpoints[variant, False], tok, variant, num_heads=HEADS, **CPU)(sentences)
    np.testing.assert_array_equal(t_out[1], j_out[1])
    np.testing.assert_array_equal(t_out[2], j_out[2])
    m = t_out[2].astype(bool)
    close(t_out[0].numpy()[m], np.asarray(j_out[0])[m], 2e-4)
    ids, mask = tok.tokenizer_fn(sentences, 16)
    want = np.asarray(j_bert.jax_mlm_logits_fn(checkpoints[variant, True], variant, num_heads=HEADS)(ids, mask))
    got = t_bert.torch_mlm_logits_fn(checkpoints[variant, True], variant, num_heads=HEADS, **CPU)(ids, mask)
    assert tuple(got.shape) == want.shape
    close(got.numpy()[mask.astype(bool)], want[mask.astype(bool)], 3e-4)


def test_builders_refuse_rows_past_the_position_table(checkpoints):
    logits_fn = t_bert.torch_mlm_logits_fn(checkpoints["roberta", True], "roberta", num_heads=HEADS, **CPU)
    ids = np.zeros((1, 63), np.int64)
    with pytest.raises(ValueError, match="usable position range"):
        logits_fn(ids, ids)


def test_pad_token_batch_matches_jax():
    from metrics_tpu.models._transformer import pad_token_batch as j_pad
    from metrics_tpu_torch.models._transformer import pad_token_batch as t_pad

    for s, cap in ((3, None), (8, None), (9, None), (9, 12), (30, 20)):
        ids, mask = np.arange(2 * s).reshape(2, s), np.ones((2, s), np.int64)
        for a, b in zip(t_pad(ids, mask, 1, cap=cap), j_pad(ids, mask, 1, cap=cap)):
            np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------------- BERTScore


@pytest.mark.parametrize("idf", [False, True], ids=["no_idf", "idf"])
@pytest.mark.parametrize("rescale", [False, True], ids=["raw", "rescaled"])
def test_bert_score_matches_jax(encoders, idf, rescale):
    preds, target = corpus(3, 7)
    kwargs = {"idf": idf, "rescale_with_baseline": rescale, "baseline": [0.1, 0.2, 0.3] if rescale else None,
              "return_hash": True, "model_name_or_path": "tiny"}
    want = j_bert_fn.bert_score(preds, target, encoder=encoders[0], **kwargs)
    got = t_bert_fn.bert_score(preds, target, encoder=encoders[1], **kwargs, **CPU)
    assert got["hash"] == want["hash"]
    for key in ("precision", "recall", "f1"):
        assert got[key].dtype == torch.float32 and got[key].device.type == "cpu"
        close(got[key], want[key], 1e-5)


def test_bert_score_identical_sentence_and_errors(encoders):
    got = tf.bert_score(["the cat sat on the mat", "hello"], ["the cat sat on the mat", "world"], encoders[1], **CPU)
    assert float(got["f1"][0]) == pytest.approx(1.0, abs=1e-5)
    for fn, enc in ((jf.bert_score, encoders[0]), (tf.bert_score, encoders[1])):
        with pytest.raises(ValueError, match="same length"):
            fn(["a"], ["a", "b"], enc)
        with pytest.raises(ValueError, match="baseline"):
            fn(["a b"], ["a b"], enc, rescale_with_baseline=True)


def test_special_token_mask_and_idf_scale_match_jax():
    mask = np.array([[1, 1, 1, 1, 0], [1, 1, 0, 0, 0], [1, 0, 0, 0, 0], [1, 1, 1, 1, 1]])
    np.testing.assert_array_equal(t_bert_fn._process_attention_mask_for_special_tokens(mask),
                                  j_bert_fn._process_attention_mask_for_special_tokens(mask))
    ids = np.arange(20).reshape(4, 5) % 7
    special = t_bert_fn._process_attention_mask_for_special_tokens(mask)
    for idf_map in (None, t_bert_fn._tokens_idf(ids)):
        np.testing.assert_array_equal(t_bert_fn._idf_scale(ids, special, idf_map),
                                      j_bert_fn._idf_scale(ids, special, idf_map))


@pytest.mark.parametrize("idf", [False, True], ids=["no_idf", "idf"])
def test_bertscore_class_matches_jax(encoders, idf):
    preds, target = corpus(4, 9)
    jm = jt.BERTScore(encoder=encoders[0], idf=idf)
    tm = tt.BERTScore(encoder=encoders[1], idf=idf, **CPU)
    for lo in (0, 3, 6):
        want = jm(preds[lo:lo + 3], target[lo:lo + 3])
        got = tm(preds[lo:lo + 3], target[lo:lo + 3])
        for key in ("precision", "recall", "f1"):
            close(got[key], want[key], 1e-5)
    want, got = jm.compute(), tm.compute()
    for key in ("precision", "recall", "f1"):
        close(got[key], want[key], 1e-5)
    assert tm._preds_corpus == jm._preds_corpus and tm._target_corpus == jm._target_corpus
    tm.reset()
    assert tm._preds_corpus == [] and tm._target_corpus == []
    with pytest.raises(ValueError, match="same length"):
        tm.update(["a"], ["a", "b"])


# ---------------------------------------------------------------------- InfoLM


@pytest.mark.parametrize("idf", [False, True], ids=["no_idf", "idf"])
def test_masked_lm_distribution_matches_jax(logits_fns, idf):
    tok = WordTokenizer()
    ids, mask = tok.tokenizer_fn(corpus(5, 4)[0], 12)
    weights = j_infolm_fn._input_ids_idf(ids, j_infolm_fn._tokens_idf(ids)) if idf else None
    want = j_infolm_fn.masked_lm_distribution(ids, mask, logits_fns[0], SPECIAL, 0.25, weights)
    got = t_infolm_fn.masked_lm_distribution(ids, mask, logits_fns[1], SPECIAL, 0.25, weights, **CPU)
    close(got, want, 1e-5)
    close(got.sum(-1), np.ones(len(ids)), 1e-5)


@pytest.mark.parametrize("measure,alpha,beta", MEASURES, ids=[m[0] for m in MEASURES])
def test_infolm_measures_match_jax(logits_fns, measure, alpha, beta):
    tok = WordTokenizer()
    preds, target = corpus(6, 4)
    kwargs = {"information_measure": measure, "alpha": alpha, "beta": beta, "max_length": 12,
              "tokenizer_fn": tok.tokenizer_fn, "special_tokens_map": SPECIAL, "return_sentence_level_score": True}
    want = jf.infolm(preds, target, logits_fn=logits_fns[0], **kwargs)
    got = tf.infolm(preds, target, logits_fn=logits_fns[1], **kwargs, **CPU)
    if measure == "fisher_rao_distance":
        # 2 arccos(c) has an unbounded slope at c = 1: on the pair of identical
        # sentences the two packages' float32 sums c differ by one ulp, which the
        # arccos turns into ~3e-4. Hold c = cos(d / 2) there, and d elsewhere.
        c_got, c_want = torch.cos(got[1] / 2).numpy(), np.cos(np.asarray(want[1]) / 2)
        close(c_got, c_want, 1e-6)
        far = c_want < 1 - 1e-6
        assert far.sum() >= 2
        close(got[1].numpy()[far], np.asarray(want[1])[far], 1e-4)
        return
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        close(g, w, 1e-4 * max(1.0, float(np.max(np.abs(np.asarray(w))))))


@pytest.mark.parametrize("measure,alpha,beta", MEASURES[:5], ids=[m[0] for m in MEASURES[:5]])
def test_infolm_class_matches_jax(logits_fns, measure, alpha, beta):
    tok = WordTokenizer()
    preds, target = corpus(7, 6)
    kwargs = {"information_measure": measure, "alpha": alpha, "beta": beta, "max_length": 12, "idf": False,
              "tokenizer_fn": tok.tokenizer_fn, "special_tokens_map": SPECIAL}
    jm = jt.InfoLM(logits_fn=logits_fns[0], **kwargs)
    tm = tt.InfoLM(logits_fn=logits_fns[1], **kwargs, **CPU)
    for lo in (0, 2, 4):
        jm.update(preds[lo:lo + 2], target[lo:lo + 2])
        tm.update(preds[lo:lo + 2], target[lo:lo + 2])
    want = float(np.asarray(jm.compute()))
    close(tm.compute(), want, 1e-4 * max(1.0, abs(want)))


def _errors(fn, *args, **kwargs):
    with pytest.raises(ValueError) as err:
        fn(*args, **kwargs)
    return str(err.value)


@pytest.mark.parametrize("kwargs", [
    {"information_measure": "nope"},
    {"information_measure": "alpha_divergence"}, {"information_measure": "alpha_divergence", "alpha": 1.0},
    {"information_measure": "alpha_divergence", "alpha": 0.0},
    {"information_measure": "beta_divergence"}, {"information_measure": "beta_divergence", "beta": -1.0},
    {"information_measure": "beta_divergence", "beta": 0.0},
    {"information_measure": "ab_divergence", "alpha": 0.5}, {"information_measure": "ab_divergence", "beta": 0.5},
    {"information_measure": "ab_divergence", "alpha": 0.5, "beta": -0.5},
    {"information_measure": "renyi_divergence"}, {"information_measure": "renyi_divergence", "alpha": 1.0},
    {"temperature": 0.0},
], ids=lambda k: "-".join(f"{v}" for v in k.values()))
def test_infolm_errors_match_jax(kwargs):
    assert _errors(tt.InfoLM, **kwargs, **CPU) == _errors(jt.InfoLM, **kwargs)
    assert _errors(tf.infolm, "a", "a", **kwargs, logits_fn=len, tokenizer_fn=len, special_tokens_map={}) == \
        _errors(jf.infolm, "a", "a", **kwargs, logits_fn=len, tokenizer_fn=len, special_tokens_map={})


def test_infolm_argument_errors_match_jax(logits_fns):
    tok = WordTokenizer()
    assert _errors(tf.infolm, "a", "a", logits_fn=logits_fns[1], **CPU) == \
        _errors(jf.infolm, "a", "a", logits_fn=logits_fns[0])
    kwargs = {"tokenizer_fn": tok.tokenizer_fn, "special_tokens_map": SPECIAL, "max_length": 8}
    assert _errors(tf.infolm, ["a"], ["a", "b"], logits_fn=logits_fns[1], **kwargs, **CPU) == \
        _errors(jf.infolm, ["a"], ["a", "b"], logits_fn=logits_fns[0], **kwargs)


def test_beta_divergence_sets_alpha_as_in_jax():
    jm = j_infolm_fn._InformationMeasure("beta_divergence", beta=0.5)
    tm = t_infolm_fn._InformationMeasure("beta_divergence", beta=0.5)
    p = np.random.RandomState(0).dirichlet(np.ones(6), 3).astype(np.float32)
    t = np.random.RandomState(1).dirichlet(np.ones(6), 3).astype(np.float32)
    close(tm(torch.from_numpy(p), torch.from_numpy(t)), jm(jnp.asarray(p), jnp.asarray(t)), 1e-5)
    assert tm.alpha == jm.alpha == 1.0


# --------------------------------------------------- the default transformers paths


class _FakeModel:
    """``from_pretrained``'s stand-in: a seeded embedding table as the last hidden
    state, and (as a masked LM) a seeded projection of it as the logits."""

    def __init__(self, mlm: bool):
        g = torch.Generator().manual_seed(0)
        self.table = torch.randn(VOCAB, 12, generator=g)
        self.head = torch.randn(12, VOCAB, generator=g)
        self.mlm = mlm

    def eval(self):
        return self

    def to(self, device):
        return self

    def __call__(self, input_ids, attention_mask):
        hidden = self.table[input_ids] * attention_mask[..., None]
        hidden = hidden + torch.roll(hidden, 1, dims=1) * 0.5

        class Out:
            last_hidden_state = hidden
            logits = hidden @ self.head

        return Out()


def _patch_transformers(monkeypatch, tok):
    import transformers

    monkeypatch.setattr(transformers.AutoTokenizer, "from_pretrained", classmethod(lambda cls, n: tok))
    monkeypatch.setattr(transformers.AutoModel, "from_pretrained", classmethod(lambda cls, n: _FakeModel(False)))
    monkeypatch.setattr(transformers.AutoModelForMaskedLM, "from_pretrained",
                        classmethod(lambda cls, n: _FakeModel(True)))


def test_default_transformers_paths_match_jax(monkeypatch):
    pytest.importorskip("transformers")
    tok = WordTokenizer()
    _patch_transformers(monkeypatch, tok)
    preds, target = corpus(8, 5)
    want = jf.bert_score(preds, target, model_name_or_path="fake", idf=True)
    got = tf.bert_score(preds, target, model_name_or_path="fake", idf=True, **CPU)
    for key in ("precision", "recall", "f1"):
        close(got[key], want[key], 1e-5)
    jm, tm = jt.BERTScore(), tt.BERTScore(**CPU)
    jm.update(preds, target)
    tm.update(preds, target)
    close(tm.compute()["f1"], jm.compute()["f1"], 1e-5)

    want = jf.infolm(preds, target, model_name_or_path="fake", max_length=10)
    got = tf.infolm(preds, target, model_name_or_path="fake", max_length=10, **CPU)
    close(got, want, 1e-4 * max(1.0, abs(float(np.asarray(want)))))
    jm, tm = jt.InfoLM(max_length=10), tt.InfoLM(max_length=10, **CPU)
    jm.update(preds, target)
    tm.update(preds, target)
    close(tm.compute(), jm.compute(), 1e-4 * max(1.0, abs(float(np.asarray(want)))))


# ------------------------------------------------------------ load_jax_state


def test_load_jax_state_of_the_corpora(encoders, logits_fns):
    preds, target = corpus(9, 4)
    for jm, tm in ((jt.BERTScore(encoder=encoders[0]), tt.BERTScore(encoder=encoders[1], **CPU)),
                   (jt.InfoLM(logits_fn=logits_fns[0], tokenizer_fn=WordTokenizer().tokenizer_fn,
                              special_tokens_map=SPECIAL, max_length=10),
                    tt.InfoLM(logits_fn=logits_fns[1], tokenizer_fn=WordTokenizer().tokenizer_fn,
                              special_tokens_map=SPECIAL, max_length=10, **CPU))):
        jm.update(preds, target)
        jm.persistent(True)
        load_jax_state(tm, jm.state_dict())
        assert tm._preds_corpus == preds and tm._target_corpus == target
        want, got = jm.compute(), tm.compute()
        if isinstance(want, dict):
            want, got = want["f1"], got["f1"]
        close(got, want, 1e-4 * max(1.0, float(np.max(np.abs(np.asarray(want))))))
