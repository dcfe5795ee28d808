"""SacreBLEU (counterpart of ``metrics_tpu/functional/text/sacre_bleu.py``).

The published sacrebleu tokenizers (mteval-v13a, mteval-v14 international, zh and
char) on the BLEU statistics. ``intl`` uses the ``regex`` package's Unicode property
classes where it is installed and a ``unicodedata`` replay of the same three passes
where it is not, so no optional package is needed.
"""
import re
import unicodedata
from functools import partial
from typing import Optional, Sequence, Union

from torch import Tensor

from metrics_tpu_torch.functional.text.bleu import _bleu_score_compute, _bleu_score_update, _bleu_statistics
from metrics_tpu_torch.utils.data import _resolve_device
from metrics_tpu_torch.utils.imports import _REGEX_AVAILABLE

AVAILABLE_TOKENIZERS = ("none", "13a", "zh", "intl", "char")

# CJK unicode ranges that the sacrebleu `zh` tokenizer isolates
_UCODE_RANGES = (
    ("\u3400", "\u4db5"),  # CJK Unified Ideographs Extension A
    ("\u4e00", "\u9fa5"),  # CJK Unified Ideographs
    ("\u9fa6", "\u9fbb"),
    ("\uf900", "\ufa2d"),  # CJK Compatibility Ideographs
    ("\ufa30", "\ufa6a"),
    ("\ufa70", "\ufad9"),
    ("\U00020000", "\U0002a6d6"),  # CJK Unified Ideographs Extension B
    ("\U0002f800", "\U0002fa1d"),  # CJK Compatibility Supplement
    ("\uff00", "\uffef"),  # full-width ASCII / punctuation, half-width kana
    ("\u2e80", "\u2eff"),  # CJK Radicals Supplement
    ("\u3000", "\u303f"),  # CJK punctuation
    ("\u31c0", "\u31ef"),  # CJK strokes
    ("\u2f00", "\u2fdf"),  # Kangxi Radicals
    ("\u2ff0", "\u2fff"),  # Chinese character structure
    ("\u3100", "\u312f"),  # phonetic symbols
    ("\u31a0", "\u31bf"),
    ("\ufe10", "\ufe1f"),
    ("\ufe30", "\ufe4f"),
    ("\u2600", "\u26ff"),
    ("\u2700", "\u27bf"),
    ("\u3200", "\u32ff"),
    ("\u3300", "\u33ff"),
)

# mteval-v13a language-independent tokenization rules
_13A_RULES = (
    (re.compile(r"([\{-\~\[-\` -\&\(-\+\:-\@\/])"), r" \1 "),
    (re.compile(r"([^0-9])([\.,])"), r"\1 \2 "),
    (re.compile(r"([\.,])([^0-9])"), r" \1 \2"),
    (re.compile(r"([0-9])(-)"), r"\1 \2 "),
)

if _REGEX_AVAILABLE:
    import regex

    _INT_RULES = (
        (regex.compile(r"(\P{N})(\p{P})"), r"\1 \2 "),
        (regex.compile(r"(\p{P})(\P{N})"), r" \1 \2"),
        (regex.compile(r"(\p{S})"), r" \1 "),
    )


def _pair_rule_pass(line: str, first_ok, second_ok, template: str) -> str:
    """One ``s/(X)(Y)/template/g`` pass with a regex's non-overlapping scan."""
    out = []
    i = 0
    while i < len(line):
        if i + 1 < len(line) and first_ok(line[i]) and second_ok(line[i + 1]):
            out.append(template.format(line[i], line[i + 1]))
            i += 2
        else:
            out.append(line[i])
            i += 1
    return "".join(out)


def _intl_tokenize_fallback(line: str) -> str:
    """mteval-v14 international tokenization through ``unicodedata`` categories.

    Replays the three passes ``(\\P{N})(\\p{P}) -> 1 2_``, ``(\\p{P})(\\P{N}) -> _1 2``
    and ``(\\p{S}) -> _1_`` in turn, each with a regex's non-overlapping scan (a
    per-character context test differs on punctuation runs such as ``5...``).
    """
    is_n = lambda ch: unicodedata.category(ch).startswith("N")  # noqa: E731
    is_p = lambda ch: unicodedata.category(ch).startswith("P")  # noqa: E731
    is_s = lambda ch: unicodedata.category(ch).startswith("S")  # noqa: E731
    line = _pair_rule_pass(line, lambda c: not is_n(c), is_p, "{0} {1} ")
    line = _pair_rule_pass(line, is_p, lambda c: not is_n(c), " {0} {1}")
    return "".join(f" {ch} " if is_s(ch) else ch for ch in line)


class _SacreBLEUTokenizer:
    """The sacrebleu line tokenizers, chosen by name."""

    _TOKENIZE_FN = {
        "none": "_tokenize_base",
        "13a": "_tokenize_13a",
        "zh": "_tokenize_zh",
        "intl": "_tokenize_international",
        "char": "_tokenize_char",
    }

    def __init__(self, tokenize: str, lowercase: bool = False) -> None:
        self.tokenize_fn = getattr(self, self._TOKENIZE_FN[tokenize])
        self.lowercase = lowercase

    def __call__(self, line: str) -> Sequence[str]:
        tokenized = self.tokenize_fn(line)
        return (tokenized.lower() if self.lowercase else tokenized).split()

    @classmethod
    def tokenize(cls, line: str, tokenize: str, lowercase: bool = False) -> Sequence[str]:
        tokenized = getattr(cls, cls._TOKENIZE_FN[tokenize])(line)
        return (tokenized.lower() if lowercase else tokenized).split()

    @classmethod
    def _tokenize_regex(cls, line: str) -> str:
        for pattern, repl in _13A_RULES:
            line = pattern.sub(repl, line)
        return " ".join(line.split())

    @staticmethod
    def _is_chinese_char(uchar: str) -> bool:
        return any(start <= uchar <= end for start, end in _UCODE_RANGES)

    @classmethod
    def _tokenize_base(cls, line: str) -> str:
        return line

    @classmethod
    def _tokenize_13a(cls, line: str) -> str:
        line = line.replace("<skipped>", "").replace("-\n", "").replace("\n", " ")
        if "&" in line:
            line = line.replace("&quot;", '"').replace("&amp;", "&").replace("&lt;", "<").replace("&gt;", ">")
        return cls._tokenize_regex(line)

    @classmethod
    def _tokenize_zh(cls, line: str) -> str:
        chars = []
        for ch in line.strip():
            chars.append(f" {ch} " if cls._is_chinese_char(ch) else ch)
        return cls._tokenize_regex("".join(chars))

    @classmethod
    def _tokenize_international(cls, line: str) -> str:
        if _REGEX_AVAILABLE:
            for pattern, repl in _INT_RULES:
                line = pattern.sub(repl, line)
        else:
            line = _intl_tokenize_fallback(line)
        return " ".join(line.split())

    @classmethod
    def _tokenize_char(cls, line: str) -> str:
        return " ".join(line)


def sacre_bleu_score(
    preds: Sequence[str],
    target: Sequence[Union[str, Sequence[str]]],
    n_gram: int = 4,
    smooth: bool = False,
    tokenize: str = "13a",
    lowercase: bool = False,
    weights: Optional[Sequence[float]] = None,
    device=None,
) -> Tensor:
    """BLEU with sacrebleu's tokenization, on ``device`` (``cuda`` unless named)."""
    device = _resolve_device(device)
    if tokenize not in AVAILABLE_TOKENIZERS:
        raise ValueError(f"Argument `tokenize` expected to be one of {AVAILABLE_TOKENIZERS} but got {tokenize}.")
    if len(preds) != len(target):
        raise ValueError(f"Corpus has different size {len(preds)} != {len(target)}")
    if weights is not None and len(weights) != n_gram:
        raise ValueError(f"List of weights has different weights than `n_gram`: {len(weights)} != {n_gram}")
    if weights is None:
        weights = [1.0 / n_gram] * n_gram

    target_ = [[tgt] if isinstance(tgt, str) else tgt for tgt in target]
    tokenize_fn = partial(_SacreBLEUTokenizer.tokenize, tokenize=tokenize, lowercase=lowercase)
    stats = _bleu_statistics(device, *_bleu_score_update(preds, target_, n_gram, tokenize_fn))
    return _bleu_score_compute(*stats, n_gram, weights, smooth)
