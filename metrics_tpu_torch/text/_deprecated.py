"""Root-import shims of the text metrics (counterpart of ``metrics_tpu/text/_deprecated.py``):
built from the package root they warn (``FutureWarning``); from
``metrics_tpu_torch.text`` they stay silent. ``ROUGEScore`` has none: the root
exports it directly, as the JAX root does.
"""
from metrics_tpu_torch.text import (
    BLEUScore,
    CharErrorRate,
    CHRFScore,
    ExtendedEditDistance,
    MatchErrorRate,
    Perplexity,
    SacreBLEUScore,
    SQuAD,
    TranslationEditRate,
    WordErrorRate,
    WordInfoLost,
    WordInfoPreserved,
)
from metrics_tpu_torch.utils.prints import _root_class_shim

_BLEUScore = _root_class_shim(BLEUScore, "BLEUScore", "text", __name__)
_CharErrorRate = _root_class_shim(CharErrorRate, "CharErrorRate", "text", __name__)
_CHRFScore = _root_class_shim(CHRFScore, "CHRFScore", "text", __name__)
_ExtendedEditDistance = _root_class_shim(ExtendedEditDistance, "ExtendedEditDistance", "text", __name__)
_MatchErrorRate = _root_class_shim(MatchErrorRate, "MatchErrorRate", "text", __name__)
_Perplexity = _root_class_shim(Perplexity, "Perplexity", "text", __name__)
_SacreBLEUScore = _root_class_shim(SacreBLEUScore, "SacreBLEUScore", "text", __name__)
_SQuAD = _root_class_shim(SQuAD, "SQuAD", "text", __name__)
_TranslationEditRate = _root_class_shim(TranslationEditRate, "TranslationEditRate", "text", __name__)
_WordErrorRate = _root_class_shim(WordErrorRate, "WordErrorRate", "text", __name__)
_WordInfoLost = _root_class_shim(WordInfoLost, "WordInfoLost", "text", __name__)
_WordInfoPreserved = _root_class_shim(WordInfoPreserved, "WordInfoPreserved", "text", __name__)

__all__ = [
    "_BLEUScore",
    "_CharErrorRate",
    "_CHRFScore",
    "_ExtendedEditDistance",
    "_MatchErrorRate",
    "_Perplexity",
    "_SacreBLEUScore",
    "_SQuAD",
    "_TranslationEditRate",
    "_WordErrorRate",
    "_WordInfoLost",
    "_WordInfoPreserved",
]
