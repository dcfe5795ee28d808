"""Root-functional shims of the text functionals (counterpart of
``metrics_tpu/functional/text/_deprecated.py``): called as
``metrics_tpu_torch.functional.<name>`` they warn (``FutureWarning``); from
``metrics_tpu_torch.functional.text`` they stay silent.
"""
from metrics_tpu_torch.functional.text import (
    bert_score,
    bleu_score,
    char_error_rate,
    chrf_score,
    extended_edit_distance,
    infolm,
    match_error_rate,
    perplexity,
    rouge_score,
    sacre_bleu_score,
    squad,
    translation_edit_rate,
    word_error_rate,
    word_information_lost,
    word_information_preserved,
)
from metrics_tpu_torch.utils.prints import _root_func_shim

_bleu_score = _root_func_shim(bleu_score, "bleu_score", "text")
_char_error_rate = _root_func_shim(char_error_rate, "char_error_rate", "text")
_chrf_score = _root_func_shim(chrf_score, "chrf_score", "text")
_extended_edit_distance = _root_func_shim(extended_edit_distance, "extended_edit_distance", "text")
_match_error_rate = _root_func_shim(match_error_rate, "match_error_rate", "text")
_perplexity = _root_func_shim(perplexity, "perplexity", "text")
_rouge_score = _root_func_shim(rouge_score, "rouge_score", "text")
_sacre_bleu_score = _root_func_shim(sacre_bleu_score, "sacre_bleu_score", "text")
_squad = _root_func_shim(squad, "squad", "text")
_translation_edit_rate = _root_func_shim(translation_edit_rate, "translation_edit_rate", "text")
_word_error_rate = _root_func_shim(word_error_rate, "word_error_rate", "text")
_word_information_lost = _root_func_shim(word_information_lost, "word_information_lost", "text")
_word_information_preserved = _root_func_shim(word_information_preserved, "word_information_preserved", "text")
_bert_score = _root_func_shim(bert_score, "bert_score", "text")
_infolm = _root_func_shim(infolm, "infolm", "text")

__all__ = [
    "_bleu_score",
    "_char_error_rate",
    "_chrf_score",
    "_extended_edit_distance",
    "_match_error_rate",
    "_perplexity",
    "_rouge_score",
    "_sacre_bleu_score",
    "_squad",
    "_translation_edit_rate",
    "_word_error_rate",
    "_word_information_lost",
    "_word_information_preserved",
    "_bert_score",
    "_infolm",
]
