"""Root-functional shims of the retrieval functionals (counterpart of
``metrics_tpu/functional/retrieval/_deprecated.py``): called as
``metrics_tpu_torch.functional.<name>`` they warn (``FutureWarning``); as
``metrics_tpu_torch.functional.retrieval.<name>`` they stay silent.
"""
from metrics_tpu_torch.functional.retrieval import (
    retrieval_average_precision,
    retrieval_fall_out,
    retrieval_hit_rate,
    retrieval_normalized_dcg,
    retrieval_precision,
    retrieval_precision_recall_curve,
    retrieval_r_precision,
    retrieval_recall,
    retrieval_reciprocal_rank,
)
from metrics_tpu_torch.utils.prints import _root_func_shim

_retrieval_average_precision = _root_func_shim(retrieval_average_precision, "retrieval_average_precision", "retrieval")
_retrieval_fall_out = _root_func_shim(retrieval_fall_out, "retrieval_fall_out", "retrieval")
_retrieval_hit_rate = _root_func_shim(retrieval_hit_rate, "retrieval_hit_rate", "retrieval")
_retrieval_normalized_dcg = _root_func_shim(retrieval_normalized_dcg, "retrieval_normalized_dcg", "retrieval")
_retrieval_precision = _root_func_shim(retrieval_precision, "retrieval_precision", "retrieval")
_retrieval_precision_recall_curve = _root_func_shim(
    retrieval_precision_recall_curve, "retrieval_precision_recall_curve", "retrieval"
)
_retrieval_r_precision = _root_func_shim(retrieval_r_precision, "retrieval_r_precision", "retrieval")
_retrieval_recall = _root_func_shim(retrieval_recall, "retrieval_recall", "retrieval")
_retrieval_reciprocal_rank = _root_func_shim(retrieval_reciprocal_rank, "retrieval_reciprocal_rank", "retrieval")

__all__ = [
    "_retrieval_average_precision",
    "_retrieval_fall_out",
    "_retrieval_hit_rate",
    "_retrieval_normalized_dcg",
    "_retrieval_precision",
    "_retrieval_precision_recall_curve",
    "_retrieval_r_precision",
    "_retrieval_recall",
    "_retrieval_reciprocal_rank",
]
