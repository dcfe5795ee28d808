"""Functional entry points of metrics_tpu_torch: every classification functional, and
the retrieval functionals through root shims that warn (as in ``metrics_tpu.functional``);
``metrics_tpu_torch.functional.retrieval`` gives them silently.
"""
from metrics_tpu_torch.functional.classification import *  # noqa: F401,F403
from metrics_tpu_torch.functional.classification import __all__ as _classification_all
from metrics_tpu_torch.functional.retrieval._deprecated import (
    _retrieval_average_precision as retrieval_average_precision,
    _retrieval_fall_out as retrieval_fall_out,
    _retrieval_hit_rate as retrieval_hit_rate,
    _retrieval_normalized_dcg as retrieval_normalized_dcg,
    _retrieval_precision as retrieval_precision,
    _retrieval_precision_recall_curve as retrieval_precision_recall_curve,
    _retrieval_r_precision as retrieval_r_precision,
    _retrieval_recall as retrieval_recall,
    _retrieval_reciprocal_rank as retrieval_reciprocal_rank,
)

__all__ = _classification_all + [
    "retrieval_average_precision",
    "retrieval_fall_out",
    "retrieval_hit_rate",
    "retrieval_normalized_dcg",
    "retrieval_precision",
    "retrieval_precision_recall_curve",
    "retrieval_r_precision",
    "retrieval_recall",
    "retrieval_reciprocal_rank",
]
