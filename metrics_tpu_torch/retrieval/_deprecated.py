"""Root-import shims of the retrieval metrics (counterpart of
``metrics_tpu/retrieval/_deprecated.py``): built from the package root they warn
(``FutureWarning``); from ``metrics_tpu_torch.retrieval`` they stay silent.
"""
from metrics_tpu_torch.retrieval import (
    RetrievalFallOut,
    RetrievalHitRate,
    RetrievalMAP,
    RetrievalMRR,
    RetrievalNormalizedDCG,
    RetrievalPrecision,
    RetrievalPrecisionRecallCurve,
    RetrievalRecall,
    RetrievalRecallAtFixedPrecision,
    RetrievalRPrecision,
)
from metrics_tpu_torch.utils.prints import _root_class_shim

_RetrievalFallOut = _root_class_shim(RetrievalFallOut, "RetrievalFallOut", "retrieval", __name__)
_RetrievalHitRate = _root_class_shim(RetrievalHitRate, "RetrievalHitRate", "retrieval", __name__)
_RetrievalMAP = _root_class_shim(RetrievalMAP, "RetrievalMAP", "retrieval", __name__)
_RetrievalMRR = _root_class_shim(RetrievalMRR, "RetrievalMRR", "retrieval", __name__)
_RetrievalNormalizedDCG = _root_class_shim(RetrievalNormalizedDCG, "RetrievalNormalizedDCG", "retrieval", __name__)
_RetrievalPrecision = _root_class_shim(RetrievalPrecision, "RetrievalPrecision", "retrieval", __name__)
_RetrievalPrecisionRecallCurve = _root_class_shim(
    RetrievalPrecisionRecallCurve, "RetrievalPrecisionRecallCurve", "retrieval", __name__
)
_RetrievalRecall = _root_class_shim(RetrievalRecall, "RetrievalRecall", "retrieval", __name__)
_RetrievalRecallAtFixedPrecision = _root_class_shim(
    RetrievalRecallAtFixedPrecision, "RetrievalRecallAtFixedPrecision", "retrieval", __name__
)
_RetrievalRPrecision = _root_class_shim(RetrievalRPrecision, "RetrievalRPrecision", "retrieval", __name__)

__all__ = [
    "_RetrievalFallOut",
    "_RetrievalHitRate",
    "_RetrievalMAP",
    "_RetrievalMRR",
    "_RetrievalNormalizedDCG",
    "_RetrievalPrecision",
    "_RetrievalPrecisionRecallCurve",
    "_RetrievalRecall",
    "_RetrievalRecallAtFixedPrecision",
    "_RetrievalRPrecision",
]
