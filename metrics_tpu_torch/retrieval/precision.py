"""RetrievalPrecision (counterpart of ``metrics_tpu/retrieval/precision.py``)."""
from typing import Any, Optional

from metrics_tpu_torch.retrieval.base import RetrievalMetric


class RetrievalPrecision(RetrievalMetric):
    """Precision@k over queries; ``adaptive_k`` caps k at each query's size."""

    _grouped_metric = "precision"

    def __init__(
        self,
        empty_target_action: str = "neg",
        ignore_index: Optional[int] = None,
        top_k: Optional[int] = None,
        adaptive_k: bool = False,
        **kwargs: Any,
    ) -> None:
        super().__init__(empty_target_action=empty_target_action, ignore_index=ignore_index, **kwargs)
        if top_k is not None and not (isinstance(top_k, int) and top_k > 0):
            raise ValueError("`top_k` has to be a positive integer or None")
        if not isinstance(adaptive_k, bool):
            raise ValueError("`adaptive_k` has to be a boolean")
        self.top_k = top_k
        self.adaptive_k = adaptive_k

    def _metric_kwargs(self) -> dict:
        return {"top_k": self.top_k, "adaptive_k": self.adaptive_k}
