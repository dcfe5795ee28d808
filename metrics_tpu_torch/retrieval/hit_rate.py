"""RetrievalHitRate (counterpart of ``metrics_tpu/retrieval/hit_rate.py``)."""
from typing import Any, Optional

from metrics_tpu_torch.retrieval.base import RetrievalMetric


class RetrievalHitRate(RetrievalMetric):
    """HitRate@k over queries."""

    _grouped_metric = "hit_rate"

    def __init__(
        self,
        empty_target_action: str = "neg",
        ignore_index: Optional[int] = None,
        top_k: Optional[int] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(empty_target_action=empty_target_action, ignore_index=ignore_index, **kwargs)
        if top_k is not None and not (isinstance(top_k, int) and top_k > 0):
            raise ValueError("`top_k` has to be a positive integer or None")
        self.top_k = top_k

    def _metric_kwargs(self) -> dict:
        return {"top_k": self.top_k}
