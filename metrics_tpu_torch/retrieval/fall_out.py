"""RetrievalFallOut (counterpart of ``metrics_tpu/retrieval/fall_out.py``): empty-target
handling refers to queries without NEGATIVE targets."""
from typing import Any, Optional

from metrics_tpu_torch.retrieval.base import RetrievalMetric


class RetrievalFallOut(RetrievalMetric):
    """Fall-out@k over queries (lower is better)."""

    higher_is_better = False
    _grouped_metric = "fall_out"
    _empty_refers_to_negatives = True

    def __init__(
        self,
        empty_target_action: str = "pos",
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
