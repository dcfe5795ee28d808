"""RetrievalMAP (counterpart of ``metrics_tpu/retrieval/average_precision.py``)."""
from typing import Any, Optional

from metrics_tpu_torch.retrieval.base import RetrievalMetric


class RetrievalMAP(RetrievalMetric):
    """Mean average precision over queries (at ``top_k`` when given).

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.retrieval import RetrievalMAP
        >>> indexes = torch.tensor([0, 0, 0, 1, 1, 1, 1])
        >>> preds = torch.tensor([0.2, 0.3, 0.5, 0.1, 0.3, 0.5, 0.2])
        >>> target = torch.tensor([False, False, True, False, True, False, True])
        >>> rmap = RetrievalMAP(device="cpu")
        >>> rmap(preds, target, indexes=indexes)
        tensor(0.7917)
    """

    _grouped_metric = "average_precision"

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
