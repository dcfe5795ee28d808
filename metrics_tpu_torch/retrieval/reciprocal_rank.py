"""RetrievalMRR (counterpart of ``metrics_tpu/retrieval/reciprocal_rank.py``)."""
from metrics_tpu_torch.retrieval.base import RetrievalMetric


class RetrievalMRR(RetrievalMetric):
    """Mean reciprocal rank over queries.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.retrieval import RetrievalMRR
        >>> indexes = torch.tensor([0, 0, 0, 1, 1, 1, 1])
        >>> preds = torch.tensor([0.2, 0.3, 0.5, 0.1, 0.3, 0.5, 0.2])
        >>> target = torch.tensor([False, False, True, False, True, False, True])
        >>> mrr = RetrievalMRR(device="cpu")
        >>> mrr(preds, target, indexes=indexes)
        tensor(0.7500)
    """

    _grouped_metric = "reciprocal_rank"
