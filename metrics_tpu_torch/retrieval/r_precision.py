"""RetrievalRPrecision (counterpart of ``metrics_tpu/retrieval/r_precision.py``)."""
from metrics_tpu_torch.retrieval.base import RetrievalMetric


class RetrievalRPrecision(RetrievalMetric):
    """R-precision over queries: the relevant share of each query's top R, R its
    number of relevant documents."""

    _grouped_metric = "r_precision"
