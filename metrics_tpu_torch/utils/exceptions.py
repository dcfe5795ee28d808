"""Exception types for metrics_tpu_torch (counterpart of ``metrics_tpu/utils/exceptions.py``)."""


class MetricsUserError(Exception):
    """Error raised by misuse of the metrics API (e.g. a merge of mismatched states)."""


class MetricsUserWarning(UserWarning):
    """Warning category for metric usage issues (e.g. compute before update)."""
