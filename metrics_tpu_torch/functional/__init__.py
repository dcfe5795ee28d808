from metrics_tpu_torch.functional.classification import *  # noqa: F401,F403
from metrics_tpu_torch.functional.classification import __all__ as _classification_all
from metrics_tpu_torch.functional.retrieval import *  # noqa: F401,F403
from metrics_tpu_torch.functional.retrieval import __all__ as _retrieval_all

__all__ = _classification_all + _retrieval_all
