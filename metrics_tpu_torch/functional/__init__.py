from metrics_tpu_torch.functional.classification import *  # noqa: F401,F403
from metrics_tpu_torch.functional.classification import __all__  # noqa: F401
