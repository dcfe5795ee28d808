"""PerceptualEvaluationSpeechQuality (counterpart of ``metrics_tpu/audio/pesq.py``)."""
from typing import Any

import torch
from torch import Tensor

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.audio.pesq import _check_pesq_args, perceptual_evaluation_speech_quality
from metrics_tpu_torch.utils import imports


class PerceptualEvaluationSpeechQuality(Metric):
    """Mean PESQ MOS-LQO over all seen samples (needs the ``pesq`` package)."""

    is_differentiable = False
    higher_is_better = True
    full_state_update = False
    plot_lower_bound = -0.5
    plot_upper_bound = 4.5

    def __init__(self, fs: int, mode: str, n_processes: int = 1, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not imports._PESQ_AVAILABLE:
            raise ModuleNotFoundError(
                "PerceptualEvaluationSpeechQuality metric requires that `pesq` is installed."
                " Install it with `pip install pesq`."
            )
        _check_pesq_args(fs, mode)
        self.fs = fs
        self.mode = mode
        self.n_processes = n_processes
        self.add_state("sum_pesq", torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("total", torch.tensor(0), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        pesq_batch = perceptual_evaluation_speech_quality(preds, target, self.fs, self.mode, n_processes=self.n_processes)
        self.sum_pesq = self.sum_pesq + torch.sum(pesq_batch)
        self.total = self.total + pesq_batch.numel()

    def compute(self) -> Tensor:
        return self.sum_pesq / self.total
