"""Enums used across metrics_tpu_torch.

Counterpart of ``metrics_tpu/utils/enums.py``: an ``EnumStr`` base with a lenient
``from_str`` constructor and the task/average selectors the classification
dispatchers read. Kept as its own copy so the port imports nothing of the JAX
package.
"""
from enum import Enum


class EnumStr(str, Enum):
    """String-valued enum with a lenient ``from_str`` constructor."""

    @classmethod
    def _name(cls) -> str:
        return "Task"

    @classmethod
    def from_str(cls, value: str, source: str = "input") -> "EnumStr":
        norm = lambda s: s.lower().replace("-", "_").replace(" ", "_")
        for member in cls:
            if norm(str(member.value)) == norm(value):
                return member
        valid = [str(e.value) for e in cls]
        raise ValueError(f"Invalid {cls._name()}: expected one of {valid}, but got {value} from {source}.") from None

    def __str__(self) -> str:
        return str(self.value)


class DataType(EnumStr):
    """Type of input data inferred from shapes/values."""

    BINARY = "binary"
    MULTILABEL = "multi-label"
    MULTICLASS = "multi-class"
    MULTIDIM_MULTICLASS = "multi-dim multi-class"

    @classmethod
    def _name(cls) -> str:
        return "Data type"


class AverageMethod(EnumStr):
    """How to average over classes."""

    MICRO = "micro"
    MACRO = "macro"
    WEIGHTED = "weighted"
    NONE = "none"
    SAMPLES = "samples"

    @classmethod
    def _name(cls) -> str:
        return "Average method"


class MDMCAverageMethod(EnumStr):
    """Multi-dim multi-class averaging."""

    GLOBAL = "global"
    SAMPLEWISE = "samplewise"


class ClassificationTask(EnumStr):
    """binary / multiclass / multilabel task selector for dispatcher classes."""

    BINARY = "binary"
    MULTICLASS = "multiclass"
    MULTILABEL = "multilabel"
