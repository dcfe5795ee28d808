"""Optional packages, found without importing them (counterpart of ``metrics_tpu/utils/imports.py``)."""
import importlib.util


def _module_available(name: str) -> bool:
    """Whether ``name`` can be imported here."""
    try:
        return importlib.util.find_spec(name) is not None
    except (ImportError, ValueError):
        return False


_SCIPY_AVAILABLE = _module_available("scipy")
_PESQ_AVAILABLE = _module_available("pesq")
_PYSTOI_AVAILABLE = _module_available("pystoi")
_NLTK_AVAILABLE = _module_available("nltk")
_REGEX_AVAILABLE = _module_available("regex")
_TRANSFORMERS_AVAILABLE = _module_available("transformers")
