"""Metric-class registry for the introspection rules (counterpart of
``metrics_tpu/analysis/registry.py``).

Every class exported from ``metrics_tpu_torch.__all__`` counts, constructed with
the constructor specs of ``obs/canon.py`` (the tables behind
:func:`~metrics_tpu_torch.obs.canon.budget_cases`, the port's copy of the JAX
package's registry) on an explicit device: a metric's states live on its device,
so the introspection tier builds them where the caller says (the card by default
in the CLI, ``cpu`` in the tests), and without a card and without ``cpu`` it
raises rather than falling back.

Construction failures are recorded, not raised, so a metric that needs an
optional dependency degrades to "not introspected" instead of killing the lint.
"""
import inspect
import warnings
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

#: fleet-axis ctor specs (core/fleet.py): one class per state flavor (scalar counts,
#: per-class vectors, float accumulators, a max-reduction state), re-constructed
#: with a fleet dim so the state-contract rules also sweep a live (fleet_size, *base)
#: registry, including the `_fleet_rows` bookkeeping state it injects
FLEET_VARIANT_SPECS: Tuple[Tuple[str, Dict[str, Any]], ...] = (
    ("BinaryAccuracy", {"fleet_size": 4}),
    ("MulticlassAccuracy", {"num_classes": 5, "average": None, "fleet_size": 4}),
    ("MeanSquaredError", {"fleet_size": 4}),
    ("MinMetric", {"fleet_size": 4}),
)


@dataclass
class IntrospectedClass:
    name: str
    cls: type
    instance: Optional[Any]  # None when construction failed/skipped
    skip_reason: str = ""

    @property
    def host_side(self) -> bool:
        """Whether the class declares its update/compute bodies host-side by
        contract (``_host_side_update``, the core/metric.py introspection hook)."""
        return bool(getattr(self.cls, "_host_side_update", False))


def check_device(device: Any) -> Any:
    """``device`` itself, after checking that it can hold tensors here: a CUDA
    device without a card raises instead of falling back to the CPU."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"the introspection tier builds every metric on {device!r}, and no CUDA device is"
            " present; pass --device cpu (device='cpu') to introspect on the CPU"
        )
    return device


def ctor_kwargs_for(name: str, device: Any) -> Callable[[], Dict[str, Any]]:
    """The constructor keyword arguments of an export (device included)."""
    from metrics_tpu_torch.obs import canon

    specs = canon._ctor_specs(device)
    thunk = specs.get(name) or (lambda: next(
        (dict(kw) for prefix, kw in canon.FAMILY_KWARGS if name.startswith(prefix)), {}))
    on = {} if name in canon._DEVICE_OF_BASE else {"device": device}
    return lambda: {**thunk(), **on}


def iter_metric_classes() -> Iterator[Tuple[str, type]]:
    """Every class exported at the package root, the budget's walk."""
    import metrics_tpu_torch

    for name in sorted(set(metrics_tpu_torch.__all__)):
        obj = getattr(metrics_tpu_torch, name, None)
        if inspect.isclass(obj):
            yield name, obj


def _construct(name: str, cls: type, kwargs: Dict[str, Any]) -> IntrospectedClass:
    from metrics_tpu_torch.core.metric import Metric

    try:
        with warnings.catch_warnings():
            # the root exports' FutureWarning shims are not the lint's business
            warnings.simplefilter("ignore")
            instance = cls(**kwargs)
    except Exception as err:  # noqa: BLE001 — lint degrades, never dies, on ctor failure
        return IntrospectedClass(name, cls, None, f"construction failed: {type(err).__name__}: {err}")
    if not isinstance(instance, Metric):
        return IntrospectedClass(name, cls, None, "dispatcher returned a non-Metric")
    return IntrospectedClass(name, type(instance), instance)


def introspect_classes(device: Any) -> Iterator[IntrospectedClass]:
    """Construct one instance per exported metric class on ``device`` (best effort)."""
    from metrics_tpu_torch.obs import canon

    check_device(device)
    for name, cls in iter_metric_classes():
        if name in canon.NOT_INTROSPECTED:
            yield IntrospectedClass(name, cls, None, canon.NOT_INTROSPECTED[name])
            continue
        try:
            kwargs = ctor_kwargs_for(name, device)()
        except Exception as err:  # noqa: BLE001 — a spec that cannot be built is a recorded skip
            yield IntrospectedClass(name, cls, None, f"construction failed: {type(err).__name__}: {err}")
            continue
        yield _construct(name, cls, kwargs)


def introspect_fleet_variants(device: Any) -> Iterator[IntrospectedClass]:
    """Fleet-constructed instances of the ``FLEET_VARIANT_SPECS`` classes,
    named ``Class@fleet`` so reports distinguish them from the plain sweep."""
    import metrics_tpu_torch

    check_device(device)
    for name, kwargs in FLEET_VARIANT_SPECS:
        yield _construct(f"{name}@fleet", getattr(metrics_tpu_torch, name), {**kwargs, "device": device})
