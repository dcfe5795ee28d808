"""Module globals of both packages that the port's tests set, put back after each test.

A test file that turns on a surface, records a manifest or runs a prewarm imports the
autouse fixture::

    from tests.torch_globals import restores_globals  # noqa: F401

so that what it leaves in a module global does not reach a later test in the same
process: with ``--dist loadfile`` the files that share a worker change from run to run
(a prewarm's report, for one, is stamped into every later state report).
"""
import importlib

import pytest

PACKAGES = ("metrics_tpu_torch", "metrics_tpu")

#: module (under each package) -> the globals a test can rebind
REBOUND = {
    "serve.excache": ("_LAST_PREWARM", "_RECORDING", "_CACHE_DIR"),
    "fault.inject": ("_SCHEDULE",),
    "obs.registry": ("_ENABLED",),
    "obs.prom": ("_READINESS",),
    "obs.flight": ("_DUMP_PATH", "_CKPT_INTEGRATION", "_CAPACITY"),
}

#: module -> (the global that holds its live object, the function that stops it)
SURFACES = {
    "obs.flight": ("_RING", "disable"),
    "obs.health": ("_MONITOR", "disable"),
    "obs.flow": ("_TRACER", "disable"),
    "obs.series": ("_SAMPLER", "disable"),
    "obs.prom": ("_SERVER", "stop_server"),
}


def _modules(names):
    return [(importlib.import_module(f"{pkg}.{name}"), name) for pkg in PACKAGES for name in names]


@pytest.fixture(autouse=True)
def restores_globals():
    saved = [(mod, attr, getattr(mod, attr)) for mod, name in _modules(REBOUND)
             for attr in REBOUND[name] if hasattr(mod, attr)]
    live = [(mod, *SURFACES[name], getattr(mod, SURFACES[name][0])) for mod, name in _modules(SURFACES)]
    yield
    for mod, attr, stop, before in live:
        if getattr(mod, attr) is not before:
            getattr(mod, stop)()
    for mod, attr, value in saved:
        setattr(mod, attr, value)
