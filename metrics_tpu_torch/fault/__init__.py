"""metrics_tpu_torch.fault: deterministic fault injection and graceful degradation
(counterpart of ``metrics_tpu/fault``).

    from metrics_tpu_torch import fault

    # the checkpoint retry path: the first fsync fails, the backoff retry commits
    with fault.FaultSchedule(fire_at={"ckpt.fsync": 0}):
        metric.save_checkpoint("ckpts")

    # seeded chaos: 25% of fused replays fail; each failure demotes the group to
    # its eager path (the engine's ``degrades`` count), bit-equal to eager
    with fault.FaultSchedule(seed=7, sites=("fused.launch",), rate=0.25) as sched:
        run_eval(collection)
    print(sched.fired)

The degradation lives in the subsystems: the fused and fleet engines demote a
failing key to the eager path (``core/fused.py:StepCache``), checkpoint saves retry
with bounded exponential backoff and restores can walk back to an earlier step
(``ckpt/manager.py``), and the ingest queue applies a failed tick's batches through
the public ``update`` (``serve/ingest.py``). With no schedule active every site
costs one attribute load and an identity check.
"""
from metrics_tpu_torch.fault.inject import (
    SITES,
    FaultSchedule,
    InjectedFaultError,
    PoisonedInputError,
    active,
    current,
    fire,
    poison_inputs,
)

__all__ = [
    "SITES",
    "FaultSchedule",
    "InjectedFaultError",
    "PoisonedInputError",
    "active",
    "current",
    "fire",
    "poison_inputs",
]
