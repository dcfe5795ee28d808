"""The rank side of ``tests/test_torch_pure.py``: one process of a ``gloo`` group that
runs the pure tier's mapped sync (``sync_state``, ``cat_sync``, ``evaluate_sharded``).

It imports ``torch``, numpy and ``metrics_tpu_torch`` only, like
``tests/torch_sync_ranks.py``, whose data and shares it reuses: each rank takes its
own contiguous share in rank order, and the test process holds every rank's values
against one ``metrics_tpu`` run on the union.
"""
import datetime

import numpy as np
import torch
import torch.distributed as dist

from tests.torch_sync_ranks import SHARES, C, collection_metrics, make_data, share

OVERFLOW_CAPACITY = 48  # fits rank 0's binary rows at two ranks, not rank 1's
CAT_BUFFER = 8  # capacity of the direct cat_sync buffers
BOOT = 4  # BootStrapper copies of the stacked pure-tier sync


def boot_indices(seed: int, rank: int, batch: int, size: int) -> np.ndarray:
    """The ``(BOOT, size)`` resample indices of one rank's batch, fed through the seam."""
    return np.random.default_rng([seed, rank, batch]).integers(0, size, (BOOT, size))


def run_boot(world: int, rank: int, seed: int) -> dict:
    """BootStrapper's pure tier over this rank's nominal pairs: a stack fed known
    indices and synced, and one drawing its own, whose seeds differ before the sync
    (rank r updates r + 2 times) and agree after it."""
    from metrics_tpu_torch.classification import MulticlassAccuracy
    from metrics_tpu_torch.parallel import evaluate_sharded
    from metrics_tpu_torch.wrappers import BootStrapper

    group = dist.group.WORLD
    parts = halves(share(make_data(seed)["nom"], world, rank, SHARES))

    def boot():
        return BootStrapper(MulticlassAccuracy(num_classes=C, average="macro", device="cpu"), BOOT, seed=seed, raw=True)

    known = boot()
    state = known.init_state()
    for i, (p, t) in enumerate(parts):
        state = known._local_update_with_indices(state, torch.as_tensor(boot_indices(seed, rank, i, len(p))), p, t)
    drawn = boot()
    own = drawn.init_state()
    for i in range(rank + 2):
        own = drawn.local_update(own, *parts[i % 2])
    return {"boot/local": state["metrics"], "boot/synced": known.sync_state(state, group)["metrics"],
            "boot/value": known.compute_from(state, group), "boot/seed_local": own["seed"],
            "boot/seed_synced": drawn.sync_state(own, group)["seed"],
            "boot/evaluate_sharded": evaluate_sharded(drawn, parts)}


def halves(arrays, device="cpu"):
    n = len(next(iter(arrays.values())))
    return [tuple(torch.as_tensor(v[part], device=device) for v in arrays.values())
            for part in (slice(0, n // 2), slice(n // 2, None))]


def run_pure(world: int, rank: int, seed: int) -> dict:
    from metrics_tpu_torch.classification import BinaryAUROC
    from metrics_tpu_torch.core import CatMetric, MaxMetric, MeanMetric, MetricCollection, MinMetric, SumMetric
    from metrics_tpu_torch.core.state import CatBuffer, cat_sync
    from metrics_tpu_torch.parallel import evaluate_sharded

    data = make_data(seed)
    group = dist.group.WORLD
    out = {}
    seg = share(data["seg"], world, rank, SHARES)
    out["collection"] = evaluate_sharded(MetricCollection(collection_metrics("cpu")), halves(seg))
    binary = halves(share(data["bin"], world, rank, SHARES))
    out["auroc/list"] = evaluate_sharded(BinaryAUROC(device="cpu"), binary)
    out["auroc/buffer"] = evaluate_sharded(BinaryAUROC(cat_capacity=64, device="cpu"), binary)
    out["auroc/binned"] = evaluate_sharded(BinaryAUROC(thresholds=11, device="cpu"), binary)
    out["auroc/overflow"] = evaluate_sharded(BinaryAUROC(cat_capacity=OVERFLOW_CAPACITY, device="cpu"), binary)
    values = torch.as_tensor(share(data["stats"], world, rank, SHARES)["values"])
    for cls in (SumMetric, MaxMetric, MinMetric, MeanMetric, CatMetric):
        metric = cls(device="cpu")
        state = metric.local_update(metric.init_state(), values)
        out[f"agg/{cls.__name__}"] = metric.compute_from(state, group)
        if metric.sync_state(state) is not state:
            raise AssertionError("sync_state without a group is not the identity")
    buf = CatBuffer.create(CAT_BUFFER, (), torch.float32, -1.0, "cpu").append(torch.arange(3 + 2 * rank) + 10.0 * rank)
    synced = cat_sync(buf, group)
    out["cat_sync"] = {"data": synced.data, "count": synced._count, "overflow": synced._overflow}
    return out


def rank_main(rank: int, world: int, store: str, results: str, seed: int) -> None:
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    try:
        out = run_pure(world, rank, seed)
        out.update(run_boot(world, rank, seed))
        out["rows"] = {k: len(v) for k, v in share(make_data(seed)["bin"], world, rank, SHARES).items()}
        torch.save(out, f"{results}.{rank}.pt")
    finally:
        dist.destroy_process_group()

