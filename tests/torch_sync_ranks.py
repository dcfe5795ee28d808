"""The rank side of ``tests/test_torch_sync.py``: one process of a ``gloo`` group.

It imports ``torch``, numpy and ``metrics_tpu_torch`` only (no JAX, nothing of
``metrics_tpu``), so that spawned ranks stay free of JAX; the test process holds
each rank's results against a single-process ``metrics_tpu`` run on the union of
the ranks' data. The data of every scenario is drawn here from a seed, the same in
every process, and each rank takes its own contiguous share in rank order.
"""
import datetime
import sys
from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.distributed as dist

C = 5  # classes of the multiclass scenarios
IGNORE = 255
# uneven shares, so that every gather of a cat state takes the ragged path; the
# binary, retrieval and exact-match data leave the last of four ranks without rows
SHARES = {2: (0.4, 0.6), 4: (0.2, 0.25, 0.3, 0.25)}
SHARES_WITH_EMPTY_RANK = {2: (0.45, 0.55), 4: (0.35, 0.4, 0.25, 0.0)}
STEPS = 2  # forward steps of the dist_sync_on_step scenario
REG_OUTPUTS = 3  # outputs of the Pearson and Spearman scenarios


def make_data(seed: int) -> Dict[str, Dict[str, np.ndarray]]:
    """The global data of every scenario."""
    rng = np.random.RandomState(seed)
    seg_target = rng.randint(0, C, (48, 4))
    seg_target[rng.rand(*seg_target.shape) < 0.05] = IGNORE
    n_bin = 101
    bin_target = rng.randint(0, 2, n_bin)
    # two decimals: ties across ranks, which the gather's rank order must keep
    bin_preds = np.round(np.clip(rng.rand(n_bin) * 0.7 + 0.3 * bin_target, 0, 1), 2).astype(np.float32)
    queries, depth = 12, 7
    ret_target = (rng.rand(queries * depth) < 0.3).astype(np.int64)
    ret_order = rng.permutation(queries * depth)
    em_target = rng.randint(0, C, (40, 3))
    data = {
        "seg": {"preds": rng.randn(48, C, 4).astype(np.float32), "target": seg_target},
        "bin": {"preds": bin_preds, "target": bin_target},
        "ret": {"preds": np.round(rng.randn(queries * depth), 1).astype(np.float32)[ret_order],
                "target": ret_target[ret_order],
                "indexes": np.repeat(np.arange(queries), depth)[ret_order]},
        "stats": {"values": rng.randn(30, 3).astype(np.float32)},
        "em": {"preds": np.where(rng.rand(40, 3) < 0.7, em_target, rng.randint(0, C, (40, 3))), "target": em_target},
        "step": {"preds": rng.randn(STEPS, 36, C).astype(np.float32), "target": rng.randint(0, C, (STEPS, 36))},
    }
    # regression rows with REG_OUTPUTS targets, rounded to one decimal: ties across ranks
    reg_preds = rng.randn(90, REG_OUTPUTS)
    data["reg"] = {"preds": np.round(reg_preds, 1).astype(np.float32),
                   "target": np.round(reg_preds + 0.5 * rng.randn(90, REG_OUTPUTS), 1).astype(np.float32)}
    # nominal pairs (dependent labels) for the nominal classes and two wrappers
    nom_target = rng.randint(0, C, 70)
    data["nom"] = {"preds": np.where(rng.rand(70) < 0.6, nom_target, rng.randint(0, C, 70)), "target": nom_target}
    return data


def bounds(n: int, shares: Sequence[float]) -> List[int]:
    return [int(round(x)) for x in np.concatenate([[0.0], np.cumsum(shares) * n])]


def share(arrays: Dict[str, np.ndarray], world: int, rank: int, shares: Dict[int, Sequence[float]]):
    """This rank's contiguous slice of every array."""
    lo, hi = bounds(len(next(iter(arrays.values()))), shares[world])[rank:rank + 2]
    return {k: v[lo:hi] for k, v in arrays.items()}


def collection_metrics(device: str) -> dict:
    """The Cityscapes collection of nine metrics at ``C`` classes."""
    from metrics_tpu_torch.classification import (
        MulticlassAccuracy,
        MulticlassCohenKappa,
        MulticlassConfusionMatrix,
        MulticlassF1Score,
        MulticlassJaccardIndex,
        MulticlassMatthewsCorrCoef,
        MulticlassPrecision,
        MulticlassRecall,
        MulticlassSpecificity,
    )

    macro = dict(num_classes=C, average="macro", ignore_index=IGNORE, device=device)
    plain = dict(num_classes=C, ignore_index=IGNORE, device=device)
    return {
        "MulticlassAccuracy": MulticlassAccuracy(**macro), "MulticlassPrecision": MulticlassPrecision(**macro),
        "MulticlassRecall": MulticlassRecall(**macro), "MulticlassF1Score": MulticlassF1Score(**macro),
        "MulticlassSpecificity": MulticlassSpecificity(**macro),
        "MulticlassJaccardIndex": MulticlassJaccardIndex(**plain),
        "MulticlassConfusionMatrix": MulticlassConfusionMatrix(**plain),
        "MulticlassCohenKappa": MulticlassCohenKappa(**plain),
        "MulticlassMatthewsCorrCoef": MulticlassMatthewsCorrCoef(**plain),
    }


def stats_metric(device: str):
    """A metric with a ``None`` state (stacked across ranks) and a callable one."""
    from metrics_tpu_torch.core import Metric

    class RunningStats(Metric):
        full_state_update = True

        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            self.add_state("total", torch.zeros(3), dist_reduce_fx=None)
            self.add_state("peak", torch.full((3,), -float("inf")), dist_reduce_fx=lambda x: torch.max(x, 0).values)

        def update(self, x):
            self.total = self.total + x.sum(0)
            self.peak = torch.maximum(self.peak, x.max(0).values)

        def compute(self):
            total = self.total.sum(0) if self.total.dim() == 2 else self.total  # stacked (world, 3) once synced
            return torch.cat([total, self.peak])

    return RunningStats(device=device)


def _snapshot(value):
    from metrics_tpu_torch.core.state import CatBuffer

    if isinstance(value, CatBuffer):
        return ("buffer", value.values().clone())
    if isinstance(value, list):
        return ("list", [v.clone() for v in value])
    return ("tensor", value.clone())


def _same(a, b) -> bool:
    (kind, value), (kind_b, value_b) = a, b
    if kind != kind_b:
        return False
    if kind != "list":
        return torch.equal(value, value_b)
    return len(value) == len(value_b) and all(torch.equal(x, y) for x, y in zip(value, value_b))


def compute_keeping_states(metric):
    """``compute`` (which syncs), then check that the live states came back unchanged."""
    before = {name: _snapshot(getattr(metric, name)) for name in metric._defaults}
    value = metric.compute()
    for name, snap in before.items():
        if not _same(snap, _snapshot(getattr(metric, name))):
            raise AssertionError(f"{type(metric).__name__}.{name}: the live state changed across a synced compute")
    if metric._is_synced:
        raise AssertionError("a metric stayed synced after compute")
    return value


def run_scenarios(world: int, rank: int, device: str, seed: int) -> dict:
    """Every scenario on this rank; returns name -> result (tensors on the CPU)."""
    from metrics_tpu_torch.core import CatMetric, MeanMetric, MetricCollection
    from metrics_tpu_torch.classification import BinaryAUROC, MulticlassAccuracy, MulticlassExactMatch
    from metrics_tpu_torch.regression import PearsonCorrCoef, SpearmanCorrCoef
    from metrics_tpu_torch.core.state import CatBuffer
    from metrics_tpu_torch.retrieval import RetrievalMAP
    from metrics_tpu_torch.utils.exceptions import MetricsUserError

    data = make_data(seed)
    out = {}

    def tensor(x):
        return torch.as_tensor(x, device=device)

    # a MetricCollection of nine metrics (two compute groups), two batches per rank
    mine = share(data["seg"], world, rank, SHARES)
    collection = MetricCollection(collection_metrics(device))
    half = len(mine["target"]) // 2
    for part in (slice(0, half), slice(half, None)):
        collection.update(tensor(mine["preds"][part]), tensor(mine["target"][part]))
    for name, value in collection.compute().items():
        out[f"collection/{name}"] = value.cpu()
    out["collection_groups"] = [list(g) for g in collection.compute_groups.values()]

    # cat list states and CatBuffers (binary AUROC, retrieval MAP) with an empty rank
    mine = share(data["bin"], world, rank, SHARES_WITH_EMPTY_RANK)
    for kind, kwargs in (("list", {}), ("buffer", {"cat_capacity": 128})):
        metric = BinaryAUROC(device=device, **kwargs)
        if len(mine["target"]):
            metric.update(tensor(mine["preds"]), tensor(mine["target"]))
        out[f"auroc/{kind}"] = compute_keeping_states(metric).cpu()
        if kind == "buffer" and not all(isinstance(getattr(metric, s), CatBuffer) for s in metric._defaults):
            raise AssertionError("unsync did not restore the CatBuffer states")
    mine = share(data["ret"], world, rank, SHARES_WITH_EMPTY_RANK)
    for kind, kwargs in (("list", {}), ("buffer", {"cat_capacity": 64})):
        metric = RetrievalMAP(device=device, **kwargs)
        if len(mine["target"]):
            metric.update(tensor(mine["preds"]), tensor(mine["target"]), indexes=tensor(mine["indexes"]))
        out[f"retrieval_map/{kind}"] = compute_keeping_states(metric).cpu()

    # a None (stacked) and a callable reduction
    metric = stats_metric(device)
    metric.update(tensor(share(data["stats"], world, rank, SHARES)["values"]))
    out["stats"] = compute_keeping_states(metric).cpu()

    # samplewise exact match: a ragged cat state of bools, empty on one rank
    mine = share(data["em"], world, rank, SHARES_WITH_EMPTY_RANK)
    metric = MulticlassExactMatch(num_classes=C, multidim_average="samplewise", device=device)
    if len(mine["target"]):
        metric.update(tensor(mine["preds"]), tensor(mine["target"]))
    out["exact_match"] = compute_keeping_states(metric).cpu()

    # sum states: a mean aggregator
    metric = MeanMetric(device=device)
    metric.update(tensor(share(data["stats"], world, rank, SHARES)["values"][:, 0]))
    out["mean"] = compute_keeping_states(metric).cpu()

    # a cat state that no rank ever filled syncs to [], as in the JAX package
    metric = CatMetric(device=device)
    out["cat_nowhere_filled"] = metric.compute()

    # dist_sync_on_step: each forward returns the batch value over every rank's batch
    metric = MulticlassAccuracy(num_classes=C, average="macro", dist_sync_on_step=True, device=device)
    steps = []
    for s in range(STEPS):
        mine = share({k: v[s] for k, v in data["step"].items()}, world, rank, SHARES)
        steps.append(metric(tensor(mine["preds"]), tensor(mine["target"])).cpu())
    out["on_step/batches"] = torch.stack(steps)
    out["on_step/compute"] = compute_keeping_states(metric).cpu()

    # a second sync without unsync raises; unsync restores
    metric.sync()
    try:
        metric.sync()
    except MetricsUserError:
        pass
    else:
        raise AssertionError("a second sync() without unsync() did not raise")
    metric.unsync()

    # Pearson's None-reduced moments (stacked, then merged) and Spearman's cat states,
    # list and CatBuffer, two updates per rank
    mine = share(data["reg"], world, rank, SHARES)
    half = len(mine["target"]) // 2
    for name, metric in (("pearson", PearsonCorrCoef(num_outputs=REG_OUTPUTS, device=device)),
                         ("spearman/list", SpearmanCorrCoef(num_outputs=REG_OUTPUTS, device=device)),
                         ("spearman/buffer", SpearmanCorrCoef(num_outputs=REG_OUTPUTS, cat_capacity=96,
                                                              device=device))):
        for part in (slice(0, half), slice(half, None)):
            metric.update(tensor(mine["preds"][part]), tensor(mine["target"][part]))
        out[name] = compute_keeping_states(metric).cpu()

    # the nominal classes' summed int64 tables, and MinMaxMetric and ClasswiseWrapper,
    # whose base metrics sync at their own compute
    from metrics_tpu_torch.nominal import CramersV, PearsonsContingencyCoefficient, TheilsU, TschuprowsT
    from metrics_tpu_torch.wrappers import ClasswiseWrapper, MinMaxMetric

    mine = share(data["nom"], world, rank, SHARES)
    half = len(mine["target"]) // 2
    for cls in (CramersV, TschuprowsT, PearsonsContingencyCoefficient, TheilsU):
        metric = cls(num_classes=C, device=device)
        for part in (slice(0, half), slice(half, None)):
            metric.update(tensor(mine["preds"][part]), tensor(mine["target"][part]))
        out[f"nominal/{cls.__name__}"] = compute_keeping_states(metric).cpu()
        out[f"nominal/{cls.__name__}/confmat"] = metric.confmat.cpu()
    minmax = MinMaxMetric(MulticlassAccuracy(num_classes=C, average="macro", device=device))
    classwise = ClasswiseWrapper(MulticlassAccuracy(num_classes=C, average=None, device=device))
    for metric in (minmax, classwise):
        for part in (slice(0, half), slice(half, None)):
            metric.update(tensor(mine["preds"][part]), tensor(mine["target"][part]))
    out["minmax"] = {k: v.cpu() for k, v in minmax.compute().items()}
    out["classwise"] = {k: v.cpu() for k, v in classwise.compute().items()}

    out["imports_jax"] = any(m == "jax" or m.startswith(("jax.", "metrics_tpu.")) or m == "metrics_tpu"
                             for m in sys.modules)
    return out


def rank_main(rank: int, world: int, store: str, results: str, seed: int) -> None:
    """Entry point of one spawned rank: join the group, run, save the results."""
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    try:
        torch.save(run_scenarios(world, rank, "cpu", seed), f"{results}.{rank}.pt")
    finally:
        dist.destroy_process_group()
