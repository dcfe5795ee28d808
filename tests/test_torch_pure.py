"""The pure tier of metrics_tpu_torch (``init_state``, ``local_update``,
``sync_state``, ``compute_from``) against metrics_tpu's, on the CPU.

For the stat-scores family, regression and aggregation: a state carried through
``local_update`` over seeded numpy batches holds the JAX package's state (counts
bit-equal, floats within rtol 1e-6) and ``compute_from`` its value; the live state,
the update count and the input state stay untouched; ``init_state`` gives fresh
tensors. The collection's pure tier, ``CatBuffer`` overflow poisoning, and
``load_jax_state`` of a JAX collection's ``init_state``-shaped states.

Then a real ``gloo`` group of 2 CPU ranks (``tests/torch_pure_ranks.py``, which
imports no JAX): ``evaluate_sharded`` of a collection and of ``BinaryAUROC`` with list,
``cat_capacity`` and binned states, ``sync_state`` of the aggregators and ``cat_sync``
itself, each rank's values against one ``metrics_tpu`` run on the union; one rank's
overflowing buffer poisons the float values to NaN on every rank. A stacked
``BootStrapper``'s pure tier fed known indices syncs to the JAX copies fed the same
rows on the union, and its drawn seeds agree on every rank after ``sync_state``.
"""
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import metrics_tpu.classification as jc
import metrics_tpu.core.aggregation as ja
import metrics_tpu.core.collections as jcol
import metrics_tpu.regression as jreg
import metrics_tpu_torch.classification as tc
import metrics_tpu_torch.core.aggregation as ta
import metrics_tpu_torch.regression as treg
from metrics_tpu_torch.convert import load_jax_state
from metrics_tpu_torch.core import MetricCollection
from metrics_tpu_torch.core.state import CatBuffer

from tests import torch_pure_ranks as pure_ranks
from tests import torch_sync_ranks as ranks
from tests.torch_deadline import deadline  # noqa: F401

SEED = 11
DEADLINE_S = 120
CPU = {"device": "cpu"}
RNG = np.random.RandomState(3)
BIN = [(RNG.rand(32).astype(np.float32), RNG.randint(0, 2, 32)) for _ in range(3)]
MC = [(RNG.rand(32, 4).astype(np.float32), RNG.randint(0, 4, 32)) for _ in range(3)]
ML = [(RNG.rand(32, 3).astype(np.float32), RNG.randint(0, 2, (32, 3))) for _ in range(3)]
REG = [(RNG.randn(32).astype(np.float32), RNG.randn(32).astype(np.float32)) for _ in range(3)]
VALUES = [(RNG.randn(17).astype(np.float32),) for _ in range(3)]

CASES = {
    "BinaryStatScores": ({}, BIN), "BinaryAccuracy": ({}, BIN), "BinaryF1Score": ({}, BIN),
    "BinaryConfusionMatrix": ({}, BIN),
    "MulticlassStatScores": ({"num_classes": 4}, MC), "MulticlassAccuracy": ({"num_classes": 4}, MC),
    "MulticlassPrecision": ({"num_classes": 4, "average": "micro"}, MC),
    "MulticlassRecall": ({"num_classes": 4, "average": None}, MC),
    "MultilabelStatScores": ({"num_labels": 3}, ML), "MultilabelF1Score": ({"num_labels": 3, "average": "weighted"}, ML),
    "MeanSquaredError": ({}, REG), "MeanAbsoluteError": ({}, REG), "PearsonCorrCoef": ({}, REG), "R2Score": ({}, REG),
    "SumMetric": ({}, VALUES), "MeanMetric": ({}, VALUES), "MaxMetric": ({}, VALUES), "MinMetric": ({}, VALUES),
    "CatMetric": ({}, VALUES),
}


def _classes(name):
    for port_mod, jax_mod in ((tc, jc), (treg, jreg), (ta, ja)):
        if hasattr(port_mod, name):
            return getattr(port_mod, name), getattr(jax_mod, name)
    raise KeyError(name)


def _np(value):
    if isinstance(value, CatBuffer):
        return value.values().numpy()
    if isinstance(value, list):
        return np.concatenate([np.atleast_1d(np.asarray(v)) for v in value]) if value else np.zeros(0)
    if isinstance(value, torch.Tensor):
        return value.numpy()
    if hasattr(value, "data") and hasattr(value, "count"):  # a JAX CatBuffer
        return np.asarray(value.values())
    return np.asarray(value)


def _close(got, want):
    got, want = _np(got), _np(want)
    if np.issubdtype(want.dtype, np.integer) or np.issubdtype(got.dtype, np.integer):
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", list(CASES))
def test_local_update_and_compute_from_match_jax(name):
    kwargs, batches = CASES[name]
    port_cls, jax_cls = _classes(name)
    port, ref = port_cls(**kwargs, **CPU), jax_cls(**kwargs)
    live_before = {k: v.clone() if isinstance(v, torch.Tensor) else list(v) for k, v in port.metric_state.items()}
    state, jstate = port.init_state(), ref.init_state()
    for k, v in state.items():
        if isinstance(v, torch.Tensor):
            assert v is not port._defaults[k] and torch.equal(v, port._defaults[k])
    for batch in batches:
        before = {k: v.clone() if isinstance(v, torch.Tensor) else list(v) for k, v in state.items()}
        new = port.local_update(state, *(torch.as_tensor(a) for a in batch))
        jstate = ref.local_update(jstate, *(jnp.asarray(a) for a in batch))
        for k, v in before.items():  # the caller's state is left as it was
            assert (torch.equal(v, state[k]) if isinstance(v, torch.Tensor) else len(v) == len(state[k]))
        state = new
    assert port._update_count == 0 and port._computed is None
    for k, v in live_before.items():
        assert (torch.equal(v, getattr(port, k)) if isinstance(v, torch.Tensor) else getattr(port, k) == [])
    assert set(state) == set(jstate)
    for k in state:
        _close(state[k], jstate[k])
    _close(port.compute_from(state), ref.compute_from(jstate))
    assert port.sync_state(state) is state  # no group: the identity


def test_compute_from_poisons_floats_when_a_buffer_overflowed():
    metric = tc.BinaryAUROC(cat_capacity=16, **CPU)
    state = metric.local_update(metric.init_state(), torch.rand(20), torch.randint(0, 2, (20,)))
    assert state["preds"].overflowed()
    with pytest.warns(RuntimeWarning, match="overflow"):
        value = metric.compute_from(state)
    assert bool(torch.isnan(value))
    ok = metric.local_update(metric.init_state(), torch.rand(8), torch.randint(0, 2, (8,)))
    assert not bool(torch.isnan(metric.compute_from(ok)))
    assert metric.preds._count == 0  # the live buffer stayed empty


def test_collection_pure_tier_matches_jax():
    port = MetricCollection({"acc": tc.MulticlassAccuracy(num_classes=4, **CPU),
                             "f1": tc.MulticlassF1Score(num_classes=4, **CPU),
                             "cm": tc.MulticlassConfusionMatrix(num_classes=4, **CPU)}, prefix="val_")
    ref = jcol.MetricCollection({"acc": jc.MulticlassAccuracy(num_classes=4), "f1": jc.MulticlassF1Score(num_classes=4),
                                 "cm": jc.MulticlassConfusionMatrix(num_classes=4)}, prefix="val_")
    state, jstate = port.init_state(), ref.init_state()
    assert set(state) == set(jstate) == {"acc", "f1", "cm"}
    for preds, target in MC:
        state = port.local_update(state, torch.as_tensor(preds), torch.as_tensor(target))
        jstate = ref.local_update(jstate, jnp.asarray(preds), jnp.asarray(target))
    got, want = port.compute_from(state), ref.compute_from(jstate)
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k])
    assert port.sync_state(state) == state
    assert all(m._update_count == 0 for m in port.values(copy_state=False))


def test_load_jax_state_of_a_collection_init_state():
    ref = jcol.MetricCollection({"acc": jc.MulticlassAccuracy(num_classes=4), "mse": jreg.MeanSquaredError(),
                                 "auroc": jc.BinaryAUROC(cat_capacity=64)})
    jstate = ref.init_state()
    jstate["acc"] = ref["acc"].local_update(jstate["acc"], jnp.asarray(MC[0][0]), jnp.asarray(MC[0][1]))
    jstate["mse"] = ref["mse"].local_update(jstate["mse"], jnp.asarray(REG[0][0]), jnp.asarray(REG[0][1]))
    jstate["auroc"] = ref["auroc"].local_update(jstate["auroc"], jnp.asarray(BIN[0][0]), jnp.asarray(BIN[0][1]))
    port = MetricCollection({"acc": tc.MulticlassAccuracy(num_classes=4, **CPU), "mse": treg.MeanSquaredError(**CPU),
                             "auroc": tc.BinaryAUROC(cat_capacity=64, **CPU)})
    load_jax_state(port, jstate)
    assert isinstance(port["auroc"].preds, CatBuffer) and port["auroc"].preds._count == 32
    port_values = port.compute()
    want = ref.compute_from(jstate)
    for k in want:
        _close(port_values[k], want[k])


def test_shard_batch_is_a_contiguous_row_split():
    from metrics_tpu_torch.parallel import shard_batch

    batch = (torch.arange(10), {"w": torch.arange(20).reshape(10, 2)}, 3)
    parts = [shard_batch(batch, rank, 3) for rank in range(3)]
    assert torch.equal(torch.cat([p[0] for p in parts]), batch[0])
    assert [len(p[0]) for p in parts] == [3, 3, 4] and all(p[2] == 3 for p in parts)
    assert torch.equal(parts[1][1]["w"], batch[1]["w"][3:6])
    assert torch.equal(shard_batch(batch)[0], batch[0])  # no group: one rank of one


# ------------------------------------------------------------ a real gloo group


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pure")
    store, results, world = str(tmp / "store"), str(tmp / "results"), 2
    ctx = mp.start_processes(pure_ranks.rank_main, args=(world, store, results, SEED), nprocs=world, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + DEADLINE_S
    try:
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                pytest.fail(f"the {world}-rank gloo group did not finish within {DEADLINE_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
                p.join(10)
    return world, [torch.load(f"{results}.{r}.pt", weights_only=False) for r in range(world)]


def test_evaluate_sharded_collection_matches_one_jax_run_on_the_union(spawned):
    _, results = spawned
    data = ranks.make_data(SEED)
    collection = jcol.MetricCollection({
        "MulticlassAccuracy": jc.MulticlassAccuracy(num_classes=ranks.C, average="macro", ignore_index=ranks.IGNORE),
        "MulticlassPrecision": jc.MulticlassPrecision(num_classes=ranks.C, average="macro", ignore_index=ranks.IGNORE),
        "MulticlassRecall": jc.MulticlassRecall(num_classes=ranks.C, average="macro", ignore_index=ranks.IGNORE),
        "MulticlassF1Score": jc.MulticlassF1Score(num_classes=ranks.C, average="macro", ignore_index=ranks.IGNORE),
        "MulticlassSpecificity": jc.MulticlassSpecificity(num_classes=ranks.C, average="macro",
                                                          ignore_index=ranks.IGNORE),
        "MulticlassJaccardIndex": jc.MulticlassJaccardIndex(num_classes=ranks.C, ignore_index=ranks.IGNORE),
        "MulticlassConfusionMatrix": jc.MulticlassConfusionMatrix(num_classes=ranks.C, ignore_index=ranks.IGNORE),
        "MulticlassCohenKappa": jc.MulticlassCohenKappa(num_classes=ranks.C, ignore_index=ranks.IGNORE),
        "MulticlassMatthewsCorrCoef": jc.MulticlassMatthewsCorrCoef(num_classes=ranks.C, ignore_index=ranks.IGNORE),
    })
    collection.update(jnp.asarray(data["seg"]["preds"]), jnp.asarray(data["seg"]["target"]))
    want = collection.compute()
    for result in results:
        assert set(result["collection"]) == set(want)
        for k in want:
            _close(result["collection"][k], want[k])


def test_evaluate_sharded_auroc_and_cat_sync_match_the_union(spawned):
    world, results = spawned
    data = ranks.make_data(SEED)
    preds, target = jnp.asarray(data["bin"]["preds"]), jnp.asarray(data["bin"]["target"])
    exact = jc.BinaryAUROC()
    exact.update(preds, target)
    binned = jc.BinaryAUROC(thresholds=11)
    binned.update(preds, target)
    for result in results:
        _close(result["auroc/list"], exact.compute())
        assert torch.equal(result["auroc/list"], result["auroc/buffer"])
        _close(result["auroc/binned"], binned.compute())
        assert bool(torch.isnan(result["auroc/overflow"]))  # rank 1 overflowed: every rank poisons
    assert max(r["rows"]["target"] for r in results) > pure_ranks.OVERFLOW_CAPACITY
    rows = [np.arange(3 + 2 * r) + 10.0 * r for r in range(world)]
    unused = [np.full(pure_ranks.CAT_BUFFER - len(r), -1.0) for r in rows]
    for result in results:
        synced = result["cat_sync"]
        np.testing.assert_array_equal(synced["data"].numpy(), np.concatenate(rows + unused))
        assert synced["count"] == sum(len(r) for r in rows) and not synced["overflow"]


def test_sync_state_of_the_aggregators_matches_the_union(spawned):
    _, results = spawned
    values = jnp.asarray(ranks.make_data(SEED)["stats"]["values"])
    for name in ("SumMetric", "MaxMetric", "MinMetric", "MeanMetric", "CatMetric"):
        ref = getattr(ja, name)()
        ref.update(values)
        for result in results:
            _close(result[f"agg/{name}"], ref.compute())


def test_bootstrapper_pure_sync_matches_the_union(spawned):
    world, results = spawned
    pairs = ranks.make_data(SEED)["nom"]
    bases = [jc.MulticlassAccuracy(num_classes=ranks.C, average="macro") for _ in range(pure_ranks.BOOT)]
    for rank in range(world):
        mine = ranks.share(pairs, world, rank, ranks.SHARES)
        p, t = mine["preds"], mine["target"]
        for i, part in enumerate((slice(0, len(p) // 2), slice(len(p) // 2, None))):
            idx = pure_ranks.boot_indices(SEED, rank, i, len(p[part]))
            for base, rows in zip(bases, idx):
                base.update(jnp.asarray(p[part][rows]), jnp.asarray(t[part][rows]))
    for name in ("tp", "fp", "tn", "fn"):
        want = np.stack([np.asarray(getattr(base, name)) for base in bases]).astype(np.int64)
        assert np.array_equal(sum(r["boot/local"][name] for r in results).numpy(), want)
        for result in results:
            assert np.array_equal(result["boot/synced"][name].numpy(), want)
    raw = jnp.stack([base.compute() for base in bases])
    seeds = [int(r["boot/seed_local"]) for r in results]
    assert len(set(seeds)) == world  # each rank advanced its own seed
    for result in results:
        _close(result["boot/value"]["raw"], raw)
        assert int(result["boot/seed_synced"]) == max(seeds)
        _close(result["boot/evaluate_sharded"]["mean"], results[0]["boot/evaluate_sharded"]["mean"])
