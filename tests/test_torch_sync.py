"""Cross-process sync of metrics_tpu_torch, on the CPU.

First the single-process cases of the JAX package's eager-sync tests
(``tests/unittests/parallel/test_eager_sync.py``) with an injected gather that
plays a world of two: ``sum``, ``cat``, ``None`` stack, a ``CatBuffer``, an empty
list state, double sync, ``compute`` on the gathered state, and the single-process
identity of ``gather_all_tensors``.

Then real ``torch.distributed`` groups of 2 and 4 ``gloo`` ranks, spawned once per
world size (``tests/torch_sync_ranks.py``, which imports no JAX): each rank feeds
its uneven share of every scenario and syncs at ``compute``. This process holds
every rank's results against a single-process ``metrics_tpu`` run on the union of
the shares, concatenated in rank order: counts by value, floats within rtol 1e-6,
atol 1e-6; list and ``cat_capacity`` states bit-equal to each other. PearsonCorrCoef
(moments stacked by the sync, merged by ``_final_aggregation``) and SpearmanCorrCoef
(gathered cat states) of three outputs are held within 1e-5 by a test of their own on the
same spawn. A spawn that outlives its deadline is killed and fails the test.
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
import metrics_tpu.retrieval as jr
from metrics_tpu_torch.core import CatMetric, Metric
from metrics_tpu_torch.core.state import CatBuffer
from metrics_tpu_torch.parallel import distributed_available, process_topology
from metrics_tpu_torch.utils.data import dim_zero_cat
from metrics_tpu_torch.utils.distributed import _pad_to, _trim_to, gather_all_tensors
from metrics_tpu_torch.utils.exceptions import MetricsUserError

from tests import torch_sync_ranks as ranks
from tests.torch_deadline import deadline  # noqa: F401

SEED = 7
DEADLINE_S = 150


def assert_close(got, want):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got.astype(np.float64), want.astype(np.float64), rtol=1e-6, atol=1e-6)


# ------------------------------------------------- single process, injected gather


class _SumMetric(Metric):
    full_state_update = True

    def __init__(self, **kwargs):
        super().__init__(device="cpu", **kwargs)
        self.add_state("x", torch.tensor(0.0), dist_reduce_fx="sum")

    def update(self, x):
        self.x = self.x + x

    def compute(self):
        return self.x


class _CatMetric(Metric):
    full_state_update = True

    def __init__(self, **kwargs):
        super().__init__(device="cpu", **kwargs)
        self.add_state("vals", [], dist_reduce_fx="cat")

    def update(self, x):
        self.vals.append(x)

    def compute(self):
        return dim_zero_cat(self.vals)


class _StackMetric(Metric):
    full_state_update = True

    def __init__(self, **kwargs):
        super().__init__(device="cpu", **kwargs)
        self.add_state("stats", torch.zeros(3), dist_reduce_fx=None)

    def update(self, x):
        self.stats = self.stats + x

    def compute(self):
        return self.stats


def _fake_world2_gather(tensor, group=None):
    """Pretend a second process holds tensor + 10."""
    return [tensor, tensor + 10]


def _available():
    return True


def test_sync_sum_state_with_injected_gather():
    m = _SumMetric(dist_sync_fn=_fake_world2_gather, distributed_available_fn=_available)
    m.update(torch.tensor(3.0))
    m.sync(dist_sync_fn=_fake_world2_gather, distributed_available=_available)
    assert float(m.x) == 3.0 + 13.0
    m.unsync()
    assert float(m.x) == 3.0


def test_sync_cat_state_with_injected_gather():
    m = _CatMetric()
    m.update(torch.tensor([1.0, 2.0]))
    m.update(torch.tensor([3.0]))
    m.sync(dist_sync_fn=_fake_world2_gather, distributed_available=_available)
    assert torch.equal(dim_zero_cat(m.vals), torch.tensor([1.0, 2.0, 3.0, 11.0, 12.0, 13.0]))
    m.unsync()
    assert len(m.vals) == 2


def test_sync_none_reduction_stacks_ranks():
    m = _StackMetric()
    m.update(torch.tensor([1.0, 2.0, 3.0]))
    m.sync(dist_sync_fn=_fake_world2_gather, distributed_available=_available)
    assert m.stats.shape == (2, 3)
    m.unsync()
    assert m.stats.shape == (3,)


def test_sync_catbuffer_goes_across_as_its_rows_and_comes_back():
    m = _CatMetric(cat_capacity=8)
    m.update(torch.tensor([1.0, 2.0]))
    m.update(torch.tensor([3.0]))
    live = m.vals
    m.sync(dist_sync_fn=_fake_world2_gather, distributed_available=_available)
    assert isinstance(m.vals, torch.Tensor)  # the synced view is dense
    assert torch.equal(m.vals, torch.tensor([1.0, 2.0, 3.0, 11.0, 12.0, 13.0]))
    m.unsync()
    assert m.vals is live and isinstance(m.vals, CatBuffer)


def test_sync_of_an_empty_list_state_gives_an_empty_list():
    m = _CatMetric(dist_sync_fn=_fake_world2_gather, distributed_available_fn=_available)
    m.sync()
    assert m.vals == []
    m.unsync()
    assert CatMetric(device="cpu", distributed_available_fn=_available, dist_sync_fn=_fake_world2_gather).compute() == []


def test_double_sync_raises():
    m = _SumMetric()
    m.update(torch.tensor(1.0))
    m.sync(dist_sync_fn=_fake_world2_gather, distributed_available=_available)
    with pytest.raises(MetricsUserError, match="already been synced"):
        m.sync(dist_sync_fn=_fake_world2_gather, distributed_available=_available)
    m.unsync()
    with pytest.raises(MetricsUserError, match="been un-synced"):
        m.unsync()
    with pytest.raises(MetricsUserError, match="shouldn't be synced"):
        m.sync(dist_sync_fn=_fake_world2_gather, distributed_available=_available)
        m(torch.tensor(1.0))


def test_compute_with_sync_uses_gathered_state():
    m = _SumMetric(dist_sync_fn=_fake_world2_gather, distributed_available_fn=_available)
    m.update(torch.tensor(5.0))
    assert float(m.compute()) == 5.0 + 15.0
    m.update(torch.tensor(1.0))
    assert float(m.x) == 6.0
    off = _SumMetric(dist_sync_fn=_fake_world2_gather, distributed_available_fn=_available, sync_on_compute=False)
    off.update(torch.tensor(5.0))
    assert float(off.compute()) == 5.0


def test_dist_sync_on_step_syncs_the_batch_value_only():
    m = _SumMetric(dist_sync_fn=_fake_world2_gather, distributed_available_fn=_available, dist_sync_on_step=True)
    assert float(m(torch.tensor(2.0))) == 2.0 + 12.0
    assert float(m.x) == 2.0 and not m._is_synced


def test_gather_all_tensors_single_process_and_the_gate():
    x = torch.tensor([1.0, 2.0])
    out = gather_all_tensors(x)
    assert len(out) == 1 and out[0] is x
    assert not distributed_available()
    assert process_topology() == (0, 1)
    assert process_topology(1, 4) == (1, 4)
    with pytest.raises(ValueError):
        process_topology(4, 4)


@pytest.mark.parametrize("shape, target", [((3, 2), (5, 2)), ((0, 4), (2, 4)), ((2, 1, 3), (2, 4, 3)), ((), ())])
def test_pad_and_trim_match_the_jax_package(shape, target):
    from metrics_tpu.utils.distributed import _pad_to as jax_pad_to

    x = np.asarray(np.arange(int(np.prod(shape)), dtype=np.float32).reshape(shape) + 1)
    padded = _pad_to(torch.from_numpy(x), target)
    assert_close(padded, jax_pad_to(jnp.asarray(x), target))
    assert torch.equal(_trim_to(padded, shape), torch.from_numpy(x))


def test_metric_refuses_bad_sync_arguments():
    with pytest.raises(ValueError, match="dist_sync_fn"):
        _SumMetric(dist_sync_fn=3)
    with pytest.raises(ValueError, match="dist_sync_on_step"):
        _SumMetric(dist_sync_on_step=1)
    with pytest.raises(ValueError, match="sync_on_compute"):
        _SumMetric(sync_on_compute="yes")


# ------------------------------------------------------------ real gloo groups


@pytest.fixture(scope="module", params=[2, 4], ids=str)
def spawned(request, tmp_path_factory):
    """``(world, every rank's results)``, one spawn per world size for the tests below."""
    return request.param, spawn(request.param, tmp_path_factory.mktemp(f"world{request.param}"))


def spawn(world: int, tmp_path) -> list:
    """Run ``ranks.rank_main`` on ``world`` spawned processes; every rank's results."""
    store, results = str(tmp_path / "store"), str(tmp_path / "results")
    ctx = mp.start_processes(ranks.rank_main, args=(world, store, results, SEED), nprocs=world, join=False,
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
    return [torch.load(f"{results}.{r}.pt", weights_only=False) for r in range(world)]


def oracle(data) -> dict:
    """The single-process ``metrics_tpu`` values of every scenario on the union."""
    want = {}
    seg = data["seg"]
    macro = dict(num_classes=ranks.C, average="macro", ignore_index=ranks.IGNORE)
    plain = dict(num_classes=ranks.C, ignore_index=ranks.IGNORE)
    collection = jcol.MetricCollection({
        "MulticlassAccuracy": jc.MulticlassAccuracy(**macro), "MulticlassPrecision": jc.MulticlassPrecision(**macro),
        "MulticlassRecall": jc.MulticlassRecall(**macro), "MulticlassF1Score": jc.MulticlassF1Score(**macro),
        "MulticlassSpecificity": jc.MulticlassSpecificity(**macro),
        "MulticlassJaccardIndex": jc.MulticlassJaccardIndex(**plain),
        "MulticlassConfusionMatrix": jc.MulticlassConfusionMatrix(**plain),
        "MulticlassCohenKappa": jc.MulticlassCohenKappa(**plain),
        "MulticlassMatthewsCorrCoef": jc.MulticlassMatthewsCorrCoef(**plain),
    })
    collection.update(jnp.asarray(seg["preds"]), jnp.asarray(seg["target"]))
    want.update({f"collection/{k}": v for k, v in collection.compute().items()})
    want["collection_groups"] = {frozenset(g) for g in collection.compute_groups.values()}
    auroc = jc.BinaryAUROC()
    auroc.update(jnp.asarray(data["bin"]["preds"]), jnp.asarray(data["bin"]["target"]))
    want["auroc"] = auroc.compute()
    ret = data["ret"]
    rmap = jr.RetrievalMAP()
    rmap.update(jnp.asarray(ret["preds"]), jnp.asarray(ret["target"]), indexes=jnp.asarray(ret["indexes"]))
    want["retrieval_map"] = rmap.compute()
    values = data["stats"]["values"]
    want["stats"] = np.concatenate([values.sum(0), values.max(0)])
    em = jc.MulticlassExactMatch(num_classes=ranks.C, multidim_average="samplewise")
    em.update(jnp.asarray(data["em"]["preds"]), jnp.asarray(data["em"]["target"]))
    want["exact_match"] = em.compute()
    mean = ja.MeanMetric()
    mean.update(jnp.asarray(values[:, 0]))
    want["mean"] = mean.compute()
    step = jc.MulticlassAccuracy(num_classes=ranks.C, average="macro")
    want["on_step/batches"] = np.stack([step(jnp.asarray(data["step"]["preds"][s]),
                                             jnp.asarray(data["step"]["target"][s])) for s in range(ranks.STEPS)])
    want["on_step/compute"] = step.compute()
    return want


def test_gloo_ranks_match_a_single_process_run_on_the_union(spawned):
    world, results = spawned
    want = oracle(ranks.make_data(SEED))
    for rank, got in enumerate(results):
        assert not got["imports_jax"], f"rank {rank} imported JAX"
        assert {frozenset(g) for g in got["collection_groups"]} == want["collection_groups"]
        for key, value in want.items():
            if key.startswith(("collection/", "on_step/")) or key in ("stats", "exact_match", "mean"):
                assert_close(got[key], value)
        for name in ("auroc", "retrieval_map"):
            assert torch.equal(got[f"{name}/list"], got[f"{name}/buffer"]), (rank, name)
            assert_close(got[f"{name}/list"], want[name])
        assert got["cat_nowhere_filled"] == []
        confmat = got["collection/MulticlassConfusionMatrix"]
        assert confmat.dtype == torch.int64 and torch.equal(confmat, results[0]["collection/MulticlassConfusionMatrix"])


def test_gloo_ranks_pearson_and_spearman_match_one_jax_run_on_the_union(spawned):
    """Pearson's moments, stacked by the sync and merged by ``_final_aggregation``, and
    Spearman's gathered cat states (list and ``CatBuffer``, bit-equal to each other)
    against one ``metrics_tpu`` run on the union, within 1e-5."""
    world, results = spawned
    reg = ranks.make_data(SEED)["reg"]
    preds, target = jnp.asarray(reg["preds"], jnp.float32), jnp.asarray(reg["target"], jnp.float32)
    pearson = jreg.PearsonCorrCoef(num_outputs=ranks.REG_OUTPUTS)
    spearman = jreg.SpearmanCorrCoef(num_outputs=ranks.REG_OUTPUTS)
    for metric in (pearson, spearman):
        metric.update(preds, target)
    for rank, got in enumerate(results):
        assert got["pearson"].shape == (ranks.REG_OUTPUTS,), (world, rank)
        np.testing.assert_allclose(got["pearson"].numpy(), np.asarray(pearson.compute()), rtol=1e-5, atol=1e-6)
        assert torch.equal(got["spearman/list"], got["spearman/buffer"]), (world, rank)
        np.testing.assert_allclose(got["spearman/list"].numpy(), np.asarray(spearman.compute()), rtol=1e-5, atol=1e-6)


def test_gloo_ranks_nominal_and_wrappers_match_one_jax_run_on_the_union(spawned):
    """The four nominal classes (int64 tables summed across ranks), MinMaxMetric and
    ClasswiseWrapper over a macro and a per-class accuracy, against one ``metrics_tpu``
    run on the union: tables bit-equal, values within 1e-6."""
    import metrics_tpu.nominal as jn
    import metrics_tpu.wrappers as jw

    world, results = spawned
    nom = ranks.make_data(SEED)["nom"]
    preds, target = jnp.asarray(nom["preds"]), jnp.asarray(nom["target"])
    want = {}
    for name in ("CramersV", "TschuprowsT", "PearsonsContingencyCoefficient", "TheilsU"):
        metric = getattr(jn, name)(num_classes=ranks.C)
        metric.update(preds, target)
        want[name] = (metric.compute(), np.asarray(metric.confmat).astype(np.int64))
    minmax = jw.MinMaxMetric(jc.MulticlassAccuracy(num_classes=ranks.C, average="macro"))
    classwise = jw.ClasswiseWrapper(jc.MulticlassAccuracy(num_classes=ranks.C, average=None))
    for metric in (minmax, classwise):
        metric.update(preds, target)
    minmax_want, classwise_want = minmax.compute(), classwise.compute()
    for name, (_, confmat) in want.items():  # each rank keeps its own live table; they sum to the union's
        tables = [got[f"nominal/{name}/confmat"] for got in results]
        assert all(t.dtype == torch.int64 for t in tables)
        assert np.array_equal(sum(tables).numpy(), confmat)
    for rank, got in enumerate(results):
        for name, (value, _) in want.items():
            assert_close(got[f"nominal/{name}"], value)
        assert set(got["minmax"]) == set(minmax_want) and set(got["classwise"]) == set(classwise_want)
        for key, value in minmax_want.items():
            assert_close(got["minmax"][key], value)
        for key, value in classwise_want.items():
            assert_close(got["classwise"][key], value)
