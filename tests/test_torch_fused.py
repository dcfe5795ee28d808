"""The fused collection engine of metrics_tpu_torch (``core/fused.py``), on the CPU.

The JAX package's fused cases that have a torch meaning
(``tests/unittests/bases/test_fused.py:217-460``): registered defaults survive and
``reset`` works, compute-group members are re-pointed after a step, partial fusion
of a mixed collection, a group mid-``sync_context`` steps eagerly, a collection
with nothing fusable never steps fused, ``forward`` parity and ``_forward_cache``,
cache hits and misses, a group whose capture fails is demoted alone, typed arity
errors, clone and pickle. On the CPU the engine runs the chained pure step eagerly
(its plain version), so fused and eager are bit-identical; the canonical collection
also agrees with the JAX package's fused collection (counts bit-equal, floats within
1e-6). The sweep runs every port class of the JAX contract registry that the fusion
rules accept through a one-metric fused collection, bit for bit against eager, and
asserts a floor on how many fused.
"""
import copy
import os
import pickle
import sys
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu
import metrics_tpu_torch
from metrics_tpu.core.fused import canonical_collection as jax_canonical_collection
from metrics_tpu_torch.classification import BinaryAccuracy, BinaryAUROC, BinaryF1Score
from metrics_tpu_torch.core import CatMetric, MetricCollection, SumMetric
from metrics_tpu_torch.core.fused import canonical_collection, engine_for, fusion_fallback_reason
from metrics_tpu_torch.regression import MeanSquaredError
from metrics_tpu_torch.utils.checks import _is_concrete
from metrics_tpu_torch.utils.exceptions import MetricsUserError

sys.path.insert(0, os.path.join(os.path.dirname(__file__)))
from unittests.bases import test_contract_sweep as _sweep  # noqa: E402
from unittests.bases.test_contract_sweep import _FULL, _case_for  # noqa: E402

CPU = "cpu"


def _batch(i, n=64):
    r = np.random.RandomState(i)
    return torch.as_tensor(r.rand(n).astype(np.float32)), torch.as_tensor(r.randint(0, 2, n).astype(np.int32))


def _leaves(value):
    if isinstance(value, dict):
        return [x for k in sorted(value) for x in _leaves(value[k])]
    if isinstance(value, (list, tuple)):
        return [x for v in value for x in _leaves(v)]
    if isinstance(value, torch.Tensor):
        return [value.detach().cpu().numpy()]
    return [np.asarray(value)]


def _bit_identical(a, b):
    la, lb = _leaves(a), _leaves(b)
    return len(la) == len(lb) and all(x.dtype == y.dtype and x.tobytes() == y.tobytes() for x, y in zip(la, lb))


def test_canonical_collection_fuses_all_five_groups_and_matches_eager():
    fused, eager = canonical_collection(True, CPU), canonical_collection(False, CPU)
    assert len(fused.compute_groups) == 5
    for i in range(3):
        p, t = _batch(i)
        fused.update(p, t)
        eager.update(p, t)
    assert _bit_identical(eager.compute(), fused.compute())
    stats = engine_for(fused).stats
    assert stats == {"launches": 3, "cache_hits": 2, "cache_misses": 1, "fallback_groups": 0, "degrades": 0}


def test_canonical_collection_agrees_with_the_jax_fused_collection():
    port, ref = canonical_collection(True, CPU), jax_canonical_collection(fused=True)
    for i in range(3):
        p, t = _batch(i)
        port.update(p, t)
        ref.update(jnp.asarray(p.numpy()), jnp.asarray(t.numpy()))
    got, want = port.compute(), ref.compute()
    for name in ("BinaryAccuracy", "BinaryAUROC", "MeanSquaredError", "MeanAbsoluteError"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]), rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(got["BinaryConfusionMatrix"].numpy(), np.asarray(want["BinaryConfusionMatrix"]))


def test_defaults_survive_and_reset_works():
    coll = canonical_collection(True, CPU)
    defaults = {n: {k: v.clone() for k, v in coll._modules[n]._defaults.items()} for n in coll._modules}
    p, t = _batch(0)
    for _ in range(2):
        coll.update(p, t)
    for name, m in coll._modules.items():
        assert all(torch.equal(m._defaults[k], v) for k, v in defaults[name].items())
        assert all(getattr(m, k) is not m._defaults[k] for k in m._defaults)
    coll.reset()
    coll.update(p, t)
    coll.reset()
    coll.update(p, t)
    ref = canonical_collection(False, CPU)
    ref.update(p, t)
    assert _bit_identical(ref.compute(), coll.compute())


def test_group_aliasing_repointed_after_launch():
    coll = MetricCollection([BinaryAccuracy(device=CPU), BinaryF1Score(device=CPU)], fused=True)
    assert len(coll._groups) == 1
    p, t = _batch(0)
    coll.update(p, t)
    coll.update(p, t)
    leader, member = coll._modules["BinaryAccuracy"], coll._modules["BinaryF1Score"]
    assert all(getattr(member, s) is getattr(leader, s) for s in leader._defaults)
    assert member._update_count == leader._update_count == 2
    eager = MetricCollection([BinaryAccuracy(device=CPU), BinaryF1Score(device=CPU)])
    eager.update(p, t)
    eager.update(p, t)
    assert _bit_identical(eager.compute(), coll.compute())


def _mixed_collection(fused):
    return MetricCollection(
        {
            "acc": BinaryAccuracy(device=CPU),
            "auroc_exact": BinaryAUROC(thresholds=None, device=CPU),  # list state: eager
            "mse_cpu": MeanSquaredError(compute_on_cpu=True, device=CPU),  # eager
            "auroc_binned": BinaryAUROC(thresholds=11, device=CPU),
        },
        fused=fused,
    )


def test_partial_fusion_mixed_collection():
    mf, me = _mixed_collection(True), _mixed_collection(False)
    for i in range(2):
        p, t = _batch(i)
        mf.update(p, t)
        me.update(p, t)
    assert _bit_identical(me.compute(), mf.compute())
    stats = engine_for(mf).stats
    assert stats["launches"] == 2 and stats["fallback_groups"] == 4  # 2 eager groups x 2 steps


def test_catbuffer_state_is_not_fusable():
    reason = fusion_fallback_reason(BinaryAUROC(cat_capacity=128, device=CPU))
    assert reason is not None and "CatBuffer" in reason


def test_mid_sync_context_falls_back_for_that_step():
    coll = canonical_collection(True, CPU)
    p, t = _batch(0)
    coll.update(p, t)
    m = coll._modules["BinaryAccuracy"]
    m._is_synced = True  # as inside sync_context
    try:
        coll.update(p, t)
    finally:
        m._is_synced = False
    assert engine_for(coll).stats["fallback_groups"] == 1
    ref = canonical_collection(False, CPU)
    ref.update(p, t)
    ref.update(p, t)
    assert _bit_identical(ref.compute(), coll.compute())


def test_collection_with_nothing_fusable_stays_eager():
    coll = MetricCollection({"cat": CatMetric(device=CPU)}, fused=True)
    coll.update(torch.arange(4.0))
    ref = MetricCollection({"cat": CatMetric(device=CPU)})
    ref.update(torch.arange(4.0))
    assert _bit_identical(ref.compute(), coll.compute())
    assert engine_for(coll).stats["launches"] == 0


def test_forward_fused_parity_and_forward_cache():
    fused, eager = canonical_collection(True, CPU), canonical_collection(False, CPU)
    for i in range(3):
        p, t = _batch(i)
        rf, re_ = fused(p, t), eager(p, t)
        assert rf.keys() == re_.keys()
        assert _bit_identical(re_, rf)
    assert _bit_identical(eager.compute(), fused.compute())
    for name, m in fused._modules.items():
        assert m._forward_cache is not None and _bit_identical(m._forward_cache, rf[name])


def test_cache_hits_and_shape_churn():
    coll = canonical_collection(True, CPU)
    p, t = _batch(0)
    coll.update(p, t)
    coll.update(p, t)
    assert engine_for(coll).stats["cache_hits"] == 1
    for n in (32, 48, 96):
        coll.update(*_batch(n, n))
    assert engine_for(coll).stats["cache_misses"] == 4  # the first capture and 3 new shapes


def test_capture_failure_demotes_group_permanently():
    class Uncapturable(MeanSquaredError):
        """Reads its input on the host, which a CUDA graph capture refuses (on the
        card ``float(preds.sum())`` raises inside a capture; here the same error is
        raised wherever the engine traces the step)."""

        def update(self, preds, target):
            if not _is_concrete(preds):
                raise RuntimeError("operation not permitted when stream is capturing")
            super().update(preds, target)

    coll = MetricCollection({"acc": BinaryAccuracy(device=CPU), "bad": Uncapturable(device=CPU)}, fused=True)
    p, t = _batch(0)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        coll.update(p, t)
    assert any("cannot fuse" in str(w.message) for w in caught)
    coll.update(p, t)
    eng = engine_for(coll)
    assert eng.stats["launches"] == 2 and "bad" in eng._trace_fallbacks and eng.stats["degrades"] == 0
    ref = MetricCollection({"acc": BinaryAccuracy(device=CPU), "bad": MeanSquaredError(device=CPU)})
    ref.update(p, t)
    ref.update(p, t)
    assert _bit_identical(ref.compute(), coll.compute())


def test_first_step_runs_each_group_once_without_a_probe():
    class Counted(MeanSquaredError):
        calls = 0

        def update(self, preds, target):
            type(self).calls += 1
            super().update(preds, target)

    coll = MetricCollection({"acc": BinaryAccuracy(device=CPU), "mse": Counted(device=CPU)}, fused=True)
    p, t = _batch(0)
    coll.update(p, t)  # a new key: the chained step runs once; groups are probed only after a failure
    assert Counted.calls == 1 and not engine_for(coll)._trace_fallbacks
    coll.update(p, t)
    assert Counted.calls == 2
    assert engine_for(coll).stats == {
        "fallback_groups": 0, "launches": 2, "cache_hits": 1, "cache_misses": 1, "degrades": 0}


def test_step_cache_breaks_a_failed_key_with_a_degrade():
    from metrics_tpu_torch.core.fused import StepCache

    steps = StepCache("test")
    state = {"x": torch.zeros(3)}

    def good(st, extra):
        return {"x": st["x"] + extra}, None

    def bad(st, extra):
        raise RuntimeError("operation not permitted when stream is capturing")

    assert torch.equal(steps.call(("a",), lambda: good, state, [torch.ones(3)], "eager")[0]["x"], torch.ones(3))
    steps.call(("a",), lambda: bad, state, [torch.ones(3)], "eager")  # a hit: the compiled step is kept
    with pytest.raises(RuntimeError):
        steps.call(("b",), lambda: bad, state, [torch.ones(3)], "eager", raise_first=True)
    assert ("b",) not in steps.broken
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        assert steps.call(("b",), lambda: bad, state, [torch.ones(3)], "eager") is None
    assert ("b",) in steps.broken and steps.call(("b",), lambda: good, state, [torch.ones(3)], "eager") is None
    assert steps.stats == {"launches": 2, "cache_hits": 1, "cache_misses": 3, "degrades": 1}
    assert all(issubclass(w.category, RuntimeWarning) for w in caught)


def test_local_update_positional_arity_typed_error():
    coll = MetricCollection({"acc": BinaryAccuracy(device=CPU), "cat": CatMetric(device=CPU)})
    p, t = _batch(0)
    with pytest.raises(MetricsUserError) as err:
        coll.local_update(coll.init_state(), p, t)
    msg = str(err.value)
    assert "cat" in msg and "CatMetric" in msg and "1 positional" in msg and "with 2" in msg and "keyword" in msg
    single = MetricCollection({"cat": CatMetric(device=CPU)})
    state = single.local_update(single.init_state(), p)
    assert len(state["cat"]["value"]) == 1


def test_fused_update_arity_typed_error():
    coll = MetricCollection({"sum": SumMetric(device=CPU)}, fused=True)
    p, t = _batch(0)
    with pytest.raises(MetricsUserError, match="SumMetric"):
        coll.update(p, t)


def test_fused_collection_clone_and_pickle():
    coll = canonical_collection(True, CPU)
    p, t = _batch(0)
    coll.update(p, t)
    clone = coll.clone()
    clone.update(p, t)
    coll.update(p, t)
    assert _bit_identical(coll.compute(), clone.compute())
    restored = pickle.loads(pickle.dumps(canonical_collection(True, CPU)))
    assert restored.fused
    restored.update(p, t)
    ref = canonical_collection(False, CPU)
    ref.update(p, t)
    assert _bit_identical(ref.compute(), restored.compute())


def test_value_checks_are_skipped_inside_a_fused_step():
    # eager raises on a non-binary target; the fused step skips value checks, as jit does
    bad = torch.tensor([0, 1, 2, 1])
    with pytest.raises(RuntimeError, match="Detected the following values"):
        BinaryAccuracy(device=CPU).update(torch.rand(4), bad)
    coll = MetricCollection({"acc": BinaryAccuracy(device=CPU)}, fused=True)
    coll.update(torch.rand(4), bad)
    assert engine_for(coll).stats["launches"] == 1


# ------------------------------------------------------------------ the sweep

_FUSED_TESTED = []


def _sweep_case(name):
    """(class, kwargs, generator, update kwargs of each update) of a registry case that the
    fusion rules accept, or the reason the sweep skips it."""
    kwargs, gen, upd_kwargs = _case_for(name)
    cls = getattr(metrics_tpu_torch, name, None)
    if cls is None:
        return "not in the port"
    if any(isinstance(v, metrics_tpu.Metric) or callable(v) for v in kwargs.values()):
        return "takes a JAX metric or a JAX callable in its constructor"
    kwargs = dict(copy.deepcopy(kwargs), device=CPU)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the root exports' FutureWarning shims
        reason = fusion_fallback_reason(cls(**copy.deepcopy(kwargs)))
    if reason is not None:
        return f"not fusable by contract: {reason}"
    return cls, kwargs, gen, (list(upd_kwargs) if upd_kwargs else [{}]) * 2


# The registry's generators draw from one RandomState (``test_contract_sweep._rng``),
# which the JAX package's sweeps (``tests/unittests/bases/test_fused.py``,
# ``test_contract_sweep.py``, ``tests/unittests/ckpt/test_roundtrip_sweep.py``) read too
# when they run in the same process; whether the fused sweep's SignalNoiseRatio,
# ScaleInvariantSignalNoiseRatio and TotalVariation cases meet bit-equality depends on
# the inputs they draw. So this file draws its cases' inputs when it is imported, in
# registry order: every process that collects it leaves the stream at the same place,
# whichever files it then runs. Classes ported after this sweep was written
# (``_OWN_STREAM``) draw from a copy of the stream, so that porting a class moves no
# other file's inputs.
_OWN_STREAM = {"Perplexity"}
_SWEEP_INPUTS = {}
for _name in _FULL:
    _case = _sweep_case(_name)
    if isinstance(_case, str):
        continue
    _stream = _sweep._rng.get_state()
    _SWEEP_INPUTS[_name] = [_case[2]() for _ in _case[3]]
    if _name in _OWN_STREAM:
        _sweep._rng.set_state(_stream)


@pytest.mark.parametrize("name", _FULL, ids=_FULL)
def test_fused_matches_eager_sweep(name):
    """Every port class of the registry that fusion accepts: a one-metric fused
    collection against the eager metric on identical inputs, bit for bit."""
    case = _sweep_case(name)
    if isinstance(case, str):
        pytest.skip(case)
    cls, kwargs, _, updates = case
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the root exports' FutureWarning shims
        m_eager = cls(**copy.deepcopy(kwargs))
        coll = MetricCollection({name: cls(**copy.deepcopy(kwargs))}, fused=True)
        for uk, inputs in zip(updates, _SWEEP_INPUTS[name]):
            args = tuple(torch.as_tensor(np.asarray(a)) if isinstance(a, np.ndarray) else a for a in inputs)
            m_eager.update(*args, **uk)
            coll.update(*args, **uk)
        eager_out = m_eager.compute()
        fused_res = coll.compute()
    fused_out = fused_res[name] if name in fused_res else fused_res
    stats = engine_for(coll).stats
    assert stats["degrades"] == 0
    if stats["launches"] == 0:
        pytest.skip("the capture probe demoted the group")
    _FUSED_TESTED.append(name)
    assert _bit_identical(eager_out, fused_out), f"{name}: fused compute() not bit-identical to eager"


def test_sweep_actually_fused_enough_classes():
    """The sweep above must have fused a real population of classes."""
    assert len(_FUSED_TESTED) >= 60, f"only {len(_FUSED_TESTED)} classes fused: {_FUSED_TESTED}"
