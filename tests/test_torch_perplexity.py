"""Perplexity of metrics_tpu_torch against metrics_tpu, on the CPU.

The same seeded numpy logits (a few positions per sequence, a vocabulary of up to 97)
go through the JAX package and the port (``device="cpu"``): float32, float16 and
bfloat16 logits (rounded to the half types the same way on both sides), with and
without ``ignore_index``, within a relative 1e-5. Also: the class over several
updates, ``forward`` and ``reset``; the pure tier and a fused collection against the
eager class; the gradient against ``jax.grad``; the validation errors by type and
message; ``load_jax_state``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu.functional.text as jf
import metrics_tpu.text as jt
import metrics_tpu_torch.functional.text as tf
import metrics_tpu_torch.text as tt
from metrics_tpu_torch.convert import load_jax_state
from metrics_tpu_torch.core.collections import MetricCollection
from metrics_tpu_torch.core.fused import engine_for
from tests.torch_deadline import deadline  # noqa: F401

RTOL = 1e-5
DTYPES = {"float32": (jnp.float32, torch.float32), "float16": (jnp.float16, torch.float16),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def logits_and_target(seed: int, shape=(3, 17, 97), ignore: float = 0.0, scale: float = 3.0):
    rng = np.random.RandomState(seed)
    logits = (scale * rng.randn(*shape)).astype(np.float32)
    target = rng.randint(0, shape[-1], shape[:2]).astype(np.int64)
    target[rng.rand(*shape[:2]) < ignore] = -100
    return logits, target


def pair(logits, target, dtype: str):
    """The same values as a JAX and a torch pair, the logits rounded to ``dtype`` on both sides."""
    jdt, tdt = DTYPES[dtype]
    j = (jnp.asarray(logits).astype(jdt), jnp.asarray(target.astype(np.int32)))
    t = (torch.from_numpy(logits).to(tdt), torch.from_numpy(target))
    assert np.array_equal(np.asarray(j[0].astype(jnp.float32)), t[0].float().numpy())
    return j, t


def assert_rel(got, want, rtol: float = RTOL):
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32 and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol, atol=0)


@pytest.mark.parametrize("ignore_index", [None, -100])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_perplexity_matches_jax(dtype, ignore_index):
    logits, target = logits_and_target(0, ignore=0.1 if ignore_index is not None else 0.0)
    (jl, jtg), (tl, ttg) = pair(logits, target, dtype)
    assert_rel(tf.perplexity(tl, ttg, ignore_index=ignore_index), jf.perplexity(jl, jtg, ignore_index=ignore_index))


def test_perplexity_of_numpy_inputs_and_an_ignore_index_inside_the_vocabulary():
    logits, target = logits_and_target(1, shape=(2, 9, 11))
    got = tf.perplexity(logits, target.astype(np.int32), ignore_index=3, device="cpu")
    assert_rel(got, jf.perplexity(jnp.asarray(logits), jnp.asarray(target.astype(np.int32)), ignore_index=3))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_perplexity_class_matches_jax(dtype):
    tm, jm = tt.Perplexity(ignore_index=-100, device="cpu"), jt.Perplexity(ignore_index=-100)
    for i in range(4):
        logits, target = logits_and_target(10 + i, shape=(2, 13, 61), ignore=0.2)
        (jl, jtg), (tl, ttg) = pair(logits, target, dtype)
        if i % 2:
            assert_rel(tm(tl, ttg), jm(jl, jtg))
        else:
            tm.update(tl, ttg)
            jm.update(jl, jtg)
    assert tm.count.dtype == torch.int64 and tm.total_log_probs.dtype == torch.float32
    assert int(tm.count) == int(np.asarray(jm.count))
    assert_rel(tm.total_log_probs, jm.total_log_probs)
    assert_rel(tm.compute(), jm.compute())
    tm.reset()
    jm.reset()
    assert int(tm.count) == 0 and float(tm.total_log_probs) == 0.0
    tm.update(tl, ttg)
    jm.update(jl, jtg)
    assert_rel(tm.compute(), jm.compute())


def test_pure_tier_and_fused_collection_match_the_eager_class():
    data = [logits_and_target(20 + i, shape=(2, 7, 33), ignore=0.1) for i in range(3)]
    data = [(torch.from_numpy(x), torch.from_numpy(y)) for x, y in data]
    eager = tt.Perplexity(ignore_index=-100, device="cpu")
    pure = tt.Perplexity(ignore_index=-100, device="cpu")
    coll = MetricCollection({"ppl": tt.Perplexity(ignore_index=-100, device="cpu")}, fused=True)
    state = pure.init_state()
    for x, y in data:
        eager.update(x, y)
        state = pure.local_update(state, x, y)
        coll.update(x, y)
    assert pure._update_count == 0 and float(pure.total_log_probs) == 0.0
    want = eager.compute()
    assert torch.equal(pure.compute_from(state), want)
    assert torch.equal(coll.compute()["ppl"], want)
    assert engine_for(coll).stats["launches"] == len(data)
    assert engine_for(coll).stats["fallback_groups"] == 0


def test_perplexity_gradient_matches_jax():
    logits, target = logits_and_target(30, shape=(2, 5, 13), ignore=0.2)
    target[0, :2] = -100
    x = torch.from_numpy(logits).requires_grad_(True)
    value = tf.perplexity(x, torch.from_numpy(target), ignore_index=-100)
    value.backward()
    want = jax.grad(lambda z: jf.perplexity(z, jnp.asarray(target.astype(np.int32)), ignore_index=-100))(
        jnp.asarray(logits)
    )
    assert tt.Perplexity.is_differentiable
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want), rtol=RTOL, atol=1e-7)
    assert float(np.abs(x.grad.numpy()[target == -100]).max()) == 0.0


ERROR_CASES = {
    "preds_ndim": (np.zeros((2, 3), np.float32), np.zeros((2, 3), np.int32)),
    "target_ndim": (np.zeros((2, 3, 4), np.float32), np.zeros((2, 3, 1), np.int32)),
    "shapes": (np.zeros((2, 3, 4), np.float32), np.zeros((2, 4), np.int32)),
    "preds_dtype": (np.zeros((2, 3, 4), np.int32), np.zeros((2, 3), np.int32)),
    "target_dtype": (np.zeros((2, 3, 4), np.float32), np.zeros((2, 3), np.float32)),
}


def _raised(fn):
    with pytest.raises(Exception) as err:
        fn()
    return type(err.value), str(err.value)


@pytest.mark.parametrize("case", sorted(ERROR_CASES))
def test_perplexity_errors_match_jax(case):
    preds, target = ERROR_CASES[case]
    want = _raised(lambda: jf.perplexity(jnp.asarray(preds), jnp.asarray(target)))
    assert _raised(lambda: tf.perplexity(torch.from_numpy(preds), torch.from_numpy(target))) == want
    want = _raised(lambda: jt.Perplexity().update(jnp.asarray(preds), jnp.asarray(target)))
    assert _raised(lambda: tt.Perplexity(device="cpu").update(torch.from_numpy(preds), torch.from_numpy(target))) == want


def test_perplexity_ignore_index_argument_error_matches_jax():
    want = _raised(lambda: jt.Perplexity(ignore_index=1.5))
    assert _raised(lambda: tt.Perplexity(ignore_index=1.5, device="cpu")) == want


def test_load_jax_state_carries_perplexity():
    jm = jt.Perplexity(ignore_index=-100)
    for i in range(2):
        logits, target = logits_and_target(40 + i, shape=(2, 6, 19), ignore=0.3)
        jm.update(jnp.asarray(logits), jnp.asarray(target.astype(np.int32)))
    jm.persistent(True)
    tm = load_jax_state(tt.Perplexity(ignore_index=-100, device="cpu"), jm.state_dict())
    assert tm.count.dtype == torch.int64 and int(tm.count) == int(np.asarray(jm.count))
    assert torch.equal(tm.total_log_probs, torch.from_numpy(np.asarray(jm.total_log_probs)))
    assert_rel(tm.compute(), jm.compute())
