"""The port's training pieces against the reference, on the CPU: int8
block-quantized moments, AdamW with them, SGD, the eval step, activation
checkpointing and microbatched gradient accumulation.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances, and why:
  * quantize / dequantize: bit-identical (the same float32 division and
    round-half-to-even);
  * one int8 AdamW step, three steps and microbatched steps: 1e-5 relative
    with an absolute floor of 1e-5 of the largest parameter — float32
    gradients summed in different orders (with int8 moments a moment next
    to a rounding boundary could land one quantum apart; none does here);
  * SGD and the eval loss: 1e-6 relative;
  * remat policies against none: equal gradients, bit for bit (the same
    operations recomputed on the CPU).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common.config import OptimizerConfig as RefOptConfig
from repro.common.config import TrainConfig as RefTrainConfig
from repro.core import membership as ref_membership
from repro.train import dequantize_blockwise as ref_dequantize
from repro.train import init_train_state as ref_init_train
from repro.train import make_eval_step as ref_make_eval
from repro.train import make_train_step as ref_make_step
from repro.train import quantize_blockwise as ref_quantize
from repro.train.optimizer import sgd_update as ref_sgd
from repro_torch.common.config import OptimizerConfig, TrainConfig
from repro_torch.core.membership import membership_loss, params_from_jax
from repro_torch.train import (
    apply_remat,
    dequantize_blockwise,
    init_train_state,
    make_eval_step,
    make_train_step,
    quantize_blockwise,
    sgd_update,
)

SHAPES = [(), (1,), (5,), (255,), (256,), (257,), (300,), (3, 513), (2, 4, 100)]


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_quantize_blockwise_bit_identical(shape):
    rng = np.random.default_rng(len(shape) * 100 + int(np.prod(shape)))
    x = np.asarray(rng.standard_normal(shape) * rng.choice([1e-3, 1.0, 50.0]), np.float32)
    if x.size >= 4:  # a zero block, and halves that round to even
        flat = x.reshape(-1)
        flat[:2] = 0.0
        flat[2], flat[3] = 127.0, 2.5
    for arr in (x, np.zeros(shape, np.float32)):
        got = quantize_blockwise(torch.from_numpy(np.array(arr)))
        want = ref_quantize(jnp.asarray(arr))
        assert got["q"].dtype == torch.int8 and got["scale"].dtype == torch.float32
        assert np.array_equal(got["q"].numpy(), np.asarray(want["q"]))
        assert np.array_equal(got["scale"].numpy().view(np.int32),
                              np.asarray(want["scale"]).view(np.int32))
        back = dequantize_blockwise(got, shape)
        ref_back = ref_dequantize(want, shape)
        assert tuple(back.shape) == shape
        assert np.array_equal(back.numpy().view(np.int32), np.asarray(ref_back).view(np.int32))


def _params(seed=2, head=(8,)):
    rng = np.random.default_rng(seed)
    p = {"term_embed": {"table": (rng.standard_normal((300, 8)) * 0.3).astype(np.float32)},
         "doc_embed": {"table": (rng.standard_normal((200, 8)) * 0.3).astype(np.float32)},
         "bias": np.float32(0.1)}
    dims = [16, *head, 1]
    p["mlp"] = [{"w": (rng.standard_normal((i, o)) / np.sqrt(i)).astype(np.float32),
                 "b": (rng.standard_normal(o) * 0.1).astype(np.float32)}
                for i, o in zip(dims[:-1], dims[1:])]
    return p


def _batch(seed, n=256):
    rng = np.random.default_rng(seed)
    return {"terms": rng.integers(0, 300, n).astype(np.int32),
            "docs": rng.integers(0, 200, n).astype(np.int32),
            "labels": (rng.random(n) < 0.3).astype(np.float32)}


def _torch(b):
    return {k: torch.from_numpy(v.astype(np.int64) if v.dtype == np.int32 else v)
            for k, v in b.items()}


def _assert_params(model, params):
    pairs = [(model.term_embed.weight, params["term_embed"]["table"]),
             (model.doc_embed.weight, params["doc_embed"]["table"]), (model.bias, params["bias"])]
    pairs += [(p[k], q[k]) for p, q in zip(model.mlp, params["mlp"]) for k in ("w", "b")]
    for got, want in pairs:
        want = np.asarray(want)
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("moments,micro", [("int8", 1), ("fp32", 2), ("int8", 4)])
def test_train_steps_match_reference(moments, micro):
    ocfg = dict(lr=0.01, warmup_steps=1, total_steps=10, weight_decay=0.1, moment_dtype=moments)
    params_np = _params()
    model = params_from_jax(params_np, device="cpu")
    step = make_train_step(membership_loss, OptimizerConfig(**ocfg), n_microbatches=micro)
    st = init_train_state(model, OptimizerConfig(**ocfg))
    if moments == "int8":
        assert all(m["q"].dtype == torch.int8 for m in st.m)
    ref_step = jax.jit(ref_make_step(ref_membership.membership_loss, RefOptConfig(**ocfg),
                                     n_microbatches=micro))
    params = jax.tree.map(jnp.asarray, params_np)
    ref_st = ref_init_train(params, RefOptConfig(**ocfg))
    for i in range(3):
        b = _batch(i)
        m = step(model, st, _torch(b))
        params, ref_st, ref_m = ref_step(params, ref_st, {k: jnp.asarray(v) for k, v in b.items()})
        np.testing.assert_allclose(float(m["loss"]), float(ref_m["loss"]), rtol=1e-5)
    _assert_params(model, params)
    if moments == "int8":  # the moments themselves, dequantized
        ref_m = [ref_dequantize(m, np.shape(p)) for m, p in zip(
            jax.tree.leaves(ref_st.m, is_leaf=lambda x: isinstance(x, dict) and "q" in x),
            jax.tree.leaves(params))]
        got = [dequantize_blockwise(m, tuple(p.shape))
               for m, (_, p) in zip(st.m, sorted(model.named_parameters()))]
        for g, w in zip(got, ref_m, strict=True):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                       atol=1e-4 * max(np.abs(np.asarray(w)).max(), 1e-30))


def test_sgd_update_matches_reference():
    rng = np.random.default_rng(3)
    ps = [rng.standard_normal(s).astype(np.float32) for s in ((4, 5), (7,), ())]
    gs = [rng.standard_normal(s).astype(np.float32) for s in ((4, 5), (7,), ())]
    got = sgd_update([torch.from_numpy(g) for g in gs], [torch.from_numpy(p.copy()) for p in ps],
                     0.05)
    want = ref_sgd([jnp.asarray(g) for g in gs], [jnp.asarray(p) for p in ps], 0.05)
    for g, w in zip(got, want, strict=True):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)


def test_eval_step_matches_reference_without_grads():
    params_np = _params()
    model = params_from_jax(params_np, device="cpu")
    b = _batch(7)
    loss = make_eval_step(membership_loss)(model, _torch(b))
    want = ref_make_eval(ref_membership.membership_loss)(jax.tree.map(jnp.asarray, params_np),
                                                         {k: jnp.asarray(v) for k, v in b.items()})
    assert not loss.requires_grad
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-6)
    assert all(p.grad is None for p in model.parameters())


def _grads(policy):
    model = params_from_jax(_params(head=(8, 6)), device="cpu")
    loss = apply_remat(membership_loss, policy)(model, _torch(_batch(11)))
    loss.backward()
    return loss.detach(), [p.grad for _, p in sorted(model.named_parameters())]


def test_remat_policies_give_the_same_gradients():
    loss, grads = _grads("none")
    for policy in ("full", "dots"):
        l2, g2 = _grads(policy)
        assert torch.equal(l2, loss)
        assert all(torch.equal(a, b) for a, b in zip(grads, g2, strict=True)), policy
    with pytest.raises(ValueError):
        apply_remat(membership_loss, "everything")


def test_train_config_remat_reaches_the_step():
    """A TrainConfig's remat policy is the step's: the same update as none."""
    ocfg = OptimizerConfig(lr=0.01, warmup_steps=1, total_steps=10)
    out = []
    for remat in ("none", "dots"):
        model = params_from_jax(_params(), device="cpu")
        step = make_train_step(membership_loss, ocfg, TrainConfig(remat=remat))
        step(model, init_train_state(model, ocfg), _torch(_batch(2)))
        out.append([p.detach().clone() for p in model.parameters()])
    assert all(torch.equal(a, b) for a, b in zip(*out))
    assert RefTrainConfig().remat == TrainConfig().remat == "none"
