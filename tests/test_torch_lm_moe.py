"""The port's MLA, MoE and MTP against the reference, on the CPU.

Reduced configs of deepseek-v2-lite-16b (MLA without a query LoRA, softmax
gates) and deepseek-v3-671b (query LoRA, sigmoid gates with the selection
bias, the MTP head); the reference's weights carried across by
``lm_params_from_jax``.  Tolerances, and why:
  * fp32 logits and loss (the MTP term included): atol 2e-4 / rtol 1e-4,
    float32 sums in other orders;
  * prefill and decode: 2e-4 of the reference's decode and of the port's
    own full forward (the reference's test's bound);
  * ``moe_ffn`` with a capacity small enough that slots drop: the same
    dropped slots exactly, outputs within 1e-5; expert choice with ties:
    the same indices exactly;
  * bf16: the loss within 1e-2 of the reference's (a bf16 rounding may flip
    a routing choice, which moves a token's output by a whole expert's).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common.config import ArchConfig as RefArchConfig
from repro.configs import get_arch as ref_get_arch
from repro.configs import reduce_config as ref_reduce
from repro.models import moe as ref_moe
from repro.models import transformer as ref_tf
from repro_torch.common.config import ArchConfig
from repro_torch.configs import get_arch, reduce_config
from repro_torch.models import moe
from repro_torch.models import transformer as tf

MLA_ARCHS = ["deepseek-v2-lite-16b", "deepseek-v3-671b"]


def _numpy_like(spec, seed):
    """numpy arrays shaped like ``spec``: weights normal / sqrt(fan-in), the
    embedding 0.02, norm scales and the selection bias 0.1."""
    rng = np.random.default_rng(seed)

    def mk(path, s):
        name = str(getattr(path[-1], "key", ""))
        std = 0.1 if name in ("scale", "bias") else 0.02 if name == "table" else \
            1.0 / np.sqrt(s.shape[-2])
        return (rng.standard_normal(s.shape) * std).astype(s.dtype)

    return jax.tree_util.tree_map_with_path(mk, spec)


def _pair(arch_id):
    rc = ref_reduce(ref_get_arch(arch_id)[0])
    tc = reduce_config(get_arch(arch_id)[0])
    params = _numpy_like(jax.eval_shape(lambda k: ref_tf.init_lm(k, rc)[0], jax.random.key(0)), 0)
    return rc, tc, params, tf.lm_params_from_jax(params, tc, device="cpu")


@pytest.mark.parametrize("arch_id", MLA_ARCHS)
def test_logits_and_loss_match_reference(arch_id):
    rc, tc, params, model = _pair(arch_id)
    assert tc.use_mtp == (arch_id == "deepseek-v3-671b") and (model.mtp is not None) == tc.use_mtp
    toks = np.random.default_rng(1).integers(0, rc.vocab_size, (2, 16)).astype(np.int32)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        ref_logits, ref_loss = jax.jit(
            lambda p, b: (ref_tf.lm_logits(p, rc, b["tokens"], jdt), ref_tf.lm_loss(p, rc, b, jdt))
        )(params, batch)
        with torch.no_grad():
            logits = tf.lm_logits(model, tc, tbatch["tokens"], tdt).numpy()
            loss = float(tf.lm_loss(model, tc, tbatch, tdt))
        if tdt == torch.float32:
            ref_loss32 = float(ref_loss)
            np.testing.assert_allclose(logits, np.asarray(ref_logits), atol=2e-4, rtol=1e-4)
            np.testing.assert_allclose(loss, float(ref_loss), atol=2e-4, rtol=1e-4)
        else:
            assert abs(loss - float(ref_loss)) < 1e-2, (loss, float(ref_loss))
    if tc.use_mtp:  # the MTP term is in the loss, and equals the reference's
        no_mtp = float(jax.jit(lambda p, b: ref_tf.lm_loss(p, rc.replace(use_mtp=False), b,
                                                           jnp.float32))(params, batch))
        with torch.no_grad():
            port_no_mtp = float(tf.lm_loss(model, tc.replace(use_mtp=False), tbatch, torch.float32))
            full = float(tf.lm_loss(model, tc, tbatch, torch.float32))
        assert full - port_no_mtp > 0.1
        np.testing.assert_allclose(full - port_no_mtp, ref_loss32 - no_mtp, atol=2e-4)


@pytest.mark.parametrize("arch_id", MLA_ARCHS)
def test_prefill_and_decode_match_reference_and_forward(arch_id):
    """The MLA cache holds the latent (c_kv, k_rope); decode re-expands it."""
    rc, tc, params, model = _pair(arch_id)
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, rc.vocab_size, (2, 12)).astype(np.int32)
    nxt = rng.integers(0, rc.vocab_size, (2, 3)).astype(np.int32)
    spec = tf.cache_spec(tc, 2, 20)
    assert spec[0] == ((2, 20, tc.kv_lora_rank), (2, 20, tc.qk_rope_head_dim))
    prefill = jax.jit(lambda p, t, c: ref_tf.lm_prefill(p, rc, t, c, jnp.float32))
    decode = jax.jit(lambda p, t, q, c: ref_tf.lm_decode_step(p, rc, t, q, c, jnp.float32))
    r, rcache = prefill(params, prompt, ref_tf.init_cache(rc, 2, 20, jnp.float32))
    t, tcache = tf.lm_prefill(model, tc, torch.from_numpy(prompt),
                              tf.init_cache(tc, 2, 20, torch.float32, device="cpu"), torch.float32)
    seq = prompt
    for i in range(4):
        with torch.no_grad():
            full = tf.lm_logits(model, tc, torch.from_numpy(seq), torch.float32)[:, -1].numpy()
        np.testing.assert_allclose(t.numpy(), np.asarray(r), atol=2e-4)
        np.testing.assert_allclose(t.numpy(), full, atol=2e-4)
        if i == 3:
            break
        tok, pos = nxt[:, i:i + 1], np.full((2, 1), 12 + i, np.int32)
        r, rcache = decode(params, tok, pos, rcache)
        t, tcache = tf.lm_decode_step(model, tc, torch.from_numpy(tok), torch.from_numpy(pos),
                                      tcache, torch.float32)
        seq = np.concatenate([seq, tok], axis=1)


def _moe_pair(aux_free: bool, cf: float, seed: int):
    kw = dict(name="moe-test", d_model=16, n_routed_experts=4, top_k=2, moe_d_ff=8,
              use_moe=True, moe_aux_free=aux_free, n_shared_experts=1, moe_capacity_factor=cf)
    rc, tc = RefArchConfig(**kw), ArchConfig(**kw)
    params = _numpy_like(jax.eval_shape(lambda k: ref_moe.init_moe(k, rc)[0], jax.random.key(0)),
                         seed)
    return rc, tc, params, {k: torch.from_numpy(np.asarray(v)) for k, v in params.items()}


def _ref_dropped(p, rc, x):
    """Which (row, slot) the reference's moe_ffn drops: its routing and
    capacity lines, run on its own arrays."""
    b, s, _ = x.shape
    logits = jnp.einsum("bsd,de->bse", x, p["router"])
    gate = jax.nn.sigmoid(logits) if rc.moe_aux_free else jax.nn.softmax(logits, -1)
    sel = gate + p["bias"][None, None, :] if rc.moe_aux_free else gate
    _, top_idx = jax.lax.top_k(sel, rc.top_k)
    flat_e = top_idx.reshape(b, s * rc.top_k)
    onehot = jax.nn.one_hot(flat_e, rc.n_routed_experts, dtype=jnp.int32)
    pos = ((jnp.cumsum(onehot, axis=1) - 1) * onehot).sum(-1)
    cap = max(1, min(int(np.ceil(rc.top_k * s / rc.n_routed_experts * rc.moe_capacity_factor)),
                     s * rc.top_k))
    return np.asarray(pos >= cap)


@pytest.mark.parametrize("aux_free", [True, False])
def test_moe_ffn_drops_the_same_slots(aux_free):
    rc, tc, params, tparams = _moe_pair(aux_free, cf=0.5, seed=7)
    x = np.random.default_rng(8).standard_normal((2, 12, 16)).astype(np.float32)
    want = np.asarray(ref_moe.moe_ffn(params, rc, jnp.asarray(x)))
    got = moe.moe_ffn(tparams, tc, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    _, top_idx = moe._route(tparams, tc, torch.from_numpy(x))
    _, _, dropped = moe._slots(top_idx, tc.n_routed_experts, moe.capacity(tc, 12))
    ref_dropped = _ref_dropped(params, rc, jnp.asarray(x))
    assert np.array_equal(dropped.numpy(), ref_dropped)
    assert 0 < ref_dropped.sum() < ref_dropped.size


def test_moe_ties_break_toward_the_lower_expert():
    """A zero router makes every gate equal: the choice is experts 0..k-1
    for every token, as the reference's top_k picks, and capacity drops the
    late tokens."""
    rc, tc, params, tparams = _moe_pair(False, cf=1.0, seed=9)
    params = dict(params, router=np.zeros_like(params["router"]))
    tparams = dict(tparams, router=torch.zeros_like(tparams["router"]))
    x = np.random.default_rng(10).standard_normal((2, 8, 16)).astype(np.float32)
    _, top_idx = moe._route(tparams, tc, torch.from_numpy(x))
    assert (top_idx == torch.arange(tc.top_k)).all()
    np.testing.assert_allclose(moe.moe_ffn(tparams, tc, torch.from_numpy(x)).numpy(),
                               np.asarray(ref_moe.moe_ffn(params, rc, jnp.asarray(x))), atol=1e-5)
    ties = np.random.default_rng(11).integers(0, 3, (5, 16)).astype(np.float32)
    _, want = jax.lax.top_k(jnp.asarray(ties), 6)
    assert np.array_equal(moe.top_k_lowest_index(torch.from_numpy(ties), 6)[1].numpy(),
                          np.asarray(want))


def test_load_balance_stats_and_bias_update_match_reference():
    rc, tc, params, tparams = _moe_pair(True, cf=1.25, seed=12)
    x = np.random.default_rng(13).standard_normal((2, 10, 16)).astype(np.float32)
    want = ref_moe.load_balance_stats(params, rc, jnp.asarray(x))
    got = moe.load_balance_stats(tparams, tc, torch.from_numpy(x))
    assert np.array_equal(got["load"].numpy(), np.asarray(want["load"]))
    assert float(got["mean"]) == float(want["mean"])
    bias = moe.update_balance_bias(tparams["bias"], got["load"], lr=1e-2)
    np.testing.assert_allclose(bias.numpy(), np.asarray(
        ref_moe.update_balance_bias(jnp.asarray(params["bias"]), want["load"], lr=1e-2)), atol=1e-7)


def test_moe_dispatch_is_the_grouped_path():
    """In one process moe_dispatch is moe_ffn, also for moe_a2a configs."""
    rc, tc, params, tparams = _moe_pair(True, cf=1.25, seed=14)
    x = torch.from_numpy(np.random.default_rng(15).standard_normal((2, 6, 16)).astype(np.float32))
    a2a = dataclasses.replace(tc, moe_a2a=True)
    assert torch.equal(moe.moe_dispatch(tparams, a2a, x), moe.moe_ffn(tparams, tc, x))
