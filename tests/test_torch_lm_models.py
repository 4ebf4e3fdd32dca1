"""The port's LM transformer (GQA archs) against the reference, on the CPU.

Reduced configs (``reduce_config``) of gemma-2b, gemma2-2b and
phi4-mini-3.8b; the reference's weights carried across by
``lm_params_from_jax``; tokens made with numpy from a seed.  Tolerances, and
why:
  * fp32 compute: logits and loss within atol 2e-4 / rtol 1e-4 (the same
    operations, float32 sums in other orders);
  * bf16 compute: the two packages round at different points (XLA keeps
    fused intermediates in fp32), so the bound is relative to bf16's own
    error: the port's logits lie within half the reference's bf16-vs-fp32
    distance of the reference's (relative L2), its own bf16-vs-fp32
    distance is at most 1.25x the reference's, and the loss within 2e-3;
  * prefill and decode: within 2e-4 of the reference's decode and of the
    port's own full forward, the reference's test's bound.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.configs import reduce_config as ref_reduce
from repro.models import attention as ref_attn
from repro.models import transformer as ref_tf
from repro_torch.configs import get_arch, reduce_config
from repro_torch.models import attention
from repro_torch.models import transformer as tf

GQA_ARCHS = ["gemma-2b", "gemma2-2b", "phi4-mini-3.8b"]
DT = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def ref_params(rc, seed=0):
    """The reference's LMParams for ``rc`` as numpy arrays drawn from a seed
    (its structure from ``jax.eval_shape`` of ``init_lm``): weights normal
    / sqrt(fan-in), the embedding 0.02, norm scales 0.1 (non-zero, so the
    (1 + scale) convention is exercised)."""
    spec = jax.eval_shape(lambda k: ref_tf.init_lm(k, rc)[0], jax.random.key(0))
    rng = np.random.default_rng(seed)

    def mk(path, s):
        name = str(getattr(path[-1], "key", ""))
        if name in ("scale", "bias"):
            std = 0.1
        elif name == "table":
            std = 0.02
        else:
            std = 1.0 / np.sqrt(s.shape[-2])
        return (rng.standard_normal(s.shape) * std).astype(s.dtype)

    return jax.tree_util.tree_map_with_path(mk, spec)


def _pair(arch_id, **kw):
    rc = ref_reduce(ref_get_arch(arch_id)[0]).replace(**kw)
    tc = reduce_config(get_arch(arch_id)[0]).replace(**kw)
    params = ref_params(rc)
    return rc, tc, params, tf.lm_params_from_jax(params, tc, device="cpu")


@pytest.mark.parametrize("arch_id", GQA_ARCHS)
def test_logits_and_loss_match_reference(arch_id):
    rc, tc, params, model = _pair(arch_id)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, rc.vocab_size, (2, 16)).astype(np.int32)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    out = {}
    for name, (jdt, tdt) in DT.items():
        ref_logits, ref_loss = jax.jit(
            lambda p, b: (ref_tf.lm_logits(p, rc, b["tokens"], jdt), ref_tf.lm_loss(p, rc, b, jdt))
        )(params, batch)
        with torch.no_grad():
            logits = tf.lm_logits(model, tc, torch.from_numpy(toks), tdt).numpy()
            loss = float(tf.lm_loss(model, tc, {k: torch.from_numpy(v) for k, v in batch.items()},
                                    tdt))
        assert logits.dtype == np.float32 and logits.shape == (2, 16, rc.vocab_size)
        out[name] = np.asarray(ref_logits), float(ref_loss), logits, loss
    ref32, ref_loss32, port32, loss32 = out["float32"]
    np.testing.assert_allclose(port32, ref32, atol=2e-4, rtol=1e-4)
    np.testing.assert_allclose(loss32, ref_loss32, atol=2e-4, rtol=1e-4)
    ref16, ref_loss16, port16, loss16 = out["bfloat16"]
    assert _rel(port16, ref16) < 0.5 * _rel(ref16, ref32), (_rel(port16, ref16), _rel(ref16, ref32))
    assert _rel(port16, ref32) < 1.25 * _rel(ref16, ref32), (_rel(port16, ref32), _rel(ref16, ref32))
    assert abs(loss16 - ref_loss16) < 2e-3, (loss16, ref_loss16)


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _serve_both(rc, tc, params, model, prompt, steps, max_len):
    """Prefill + decode steps in both packages (fp32) -> (ref logits, port
    logits, port full-forward logits) per step, prefill first."""
    b, s = prompt.shape
    rng = np.random.default_rng(2)
    nxt = rng.integers(0, rc.vocab_size, (b, steps)).astype(np.int32)
    prefill = jax.jit(lambda p, t, c: ref_tf.lm_prefill(p, rc, t, c, jnp.float32))
    decode = jax.jit(lambda p, t, q, c: ref_tf.lm_decode_step(p, rc, t, q, c, jnp.float32))
    rc_cache = ref_tf.init_cache(rc, b, max_len, jnp.float32)
    tc_cache = tf.init_cache(tc, b, max_len, torch.float32, device="cpu")
    r, rc_cache = prefill(params, prompt, rc_cache)
    t, tc_cache = tf.lm_prefill(model, tc, torch.from_numpy(prompt), tc_cache, torch.float32)
    out = []
    seq = prompt
    for i in range(steps + 1):
        with torch.no_grad():
            full = tf.lm_logits(model, tc, torch.from_numpy(seq), torch.float32)[:, -1].numpy()
        out.append((np.asarray(r), t.numpy(), full))
        if i == steps:
            break
        tok, pos = nxt[:, i:i + 1], np.full((b, 1), s + i, np.int32)
        r, rc_cache = decode(params, tok, pos, rc_cache)
        t, tc_cache = tf.lm_decode_step(model, tc, torch.from_numpy(tok), torch.from_numpy(pos),
                                        tc_cache, torch.float32)
        seq = np.concatenate([seq, tok], axis=1)
    return out


@pytest.mark.parametrize("arch_id", GQA_ARCHS)
def test_prefill_and_decode_match_reference_and_forward(arch_id):
    rc, tc, params, model = _pair(arch_id)
    prompt = np.random.default_rng(3).integers(0, rc.vocab_size, (2, 12)).astype(np.int32)
    for ref, port, full in _serve_both(rc, tc, params, model, prompt, steps=3, max_len=24):
        np.testing.assert_allclose(port, ref, atol=2e-4)
        np.testing.assert_allclose(port, full, atol=2e-4)


def test_gemma2_local_ring_wraps():
    """window_size=8: the local layers' caches are 8-slot rings; a 12-token
    prompt writes its last 8 tokens, and 6 decode steps wrap the ring."""
    rc, tc, params, model = _pair("gemma2-2b", window_size=8)
    assert tf.cache_spec(tc, 2, 24)[0][0][1] == 8  # layer 0 is local
    prompt = np.random.default_rng(4).integers(0, rc.vocab_size, (2, 12)).astype(np.int32)
    for ref, port, full in _serve_both(rc, tc, params, model, prompt, steps=6, max_len=24):
        np.testing.assert_allclose(port, ref, atol=2e-4)
        np.testing.assert_allclose(port, full, atol=2e-4)


def test_rope_mask_and_ring_positions_match_reference():
    rng = np.random.default_rng(5)
    pos = rng.integers(0, 50, (2, 7)).astype(np.int32)
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    rcos, rsin = ref_attn.rope_freqs(16, 10000.0, jnp.asarray(pos))
    cos, sin = attention.rope_freqs(16, 10000.0, torch.from_numpy(pos))
    np.testing.assert_allclose(cos.numpy(), np.asarray(rcos), atol=1e-6)
    np.testing.assert_allclose(sin.numpy(), np.asarray(rsin), atol=1e-6)
    np.testing.assert_allclose(attention.apply_rope(torch.from_numpy(x), cos, sin).numpy(),
                               np.asarray(ref_attn.apply_rope(jnp.asarray(x), rcos, rsin)), atol=1e-6)
    k_pos = np.concatenate([pos, -np.ones((2, 3), np.int32)], axis=1)
    for window in (None, 5):
        got = attention.causal_mask(torch.from_numpy(pos), torch.from_numpy(k_pos), window).numpy()
        want = np.asarray(ref_attn.causal_mask(jnp.asarray(pos), jnp.asarray(k_pos), window))
        assert np.array_equal(got, want)
    q = np.array([[19], [4]], np.int32)
    assert np.array_equal(attention._ring_positions(torch.from_numpy(q), 8).numpy(),
                          np.asarray(ref_attn._ring_positions(jnp.asarray(q), 8)))


def test_init_lm_shapes_axes_and_generator():
    """init_lm draws from a seeded generator on the device asked for, with
    the reference's structure; the meta device gives shapes only."""
    tc = reduce_config(get_arch("gemma2-2b")[0])
    a, axes = tf.init_lm(0, tc, device="cpu")
    b, _ = tf.init_lm(0, tc, device="cpu")
    c, _ = tf.init_lm(1, tc, device="cpu")
    sd_a, sd_b, sd_c = a.state_dict(), b.state_dict(), c.state_dict()
    assert set(sd_a) == set(axes)
    assert all(torch.equal(sd_a[k], sd_b[k]) for k in sd_a)
    assert not torch.equal(sd_a["embed.table"], sd_c["embed.table"])
    assert "stacked.1.post_ln2.scale" in sd_a and tc.tie_embeddings and a.lm_head is None
    meta, _ = tf.init_lm(0, tc, device="meta")
    assert {k: v.shape for k, v in meta.state_dict().items()} == {k: v.shape for k, v in sd_a.items()}
    assert all(v.is_meta for v in meta.state_dict().values())
    with pytest.raises(RuntimeError, match="CUDA"):
        if not torch.cuda.is_available():
            tf.init_lm(0, tc)  # the default device is the card
        else:
            raise RuntimeError("CUDA present")
