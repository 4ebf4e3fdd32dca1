"""The port's LM training path against the reference, on the CPU: one
train step, the remat policies, the token stream, the checkpoint manager
(its own format, read and written by both packages), kill-and-resume and
the launcher.

Tolerances, and why:
  * one train step (fp32 compute, eps 1e-3 so that the first AdamW update
    is smooth in the gradient rather than its sign): loss and grad norm
    rtol 1e-4, updated parameters atol 1e-4 (1% of the learning rate) —
    float32 sums in other orders, which the update's lr / eps = 10 amplifies;
  * remat policies: equal gradients, bit for bit (the same operations
    recomputed on the CPU);
  * the token stream and checkpoints: exact; kill-and-resume: bit for bit.
"""
import itertools
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import restore_checkpoint as ref_restore
from repro.checkpoint import save_checkpoint as ref_save
from repro.common.config import OptimizerConfig as RefOptConfig
from repro.configs import get_arch as ref_get_arch
from repro.configs import reduce_config as ref_reduce
from repro.data.loader import lm_token_batches as ref_token_batches
from repro.models import transformer as ref_tf
from repro.train import init_train_state as ref_init_train
from repro.train import make_train_step as ref_make_step
from repro_torch.checkpoint import CheckpointManager, latest_step, restore_checkpoint, save_checkpoint
from repro_torch.common.config import OptimizerConfig, ShapeSpec, TrainConfig
from repro_torch.configs import get_arch, reduce_config
from repro_torch.data.loader import PrefetchLoader, lm_token_batches
from repro_torch.launch import steps
from repro_torch.launch.train import main as train_main
from repro_torch.launch.train import train_loop
from repro_torch.models import transformer as tf
from repro_torch.train import init_train_state, make_train_step

ROOT = Path(__file__).resolve().parents[1]


def _numpy_like(spec, seed):
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


def _batch(vocab, seed=1, b=2, s=16):
    return next(lm_token_batches(vocab_size=vocab, batch=b, seq_len=s, seed=seed))


@pytest.mark.parametrize("arch_id", ["gemma2-2b", "deepseek-v2-lite-16b"])
def test_train_step_matches_reference(arch_id):
    rc, tc, params, model = _pair(arch_id)
    batch = _batch(rc.vocab_size)
    kw = dict(lr=1e-2, warmup_steps=1, eps=1e-3)
    ref_step = jax.jit(ref_make_step(lambda p, b: ref_tf.lm_loss(p, rc, b, jnp.float32),
                                     RefOptConfig(**kw)))
    new_p, _, ref_m = ref_step(params, ref_init_train(params, RefOptConfig(**kw)), batch)
    ocfg = OptimizerConfig(**kw)
    step = make_train_step(lambda m, b: tf.lm_loss(m, tc, b, torch.float32), ocfg)
    metrics = step(model, init_train_state(model, ocfg), {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(metrics["loss"]), float(ref_m["loss"]), rtol=1e-4)
    np.testing.assert_allclose(float(metrics["grad_norm"]), float(ref_m["grad_norm"]), rtol=1e-4)
    moved = tf.lm_params_from_jax(jax.tree.map(np.asarray, new_p), tc, device="cpu").state_dict()
    before = dict(_pair(arch_id)[3].state_dict())
    for name, p in model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), moved[name].numpy(), atol=1e-4, err_msg=name)
    assert max(float((model.state_dict()[n] - before[n]).abs().max()) for n in before) > 5e-3


@pytest.mark.parametrize("arch_id", ["gemma2-2b", "deepseek-v2-lite-16b"])
def test_remat_policies_give_the_same_gradients(arch_id):
    _, tc, _, model = _pair(arch_id)
    batch = {k: torch.from_numpy(v) for k, v in _batch(tc.vocab_size).items()}
    grads = {}
    for policy in ("none", "dots", "full"):
        model.zero_grad()
        tf.lm_loss(model, tc, batch, torch.float32, remat=policy).backward()
        # the MoE selection bias steers top-k only: it gets no gradient
        grads[policy] = {n: p.grad.clone() for n, p in model.named_parameters()
                         if p.grad is not None}
    assert all(n.endswith("ffn.bias") for n, _ in model.named_parameters() if n not in grads["none"])
    for policy in ("dots", "full"):
        assert grads[policy].keys() == grads["none"].keys()
        for n, g in grads["none"].items():
            assert torch.equal(grads[policy][n], g), (policy, n)


def test_lm_token_batches_equal_reference():
    ours = lm_token_batches(vocab_size=1000, batch=3, seq_len=17, seed=5)
    ref = ref_token_batches(vocab_size=1000, batch=3, seq_len=17, seed=5)
    for a, b in itertools.islice(zip(ours, ref), 3):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype == np.int32 and np.array_equal(a[k], b[k])


def test_prefetch_loader_order_errors_and_close():
    it = PrefetchLoader(iter(range(10)), depth=2)
    assert list(it) == list(range(10))
    it.close()

    def bad():
        yield 1
        raise KeyError("boom")

    it = PrefetchLoader(bad())
    assert next(it) == 1
    with pytest.raises(KeyError):
        next(it)
    it.close()
    forever = PrefetchLoader(itertools.count(), depth=2)  # blocks on a full queue
    assert next(forever) == 0
    t0 = time.perf_counter()
    forever.close()
    assert time.perf_counter() - t0 < 2.0 and not forever._thread.is_alive()
    assert not [t for t in threading.enumerate() if t is forever._thread]


# ------------------------------------------------ checkpoints (tests/test_train.py, ported)
def test_checkpoint_roundtrip(tmp_path):
    tree = {"a": torch.arange(6).reshape(2, 3), "b": {"c": torch.ones(4, dtype=torch.bfloat16)}}
    save_checkpoint(str(tmp_path), 3, tree)
    assert latest_step(str(tmp_path)) == 3
    out = restore_checkpoint(str(tmp_path), 3, tree)
    assert torch.equal(out["a"], torch.arange(6).reshape(2, 3))
    assert out["b"]["c"].dtype == torch.bfloat16 and torch.equal(out["b"]["c"], tree["b"]["c"])


def test_checkpoint_manager_gc_and_latest(tmp_path):
    cm = CheckpointManager(str(tmp_path), keep_last=2)
    tree = {"w": torch.zeros(3)}
    for s in (1, 2, 3, 4):
        cm.save(s, tree)
    assert sorted(os.listdir(tmp_path)) == ["step_00000003", "step_00000004"]
    step, out = cm.restore_latest(tree)
    assert step == 4 and torch.equal(out["w"], tree["w"])


def test_checkpoint_restores_structure_mismatch_raises(tmp_path):
    save_checkpoint(str(tmp_path), 1, {"w": torch.zeros(3)})
    with pytest.raises(ValueError):
        restore_checkpoint(str(tmp_path), 1, {"w": torch.zeros(3), "extra": torch.zeros(1)})


def test_checkpoint_atomic_no_partial_dirs(tmp_path):
    cm = CheckpointManager(str(tmp_path))
    cm.save(7, {"w": torch.zeros(2)})
    assert os.listdir(tmp_path) == ["step_00000007"]
    assert sorted(os.listdir(tmp_path / "step_00000007")) == ["manifest.json", "shards.npz"]


def test_checkpoint_train_state_and_device(tmp_path):
    """A model's state dict and its AdamState (int8 moments, the step as an
    int) round-trip; ``device`` places the leaves."""
    _, tc, _, model = _pair("gemma2-2b")
    ocfg = OptimizerConfig(moment_dtype="int8")
    opt = init_train_state(model, ocfg)
    step = make_train_step(lambda m, b: tf.lm_loss(m, tc, b, torch.float32), ocfg)
    step(model, opt, {k: torch.from_numpy(v) for k, v in _batch(tc.vocab_size).items()})
    tree = {"params": model.state_dict(), "opt": opt, "note": None}
    save_checkpoint(str(tmp_path), 1, tree)
    fresh = tf.init_lm(3, tc, device="cpu")[0]
    like = {"params": fresh.state_dict(), "opt": init_train_state(fresh, ocfg), "note": None}
    out = restore_checkpoint(str(tmp_path), 1, like, device="cpu")
    assert out["opt"].step == 1 and out["note"] is None
    assert all(torch.equal(out["params"][k], v) for k, v in model.state_dict().items())
    for a, b in zip(out["opt"].m, opt.m):
        assert torch.equal(a["q"], b["q"]) and torch.equal(a["scale"], b["scale"])


def test_checkpoint_crosses_packages_with_bf16(tmp_path):
    """A flat tree of fp32, int32 and bf16 arrays written by either package
    restores in the other, bit for bit."""
    rng = np.random.default_rng(0)
    f32 = rng.standard_normal((3, 5)).astype(np.float32)
    i32 = rng.integers(-9, 9, (7,)).astype(np.int32)
    bf = torch.from_numpy(rng.standard_normal((4, 2)).astype(np.float32)).to(torch.bfloat16)
    ours = {"w": torch.from_numpy(f32), "i": torch.from_numpy(i32), "h": bf}
    save_checkpoint(str(tmp_path / "port"), 5, ours)
    back = ref_restore(str(tmp_path / "port"), 5, {"w": jnp.zeros((3, 5)), "i": jnp.zeros(7, jnp.int32),
                                                   "h": jnp.zeros((4, 2), jnp.bfloat16)})
    assert np.array_equal(np.asarray(back["w"]), f32) and np.array_equal(np.asarray(back["i"]), i32)
    assert back["h"].dtype == jnp.bfloat16
    assert np.array_equal(np.asarray(back["h"]).view(np.int16), bf.view(torch.int16).numpy())

    ref_save(str(tmp_path / "ref"), 6, {"w": jnp.asarray(f32), "i": jnp.asarray(i32),
                                        "h": jnp.asarray(bf.float().numpy(), jnp.bfloat16)})
    got = restore_checkpoint(str(tmp_path / "ref"), 6, {k: torch.zeros(1) for k in ("w", "i", "h")})
    assert got["w"].dtype == torch.float32 and torch.equal(got["w"], ours["w"])
    assert got["i"].dtype == torch.int32 and torch.equal(got["i"], ours["i"])
    assert got["h"].dtype == torch.bfloat16 and torch.equal(got["h"], bf)


def test_kill_and_resume_is_bit_for_bit(tmp_path):
    """4 steps straight through, against 2 steps, a checkpoint at step 2, a
    fresh model and optimizer restored from it and run to step 4."""
    cfg = reduce_config(get_arch("gemma2-2b")[0])
    cell = steps.lm_cell(cfg, ShapeSpec(name="train", kind="train", seq_len=16, global_batch=2))
    batches = list(itertools.islice(
        lm_token_batches(vocab_size=cfg.vocab_size, batch=2, seq_len=16, seed=3), 4))
    tc = lambda n, d, every: TrainConfig(steps=n, checkpoint_dir=str(tmp_path / d),
                                         checkpoint_every=every, log_every=100)
    straight, opt_a, _ = train_loop(cell, tc(4, "a", 0), data_it=iter(batches), device="cpu")
    train_loop(cell, tc(2, "b", 2), data_it=iter(batches[:2]), device="cpu")
    assert latest_step(str(tmp_path / "b")) == 2
    resumed, opt_b, metrics = train_loop(cell, tc(4, "b", 2), data_it=iter(batches[2:]), device="cpu")
    assert opt_a.step == opt_b.step == 4 and np.isfinite(float(metrics["loss"]))
    for name, p in straight.state_dict().items():
        assert torch.equal(p, resumed.state_dict()[name]), name
    for a, b in zip(opt_a.m + opt_a.v, opt_b.m + opt_b.v):
        assert torch.equal(a, b)


def test_launcher_trains_and_resumes_on_the_cpu(tmp_path, capsys):
    """``python -m repro_torch.launch.train`` as a subprocess, then its main()
    again in this process, which resumes from the subprocess's checkpoint."""
    args = ["--arch", "gemma2-2b", "--reduced", "--device", "cpu", "--batch", "2", "--seq", "32",
            "--ckpt-dir", str(tmp_path), "--checkpoint-every", "2"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    first = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", *args, "--steps", "2"],
                           capture_output=True, text=True, env=env, timeout=120)
    assert first.returncode == 0, first.stderr
    assert "[train] step 0 loss" in first.stdout
    assert latest_step(str(tmp_path)) == 2
    train_main([*args, "--steps", "3", "--remat", "full"])
    out = capsys.readouterr().out
    assert "resumed from step 2" in out and "[train] step 0 loss" not in out
