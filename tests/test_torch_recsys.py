"""The port's recsys models (DLRM, FM, BST, MIND) against the reference, on
the CPU.

Reduced configs (``reduce_config``: every vocabulary capped at 1,000 rows);
the reference's parameters drawn with numpy over ``jax.eval_shape`` of its
``init_*`` and carried across by ``recsys_params_from_jax``; batches made
with numpy from a seed, ids of -1 and >= V among them.  Tolerances, and
why:
  * ``take`` and ``embedding_bag``: exact (gathers, and sums of at most 4
    rows in one order);
  * forward, retrieval and loss (fp32): atol 1e-5 / rtol 1e-4 — the same
    operations, float32 sums (matmuls, einsums, softmax) in other orders;
  * retrieval against the forward with the target swapped, in the port
    alone: rtol 1e-4 / atol 1e-5, the reference test's bound;
  * one AdamW step (eps 1e-3, as the LM train test): loss and grad norm
    rtol 1e-4, updated parameters atol 1e-4 (1% of the learning rate).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common.config import OptimizerConfig as RefOptConfig
from repro.configs import get_arch as ref_get_arch
from repro.configs import reduce_config as ref_reduce
from repro.models import recsys as ref_rec
from repro.train import init_train_state as ref_init_train
from repro.train import make_train_step as ref_make_step
from repro_torch.common.config import OptimizerConfig
from repro_torch.configs import get_arch, reduce_config
from repro_torch.models import recsys
from repro_torch.train import init_train_state, make_train_step

ARCHS = ["dlrm-mlperf", "fm", "bst", "mind"]
OPT = dict(lr=1e-2, warmup_steps=1, eps=1e-3)
TABLES = ("tables", "linear", "item_table", "pos_table")


def path_name(path) -> str:
    return ".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)


def numpy_params(spec, seed=0):
    """Numpy arrays over the reference's ShapeDtypeStructs, by leaf name:
    tables 0.1 N (larger than the init's 0.01, so interactions and
    attention are not flat), LayerNorm scales 1 + 0.1 N, biases, ``w0``
    and ``b_init`` 0.1 N, BST's ``wo`` N / sqrt(H * d/H), other weights
    N / sqrt(fan-in)."""
    rng = np.random.default_rng(seed)

    def mk(path, s):
        full = path_name(path)
        name = full.split(".")[-1]
        z = rng.standard_normal(s.shape)
        if full.split(".")[0] in TABLES:
            z = 0.1 * z
        elif name == "scale":
            z = 1.0 + 0.1 * z
        elif name in ("bias", "b", "w0", "b_init"):
            z = 0.1 * z
        elif name == "wo":
            z = z / np.sqrt(s.shape[0] * s.shape[1])
        else:
            z = z / np.sqrt(s.shape[0])
        return z.astype(s.dtype)

    return jax.tree_util.tree_map_with_path(mk, spec)


def _pair(arch):
    rc = ref_reduce(ref_get_arch(arch)[0])
    tc = reduce_config(get_arch(arch)[0])
    spec = jax.eval_shape(lambda k: ref_rec.INIT[arch](k, rc)[0], jax.random.key(0))
    params = numpy_params(spec)
    return rc, tc, params, recsys.recsys_params_from_jax(params, tc, device="cpu")


def _batch(cfg, b=12, seed=1):
    """A batch for ``cfg``; ids run from -1 to V + 3 (clamped by every lookup)."""
    rng = np.random.default_rng(seed)
    out = {"label": rng.integers(0, 2, b).astype(np.float32)}
    if cfg.name == "dlrm-mlperf":
        out["dense"] = rng.standard_normal((b, cfg.n_dense)).astype(np.float32)
    if cfg.name in ("dlrm-mlperf", "fm"):
        hi = np.asarray(cfg.vocab_sizes)[None, :] + 4
        out["sparse"] = (rng.integers(0, 2**30, (b, cfg.n_sparse)) % (hi + 1) - 1).astype(np.int32)
    else:
        v = cfg.vocab_sizes[0]
        out["hist"] = rng.integers(-1, v + 4, (b, cfg.hist_len)).astype(np.int32)
        out["target"] = rng.integers(-1, v + 4, b).astype(np.int32)
    return out


def _user(cfg, seed=2):
    b = _batch(cfg, b=1, seed=seed)
    return {k: v for k, v in b.items() if k not in ("label", "target")}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# ------------------------------------------------------------ lookups
def test_take_clamps_like_jnp_take_clip():
    table = np.random.default_rng(0).standard_normal((7, 3)).astype(np.float32)
    ids = np.array([[-5, -1, 0, 3], [6, 7, 10, 2**30]], np.int32)
    want = np.asarray(jnp.take(jnp.asarray(table), ids, axis=0, mode="clip"))
    got = recsys.take(torch.from_numpy(table), torch.from_numpy(ids)).numpy()
    assert np.array_equal(got, want)
    assert np.array_equal(got[0, 1], table[0]) and np.array_equal(got[1, 1], table[6])


@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_embedding_bag_matches_reference(mode):
    rng = np.random.default_rng(3)
    table = rng.standard_normal((20, 6)).astype(np.float32)
    idx = np.array([[1, 3, -1, -1], [0, -1, -1, -1], [-1, -1, -1, -1], [19, 20, 23, 5],
                    [2, 2, 2, 2]], np.int32)
    want = np.asarray(ref_rec.embedding_bag(jnp.asarray(table), jnp.asarray(idx), mode=mode))
    got = recsys.embedding_bag(torch.from_numpy(table), torch.from_numpy(idx), mode=mode).numpy()
    np.testing.assert_array_equal(got, want)
    # a pad masks its row; ids >= V clamp to the last row; an all-pad bag is 0
    np.testing.assert_allclose(got[3], (3 * table[19] + table[5]) / (4 if mode == "mean" else 1),
                               rtol=1e-6)
    assert not got[2].any()


# ------------------------------------------------------------ models
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_retrieval_and_loss_match_reference(arch):
    rc, tc, params, model = _pair(arch)
    batch, user = _batch(tc), _user(tc)
    v0 = tc.vocab_sizes[0]
    cands = np.concatenate([np.arange(-1, 40), [v0 - 1, v0, v0 + 3]]).astype(np.int32)
    ref = jax.jit(lambda p, b, u, c: (ref_rec.FORWARD[arch](p, rc, b), ref_rec.recsys_loss(p, rc, b),
                                      ref_rec.RETRIEVAL[arch](p, rc, u, c)))
    ref_fwd, ref_loss, ref_ret = ref(params, batch, user, cands)
    with torch.no_grad():
        fwd = recsys.FORWARD[arch](model, tc, _t(batch))
        loss = recsys.recsys_loss(model, tc, _t(batch))
        ret = recsys.RETRIEVAL[arch](model, tc, _t(user), torch.from_numpy(cands))
    assert fwd.shape == (12,) and ret.shape == (len(cands),)
    np.testing.assert_allclose(fwd.numpy(), np.asarray(ref_fwd), atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(float(loss), float(ref_loss), atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(ret.numpy(), np.asarray(ref_ret), atol=1e-5, rtol=1e-4)
    assert np.ptp(fwd.numpy()) > 1e-3  # the scores are not flat


@pytest.mark.parametrize("arch", ARCHS)
def test_retrieval_equals_forward_with_the_target_swapped(arch):
    """The reference's factorized-retrieval tests, for all four models."""
    _, tc, _, model = _pair(arch)
    user = _user(tc, seed=4)
    cands = np.arange(-1, 30, dtype=np.int32)
    with torch.no_grad():
        fast = recsys.RETRIEVAL[arch](model, tc, _t(user), torch.from_numpy(cands)).numpy()
        rows = {k: np.repeat(v, len(cands), 0) for k, v in user.items()}
        if "sparse" in rows:
            rows["sparse"][:, 0] = cands
        else:
            rows["target"] = cands
        slow = recsys.FORWARD[arch](model, tc, _t(rows)).numpy()
    np.testing.assert_allclose(fast, slow, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch):
    rc, tc, params, model = _pair(arch)
    batch = _batch(tc, b=16, seed=5)
    ref_step = jax.jit(ref_make_step(lambda p, b: ref_rec.recsys_loss(p, rc, b),
                                     RefOptConfig(**OPT)))
    new_p, _, ref_m = ref_step(params, ref_init_train(params, RefOptConfig(**OPT)), batch)
    ocfg = OptimizerConfig(**OPT)
    before = {n: p.detach().clone() for n, p in model.state_dict().items()}
    step = make_train_step(lambda m, b: recsys.recsys_loss(m, tc, b), ocfg)
    metrics = step(model, init_train_state(model, ocfg), _t(batch))
    np.testing.assert_allclose(float(metrics["loss"]), float(ref_m["loss"]), rtol=1e-4)
    np.testing.assert_allclose(float(metrics["grad_norm"]), float(ref_m["grad_norm"]), rtol=1e-4)
    moved = recsys.recsys_params_from_jax(jax.tree.map(np.asarray, new_p), tc,
                                          device="cpu").state_dict()
    assert moved.keys() == model.state_dict().keys()
    for name, p in model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), moved[name].numpy(), atol=1e-4, err_msg=name)
    assert max(float((model.state_dict()[n] - before[n]).abs().max()) for n in before) > 5e-3


@pytest.mark.parametrize("arch", ARCHS)
def test_init_structure_and_axes_equal_reference(arch):
    """init_*'s state-dict names, shapes and axes: the reference's tree
    paths, one for one (tables as lists, BST's attention layouts, FM's 0-d
    ``w0``), drawn on the generator's device at the reference's scales."""
    rc = ref_reduce(ref_get_arch(arch)[0])
    tc = reduce_config(get_arch(arch)[0])
    box = {}

    def init(k):
        p, box["axes"] = ref_rec.INIT[arch](k, rc)
        return p

    spec = jax.eval_shape(init, jax.random.key(0))
    model, axes = recsys.INIT[arch](0, tc, device="cpu")
    want = {path_name(p): leaf for p, leaf in jax.tree_util.tree_leaves_with_path(spec)}
    got = dict(model.named_parameters())
    assert list(got) == list(axes) and set(got) == set(want)
    for n, leaf in want.items():
        assert tuple(got[n].shape) == leaf.shape, n
    is_ax = lambda x: isinstance(x, tuple) and all(isinstance(a, (str, type(None))) for a in x)
    assert axes == {path_name(p): tuple(a) for p, a in
                    jax.tree_util.tree_leaves_with_path(box["axes"], is_leaf=is_ax)}
    table = got["tables.0" if "tables.0" in got else "item_table"].detach()
    assert 0.005 < float(table.std()) < 0.02  # normal x 0.01
    again = recsys.INIT[arch](0, tc, device="cpu")[0].state_dict()
    assert all(torch.equal(p, again[n]) for n, p in model.state_dict().items())
