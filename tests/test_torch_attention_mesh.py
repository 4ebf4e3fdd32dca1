"""Attention's core split over a (data 2, model 2) mesh as the reference
shards its scores (``models/attention.py``: ``_score_layout``, ``_attend``,
``common/sharding.py:local_blocks``), on the CPU.

The reference constrains the (B, H, Sq, Sk) fp32 scores to ``("batch",
"heads", "seq_sharded", None)`` (``("batch", None, "seq_sharded", None)``
in ``attn_shard="seq"`` mode), so ``model`` splits the heads where it
divides them and the query positions where it does not.  One gloo world
of 4 ranks runs every case once (a module-scoped fixture) and the one
process port beside it; one JAX subprocess runs the reference's
``gqa_attention`` / ``mla_attention`` on the same numpy inputs and the
per-device score shape its ``spec_for_shape`` gives on a (2, 2) mesh.
Each case checks, within 1e-5 + 1e-4 relative (fp32):
  * the output (and the caches) against the one-process port and the
    reference;
  * the gradients of x and of every weight of the mean of y * cot (a
    mean over the tokens, as the LM's loss is) against the one-process
    port (the calls that run with gradients: every call that reads no cache it
    wrote; a cache written on a mesh carries no gradient, as serving runs
    under ``no_grad``);
  * every rank's score block (the fp32 softmax's shape, below DTensor,
    and the largest fp32 product) against the reference's per-device
    shape.
"""
import json
import os
import subprocess
import sys
import traceback

import numpy as np
import pytest
import torch

ROOT = os.path.join(os.path.dirname(__file__), "..")
SRC = os.path.join(ROOT, "src")
WORLD = 4
ATOL, RTOL = 1e-5, 1e-4
B, S = 4, 32  # 2 rows a data block; S above every head width, so the
# scores are each call's largest fp32 product
MESH = ((2, 2), ("data", "model"))

# case -> arch, config overrides, window, cache slots (None: no cache)
CASES = {
    # MQA: each model rank 2 of the 4 q heads, both reading the one kv head
    "gqa_heads": ("gemma2-2b", dict(n_heads=4, n_kv_heads=1, attn_softcap=None), None, None),
    # 3 heads do not split 2 ways: the query positions do
    "gqa_query_positions": ("gemma2-2b", dict(n_heads=3, n_kv_heads=1, attn_softcap=None),
                            None, None),
    "attn_shard_seq": ("phi4-mini-3.8b", dict(n_heads=4, n_kv_heads=2), None, None),
    "window_softcap": ("gemma2-2b", dict(n_heads=4, n_kv_heads=2, window_size=24,
                                         attn_softcap=50.0), 24, None),
    # a local layer's prefill into a 24-slot ring, then a decode step
    "ring_prefill_decode": ("gemma2-2b", dict(n_heads=4, n_kv_heads=2, window_size=24,
                                              attn_softcap=50.0), 24, 24),
    "mla": ("deepseek-v3-671b", {}, None, None),  # with the q low-rank path
    "mla_cache": ("deepseek-v2-lite-16b", {}, None, S + 8),
}
# 6 q heads over 2 ranks read kv heads {0, 1} and {1, 2} of 3: no even split
UNEVEN = ("gemma2-2b", dict(n_heads=6, n_kv_heads=3, attn_softcap=None))
META = torch.device("meta")
CACHE_NAMES = ("prefill_k", "prefill_v", "decode_k", "decode_v")


def _cfg(pkg: str, arch: str, over: dict):
    mod = __import__(f"{pkg}.configs", fromlist=["get_arch", "reduce_config"])
    return mod.reduce_config(mod.get_arch(arch)[0]).replace(**over)


def _flat(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def _calls(case: str) -> list[tuple[str, int, int]]:
    """(name, Sq, Sk) of each call of a case."""
    arch, over, window, slots = CASES[case]
    if slots is None:
        return [("fwd", S, S)]
    return [("prefill", S, S if window else slots), ("decode", 1, slots)]


def _cache_shapes(cfg, slots: int) -> tuple:
    if cfg.use_mla:
        return (B, slots, cfg.kv_lora_rank), (B, slots, cfg.qk_rope_head_dim)
    return ((B, slots, cfg.n_kv_heads, cfg.resolved_head_dim),) * 2


def _inputs() -> dict:
    """Weights (rmsnorm scales nonzero), x, the decode token's x and the
    cotangents of each case, from one seed."""
    from repro_torch.models import attention as attn

    rng = np.random.default_rng(0)
    out = {}
    for case, (arch, over, _, _) in {**CASES, "uneven": (*UNEVEN, None, None)}.items():
        cfg = _cfg("repro_torch", arch, over)
        params, _ = (attn.init_mla if cfg.use_mla else attn.init_gqa)(None, cfg, device=META)
        for name, p in _flat(params).items():
            scale = 0.3 if name.endswith("scale") else 1.0 / np.sqrt(p.shape[0])
            out[f"{case}/w/{name}"] = (rng.standard_normal(tuple(p.shape)) * scale).astype(np.float32)
        d = cfg.d_model
        out[f"{case}/x"] = rng.standard_normal((B, S, d)).astype(np.float32)
        out[f"{case}/x1"] = rng.standard_normal((B, 1, d)).astype(np.float32)
        out[f"{case}/cot"] = rng.standard_normal((B, S, d)).astype(np.float32)
    return out


# ------------------------------------------------------------ the world
def _score_recorder():
    """A dispatch mode below DTensor recording each fp32 softmax's shape
    and the largest fp32 batched product's element count (a rank's score
    block: the einsums run on local tensors)."""
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode

    class Scores(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.softmax: list[list[int]] = []
            self.largest = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if any(issubclass(t, DTensor) for t in types):
                return NotImplemented
            out = func(*args, **(kwargs or {}))
            if isinstance(out, torch.Tensor) and out.dtype == torch.float32:
                if func is torch.ops.aten._softmax.default:
                    self.softmax.append(list(out.shape))
                elif func is torch.ops.aten.bmm.default:
                    self.largest = max(self.largest, out.numel())
            return out

    return Scores()


def _run(case: str, t: dict, mesh=None) -> dict:
    """One case through the port: on ``mesh`` (DTensor weights, x, caches
    and the decode position, laid out by their logical axes) or in one
    process -> outputs, gradients and caches as numpy, and on a mesh the
    score blocks this rank computed."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.common.sharding import mesh_context, sharding_for_shape
    from repro_torch.launch.steps import _cache_axes
    from repro_torch.models import attention as attn

    arch, over, window, slots = CASES[case]
    cfg = _cfg("repro_torch", arch, over)
    fn = attn.mla_attention if cfg.use_mla else attn.gqa_attention
    _, axes = (attn.init_mla if cfg.use_mla else attn.init_gqa)(None, cfg, device=META)
    axes = _flat(axes)

    def place(x, ax):
        if mesh is None:
            return x.clone()
        return distribute_tensor(x, mesh, sharding_for_shape(ax, tuple(x.shape), mesh))

    def whole(x):
        # a copy: the caches are written in place by the next call
        return (x.full_tensor() if mesh is not None else x).detach().numpy().copy()

    flat = {n: place(t[f"{case}/w/{n}"], axes[n]).requires_grad_() for n in axes}
    params: dict = {}
    for n, p in flat.items():
        head, _, leaf = n.rpartition(".")
        (params.setdefault(head, {}) if head else params)[leaf] = p
    x = place(t[f"{case}/x"], ("batch", None, None)).requires_grad_()
    rec = _score_recorder() if mesh is not None else None
    res: dict = {"blocks": [], "largest": []}
    ctx = mesh_context(mesh) if mesh is not None else torch.enable_grad()

    def call(*a, grad: bool, **k):
        with torch.set_grad_enabled(grad):
            if rec is None:
                return fn(params, cfg, *a, window=window, **k)
            rec.softmax, rec.largest = [], 0
            with rec:
                y = fn(params, cfg, *a, window=window, **k)
            res["blocks"] += rec.softmax
            res["largest"].append(rec.largest)
            return y

    with ctx:
        if slots is None:
            y, _ = call(x, torch.arange(S, dtype=torch.int32)[None, :], grad=True)
            caches = []
        else:
            shapes = [torch.zeros(s) for s in _cache_shapes(cfg, slots)]
            axes_kv = _cache_axes(cfg, [attn.KVCache(*shapes)])[0]
            kv = attn.KVCache(*(place(z, ax) for z, ax in zip(shapes, axes_kv)))
            pos = torch.arange(S, dtype=torch.int32)[None, :].expand(B, S)
            # the ring prefill reads no cache: its gradients are defined
            y, kv = call(x, pos, cache=kv, grad=window is not None)
            caches = [whole(kv.k), whole(kv.v)]
            x1 = place(t[f"{case}/x1"], ("batch", None, None))
            p1 = place(torch.full((B, 1), S, dtype=torch.int32), ("batch", None))
            y1, kv = call(x1, p1, cache=kv, grad=False)
            res["y1"] = whole(y1)
            caches += [whole(kv.k), whole(kv.v)]
        res["y"], res["caches"] = whole(y), caches
        if y.requires_grad:
            # a mean over the tokens, as the LM's cross entropy is
            (y * place(t[f"{case}/cot"], ("batch", None, None))).mean().backward()
            res["grads"] = {"x": whole(x.grad), **{n: whole(p.grad) for n, p in flat.items()}}
    return res


def _uneven(t: dict, mesh) -> str:
    """The uneven kv split on the mesh -> the error it raises."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.common.sharding import mesh_context, sharding_for_shape
    from repro_torch.models import attention as attn

    cfg = _cfg("repro_torch", *UNEVEN)
    _, axes = attn.init_gqa(None, cfg, device=META)
    params = {n: distribute_tensor(t[f"uneven/w/{n}"], mesh,
                                   sharding_for_shape(axes[n], t[f"uneven/w/{n}"].shape, mesh))
              for n in axes}
    x = distribute_tensor(t["uneven/x"], mesh,
                          sharding_for_shape(("batch", None, None), (B, S, cfg.d_model), mesh))
    try:
        with mesh_context(mesh):
            attn.gqa_attention(params, cfg, x, torch.arange(S, dtype=torch.int32)[None, :])
    except ValueError as e:
        return str(e)
    return "no error"


def _world(rank: int, world: int, inputs: str, out_dir: str) -> None:
    from repro_torch.common.sharding import concrete_mesh

    torch.set_num_threads(1)
    t = {k: torch.from_numpy(v) for k, v in np.load(inputs).items()}
    mesh = concrete_mesh(*MESH, device_type="cpu")
    res: dict = {}
    for case in CASES:
        try:
            res[case] = {"mesh": _run(case, t, mesh)}
            if rank == 0:
                res[case]["one"] = _run(case, t)
        except Exception:
            res[case] = traceback.format_exc()
    res["uneven"] = _uneven(t, mesh)
    torch.save(res, os.path.join(out_dir, f"world{rank}.pt"))


# ------------------------------------------------------------ the reference
REF = r"""
import json, sys
import numpy as np, jax, jax.numpy as jnp
from repro.common.sharding import abstract_mesh, spec_for_shape
from repro.configs import get_arch, reduce_config
from repro.models import attention as A
d = dict(np.load(sys.argv[1] + "/inputs.npz"))
spec = json.load(open(sys.argv[1] + "/cases.json"))
mesh = abstract_mesh(*spec["mesh"])
out, shares = {}, {}
def unflat(case):
    tree = {}
    for k, v in d.items():
        if k.startswith(case + "/w/"):
            *outer, leaf = k[len(case) + 3:].split(".")
            (tree.setdefault(outer[0], {}) if outer else tree)[leaf] = jnp.asarray(v)
    return tree
for case, (arch, over, window, slots) in spec["cases"].items():
    cfg = reduce_config(get_arch(arch)[0]).replace(**over)
    fn = A.mla_attention if cfg.use_mla else A.gqa_attention
    kw = {} if cfg.use_mla else {"window": window}
    p, b, s = unflat(case), spec["B"], spec["S"]
    x = jnp.asarray(d[case + "/x"])
    if slots is None:
        y, _ = fn(p, cfg, x, jnp.arange(s, dtype=jnp.int32)[None, :], **kw)
    else:
        if cfg.use_mla:
            shp = ((b, slots, cfg.kv_lora_rank), (b, slots, cfg.qk_rope_head_dim))
        else:
            shp = ((b, slots, cfg.n_kv_heads, cfg.resolved_head_dim),) * 2
        kv = A.KVCache(*(jnp.zeros(z, jnp.float32) for z in shp))
        pos = jnp.broadcast_to(jnp.arange(s, dtype=jnp.int32)[None, :], (b, s))
        y, kv = fn(p, cfg, x, pos, cache=kv, **kw)
        out[case + "/prefill_k"], out[case + "/prefill_v"] = kv.k, kv.v
        y1, kv = fn(p, cfg, jnp.asarray(d[case + "/x1"]), jnp.full((b, 1), s, jnp.int32),
                    cache=kv, **kw)
        out[case + "/y1"], out[case + "/decode_k"], out[case + "/decode_v"] = y1, kv.k, kv.v
    out[case + "/y"] = y
    # the reference's constraint on its scores (attention.py:153-156, :277)
    axes = (("batch", None, "seq_sharded", None) if cfg.attn_shard == "seq" and not cfg.use_mla
            else ("batch", "heads", "seq_sharded", None))
    shares[case] = []
    for name, sq, sk in spec["calls"][case]:
        shape = (b, cfg.n_heads, sq, sk)
        sp = spec_for_shape(axes, shape, mesh)
        shares[case].append([n // int(np.prod([mesh.shape[a] for a in
                                                ((e,) if isinstance(e, str) else e)]))
                             if e is not None else n for n, e in zip(shape, tuple(sp))])
np.savez(sys.argv[1] + "/ref.npz", **{k: np.asarray(v) for k, v in out.items()})
json.dump(shares, open(sys.argv[1] + "/shares.json", "w"))
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from repro_torch.distributed.comm import run_world

    d = tmp_path_factory.mktemp("torch_attention_mesh")
    np.savez(d / "inputs.npz", **_inputs())
    with open(d / "cases.json", "w") as f:
        json.dump({"cases": CASES, "calls": {c: _calls(c) for c in CASES}, "B": B, "S": S,
                   "mesh": MESH}, f)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    ref = subprocess.Popen([sys.executable, "-c", REF, str(d)], env=env, text=True,
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    try:
        run_world(_world, WORLD, str(d / "inputs.npz"), str(d), backend="gloo", timeout_s=300.0)
    finally:
        out, err = ref.communicate(timeout=300)
    assert ref.returncode == 0, f"reference:\n{out}\n{err}"
    worlds = [torch.load(d / f"world{r}.pt", weights_only=False) for r in range(WORLD)]
    with open(d / "shares.json") as f:
        shares = json.load(f)
    return worlds, dict(np.load(d / "ref.npz")), shares


def _close(a, b, what):
    np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL, err_msg=what)


@pytest.mark.parametrize("case", list(CASES))
def test_mesh_attention_equals_one_process_and_reference(runs, case):
    """Output, caches and gradients on the (2, 2) mesh equal the one-process
    port's, the outputs and caches the reference's; each rank's score
    block is the reference's per-device share, call by call."""
    worlds, ref, shares = runs
    for r, w in enumerate(worlds):
        if isinstance(w[case], str):
            pytest.fail(f"rank {r} raised:\n{w[case]}")
    mesh, one = worlds[0][case]["mesh"], worlds[0][case]["one"]
    _close(mesh["y"], one["y"], "output vs one process")
    _close(mesh["y"], ref[f"{case}/y"], "output vs the reference")
    if "y1" in one:
        _close(mesh["y1"], one["y1"], "decode output vs one process")
        _close(mesh["y1"], ref[f"{case}/y1"], "decode output vs the reference")
        for got, want, name in zip(mesh["caches"], one["caches"], CACHE_NAMES):
            _close(got, want, f"{name} cache vs one process")
            _close(got, ref[f"{case}/{name}"], f"{name} cache vs the reference")
    has_grads = CASES[case][3] is None or CASES[case][2] is not None
    assert ("grads" in one) == ("grads" in mesh) == has_grads
    for name, g in one.get("grads", {}).items():
        assert np.abs(g).max() > 0, name
        _close(mesh["grads"][name], g, f"gradient of {name}")
    for r, w in enumerate(worlds):
        blocks = w[case]["mesh"]["blocks"]
        assert blocks == shares[case], (r, blocks, shares[case])
        assert w[case]["mesh"]["largest"] == [int(np.prod(s)) for s in shares[case]], r


def test_heads_and_query_positions_split_where_the_reference_splits(runs):
    """The layouts the cases were chosen for: heads split 2 ways (1/2 of
    the heads a rank) where 2 divides them, query positions where it does
    not, and a decode step's one query split by heads."""
    _, _, shares = runs
    assert shares["gqa_heads"] == [[2, 2, S, S]]
    assert shares["gqa_query_positions"] == [[2, 3, S // 2, S]]
    assert shares["attn_shard_seq"] == [[2, 4, S // 2, S]]
    assert shares["ring_prefill_decode"] == [[2, 2, S, S], [2, 2, 1, 24]]
    assert shares["mla_cache"] == [[2, 2, S, S + 8], [2, 2, 1, S + 8]]


def test_uneven_kv_split_raises(runs):
    """No fallback: q heads whose kv heads split neither in blocks nor one
    a rank (6 q heads, 3 kv heads, 2 ranks) raise instead of gathering."""
    worlds, _, _ = runs
    for w in worlds:
        assert "splits 2 ways" in w["uneven"], w["uneven"]


def test_a_block_that_is_not_the_share_raises():
    from repro_torch.models.attention import _own_share

    block = torch.empty(2, 4, 8, 8)
    assert _own_share(block, (2, 4, 8, 8)) is block
    assert _own_share(block, None) is block
    with pytest.raises(RuntimeError, match="not this rank's share"):
        _own_share(block, (2, 2, 8, 8))
