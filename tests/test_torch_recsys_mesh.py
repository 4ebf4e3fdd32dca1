"""Row-sharded lookups on a (data 2, model 2) mesh (``common/sharding.py``:
``take_rows``, ``_BlockRows``) and BST's and MIND's retrieval split over
``model`` as the reference splits its candidates (``models/recsys.py``),
on the CPU.

The candidates and the item tables' rows are both split over ``model``:
``take_rows`` keeps the candidates split (each rank gets its own ids'
rows), and BST encodes, MIND scores, only its rank's candidates.  One gloo
world of 4 ranks runs every case once (a module-scoped fixture) and the
one-process port beside it; one JAX subprocess runs the reference's
``RETRIEVAL`` and ``lax.top_k`` on the same numpy weights and inputs, made
from a seed.  Reduced BST and MIND, 512 candidates (256 a model rank).
Each case checks, in fp32:
  * retrieval scores within 1e-5 + 1e-4 relative of the one-process port
    and of the reference, and the top-100 ids equal (planted ties go to
    the lower index);
  * MIND's train loss and every gradient within 1e-5 of each leaf's
    largest element against one process (the table's gradient is summed
    in another order: equal within fp32 rounding, not bit for bit);
  * every rank's BST score block is (C/2, H, 21, 21), recorded below
    DTensor, and the largest fp32 tensor a rank makes is that block;
  * the lookups' backward makes no tensor of the whole batch's (B, L, D)
    rows;
  * a table whose rows split unevenly (``torch.chunk``'s 4 + 3 rows)
    equals one process for every ids layout ``take_rows`` takes, and the
    layouts it cannot split raise.
"""
import os
import subprocess
import sys
import traceback
from contextlib import nullcontext

import numpy as np
import pytest
import torch

ROOT = os.path.join(os.path.dirname(__file__), "..")
SRC = os.path.join(ROOT, "src")
WORLD = 4
MESH = ((2, 2), ("data", "model"))
ATOL, RTOL = 1e-5, 1e-4
C, B = 512, 8  # candidates (256 a model rank); MIND's train batch (4 a data rank)
ARCHS = ("bst", "mind")
TIES = ((3, 200), (7, 300), (11, 12), (40, 480), (100, 101), (130, 260))  # equal candidates
META = torch.device("meta")


# {"ffn.0.w": x} -> {"ffn": [{"w": x}]}: state-dict names to the pytree
# both packages' params take (the reference's subprocess runs it too)
UNFLAT = r"""
def unflat(flat):
    tree = {}
    for name, v in flat.items():
        *outer, leaf = name.split(".")
        node = tree
        for k in outer:
            node = node.setdefault(k, {})
        node[leaf] = v

    def lists(x):
        if not isinstance(x, dict):
            return x
        x = {k: lists(y) for k, y in x.items()}
        return [x[str(i)] for i in range(len(x))] if all(k.isdigit() for k in x) else x

    return lists(tree)
"""
exec(UNFLAT)


def _cfg(pkg: str, arch: str):
    mod = __import__(f"{pkg}.configs", fromlist=["get_arch", "reduce_config"])
    return mod.reduce_config(mod.get_arch(arch)[0])


def _inputs() -> dict:
    """Weights (layernorm scales near 1), one history, the candidates with
    planted duplicates, and MIND's train batch, from one seed."""
    from repro_torch.models import recsys

    rng = np.random.default_rng(0)
    out = {}
    for arch in ARCHS:
        cfg = _cfg("repro_torch", arch)
        model, _ = recsys.INIT[arch](None, cfg, device=META)
        for name, p in model.named_parameters():
            if name.endswith("scale"):
                w = 1.0 + 0.1 * rng.standard_normal(tuple(p.shape))
            elif name == "item_table":
                w = rng.standard_normal(tuple(p.shape))
            else:
                w = rng.standard_normal(tuple(p.shape)) / np.sqrt(p.shape[0])
            out[f"{arch}/w/{name}"] = w.astype(np.float32)
        v = cfg.vocab_sizes[0]
        out[f"{arch}/hist"] = rng.integers(0, v, (1, cfg.hist_len)).astype(np.int32)
        cands = rng.permutation(v)[:C].astype(np.int32)
        for a, b in TIES:
            cands[b] = cands[a]
        out[f"{arch}/candidates"] = cands
    cfg = _cfg("repro_torch", "mind")
    v = cfg.vocab_sizes[0]
    out["train/hist"] = rng.integers(0, v, (B, cfg.hist_len)).astype(np.int32)
    out["train/target"] = rng.integers(0, v, (B,)).astype(np.int32)
    out["train/label"] = rng.integers(0, 2, (B,)).astype(np.float32)
    # the uneven table: 7 rows split 4 + 3 over model
    out["uneven/table"] = rng.standard_normal((7, 3)).astype(np.float32)
    out["uneven/ids"] = rng.integers(0, 7, (8, 2)).astype(np.int64)
    out["uneven/cot"] = rng.standard_normal((8, 2, 3)).astype(np.float32)
    return out


# ------------------------------------------------------------ the world
def _recorder():
    """A dispatch mode below DTensor recording each fp32 softmax's shape,
    the largest fp32 tensor an op returns and every shape it returns (not
    the fake tensors of global shape that DTensor's sharding propagation
    makes to infer an op's output)."""
    from torch._subclasses.fake_tensor import FakeTensor
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode

    class Record(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.softmax: list[list[int]] = []
            self.largest = 0
            self.shapes: set[tuple] = set()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if any(issubclass(t, DTensor) for t in types):
                return NotImplemented
            out = func(*args, **(kwargs or {}))
            for t in (out if isinstance(out, (list, tuple)) else (out,)):
                if isinstance(t, torch.Tensor) and not isinstance(t, FakeTensor):
                    self.shapes.add(tuple(t.shape))
                    if t.dtype == torch.float32:
                        self.largest = max(self.largest, t.numel())
            if func is torch.ops.aten._softmax.default and not isinstance(out, FakeTensor):
                self.softmax.append(list(out.shape))
            return out

    return Record()


def _model(arch: str, t: dict, mesh=None):
    """The port's model from the numpy weights (laid out on ``mesh``)."""
    from repro_torch.common.sharding import shard_module
    from repro_torch.models import recsys

    cfg = _cfg("repro_torch", arch)
    _, axes = recsys.INIT[arch](None, cfg, device=META)
    model = recsys.recsys_params_from_jax(
        unflat({n: t[f"{arch}/w/{n}"].numpy() for n in axes}), cfg, device="cpu")
    if mesh is not None:
        shard_module(model, axes, mesh)
    return cfg, model


def _place(x: torch.Tensor, axes: tuple, mesh):
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.common.sharding import sharding_for_shape

    if mesh is None:
        return x.clone()
    return distribute_tensor(x, mesh, sharding_for_shape(axes, tuple(x.shape), mesh))


def _pl(placements) -> list[str]:
    """Placements as "R", "P" or "S<dim>" (their str varies across torch versions)."""
    return ["R" if p.is_replicate() else f"S{p.dim}" if p.is_shard() else "P" for p in placements]


def _whole(x) -> np.ndarray:
    from repro_torch.common.sharding import is_dtensor

    return (x.full_tensor() if is_dtensor(x) else x).detach().numpy().copy()


def _retrieval(arch: str, t: dict, mesh=None) -> dict:
    """Scores and the cell's top-100 (its step), on ``mesh`` or in one
    process; on a mesh the score blocks and largest fp32 tensor a rank made."""
    from repro_torch.common.config import ShapeSpec
    from repro_torch.common.sharding import mesh_context
    from repro_torch.launch.steps import recsys_cell
    from repro_torch.models import recsys

    cfg, model = _model(arch, t, mesh)
    batch = {"hist": _place(t[f"{arch}/hist"], ("batch", None), mesh)}
    cands = _place(t[f"{arch}/candidates"], ("candidates",), mesh)
    cell = recsys_cell(cfg, ShapeSpec(name="r", kind="retrieval", global_batch=1,
                                      n_candidates=C))
    rec = _recorder()
    res = {}
    with torch.no_grad(), mesh_context(mesh) if mesh is not None else nullcontext():
        with rec:
            scores = recsys.RETRIEVAL[arch](model, cfg, batch, cands)
        vals, idx = cell.step(model, {**batch, "candidates": cands})
    res["scores"], res["top_vals"], res["top_ids"] = _whole(scores), _whole(vals), _whole(idx)
    res["softmax"], res["largest"] = rec.softmax, rec.largest
    if mesh is not None:
        res["placements"] = _pl(scores.placements)
    return res


def _mind_train(t: dict, mesh=None) -> dict:
    """MIND's train loss and the gradient of every parameter; on a mesh the
    shapes its backward made below DTensor."""
    from repro_torch.common.sharding import mesh_context
    from repro_torch.models import recsys

    cfg, model = _model("mind", t, mesh)
    batch = {k: _place(t[f"train/{k}"], ("batch", None) if k == "hist" else ("batch",), mesh)
             for k in ("hist", "target", "label")}
    rec = _recorder()
    with mesh_context(mesh) if mesh is not None else nullcontext():
        loss = recsys.recsys_loss(model, cfg, batch)
        with rec:
            loss.backward()
    return {"loss": float(_whole(loss)),
            "grads": {n: _whole(p.grad) for n, p in model.named_parameters()},
            "shapes": sorted(rec.shapes)}


def _uneven(t: dict, mesh) -> dict:
    """``take_rows`` of the 7-row table split 4 + 3 over model, for each
    ids layout it takes -> (rows, the table's gradient) as numpy, and the
    errors of the layouts it cannot split."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.common.sharding import sharding_for_shape, take_rows

    table0, ids0, cot0 = t["uneven/table"], t["uneven/ids"], t["uneven/cot"]
    layouts = {  # ids placements over (data, model)
        "whole": None,
        "data": (Shard(0), Replicate()),
        "model": (Replicate(), Shard(0)),
        "data_model": (Shard(0), Shard(0)),
        "data_dim1": (Shard(1), Replicate()),
    }
    out: dict = {}
    for name, pl in layouts.items():
        table = distribute_tensor(table0, mesh, sharding_for_shape(("table_vocab", None),
                                                                   (7, 3), mesh))
        table.requires_grad_()
        ids = ids0 if pl is None else distribute_tensor(ids0, mesh, pl)
        rows = take_rows(table, ids)
        cot = distribute_tensor(cot0, mesh, (Replicate(), Replicate()))
        (rows * cot).sum().backward()
        out[name] = (_whole(rows), _whole(table.grad), _pl(table.placements))
    errors = {}
    for name, ids, pl in (("ids_split_on_dim1", ids0, (Replicate(), Shard(1))),
                          ("uneven_ids", ids0[:7], (Replicate(), Shard(0)))):
        table = distribute_tensor(table0, mesh, sharding_for_shape(("table_vocab", None),
                                                                   (7, 3), mesh))
        try:
            take_rows(table, distribute_tensor(ids, mesh, pl))
            errors[name] = "no error"
        except ValueError as e:
            errors[name] = str(e)
    out["errors"] = errors
    return out


def _world(rank: int, world: int, inputs: str, out_dir: str) -> None:
    from repro_torch.common.sharding import concrete_mesh

    torch.set_num_threads(1)
    t = {k: torch.from_numpy(v) for k, v in np.load(inputs).items()}
    mesh = concrete_mesh(*MESH, device_type="cpu")
    cases = {f"{a}_retrieval": (lambda a=a, m=None: _retrieval(a, t, m)) for a in ARCHS}
    cases["mind_train"] = lambda m=None: _mind_train(t, m)
    res: dict = {}
    for case, fn in cases.items():
        try:
            res[case] = {"mesh": fn(m=mesh)}
            if rank == 0:
                res[case]["one"] = fn()
        except Exception:
            res[case] = traceback.format_exc()
    try:
        res["uneven"] = _uneven(t, mesh)
    except Exception:
        res["uneven"] = traceback.format_exc()
    torch.save(res, os.path.join(out_dir, f"world{rank}.pt"))


# ------------------------------------------------------------ the reference
REF = UNFLAT + r"""
import sys
import numpy as np, jax, jax.numpy as jnp
from repro.configs import get_arch, reduce_config
from repro.models import recsys as R
d = dict(np.load(sys.argv[1] + "/inputs.npz"))
out = {}
for arch in ("bst", "mind"):
    cfg = reduce_config(get_arch(arch)[0])
    w = {k[len(arch) + 3:]: jnp.asarray(v) for k, v in d.items() if k.startswith(arch + "/w/")}
    scores = R.RETRIEVAL[arch](unflat(w), cfg, {"hist": jnp.asarray(d[arch + "/hist"])},
                               jnp.asarray(d[arch + "/candidates"]))
    vals, idx = jax.lax.top_k(scores, 100)
    out[arch + "/scores"], out[arch + "/top_ids"] = scores, idx
np.savez(sys.argv[1] + "/ref.npz", **{k: np.asarray(v) for k, v in out.items()})
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from repro_torch.distributed.comm import run_world

    d = tmp_path_factory.mktemp("torch_recsys_mesh")
    np.savez(d / "inputs.npz", **_inputs())
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
    return worlds, dict(np.load(d / "ref.npz"))


def _ok(worlds, case):
    for r, w in enumerate(worlds):
        if isinstance(w[case], str):
            pytest.fail(f"rank {r} raised:\n{w[case]}")


def _close(a, b, what):
    np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL, err_msg=what)


@pytest.mark.parametrize("arch", ARCHS)
def test_retrieval_on_the_mesh_equals_one_process_and_reference(runs, arch):
    """Scores on the (2, 2) mesh equal the one-process port's and the
    reference's; the top-100 ids are the same on every rank, in one
    process and in the reference, and each planted tie in them lists the
    lower index first."""
    worlds, ref = runs
    case = f"{arch}_retrieval"
    _ok(worlds, case)
    one = worlds[0][case]["one"]
    _close(one["scores"], ref[f"{arch}/scores"], "one process vs the reference")
    for r, w in enumerate(worlds):
        mesh = w[case]["mesh"]
        _close(mesh["scores"], one["scores"], f"rank {r}: mesh vs one process")
        _close(mesh["scores"], ref[f"{arch}/scores"], f"rank {r}: mesh vs the reference")
        np.testing.assert_array_equal(mesh["top_ids"], one["top_ids"], f"rank {r}")
    np.testing.assert_array_equal(one["top_ids"], ref[f"{arch}/top_ids"])
    top = list(one["top_ids"])
    planted = [(a, b) for a, b in TIES if a in top and b in top]
    assert planted, "no planted tie reached the top 100"
    for a, b in planted:
        assert one["scores"][a] == one["scores"][b]
        assert top.index(a) + 1 == top.index(b), (a, b, top)


@pytest.mark.parametrize("arch", ARCHS)
def test_scores_stay_split_over_model(runs, arch):
    """Each rank's scores are its model block's candidates' (laid out
    Shard(0) over model, replicated over data), not a sum over every
    candidate."""
    worlds, _ = runs
    _ok(worlds, f"{arch}_retrieval")
    for w in worlds:
        assert w[f"{arch}_retrieval"]["mesh"]["placements"] == ["R", "S0"]


def test_bst_score_block_is_the_ranks_share(runs):
    """Every rank's BST softmax is its (C/2, H, 21, 21) block of the fp32
    scores, and nothing it makes is larger; in one process the block is
    the whole (C, H, 21, 21)."""
    worlds, _ = runs
    _ok(worlds, "bst_retrieval")
    cfg = _cfg("repro_torch", "bst")
    s = cfg.hist_len + 1
    share = [C // 2, cfg.n_heads, s, s]
    for r, w in enumerate(worlds):
        mesh = w["bst_retrieval"]["mesh"]
        assert mesh["softmax"] == [share], (r, mesh["softmax"])
        assert mesh["largest"] == int(np.prod(share)), (r, mesh["largest"])
    assert worlds[0]["bst_retrieval"]["one"]["softmax"] == [[C, cfg.n_heads, s, s]]


def test_mind_train_loss_and_gradients_equal_one_process(runs):
    """MIND's loss and the gradient of every parameter (the item table's
    summed into each rank's block and all-reduced over data) within 1e-5
    of each leaf's largest element of one process's."""
    worlds, _ = runs
    _ok(worlds, "mind_train")
    one = worlds[0]["mind_train"]["one"]
    for r, w in enumerate(worlds):
        mesh = w["mind_train"]["mesh"]
        assert abs(mesh["loss"] - one["loss"]) <= ATOL * max(abs(one["loss"]), 1.0), r
        assert set(mesh["grads"]) == set(one["grads"])
        for name, g in one["grads"].items():
            scale = float(np.abs(g).max())
            assert scale > 0, name
            err = float(np.abs(mesh["grads"][name] - g).max())
            assert err <= ATOL * scale, (r, name, err, scale)


def test_lookup_backward_builds_no_whole_batch_rows(runs):
    """The backward on the mesh makes each data rank's (B/2, L, D) rows'
    gradient and no tensor of the whole batch's (B, L, D) rows."""
    worlds, _ = runs
    _ok(worlds, "mind_train")
    cfg = _cfg("repro_torch", "mind")
    whole = (B, cfg.hist_len, cfg.embed_dim)
    for r, w in enumerate(worlds):
        shapes = {tuple(s) for s in w["mind_train"]["mesh"]["shapes"]}
        assert (B // 2, cfg.hist_len, cfg.embed_dim) in shapes, r
        assert whole not in shapes, r


@pytest.mark.parametrize("layout", ["whole", "data", "model", "data_model", "data_dim1"])
def test_uneven_table_rows_equal_one_process(runs, layout):
    """``take_rows`` of a 7-row table split 4 + 3 over model: the rows and
    the table's gradient equal one process's for ids whole, split over
    data (partial over model), over model (the ids stay split), over both,
    and split on dimension 1 over data."""
    worlds, _ = runs
    for r, w in enumerate(worlds):
        if isinstance(w["uneven"], str):
            pytest.fail(f"rank {r} raised:\n{w['uneven']}")
    t = _inputs()
    t0 = torch.from_numpy(t["uneven/table"]).requires_grad_()
    rows = t0[torch.from_numpy(t["uneven/ids"])]
    (rows * torch.from_numpy(t["uneven/cot"])).sum().backward()
    for r, w in enumerate(worlds):
        got_rows, got_grad, pl = w["uneven"][layout]
        assert pl == ["R", "S0"], pl
        np.testing.assert_array_equal(got_rows, rows.detach().numpy(), f"rank {r}")
        _close(got_grad, t0.grad.numpy(), f"rank {r}: the table's gradient")


def test_layouts_take_rows_cannot_split_raise(runs):
    """No fallback: ids split on dimension 1, or unevenly, over the mesh
    dimension that splits the rows raise instead of gathering them whole."""
    worlds, _ = runs
    for w in worlds:
        errors = w["uneven"]["errors"]
        for name, msg in errors.items():
            assert "only dimension 0, evenly" in msg, (name, msg)

