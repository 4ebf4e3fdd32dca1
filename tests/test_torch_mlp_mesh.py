"""The MLPs tensor-parallel over ``model`` on a (data 2, model 2) mesh
(``common/nn.py:mlp`` on a DTensor, ``distributed/comm.py``'s ``pvary`` and
``psum_whole``), and the models that run them: reduced BST's train step and
serve, reduced DLRM's serve (its interaction on rows split over ``model``
too) and MeshGraphNet's ``molecule`` train step, on the CPU.

The reference's ``mlp_init`` lays an MLP's hidden units over ``model``
(``(None, model)`` and ``(model, None)`` in turn); where the rows are split
over the batch alone, each rank computes its block of units (an even
layer) or its partial product, summed over ``model`` (an odd layer), and a
layer whose width ``model`` does not divide is replicated.  One gloo world
of 4 ranks runs every case once (a module-scoped fixture) and the
one-process port beside it on rank 0; one JAX subprocess runs the
reference's ``mlp``, ``recsys_loss``, ``FORWARD`` and ``mgn_loss`` on the
same numpy weights and inputs, made from a seed.  Each case checks, in
fp32:
  * outputs, scores and losses within 1e-5 + 1e-4 relative of one process
    and of the reference (the row-parallel sums add in another order);
  * every gradient within 1e-5 of its leaf's largest element against one
    process and against the reference (at 8 rows no pre-activation sits
    within rounding of a ReLU's kink; at scale one does, and single
    gradient elements take the other branch, so the card's phase X7
    bounds each leaf's relative Frobenius error instead);
  * the MLPs' FLOPs a rank, counted below DTensor, within 5% of one
    process's / 4 for the layers ``model`` divides (/ 2, the rows' share,
    for a replicated one);
  * no all-gather of a whole MLP weight, forward, backward or in the AdamW
    update (fp32 and int8 moments), and every moment a block as its
    parameter is.
"""
import os
import re
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
GRAD_TOL = 1e-5  # of each leaf's largest element
FLOPS_TOL = 0.05
ROWS = 8  # the MLPs' rows and the recsys batches (4 a data rank)
# [in, h1, ..., out]: 2 to 5 layers; 9 and 1 are widths model (2) does not
# divide (a replicated layer, as the reference's spec_for_shape drops the
# axis); 3 layers end column-parallel (the output split over model)
MLPS = {"2_layers": (16, 32, 8), "3_layers": (16, 32, 24, 8), "3_layers_width_9": (16, 9, 24, 8),
        "4_layers": (16, 32, 24, 16, 1), "5_layers": (16, 32, 24, 16, 8, 1)}
MODELS = ("bst_train", "bst_serve", "dlrm_serve", "mgn_molecule")
META = torch.device("meta")
MLP_WEIGHT = re.compile(r"(^|\.)\d+\.[wb]$")  # an MLP layer's w or b: "ffn.1.w", "top.4.b"


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
    cfg = mod.reduce_config(mod.get_arch(arch)[0])
    return cfg.replace(node_feat_dim=32) if arch == "meshgraphnet" else cfg  # molecule's d_feat


def _molecule():
    from repro_torch.configs import get_arch

    return next(s for s in get_arch("meshgraphnet")[1] if s.name == "molecule")


def _weights(rng, named) -> dict:
    """Numpy weights by state-dict name: scales near 1, biases 0.1 N,
    tables N, other weights N / sqrt(fan-in)."""
    out = {}
    for name, shape in named:
        z = rng.standard_normal(shape)
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "scale":
            z = 1.0 + 0.1 * z
        elif leaf in ("b", "bias"):
            z = 0.1 * z
        elif name != "item_table" and not name.startswith("tables."):
            z = z / np.sqrt(shape[0])
        out[name] = z.astype(np.float32)
    return out


def _inputs() -> dict:
    from repro_torch.launch.steps import gnn_graph_dims
    from repro_torch.models import gnn, recsys

    rng = np.random.default_rng(0)
    out = {}
    for case, dims in MLPS.items():
        for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
            out[f"{case}/w/{i}.w"] = (rng.standard_normal((a, b)) / np.sqrt(a)).astype(np.float32)
            out[f"{case}/w/{i}.b"] = (0.1 * rng.standard_normal(b)).astype(np.float32)
        out[f"{case}/x"] = rng.standard_normal((ROWS, dims[0])).astype(np.float32)
        out[f"{case}/cot"] = rng.standard_normal((ROWS, dims[-1])).astype(np.float32)
    for arch in ("bst", "dlrm-mlperf"):
        cfg = _cfg("repro_torch", arch)
        model, _ = recsys.INIT[arch](None, cfg, device=META)
        for name, w in _weights(rng, [(n, tuple(p.shape))
                                      for n, p in model.named_parameters()]).items():
            out[f"{arch}/w/{name}"] = w
    cfg = _cfg("repro_torch", "bst")
    v = cfg.vocab_sizes[0]
    out["bst/hist"] = rng.integers(0, v, (ROWS, cfg.hist_len)).astype(np.int32)
    out["bst/target"] = rng.integers(0, v, (ROWS,)).astype(np.int32)
    out["bst/label"] = rng.integers(0, 2, (ROWS,)).astype(np.float32)
    cfg = _cfg("repro_torch", "dlrm-mlperf")
    out["dlrm-mlperf/dense"] = rng.standard_normal((ROWS, cfg.n_dense)).astype(np.float32)
    out["dlrm-mlperf/sparse"] = np.stack([rng.integers(0, v, ROWS) for v in cfg.vocab_sizes],
                                         axis=1).astype(np.int32)
    cfg = _cfg("repro_torch", "meshgraphnet")
    model, _ = gnn.init_mgn(None, cfg, device=META)
    for name, w in _weights(rng, [(n, tuple(p.shape))
                                  for n, p in model.named_parameters()]).items():
        out[f"mgn/w/{name}"] = w
    n, e, d_feat = gnn_graph_dims(_molecule())
    n_valid, e_valid = n - 64, e - 128  # padding at the end, masked
    node_mask, edge_mask = np.ones(n, np.float32), np.ones(e, np.float32)
    node_mask[n_valid:], edge_mask[e_valid:] = 0, 0
    out.update({"mgn/node_feat": rng.standard_normal((n, d_feat)).astype(np.float32),
                "mgn/edge_feat": rng.standard_normal((e, cfg.edge_feat_dim)).astype(np.float32),
                "mgn/senders": rng.integers(0, n_valid, e).astype(np.int32),
                "mgn/receivers": rng.integers(0, n_valid, e).astype(np.int32),
                "mgn/node_mask": node_mask, "mgn/edge_mask": edge_mask,
                "mgn/node_targets": rng.standard_normal((n, cfg.gnn_out_dim)).astype(np.float32)})
    return out


# ------------------------------------------------------------ the world
class _Counted:
    """``repro_torch.common.nn.mlp`` wrapped to add the FLOPs that the dry
    run's counter below DTensor (``dryrun._rank_ops_mode``) sees in each
    MLP's forward to ``mlp_flops`` (an MLP that calls ``mlp`` again, on
    each rank's rows, is counted once)."""

    def __init__(self, ops):
        from repro_torch.common import nn

        self.ops, self.nn, self.mlp_flops, self.depth = ops, nn, 0, 0
        self.orig = nn.mlp

    def __enter__(self):
        def mlp(*args, **kwargs):
            f0 = self.ops.flops
            self.depth += 1
            try:
                out = self.orig(*args, **kwargs)
            finally:
                self.depth -= 1
            if not self.depth:
                self.mlp_flops += self.ops.flops - f0
            return out

        self.nn.mlp = mlp
        return self

    def __exit__(self, *exc):
        self.nn.mlp = self.orig


def _whole(x) -> np.ndarray:
    from repro_torch.common.sharding import is_dtensor

    return (x.full_tensor() if is_dtensor(x) else x).detach().numpy().copy()


def _place(x: torch.Tensor, axes: tuple, mesh):
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.common.sharding import sharding_for_shape

    if mesh is None:
        return x.clone()
    return distribute_tensor(x, mesh, sharding_for_shape(axes, tuple(x.shape), mesh))


def _events(ops) -> list:
    return [(e["kind"], [list(s) for s in e["shape"]], e["where"]) for e in ops.events]


def _mlp_case(case: str, t: dict, mesh=None) -> dict:
    """``nn.mlp`` forward and the gradient of y . cot, all FLOPs counted."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.common import nn
    from repro_torch.common.sharding import mesh_context, sharding_for_shape, spec_for_shape
    from repro_torch.launch.dryrun import _rank_ops_mode

    dims = MLPS[case]
    axes = nn.mlp_axes(len(dims) - 1)
    params = []
    for i, ax in enumerate(axes):
        layer = {}
        for k in ("w", "b"):
            w = t[f"{case}/w/{i}.{k}"]
            layer[k] = (w.clone() if mesh is None else distribute_tensor(
                w, mesh, sharding_for_shape(ax[k], tuple(w.shape), mesh))).requires_grad_()
        params.append(layer)
    x = _place(t[f"{case}/x"], ("batch", None), mesh).requires_grad_()
    cot = _place(t[f"{case}/cot"], ("batch", None), mesh)
    ops = _rank_ops_mode()
    with mesh_context(mesh) if mesh is not None else nullcontext(), ops:
        y = nn.mlp(params, x)
        (y * cot).sum().backward()
    res = {"y": _whole(y), "flops": ops.flops, "events": _events(ops), "grads": {"x": _whole(x.grad)}}
    for i, layer in enumerate(params):
        for k, w in layer.items():
            res["grads"][f"{i}.{k}"] = _whole(w.grad)
    if mesh is not None:
        res["weight_shapes"] = {f"{i}.{k}": list(w.shape) for i, layer in enumerate(params)
                                for k, w in layer.items()}
        res["split"] = [any(e is not None for e in spec_for_shape(ax["w"], tuple(layer["w"].shape),
                                                                  mesh))
                        for ax, layer in zip(axes, params)]
    return res


def _model(case: str, t: dict, mesh=None):
    """(cfg, the port's model from the numpy weights (on ``mesh``), its
    axes, the batch (placed by the cell's input axes), the cell)."""
    from repro_torch.common.config import ShapeSpec
    from repro_torch.common.sharding import shard_module
    from repro_torch.launch.steps import gnn_cell, recsys_cell
    from repro_torch.models import gnn, recsys

    if case == "mgn_molecule":
        arch, key = "meshgraphnet", "mgn"
        cfg = _cfg("repro_torch", arch)
        cell = gnn_cell(cfg, _molecule())
        _, axes = gnn.init_mgn(None, cfg, device=META)
        model = gnn.mgn_params_from_jax(unflat({n: t[f"{key}/w/{n}"].numpy() for n in axes}),
                                        cfg, device="cpu")
    else:
        arch = key = "bst" if case.startswith("bst") else "dlrm-mlperf"
        cfg = _cfg("repro_torch", arch)
        kind = "train" if case.endswith("train") else "serve"
        cell = recsys_cell(cfg, ShapeSpec(name=case, kind=kind, global_batch=ROWS))
        _, axes = recsys.INIT[arch](None, cfg, device=META)
        model = recsys.recsys_params_from_jax(
            unflat({n: t[f"{key}/w/{n}"].numpy() for n in axes}), cfg, device="cpu")
    if mesh is not None:
        shard_module(model, axes, mesh)
    batch = {k: _place(t[f"{key}/{k}"], ax, mesh) for k, ax in cell.input_axes.items()}
    return cell.arch, model, axes, batch, cell


def _model_case(case: str, t: dict, mesh=None) -> dict:
    """Loss and every gradient (train) or scores (serve), the MLPs'
    forward FLOPs and the collectives."""
    from repro_torch.common.sharding import mesh_context
    from repro_torch.launch.dryrun import _rank_ops_mode
    from repro_torch.models import gnn, recsys

    cfg, model, _, batch, _ = _model(case, t, mesh)
    ops = _rank_ops_mode()
    res = {}
    with mesh_context(mesh) if mesh is not None else nullcontext():
        with ops, _Counted(ops) as c:
            if case == "mgn_molecule":
                loss = gnn.mgn_loss(model, cfg, batch)
            elif case == "bst_train":
                loss = recsys.recsys_loss(model, cfg, batch)
            else:
                with torch.no_grad():
                    scores = recsys.FORWARD[cfg.name](model, cfg, batch)
            if case.endswith("serve"):
                res["scores"] = scores
            else:
                loss.backward()
                res["loss"] = loss
        # gathered for the comparison outside the counter
        if case.endswith("serve"):
            res["scores"] = _whole(res["scores"])
        else:
            res["loss"] = float(_whole(res["loss"]))
            res["grads"] = {n: _whole(p.grad) for n, p in model.named_parameters()}
    res.update(mlp_flops=c.mlp_flops, events=_events(ops),
               weight_shapes={n: list(p.shape) for n, p in model.named_parameters()
                              if MLP_WEIGHT.search(n)})
    return res


def _train_steps(t: dict, mesh) -> dict:
    """BST's and MGN's cell train step (AdamW, fp32 and int8 moments) on the
    mesh: the collectives, and each moment's block beside its parameter's."""
    from repro_torch.common.config import OptimizerConfig
    from repro_torch.common.sharding import mesh_context
    from repro_torch.launch.dryrun import _rank_ops_mode
    from repro_torch.models import gnn, recsys
    from repro_torch.train import init_train_state, make_train_step

    out = {}
    for case, loss in (("bst_train", recsys.recsys_loss), ("mgn_molecule", gnn.mgn_loss)):
        for moments in ("fp32", "int8"):
            cfg, model, _, batch, _ = _model(case, t, mesh)
            opt_cfg = OptimizerConfig(moment_dtype=moments)
            step = make_train_step(lambda m, b, cfg=cfg, loss=loss: loss(m, cfg, b), opt_cfg)
            opt = init_train_state(model, opt_cfg)
            ops = _rank_ops_mode()
            with mesh_context(mesh), ops:
                step(model, opt, batch)
            blocks = {}
            for (name, p), m in zip(sorted(model.named_parameters()), opt.m):
                q = m["q"] if isinstance(m, dict) else m
                blocks[name] = [list(p.to_local().shape), list(q.to_local().shape)]
            out[f"{case}/{moments}"] = {
                "events": _events(ops), "blocks": blocks,
                "weight_shapes": {n: list(p.shape) for n, p in model.named_parameters()
                                  if MLP_WEIGHT.search(n)}}
    return out


def _world(rank: int, world: int, inputs: str, out_dir: str) -> None:
    from repro_torch.common.sharding import concrete_mesh

    torch.set_num_threads(1)
    t = {k: torch.from_numpy(v) for k, v in np.load(inputs).items()}
    mesh = concrete_mesh(*MESH, device_type="cpu")
    cases = {c: (lambda c=c, m=None: _mlp_case(c, t, m)) for c in MLPS}
    cases.update({c: (lambda c=c, m=None: _model_case(c, t, m)) for c in MODELS})
    res: dict = {}
    for case, fn in cases.items():
        try:
            res[case] = {"mesh": fn(m=mesh)}
            if rank == 0:
                res[case]["one"] = fn()
        except Exception:
            res[case] = traceback.format_exc()
    try:
        res["train_steps"] = _train_steps(t, mesh)
    except Exception:
        res["train_steps"] = traceback.format_exc()
    torch.save(res, os.path.join(out_dir, f"world{rank}.pt"))


# ------------------------------------------------------------ the reference
REF = UNFLAT + r"""
import dataclasses, sys
import numpy as np, jax, jax.numpy as jnp
from repro.common import nn
from repro.configs import get_arch, reduce_config
from repro.models import gnn as G, recsys as R
d = {k: jnp.asarray(v) for k, v in np.load(sys.argv[1] + "/inputs.npz").items()}
cases = sys.argv[2].split(",")
out = {}

def w(prefix):
    return unflat({k[len(prefix) + 3:]: v for k, v in d.items() if k.startswith(prefix + "/w/")})

def name(path):
    return ".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)

def grads(case, g):
    for path, leaf in jax.tree_util.tree_flatten_with_path(g)[0]:
        out[case + "/grad/" + name(path)] = leaf

for case in cases:
    params, x, cot = w(case), d[case + "/x"], d[case + "/cot"]
    y, vjp = jax.vjp(lambda p, x: nn.mlp(p, x), params, x)
    gp, gx = vjp(cot)
    out[case + "/y"], out[case + "/grad/x"] = y, gx
    grads(case, gp)
cfg = reduce_config(get_arch("bst")[0])
batch = {k: d["bst/" + k] for k in ("hist", "target", "label")}
loss, g = jax.value_and_grad(lambda p: R.recsys_loss(p, cfg, batch))(w("bst"))
out["bst_train/loss"] = loss
grads("bst_train", g)
out["bst_serve/scores"] = R.FORWARD["bst"](w("bst"), cfg, batch)
cfg = reduce_config(get_arch("dlrm-mlperf")[0])
out["dlrm_serve/scores"] = R.FORWARD["dlrm-mlperf"](
    w("dlrm-mlperf"), cfg, {k: d["dlrm-mlperf/" + k] for k in ("dense", "sparse")})
cfg = dataclasses.replace(reduce_config(get_arch("meshgraphnet")[0]), node_feat_dim=32)
batch = {k[4:]: v for k, v in d.items() if k.startswith("mgn/") and not k.startswith("mgn/w/")}
loss, g = jax.value_and_grad(lambda p: G.mgn_loss(p, cfg, batch))(w("mgn"))
out["mgn_molecule/loss"] = loss
grads("mgn_molecule", g)
np.savez(sys.argv[1] + "/ref.npz", **{k: np.asarray(v) for k, v in out.items()})
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from repro_torch.distributed.comm import run_world

    d = tmp_path_factory.mktemp("torch_mlp_mesh")
    np.savez(d / "inputs.npz", **_inputs())
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    ref = subprocess.Popen([sys.executable, "-c", REF, str(d), ",".join(MLPS)], env=env,
                           text=True, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
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


def _grads_close(got: dict, want: dict, what: str) -> None:
    assert set(got) == set(want), (what, sorted(set(got) ^ set(want)))
    for name, g in want.items():
        scale = float(np.abs(g).max())
        err = float(np.abs(got[name] - g).max())
        assert err <= GRAD_TOL * max(scale, 1e-30), (what, name, err, scale)


def _no_whole_weight_gathered(events, weight_shapes: dict, what: str) -> None:
    whole = {tuple(s) for s in weight_shapes.values()}
    for kind, shapes, where in events:
        if kind == "all-gather":
            for s in shapes:
                assert tuple(s) not in whole, (what, kind, s, where)


@pytest.mark.parametrize("case", list(MLPS))
def test_mlp_on_the_mesh_equals_one_process_and_reference(runs, case):
    """``nn.mlp`` of 2 to 5 layers on the (2, 2) mesh: the output and the
    gradient of every weight and of the input equal one process's and the
    reference's, on every rank."""
    worlds, ref = runs
    _ok(worlds, case)
    one = worlds[0][case]["one"]
    _close(one["y"], ref[f"{case}/y"], "one process vs the reference")
    want = {k[len(case) + 6:]: v for k, v in ref.items() if k.startswith(f"{case}/grad/")}
    _grads_close(one["grads"], want, f"{case}: one process vs the reference")
    for r, w in enumerate(worlds):
        mesh = w[case]["mesh"]
        _close(mesh["y"], one["y"], f"rank {r}: mesh vs one process")
        _close(mesh["y"], ref[f"{case}/y"], f"rank {r}: mesh vs the reference")
        _grads_close(mesh["grads"], one["grads"], f"{case} rank {r}: mesh vs one process")
        _grads_close(mesh["grads"], want, f"{case} rank {r}: mesh vs the reference")


@pytest.mark.parametrize("case", list(MLPS))
def test_mlp_flops_a_rank_are_its_share(runs, case):
    """Each rank's FLOPs below DTensor, forward and backward, within 5% of
    one process's / 4 for the layers ``model`` divides (rows / 2, units
    / 2) and / 2 for a replicated one (9 and 1 wide), layer by layer."""
    worlds, _ = runs
    _ok(worlds, case)
    dims = MLPS[case]
    layer = [3 * 2 * ROWS * a * b for a, b in zip(dims[:-1], dims[1:])]  # y, dW, dx
    assert worlds[0][case]["one"]["flops"] == sum(layer)
    split = [b % 2 == 0 if i % 2 == 0 else a % 2 == 0
             for i, (a, b) in enumerate(zip(dims[:-1], dims[1:]))]
    assert split == worlds[0][case]["mesh"]["split"], split
    share = sum(f / (4 if s else 2) for f, s in zip(layer, split))
    for r, w in enumerate(worlds):
        got = w[case]["mesh"]["flops"]
        assert abs(got - share) <= FLOPS_TOL * share, (r, got, share)


@pytest.mark.parametrize("case", list(MLPS))
def test_mlp_gathers_no_weight(runs, case):
    """No all-gather on the mesh at all, and none of a whole weight: the
    weights stay in their blocks forward and backward."""
    worlds, _ = runs
    _ok(worlds, case)
    for w in worlds:
        mesh = w[case]["mesh"]
        assert not [e for e in mesh["events"] if e[0] == "all-gather"], mesh["events"]
        _no_whole_weight_gathered(mesh["events"], mesh["weight_shapes"], case)


@pytest.mark.parametrize("case", MODELS)
def test_model_on_the_mesh_equals_one_process_and_reference(runs, case):
    """BST's train loss and serve scores, DLRM's serve scores and
    MeshGraphNet's ``molecule`` loss on the mesh equal one process's and
    the reference's; every gradient within 1e-5 of its largest element of
    one process's and of the reference's."""
    worlds, ref = runs
    _ok(worlds, case)
    one = worlds[0][case]["one"]
    key = "scores" if "scores" in one else "loss"
    _close(np.asarray(one[key]), ref[f"{case}/{key}"], f"{case}: one process vs the reference")
    want = {k[len(case) + 6:]: v for k, v in ref.items() if k.startswith(f"{case}/grad/")}
    if key == "loss":
        _grads_close(one["grads"], want, f"{case}: one process vs the reference")
    for r, w in enumerate(worlds):
        mesh = w[case]["mesh"]
        _close(np.asarray(mesh[key]), np.asarray(one[key]), f"{case} rank {r}: mesh vs one process")
        _close(np.asarray(mesh[key]), ref[f"{case}/{key}"], f"{case} rank {r}: mesh vs reference")
        if key == "loss":
            _grads_close(mesh["grads"], one["grads"], f"{case} rank {r}: mesh vs one process")
            _grads_close(mesh["grads"], want, f"{case} rank {r}: mesh vs the reference")


@pytest.mark.parametrize("case", MODELS)
def test_model_mlp_flops_a_rank_are_a_quarter(runs, case):
    """The MLPs' forward FLOPs a rank below DTensor within 5% of one
    process's / 4: every MLP layer of reduced BST, DLRM and MeshGraphNet
    splits over ``model`` but DLRM's last (1 wide, 256 of its 2.4M
    multiply-adds a row)."""
    worlds, _ = runs
    _ok(worlds, case)
    one = worlds[0][case]["one"]["mlp_flops"]
    assert one > 0
    for r, w in enumerate(worlds):
        got = w[case]["mesh"]["mlp_flops"]
        assert abs(got - one / 4) <= FLOPS_TOL * one / 4, (case, r, got, one / 4)


@pytest.mark.parametrize("case", MODELS)
def test_model_gathers_no_whole_mlp_weight(runs, case):
    """No all-gather of a whole MLP weight or bias in the forward or
    backward of any model on the mesh."""
    worlds, _ = runs
    _ok(worlds, case)
    for w in worlds:
        mesh = w[case]["mesh"]
        assert mesh["weight_shapes"], case
        _no_whole_weight_gathered(mesh["events"], mesh["weight_shapes"], case)


@pytest.mark.parametrize("case", ["bst_train/fp32", "bst_train/int8", "mgn_molecule/fp32",
                                  "mgn_molecule/int8"])
def test_train_step_keeps_weights_and_moments_in_blocks(runs, case):
    """The cell's AdamW step on the mesh, fp32 and int8 moments: no
    all-gather of a whole MLP weight anywhere in it, and every moment is
    the block its parameter is (the gradient summed over ``data`` only)."""
    worlds, _ = runs
    for r, w in enumerate(worlds):
        if isinstance(w["train_steps"], str):
            pytest.fail(f"rank {r} raised:\n{w['train_steps']}")
        got = w["train_steps"][case]
        _no_whole_weight_gathered(got["events"], got["weight_shapes"], case)
        for name, (param, moment) in got["blocks"].items():
            assert param == moment, (case, name, param, moment)
        split = [n for n, (p, _) in got["blocks"].items()
                 if MLP_WEIGHT.search(n) and p != got["weight_shapes"][n]]
        assert split, f"{case}: no MLP weight is split on the mesh"
