"""The port's neighbor sampler, MeshGraphNet and GNN cells against the
reference, on the CPU.

The reference's parameters are drawn with numpy over ``jax.eval_shape`` of
its ``init_mgn`` and carried across by ``mgn_params_from_jax``; graphs are
made with numpy from a seed, with padding (masked nodes and edges).
Tolerances, and why:
  * the sampler, ``subgraph_budget`` and ``gnn_graph_dims``: exact (the
    same numpy calls in the same order; integer arithmetic);
  * forward and loss (fp32, 3 message-passing layers): atol 2e-5 / rtol
    1e-4 — the same operations, with float32 sums (the matmuls, the
    LayerNorm means and the scatter-add, which XLA's segment_sum orders
    otherwise) in other orders;
  * one AdamW step (eps 1e-3, as the LM train test): loss and grad norm
    rtol 1e-4, updated parameters atol 1e-4 (1% of the learning rate);
  * per-layer remat against none: gradients equal bit for bit (the same
    operations recomputed on the CPU);
  * cells: parameter and input shapes, dtypes and logical axes exact;
    kill-and-resume bit for bit.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.common.config import OptimizerConfig as RefOptConfig
from repro.configs import get_arch as ref_get_arch
from repro.configs import reduce_config as ref_reduce
from repro.launch import steps as ref_steps
from repro.models import gnn as ref_gnn
from repro.models import sampler as ref_sampler
from repro.train import init_train_state as ref_init_train
from repro.train import make_train_step as ref_make_step
from repro_torch.checkpoint import latest_step
from repro_torch.common.config import OptimizerConfig, ShapeSpec
from repro_torch.configs import get_arch, reduce_config
from repro_torch.configs.shapes import GNN_SHAPES
from repro_torch.launch import steps
from repro_torch.launch.train import main as train_main
from repro_torch.models import gnn, sampler
from repro_torch.train import init_train_state, make_train_step

ROOT = Path(__file__).resolve().parents[1]
OPT = dict(lr=1e-2, warmup_steps=1, eps=1e-3)


def path_name(path) -> str:
    return ".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)


def numpy_params(spec, seed=0):
    """Numpy arrays over a tree of ShapeDtypeStructs, by leaf name: LayerNorm
    scales 1 + 0.1 N, biases 0.1 N (non-zero, so both are exercised), dense
    weights N / sqrt(fan-in)."""
    rng = np.random.default_rng(seed)

    def mk(path, s):
        name = path_name(path).rsplit(".", 1)[-1]
        z = rng.standard_normal(s.shape)
        if name == "scale":
            z = 1.0 + 0.1 * z
        elif name in ("bias", "b"):
            z = 0.1 * z
        else:
            z = z / np.sqrt(s.shape[0])
        return z.astype(s.dtype)

    return jax.tree_util.tree_map_with_path(mk, spec)


def _pair(aggregator="sum"):
    rc = ref_reduce(ref_get_arch("meshgraphnet")[0]).replace(gnn_aggregator=aggregator)
    tc = reduce_config(get_arch("meshgraphnet")[0]).replace(gnn_aggregator=aggregator)
    spec = jax.eval_shape(lambda k: ref_gnn.init_mgn(k, rc)[0], jax.random.key(0))
    params = numpy_params(spec)
    return rc, tc, params, gnn.mgn_params_from_jax(params, tc, device="cpu")


def _graph(cfg, n=40, e=150, seed=1):
    """A padded graph: the last 6 nodes and the last 20 edges are padding."""
    rng = np.random.default_rng(seed)
    node_mask = np.ones(n, np.float32)
    node_mask[-6:] = 0
    edge_mask = np.ones(e, np.float32)
    edge_mask[-20:] = 0
    return {
        "node_feat": rng.standard_normal((n, cfg.node_feat_dim)).astype(np.float32),
        "edge_feat": rng.standard_normal((e, cfg.edge_feat_dim)).astype(np.float32),
        "senders": rng.integers(0, n - 6, e).astype(np.int32),
        "receivers": rng.integers(0, n - 6, e).astype(np.int32),
        "node_mask": node_mask,
        "edge_mask": edge_mask,
        "node_targets": rng.standard_normal((n, cfg.gnn_out_dim)).astype(np.float32),
    }


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# ------------------------------------------------------------------ sampler
@pytest.mark.parametrize("n_nodes,deg,seeds,fanout", [
    (500, 8, 16, (5, 3)),  # the reference test's graph
    (300, 3, 40, (4, 2)),  # nodes run out: the max_nodes budget bites
    (2000, 20, 24, (6, 4, 2)),  # three hops
])
def test_sampler_arrays_equal_reference(n_nodes, deg, seeds, fanout):
    g = sampler.CSRGraph.random(n_nodes, avg_degree=deg, seed=3)
    rg = ref_sampler.CSRGraph.random(n_nodes, avg_degree=deg, seed=3)
    assert np.array_equal(g.indptr, rg.indptr) and np.array_equal(g.indices, rg.indices)
    assert np.array_equal(g.neighbors(7), rg.neighbors(7))
    max_n, max_e = sampler.subgraph_budget(seeds, fanout)
    assert (max_n, max_e) == ref_sampler.subgraph_budget(seeds, fanout)
    if n_nodes == 300:
        max_n = 60
    roots = np.random.default_rng(5).choice(n_nodes, seeds, replace=False)
    for rng_seed in (0, 1):
        got = sampler.sample_subgraph(g, roots, fanout, max_nodes=max_n, max_edges=max_e,
                                      rng=np.random.default_rng(rng_seed))
        want = ref_sampler.sample_subgraph(rg, roots, fanout, max_nodes=max_n, max_edges=max_e,
                                           rng=np.random.default_rng(rng_seed))
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    n_valid, e_valid = int(got["node_mask"].sum()), int(got["edge_mask"].sum())
    assert seeds <= n_valid <= max_n and 0 < e_valid <= max_e
    # every sampled edge is an edge of the graph, sender a neighbour of receiver
    for s_, r_ in zip(got["senders"][:e_valid], got["receivers"][:e_valid]):
        assert got["node_ids"][s_] in g.neighbors(int(got["node_ids"][r_]))


@given(st.integers(1, 2048), st.tuples(st.integers(1, 20), st.integers(1, 20)))
@settings(max_examples=25, deadline=None)
def test_subgraph_budget_formula(seeds, fanout):
    n, e = sampler.subgraph_budget(seeds, fanout)
    assert (n, e) == ref_sampler.subgraph_budget(seeds, fanout)
    assert n == seeds * (1 + fanout[0] + fanout[0] * fanout[1])
    assert e == seeds * (fanout[0] + fanout[0] * fanout[1])


# ------------------------------------------------------------------ MGN
@pytest.mark.parametrize("aggregator", ["sum", "mean"])
def test_forward_and_loss_match_reference(aggregator):
    rc, tc, params, model = _pair(aggregator)
    batch = _graph(tc)
    ref_out, ref_loss = jax.jit(
        lambda p, b: (ref_gnn.mgn_forward(p, rc, b), ref_gnn.mgn_loss(p, rc, b)))(params, batch)
    with torch.no_grad():
        out = gnn.mgn_forward(model, tc, _t(batch))
        loss = gnn.mgn_loss(model, tc, _t(batch))
    assert out.shape == (40, tc.gnn_out_dim) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(float(loss), float(ref_loss), atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("aggregator,remat", [("sum", False), ("sum", True), ("mean", False),
                                              ("mean", True)])
def test_train_step_matches_reference(aggregator, remat):
    rc, tc, params, model = _pair(aggregator)
    batch = _graph(tc, seed=2)
    ref_step = jax.jit(ref_make_step(lambda p, b: ref_gnn.mgn_loss(p, rc, b, remat=remat),
                                     RefOptConfig(**OPT)))
    new_p, _, ref_m = ref_step(params, ref_init_train(params, RefOptConfig(**OPT)), batch)
    ocfg = OptimizerConfig(**OPT)
    before = {n: p.detach().clone() for n, p in model.state_dict().items()}
    step = make_train_step(lambda m, b: gnn.mgn_loss(m, tc, b, remat=remat), ocfg)
    metrics = step(model, init_train_state(model, ocfg), _t(batch))
    np.testing.assert_allclose(float(metrics["loss"]), float(ref_m["loss"]), rtol=1e-4)
    np.testing.assert_allclose(float(metrics["grad_norm"]), float(ref_m["grad_norm"]), rtol=1e-4)
    moved = gnn.mgn_params_from_jax(jax.tree.map(np.asarray, new_p), tc, device="cpu").state_dict()
    for name, p in model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), moved[name].numpy(), atol=1e-4, err_msg=name)
    assert max(float((model.state_dict()[n] - before[n]).abs().max()) for n in before) > 5e-3


@pytest.mark.parametrize("aggregator", ["sum", "mean"])
def test_remat_gives_the_same_gradients_bit_for_bit(aggregator):
    _, tc, _, model = _pair(aggregator)
    batch = _t(_graph(tc, seed=3))
    grads = {}
    for remat in (False, True):
        model.zero_grad()
        gnn.mgn_loss(model, tc, batch, remat=remat).backward()
        grads[remat] = {n: p.grad.clone() for n, p in model.named_parameters()}
    for n, g in grads[False].items():
        assert torch.equal(grads[True][n], g), n


def test_init_structure_and_axes_equal_reference():
    """init_mgn's state-dict names, shapes and axes: the reference's tree
    paths, one for one."""
    rc = ref_reduce(ref_get_arch("meshgraphnet")[0])
    tc = reduce_config(get_arch("meshgraphnet")[0])
    box = {}

    def init(k):
        p, box["axes"] = ref_gnn.init_mgn(k, rc)
        return p

    spec = jax.eval_shape(init, jax.random.key(0))
    model, axes = gnn.init_mgn(0, tc, device="cpu")
    want = {path_name(p): leaf for p, leaf in jax.tree_util.tree_leaves_with_path(spec)}
    got = dict(model.named_parameters())
    assert list(got) == list(axes) and set(got) == set(want)
    for n, leaf in want.items():
        assert tuple(got[n].shape) == leaf.shape, n
    is_ax = lambda x: isinstance(x, tuple) and all(isinstance(a, (str, type(None))) for a in x)
    ref_axes = {path_name(p): tuple(a) for p, a in
                jax.tree_util.tree_leaves_with_path(box["axes"], is_leaf=is_ax)}
    assert axes == ref_axes
    # the reference's scales: N / sqrt(fan-in) weights, zero biases, unit LN scales
    assert float(model["layers"][0]["edge_ln"]["scale"].detach().min()) == 1.0
    assert float(model["node_enc"][0]["b"].detach().abs().max()) == 0.0


# ------------------------------------------------------------------ cells
@pytest.mark.parametrize("shape", GNN_SHAPES, ids=lambda s: s.name)
def test_gnn_cell_equals_reference(shape):
    assert steps.gnn_graph_dims(shape) == ref_steps.gnn_graph_dims(shape)
    cfg, rcfg = get_arch("meshgraphnet")[0], ref_get_arch("meshgraphnet")[0]
    cell, ref = steps.build_cell(cfg, shape), ref_steps.build_cell(rcfg, shape)
    assert cell.kind == ref.kind == "train" and cell.arch.node_feat_dim == ref.arch.node_feat_dim
    want = {path_name(p): leaf for p, leaf in jax.tree_util.tree_leaves_with_path(ref.param_specs)}
    assert set(cell.param_specs) == set(want)
    for n, leaf in want.items():
        assert cell.param_specs[n].shape == leaf.shape and cell.param_specs[n].dtype == torch.float32
    is_ax = lambda x: isinstance(x, tuple) and all(isinstance(a, (str, type(None))) for a in x)
    assert cell.param_axes == {path_name(p): tuple(a) for p, a in
                               jax.tree_util.tree_leaves_with_path(ref.param_axes, is_leaf=is_ax)}
    assert {k: s.shape for k, s in cell.input_specs.items()} == \
        {k: s.shape for k, s in ref.input_specs.items()}
    assert cell.input_axes == ref.input_axes


def test_small_gnn_cell_steps_and_axes_match_names():
    """The reference smoke test's full_graph_sm case, on the port."""
    rc = reduce_config(get_arch("meshgraphnet")[0])
    cell = steps.build_cell(rc, ShapeSpec(name="full_graph_sm", kind="train", n_nodes=60,
                                                n_edges=240, d_feat=16))
    model = cell.init_fn(0, "cpu")
    assert list(dict(model.named_parameters())) == list(cell.param_axes)
    rng = np.random.default_rng(11)
    batch = {k: torch.from_numpy(
        rng.integers(0, 3, s.shape).astype(np.int32) if s.dtype == torch.int32
        else np.ones(s.shape, np.float32) if "mask" in k
        else rng.standard_normal(s.shape).astype(np.float32)) for k, s in cell.input_specs.items()}
    m = cell.step(model, init_train_state(model, cell.opt_cfg), batch)
    assert np.isfinite(float(m["loss"])) and np.isfinite(float(m["grad_norm"]))


def test_launcher_kill_and_resume_is_bit_for_bit(tmp_path):
    """``python -m repro_torch.launch.train --arch meshgraphnet`` killed after
    2 steps (a subprocess) and resumed to 4 in this process, against 4 steps
    straight: the same parameters and moments, bit for bit."""
    args = ["--arch", "meshgraphnet", "--reduced", "--device", "cpu", "--batch", "4"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    first = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *args, "--steps", "2",
         "--ckpt-dir", str(tmp_path / "b"), "--checkpoint-every", "2"],
        capture_output=True, text=True, env=env, timeout=120)
    assert first.returncode == 0, first.stderr
    assert "[train] step 0 loss" in first.stdout and latest_step(str(tmp_path / "b")) == 2
    resumed, opt_b, _ = train_main([*args, "--steps", "4", "--ckpt-dir", str(tmp_path / "b"),
                                    "--checkpoint-every", "2"])
    straight, opt_a, _ = train_main([*args, "--steps", "4", "--ckpt-dir", str(tmp_path / "a"),
                                     "--checkpoint-every", "0"])
    assert opt_a.step == opt_b.step == 4
    for name, p in straight.state_dict().items():
        assert torch.equal(p, resumed.state_dict()[name]), name
    for a, b in zip(opt_a.m + opt_a.v, opt_b.m + opt_b.v):
        assert torch.equal(a, b)
