"""The port's mesh pieces (``repro_torch.distributed``, the mesh half of
``common.sharding``, elastic reshard) against the reference on the CPU.

One gloo world of 8 ranks runs every check once (a module-scoped fixture);
the reference runs the same numpy inputs once in a JAX subprocess with 8
host devices, as ``tests/test_distributed.py`` does.  Each check is its own
test case on the saved results.
"""
import os
import subprocess
import sys
import traceback

import numpy as np
import pytest
import torch

ROOT = os.path.join(os.path.dirname(__file__), "..")
SRC = os.path.join(ROOT, "src")
WORLD = 8

# reduced gemma2-2b as the reference's sharded train step test cuts it
TRAIN = dict(d_model=64, n_heads=4, head_dim=16)
TRAIN_B, TRAIN_S = 8, 32


def _inputs() -> dict:
    rng = np.random.default_rng(0)
    return {
        "car_a": rng.standard_normal((WORLD, 3, 7)).astype(np.float32),
        "car_b": rng.standard_normal((WORLD, 40)).astype(np.float32),
        "ef_g1": rng.standard_normal((WORLD, 37)).astype(np.float32),
        "ef_g2": rng.standard_normal((WORLD, 37)).astype(np.float32),
        "cm_x": rng.standard_normal((16, 64)).astype(np.float32),
        "cm_w": rng.standard_normal((64, 32)).astype(np.float32),
        "cm_cot": rng.standard_normal((16, 32)).astype(np.float32),
        "pipe_w": (rng.standard_normal((4, 16, 16)) * 0.3).astype(np.float32),
        "pipe_x": rng.standard_normal((8, 4, 16)).astype(np.float32),
        "pipe_cot": rng.standard_normal((8, 4, 16)).astype(np.float32),
        "sm_x": rng.standard_normal((8, 12)).astype(np.float32),
        "sm_t": rng.standard_normal((16, 3)).astype(np.float32),
        "comm_x": rng.standard_normal((WORLD * 8, 3)).astype(np.float32),
        "tokens": rng.integers(0, 251, (TRAIN_B, TRAIN_S)).astype(np.int32),
        "labels": rng.integers(0, 251, (TRAIN_B, TRAIN_S)).astype(np.int32),
    }


# ------------------------------------------------------------ the world
def _checks(rank: int, d: dict, out_dir: str) -> dict:
    from torch.distributed.tensor import DTensor, Shard, distribute_tensor

    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.common.sharding import (NamedSharding, axis_index, concrete_mesh,
                                             mesh_context, shard_map)
    from repro_torch.distributed import (ErrorFeedback, collective_matmul_ag,
                                         compressed_allreduce, make_pipeline_fn,
                                         matmul_reduce_scatter, quantize_chunk)
    from repro_torch.distributed import comm

    t = {k: torch.from_numpy(v) for k, v in d.items()}
    flat = concrete_mesh((WORLD,), ("data",), device_type="cpu")
    grid = concrete_mesh((2, 4), ("data", "model"), device_type="cpu")
    res: dict = {}

    def gather(x: torch.Tensor) -> np.ndarray:
        return comm.all_gather(x[None], ("data", "model"), mesh=grid).numpy()

    def check(name, fn):
        try:
            res[name] = fn()
        except Exception:
            res[name] = traceback.format_exc()

    # the collectives on (2, 4): positions data-major
    def comm_checks():
        _, ranks = comm.group_of(("data", "model"), grid)
        _, model_ranks = comm.group_of("model", grid)
        blk = t["comm_x"][rank * 8:(rank + 1) * 8]
        kept = blk.clone()
        ops = (lambda b: comm.psum(b, "data", grid), lambda b: comm.all_to_all(b, "model", grid),
               lambda b: comm.ppermute(b, "model", [(i, (i + 1) % 4) for i in range(4)], grid),
               lambda b: comm.all_gather(b, "model", mesh=grid))
        untouched = []
        for op in ops:
            op(blk)
            untouched.append(torch.equal(blk, kept))
        return {
            "untouched": gather(torch.tensor(untouched)),
            "flat_ranks": np.array(ranks), "model_ranks": gather(torch.tensor(model_ranks)),
            "ppermute": gather(comm.ppermute(blk, "model", [(i, (i + 1) % 4) for i in range(4)],
                                             grid)),
            "ppermute_partial": gather(comm.ppermute(blk, ("data", "model"), [(0, 5), (5, 2)],
                                                     grid)),
            "all_to_all": gather(comm.all_to_all(blk, ("data", "model"), grid)),
            "psum": gather(comm.psum(blk, "data", grid)),
        }
    check("comm", comm_checks)

    def car():
        tree = {"b": t["car_b"][rank], "a": t["car_a"][rank]}
        out = compressed_allreduce(tree, flat, "data")
        one = concrete_mesh((WORLD, 1), ("data", "solo"), device_type="cpu")
        same = compressed_allreduce(tree, one, "solo")
        return {"a": gather(out["a"]), "b": gather(out["b"]),
                "keys": np.array([list(out) == ["b", "a"]]),
                "solo_is_tree": np.array([same is tree])}
    check("car", car)

    def quant():
        q, s = quantize_chunk(torch.tensor([0.5, 1.5, 2.5, -0.5, -2.5, 127.0]))
        return {"q": q.numpy(), "s": s.numpy()}
    check("quant", quant)

    def ef():
        g1, g2 = t["ef_g1"][rank], t["ef_g2"][rank]
        e = ErrorFeedback.init({"g": g1})
        c = ErrorFeedback.pre({"g": g1}, e)
        q = compressed_allreduce(c, flat, "data")
        e = ErrorFeedback.post(c, q)
        c2 = ErrorFeedback.pre({"g": g2}, e)
        return {"e1": gather(e["g"]), "c2": gather(c2["g"]), "q1": gather(q["g"])}
    check("ef", ef)

    def cm():
        ag = shard_map(lambda a, b: collective_matmul_ag(a, b, "data", flat), flat,
                       in_specs=((None, "data"), (None, "data")), out_specs=(None, "data"))
        rs = shard_map(lambda a, b: matmul_reduce_scatter(a, b, "data", flat), flat,
                       in_specs=((None, "data"), ("data", None)), out_specs=(None, "data"))
        out = {"ag": ag(t["cm_x"], t["cm_w"]).numpy(), "rs": rs(t["cm_x"], t["cm_w"]).numpy()}
        for name, fn in (("ag", ag), ("rs", rs)):  # gradients of sum(y * cot)
            x, w = (t[k].clone().requires_grad_() for k in ("cm_x", "cm_w"))
            (fn(x, w) * t["cm_cot"]).sum().backward()
            out[f"{name}_gx"], out[f"{name}_gw"] = x.grad.numpy(), w.grad.numpy()
        return out
    check("cm", cm)

    def pipe():
        pmesh = concrete_mesh((2, 4), ("data", "pipe"), device_type="cpu")
        pf = make_pipeline_fn(lambda wp, x: torch.tanh(x @ wp), pmesh, 4)
        out = pf(t["pipe_w"], t["pipe_x"])
        w, x = (t[k].clone().requires_grad_() for k in ("pipe_w", "pipe_x"))
        (pf(w, x) * t["pipe_cot"]).sum().backward()
        return {"out": out.numpy(), "all": gather(out), "gw": w.grad.numpy(),
                "gx": x.grad.numpy()}
    check("pipe", pipe)

    def smap():
        def scaled(x):
            return x * (10 * axis_index("data", grid) + axis_index("model", grid) + 1)

        both = shard_map(scaled, grid, in_specs=(("data", "model"),), out_specs=("data", "model"))
        folded = shard_map(lambda x: x * (axis_index(("data", "model"), grid) + 1), grid,
                           in_specs=((("data", "model"), None),),
                           out_specs=(("data", "model"), None))
        own = shard_map(lambda x: x.sum()[None], grid, in_specs=(("data", "model"),),
                        out_specs=())
        return {"both": both(t["sm_x"]).numpy(), "folded": folded(t["sm_t"]).numpy(),
                "own": gather(own(t["sm_x"]))}
    check("smap", smap)

    def train(case):
        import dataclasses

        from repro_torch.common.config import ShapeSpec
        from repro_torch.configs import get_arch, reduce_config
        from repro_torch.launch.mesh import sharded_step_vs_one_process
        from repro_torch.launch.steps import build_cell
        from repro_torch.models import moe_a2a
        from repro_torch.models import transformer as tf
        from repro_torch.train import make_train_step

        if case.startswith("dsv3"):
            rc = reduce_config(get_arch("deepseek-v3-671b")[0])
        else:
            rc = reduce_config(get_arch("gemma2-2b")[0]).replace(**TRAIN)
        cell = build_cell(rc, ShapeSpec(name="t", kind="train", seq_len=TRAIN_S,
                                        global_batch=TRAIN_B))
        # fp32 moments, and the cell's own int8 moments (deepseek-v3's)
        opt_cfg = dataclasses.replace(cell.opt_cfg, moment_dtype="int8" if case == "dsv3_int8"
                                      else "fp32")
        step = cell.step if case == "bf16" else make_train_step(
            lambda m, b: tf.lm_loss(m, rc, b, compute_dtype=torch.float32, remat="dots"),
            opt_cfg)
        calls = [0]
        a2a = moe_a2a.moe_ffn_a2a

        def counted(*a, **k):
            calls[0] += 1
            return a2a(*a, **k)

        moe_a2a.moe_ffn_a2a = counted
        try:
            out = sharded_step_vs_one_process(cell, step, opt_cfg, cell.init_fn(0, "cpu"),
                                              {k: t[k] for k in ("tokens", "labels")}, grid)
        finally:
            moe_a2a.moe_ffn_a2a = a2a
        out["a2a_calls"] = calls[0]
        out["moe_layers"] = sum(name.endswith("ffn.router") for name in out["leaves"])
        if case == "dsv3_int8":  # the moments' layout as the plan lays it out
            from repro_torch.common.sharding import sharding_for_shape
            from repro_torch.launch.dryrun import _opt_axes_like, opt_specs_like

            specs = opt_specs_like(cell.param_specs, opt_cfg)
            axes = _opt_axes_like(cell.param_axes, specs)
            out["planned"] = {
                name: {k: [str(p) for p in sharding_for_shape(ax[k], tuple(sp[k].shape), grid)]
                       for k in ("q", "scale")}
                for name, ax, sp in zip(sorted(cell.param_specs), axes.m, specs.m)}
        return out
    check("train_bf16", lambda: train("bf16"))
    check("train_fp32", lambda: train("fp32"))
    check("train_dsv3", lambda: train("dsv3"))
    check("train_dsv3_int8", lambda: train("dsv3_int8"))

    def int8_moments():
        """Two int8 AdamW updates of given gradients on the mesh against the
        same updates in one process, for three layouts: the fault's smallest
        input, a (4, 8) parameter split over data's 2 ranks; a last axis of
        1,792 split 448 a rank over model's 4 (blocks of 256 cut by the
        shards); and one of 1,000 split 250 a rank."""
        from torch.distributed.tensor import Replicate

        from repro_torch.common.config import OptimizerConfig
        from repro_torch.train.optimizer import adam_update, init_adam

        # no clipping: the global norm sums the shards in another order
        cfg = OptimizerConfig(moment_dtype="int8", warmup_steps=0, grad_clip=0.0)
        gen = torch.Generator().manual_seed(5)
        out = {}
        for name, shape, pl in (("rows", (4, 8), (Shard(0), Replicate())),
                                ("last448", (3, 1792), (Replicate(), Shard(1))),
                                ("last250", (2, 1000), (Shard(0), Shard(1)))):
            p0 = torch.randn(shape, generator=gen)
            gs = [torch.randn(shape, generator=gen) for _ in range(2)]
            plain, mesh_p = p0.clone(), distribute_tensor(p0.clone(), grid, pl)
            st, st_mesh = init_adam([plain], cfg), init_adam([mesh_p], cfg)
            for g in gs:  # two steps: the second dequantizes the first's moments
                adam_update([g], st, [plain], cfg)
                adam_update([distribute_tensor(g, grid, pl)], st_mesh, [mesh_p], cfg)
            out[name] = {
                "param_equal": torch.equal(mesh_p.full_tensor(), plain),
                "moments_equal": all(
                    torch.equal(getattr(st_mesh, k)[0][f].full_tensor(), getattr(st, k)[0][f])
                    for k in ("m", "v") for f in ("q", "scale")),
                "placements": [[str(p) for p in st_mesh.m[0][f].placements]
                               for f in ("q", "scale")]}
        return out
    check("int8_moments", int8_moments)

    def placement():
        from repro_torch.common.sharding import (abstract_like, logical_to_sharding,
                                                 shard_params, sharding_tree, with_sharding)
        from repro_torch.launch.mesh import make_host_mesh

        params = {"w": t["sm_x"], "b": {"v": t["sm_t"][:, 0]}}
        axes = {"w": ("embed", "mlp"), "b": {"v": ("batch",)}}
        placed = shard_params(params, axes, grid)
        tree = sharding_tree(axes, grid)
        moved = with_sharding(placed["w"], (None, "mlp"), grid)
        meta = abstract_like(params)
        host = make_host_mesh()
        return {
            "w_local": gather(placed["w"].to_local()), "v_local": gather(placed["b"]["v"].to_local()),
            "placements": np.array([str(tuple(placed["w"].placements)), str(tree["w"]),
                                    str(tree["b"]["v"]), str(tuple(moved.placements)),
                                    str(logical_to_sharding(("vocab", "embed"), grid))]),
            "moved_full": moved.full_tensor().numpy(),
            "meta": np.array([meta["w"].is_meta, tuple(meta["b"]["v"].shape) == (16,)]),
            "host_mesh": np.array([*host.shape, len(host.mesh_dim_names)]),
        }
    check("placement", placement)

    def reshard():
        x = torch.arange(64.0).reshape(8, 8)
        xs = distribute_tensor(x, flat, [Shard(0)])
        d_ = os.path.join(out_dir, "ckpt")
        save_checkpoint(d_, 1, {"x": xs})
        # (data, model) mesh, spec ("model", "data"): model on dim 0, data on dim 1
        out = restore_checkpoint(d_, 1, {"x": x},
                                 shardings={"x": NamedSharding(grid, (Shard(1), Shard(0)))})
        got = out["x"]
        return {"full": got.full_tensor().numpy(), "local": gather(got.to_local()),
                "placements": np.array([str(p) for p in got.placements])}
    check("reshard", reshard)
    return res


def _world(rank: int, world: int, inputs: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    res = _checks(rank, dict(np.load(inputs)), out_dir)
    if rank == 0:
        torch.save(res, os.path.join(out_dir, "world.pt"))


# ------------------------------------------------------------ the reference
REF = r"""
import sys, numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.common.sharding import concrete_mesh, shard_map
from repro.distributed import (ErrorFeedback, collective_matmul_ag, compressed_allreduce,
                               make_pipeline_fn, matmul_reduce_scatter, quantize_chunk)
d = dict(np.load(sys.argv[1] + "/inputs.npz"))
out = {}
flat = concrete_mesh((8,), ("data",))
grid = concrete_mesh((2, 4), ("data", "model"))
sm = lambda f, m, i, o: jax.jit(shard_map(f, mesh=m, in_specs=i, out_specs=o))
ax = ("data", "model")
x = jnp.asarray(d["comm_x"])
out["ppermute"] = sm(lambda b: jax.lax.ppermute(b, "model", [(i, (i + 1) % 4) for i in range(4)]),
                     grid, P(ax), P(ax))(x)
out["ppermute_partial"] = sm(lambda b: jax.lax.ppermute(b, ax, [(0, 5), (5, 2)]),
                             grid, P(ax), P(ax))(x)
out["all_to_all"] = sm(lambda b: jax.lax.all_to_all(b, ax, 0, 0, tiled=True), grid, P(ax), P(ax))(x)
out["psum"] = sm(lambda b: jax.lax.psum(b, "data"), grid, P(ax), P(ax))(x)
def car(a, b):
    o = compressed_allreduce({"b": b[0], "a": a[0]}, flat, "data")
    return o["a"][None], o["b"][None]
out["car_a"], out["car_b"] = sm(car, flat, (P("data"), P("data")), (P("data"), P("data")))(
    d["car_a"], d["car_b"])
q, s = quantize_chunk(jnp.asarray([0.5, 1.5, 2.5, -0.5, -2.5, 127.0], jnp.float32))
out["quant_q"], out["quant_s"] = q, s
def ef(g1, g2):
    e = ErrorFeedback.init({"g": g1[0]})
    c = ErrorFeedback.pre({"g": g1[0]}, e)
    qq = compressed_allreduce(c, flat, "data")
    e = ErrorFeedback.post(c, qq)
    c2 = ErrorFeedback.pre({"g": g2[0]}, e)
    return e["g"][None], c2["g"][None], qq["g"][None]
out["ef_e1"], out["ef_c2"], out["ef_q1"] = sm(ef, flat, (P("data"), P("data")),
                                              (P("data"),) * 3)(d["ef_g1"], d["ef_g2"])
out["cm_ag"] = sm(lambda a, b: collective_matmul_ag(a, b, "data"), flat,
                  (P(None, "data"), P(None, "data")), P(None, "data"))(d["cm_x"], d["cm_w"])
out["cm_rs"] = sm(lambda a, b: matmul_reduce_scatter(a, b, "data"), flat,
                  (P(None, "data"), P("data", None)), P(None, "data"))(d["cm_x"], d["cm_w"])
pmesh = jax.make_mesh((4,), ("pipe",), devices=jax.devices()[:4],
                      axis_types=(jax.sharding.AxisType.Auto,))
pf = make_pipeline_fn(lambda wp, x: jnp.tanh(x @ wp), pmesh, 4)
out["pipe"] = jax.jit(pf)(d["pipe_w"], d["pipe_x"])
out["pipe_gw"], out["pipe_gx"] = jax.jit(jax.grad(
    lambda w, x: jnp.sum(pf(w, x) * d["pipe_cot"]), argnums=(0, 1)))(d["pipe_w"], d["pipe_x"])
def scaled(x):
    return x * (10 * jax.lax.axis_index("data") + jax.lax.axis_index("model") + 1)
out["sm_both"] = sm(scaled, grid, P("data", "model"), P("data", "model"))(d["sm_x"])
out["sm_folded"] = sm(lambda x: x * (jax.lax.axis_index(ax) + 1), grid, P(ax, None),
                      P(ax, None))(d["sm_t"])
from repro.launch.mesh import mesh_config
out["mesh_cfg"], out["mesh_cfg_pod"] = mesh_config(False).shape, mesh_config(True).shape
np.savez(sys.argv[1] + "/ref.npz", **{k: np.asarray(v) for k, v in out.items()})
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from repro_torch.distributed.comm import run_world

    d = tmp_path_factory.mktemp("torch_distributed")
    np.savez(d / "inputs.npz", **_inputs())
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu", PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    ref = subprocess.Popen([sys.executable, "-c", REF, str(d)], env=env, text=True,
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    try:
        run_world(_world, WORLD, str(d / "inputs.npz"), str(d), backend="gloo", timeout_s=300.0)
    finally:
        out, err = ref.communicate(timeout=420)
    assert ref.returncode == 0, f"reference:\n{out}\n{err}"
    return torch.load(d / "world.pt", weights_only=False), dict(np.load(d / "ref.npz")), _inputs()


def _got(runs, name):
    res = runs[0][name]
    if isinstance(res, str):
        pytest.fail(f"check {name} raised in the world:\n{res}")
    return res


# ------------------------------------------------------------ collectives
def test_flattened_group_is_data_major(runs):
    got = _got(runs, "comm")
    assert got["flat_ranks"].tolist() == list(range(WORLD))
    assert got["model_ranks"].tolist() == [[0, 1, 2, 3]] * 4 + [[4, 5, 6, 7]] * 4


def test_collectives_leave_their_input_unchanged(runs):
    """psum, all_to_all, ppermute and all_gather read their input and
    write new tensors (a reduction in place would change the caller's)."""
    assert _got(runs, "comm")["untouched"].all()


@pytest.mark.parametrize("op", ["ppermute", "ppermute_partial", "all_to_all", "psum"])
def test_collectives_equal_lax(runs, op):
    got = _got(runs, "comm")[op].reshape(-1, 3)
    np.testing.assert_array_equal(got, runs[1][op])


# ------------------------------------------------------------ compression
def test_compressed_allreduce_equals_reference_bit_for_bit(runs):
    got = _got(runs, "car")
    for leaf in ("a", "b"):
        np.testing.assert_array_equal(got[leaf], runs[1][f"car_{leaf}"])


def test_compressed_allreduce_same_bits_on_every_rank_within_bar(runs):
    got = _got(runs, "car")
    for leaf in ("a", "b"):
        assert all(np.array_equal(got[leaf][r], got[leaf][0]) for r in range(WORLD))
        exact = runs[2][f"car_{leaf}"].sum(0)
        assert np.abs(got[leaf][0] - exact).max() / np.abs(exact).max() < 5e-2
    assert got["keys"].all()  # the tree keeps its own key order


def test_compressed_allreduce_one_rank_axis_returns_the_tree(runs):
    assert _got(runs, "car")["solo_is_tree"].all()


def test_quantize_chunk_rounds_half_to_even_as_reference(runs):
    got = _got(runs, "quant")
    np.testing.assert_array_equal(got["q"], runs[1]["quant_q"])
    np.testing.assert_array_equal(got["s"], runs[1]["quant_s"])


def test_error_feedback_equals_reference(runs):
    got = _got(runs, "ef")
    for k in ("e1", "c2", "q1"):
        np.testing.assert_array_equal(got[k], runs[1][f"ef_{k}"])


# ------------------------------------------------------------ collective matmul, pipeline
@pytest.mark.parametrize("fn", ["ag", "rs"])
def test_collective_matmul_equals_reference(runs, fn):
    got = _got(runs, "cm")[fn]
    x, w = runs[2]["cm_x"], runs[2]["cm_w"]
    np.testing.assert_allclose(got, runs[1][f"cm_{fn}"], atol=1e-4, rtol=0)
    np.testing.assert_allclose(got, x @ w, atol=1e-4, rtol=0)


@pytest.mark.parametrize("fn", ["ag", "rs"])
def test_collective_matmul_gradients(runs, fn):
    """Gradients of sum((x @ w) * cot) through the ring's ppermutes and the
    shard_map boundary: cot @ w.T and x.T @ cot, within 1e-4 (fp32)."""
    got = _got(runs, "cm")
    x, w, cot = runs[2]["cm_x"], runs[2]["cm_w"], runs[2]["cm_cot"]
    np.testing.assert_allclose(got[f"{fn}_gx"], cot @ w.T, atol=1e-4, rtol=0)
    np.testing.assert_allclose(got[f"{fn}_gw"], x.T @ cot, atol=1e-4, rtol=0)


def test_gpipe_gradients_equal_reference(runs):
    """Gradients of sum(y * cot) in the stacked stage weights and the
    microbatches, by the reverse schedule on a (data 2, pipe 4) mesh,
    against ``jax.grad`` of the reference's pipeline: within 1e-5 (fp32)."""
    got = _got(runs, "pipe")
    for k in ("gw", "gx"):
        want = runs[1][f"pipe_{k}"]
        assert np.abs(want).max() > 0, k
        np.testing.assert_allclose(got[k], want, atol=1e-5, rtol=0, err_msg=k)


def test_gpipe_equals_reference_and_sequential(runs):
    got = _got(runs, "pipe")
    ref = runs[2]["pipe_x"]
    for s in range(4):
        ref = np.tanh(ref @ runs[2]["pipe_w"][s])
    np.testing.assert_allclose(got["out"], runs[1]["pipe"], atol=1e-5, rtol=0)
    np.testing.assert_allclose(got["out"], ref, atol=1e-5, rtol=0)
    assert all(np.array_equal(got["all"][r], got["out"]) for r in range(WORLD))


# ------------------------------------------------------------ shard_map
@pytest.mark.parametrize("case", ["both", "folded"])
def test_shard_map_slices_and_reassembles_as_reference(runs, case):
    np.testing.assert_array_equal(_got(runs, "smap")[case], runs[1][f"sm_{case}"])


def test_shard_map_replicated_out_spec_returns_each_ranks_value(runs):
    x = runs[2]["sm_x"]
    want = [x[4 * (r // 4):4 * (r // 4) + 4, 3 * (r % 4):3 * (r % 4) + 3].sum()
            for r in range(WORLD)]
    np.testing.assert_allclose(_got(runs, "smap")["own"].reshape(-1), want, rtol=1e-6)


# ------------------------------------------------------------ DTensor train step
def _sharded(got):
    n_sharded, n = got["sharded"]
    assert n_sharded > n // 2  # the rules shard most leaves; no whole-model replica


def _close(got, k, rel):
    a, b = got[k]
    assert np.isfinite(a) and abs(a - b) <= rel * abs(b), (k, a, b)


def _params_within(got, share: float):
    """At least ``share`` of all parameter elements within 0.05 lr of the
    one-process step's, and every element within 2.05 lr: Adam's first
    step moves a parameter by lr times about the sign of its gradient, so
    a flipped sign is 2 lr apart, and fp32 rounding of the update about
    0.05 lr.  A skipped or sign-flipped update fails the share."""
    leaves, lr = got["leaves"].values(), got["lr"]
    n = sum(v["numel"] for v in leaves)
    assert sum(v["within"] * v["numel"] for v in leaves) >= share * n
    worst = max(v["param_diff"] for v in leaves)
    assert worst <= 2.05 * lr, (worst, lr)


def test_dtensor_train_step_fp32_equals_one_process_step(runs):
    """Reduced gemma2-2b, one AdamW step on a (2, 4) mesh by the production
    rules against the one-process step, at fp32 compute: only the order of
    the shards' reductions differs.  Loss and gradient norm within 1e-5
    relative; each leaf's gradient within 1e-5 of its largest element;
    every parameter within 5% of the step's lr (Adam's first step moves a
    parameter by about lr)."""
    got = _got(runs, "train_fp32")
    _close(got, "loss", 1e-5)
    _close(got, "grad_norm", 1e-5)
    for name, v in got["leaves"].items():
        assert v["grad_diff"] <= 1e-5 * v["grad_max"], (name, v)
        assert v["param_diff"] <= 0.05 * got["lr"], (name, v)
    _sharded(got)


def test_dtensor_train_step_bf16_cell_equals_one_process_step(runs):
    """The cell's own step (bf16 activations): loss within 1e-3 relative,
    gradient norm within 1e-2 relative (bf16 rounding in another order).
    A parameter's first Adam step flips where its gradient is bf16 noise:
    99% of the elements within 0.05 lr, every one within 2.05 lr."""
    got = _got(runs, "train_bf16")
    _close(got, "loss", 1e-3)
    _close(got, "grad_norm", 1e-2)
    _params_within(got, 0.99)
    _sharded(got)


def test_dtensor_train_step_deepseek_v3_through_the_all_to_all(runs):
    """Reduced deepseek-v3 (``moe_a2a``, bf16 weights), one AdamW step at
    fp32 compute on the (2, 4) mesh: every MoE layer takes the explicit
    all-to-all, forward and backward, and the step equals the one-process
    step (the grouped MoE path).  Loss and gradient norm within 1e-5
    relative; a leaf's gradient within 1e-5 (fp32 leaves) or 2e-2 (bf16
    leaves, about five of bf16's steps) of its largest element; 99.9% of
    the parameter elements within 0.05 lr, every one within 2.05 lr."""
    got = _got(runs, "train_dsv3")
    assert got["moe_layers"] > 0 and got["a2a_calls"] >= got["moe_layers"], got["a2a_calls"]
    _close(got, "loss", 1e-5)
    _close(got, "grad_norm", 1e-5)
    for name, v in got["leaves"].items():
        rel = 2e-2 if v["dtype"] == "bfloat16" else 1e-5
        assert v["grad_diff"] <= rel * v["grad_max"], (name, v)
    _params_within(got, 0.999)
    _sharded(got)


def test_dtensor_train_step_deepseek_v3_int8_moments(runs):
    """The same step with deepseek-v3's own int8 AdamW moments on the mesh:
    'q' and 'scale' are DTensors laid out as ``_opt_axes_like`` plans them,
    and the step equals the one-process int8 step to the fp32-moment case's
    tolerances; each leaf's first moment (dequantized) within 2e-2 of its
    largest element, the gradients' own bf16 tolerance."""
    got = _got(runs, "train_dsv3_int8")
    assert got["moe_layers"] > 0 and got["a2a_calls"] >= got["moe_layers"], got["a2a_calls"]
    _close(got, "loss", 1e-5)
    _close(got, "grad_norm", 1e-5)
    for name, v in got["leaves"].items():
        rel = 2e-2 if v["dtype"] == "bfloat16" else 1e-5
        assert v["grad_diff"] <= rel * v["grad_max"], (name, v)
        assert v["m_diff"] <= 2e-2 * v["m_max"], (name, v)
        assert v["m_placements"] == got["planned"][name], name
    # and some leaf's last axis is split: its scale is replicated where q is not
    assert any(v["m_placements"]["scale"] != v["m_placements"]["q"]
               for v in got["leaves"].values())
    _params_within(got, 0.999)
    _sharded(got)


@pytest.mark.parametrize("layout", ["rows", "last448", "last250"])
def test_int8_adam_moments_on_a_mesh_equal_one_process(runs, layout):
    """Two int8 AdamW updates of given gradients, on the mesh and in one
    process, are bit for bit equal: parameter, 'q' and 'scale' of both
    moments.  Blocks of 256 run along the global last axis, also where the
    shards cut them (448 or 250 columns a rank); 'q' takes the parameter's
    placements and 'scale' is replicated on the mesh dimensions that split
    the last axis."""
    got = _got(runs, "int8_moments")[layout]
    assert got["param_equal"] and got["moments_equal"], got
    q_pl, scale_pl = got["placements"]
    want_q = {"rows": ["S(0)", "R"], "last448": ["R", "S(1)"], "last250": ["S(0)", "S(1)"]}
    want_scale = {"rows": ["S(0)", "R"], "last448": ["R", "R"], "last250": ["S(0)", "R"]}
    short = lambda pl: [p.replace("Shard(dim=", "S(").replace("Replicate()", "R") for p in pl]
    assert short(q_pl) == want_q[layout] and short(scale_pl) == want_scale[layout], got


# ------------------------------------------------------------ placements
def test_specs_become_dtensor_placements(runs):
    """Logical axes by the production rules on (data 2, model 4): the
    reference's P("data", "model") for ("embed", "mlp") is Shard(0) on
    data and Shard(1) on model; a folded "batch" is data's alone here."""
    got = _got(runs, "placement")
    assert got["placements"].tolist() == [
        "(Shard(dim=0), Shard(dim=1))", "(Shard(dim=0), Shard(dim=1))",
        "(Shard(dim=0), Replicate())", "(Replicate(), Shard(dim=1))",
        "(Shard(dim=1), Shard(dim=0))"]
    x, v = runs[2]["sm_x"], runs[2]["sm_t"][:, 0]
    for r in range(WORLD):
        i, j = r // 4, r % 4
        np.testing.assert_array_equal(got["w_local"][r], x[4 * i:4 * i + 4, 3 * j:3 * j + 3])
        np.testing.assert_array_equal(got["v_local"][r], v[8 * i:8 * i + 8])
    np.testing.assert_array_equal(got["moved_full"], x)  # with_sharding keeps the value
    assert got["meta"].all()
    assert got["host_mesh"].tolist() == [1, WORLD, 2]


def test_mesh_config_equals_reference(runs):
    from repro_torch.launch.mesh import mesh_config, production_spec

    for multi_pod, key in ((False, "mesh_cfg"), (True, "mesh_cfg_pod")):
        cfg = mesh_config(multi_pod)
        assert list(cfg.shape) == runs[1][key].tolist()
        assert production_spec(multi_pod).axis_sizes == tuple(cfg.shape)


# ------------------------------------------------------------ elastic reshard
def test_checkpoint_elastic_reshard(runs):
    got = _got(runs, "reshard")
    x = np.arange(64.0).reshape(8, 8)
    np.testing.assert_array_equal(got["full"], x)
    assert got["placements"].tolist() == ["S(1)", "S(0)"]
    for r in range(WORLD):  # rank (data i, model j) holds rows of j, columns of i
        i, j = r // 4, r % 4
        np.testing.assert_array_equal(got["local"][r], x[2 * j:2 * j + 2, 4 * i:4 * i + 4])
