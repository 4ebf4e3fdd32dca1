"""The paper's system at web scale (``launch/dryrun_learned_index``) and the
dry run's shardings (``launch/dryrun``) against the reference, on the CPU.

``exhaustive_step`` and ``block_step`` run at a small size on the kernels'
plain versions, in this process and doc-sharded over a (data 2, model 2)
gloo world (a module-scoped fixture); the reference runs the same numpy
inputs once in a JAX subprocess.  Embeddings are small integers (exact in
bf16, their dot products exact in fp32) and thresholds half-integers, so
no logit ties its threshold and the words must agree word for word.
``shardings_for``'s per-rank shapes and bytes are held to the reference's
``NamedSharding(abstract_mesh(...), spec).shard_shape``, with no compile.
"""
import functools
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
N_DOCS, N_TERMS, E, T = 2048, 96, 16, 8
Q, C, W_BLK = 12, 320, 2  # queries; block_step's candidates; block words a term
GRID = {  # three cells of the grid: (arch, shape)
    "gemma2-2b": "train_4k", "deepseek-v3-671b": "train_4k", "dlrm-mlperf": "train_batch"}
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _inputs() -> dict:
    rng = np.random.default_rng(0)
    queries = rng.integers(0, N_TERMS, (Q, T)).astype(np.int32)
    queries[1, 5:] = -1  # pad terms
    queries[2, :] = -1  # an all-pad query
    queries[3, :2] = -1
    return {
        "term_embed": rng.integers(-2, 3, (N_TERMS, E)).astype(np.float32),
        "doc_embed": rng.integers(-2, 3, (N_DOCS, E)).astype(np.float32),
        # half-integers around the logits' spread: every term matches a share of docs
        "tau": (rng.integers(-4, 2, N_TERMS) + 0.5).astype(np.float32),
        "queries": queries,
        "block_maps": rng.integers(0, 2**32, (N_TERMS, W_BLK), dtype=np.uint64).astype(np.uint32),
        "cand_docs": rng.integers(0, N_DOCS, (Q, C)).astype(np.int32),
    }


def _params(d: dict) -> dict:
    return {k: torch.from_numpy(d[k]).to(torch.bfloat16 if k != "tau" else torch.float32)
            for k in ("term_embed", "doc_embed", "tau")}


# ------------------------------------------------------------ the world
def _world(rank: int, world: int, inputs: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    from repro_torch.common.sharding import concrete_mesh, shard_map
    from repro_torch.launch.dryrun_learned_index import exhaustive_step

    d = dict(np.load(inputs))
    p = _params(d)
    mesh = concrete_mesh((2, 2), ("data", "model"), device_type="cpu")
    try:
        # docs over data, terms and queries replicated; words reassembled over data
        step = shard_map(lambda te, de, tau, q: exhaustive_step(
            {"term_embed": te, "doc_embed": de, "tau": tau}, q), mesh,
            in_specs=((None, None), ("data", None), (None,), (None, None)),
            out_specs=(None, "data"))
        res = step(p["term_embed"], p["doc_embed"], p["tau"],
                   torch.from_numpy(d["queries"])).numpy()
    except Exception:
        res = traceback.format_exc()
    if rank == 0:
        torch.save(res, os.path.join(out_dir, "world.pt"))


# ------------------------------------------------------------ the reference
REF = r"""
import json, sys, numpy as np, jax, jax.numpy as jnp
jax.devices()  # the backend starts before the module below prepends its flags
import repro.launch.dryrun_learned_index as li
from jax.sharding import NamedSharding
from repro.common.sharding import abstract_mesh, spec_for_shape
from repro.configs import get_arch
from repro.launch import steps as ref_steps
from repro.launch.dryrun import _opt_axes_like
from repro.models import transformer as ref_tf
from repro.train import init_train_state
out_dir = sys.argv[1]
d = dict(np.load(out_dir + "/inputs.npz"))
MESHES = json.loads(sys.argv[2])
GRID = json.loads(sys.argv[3])
p = {k: jnp.asarray(d[k], jnp.bfloat16 if k != "tau" else jnp.float32)
     for k in ("term_embed", "doc_embed", "tau")}
full, li.N_DOCS_PAD = li.N_DOCS_PAD, d["doc_embed"].shape[0]  # its all-ones start
words = li.exhaustive_step(p, jnp.asarray(d["queries"]))
li.N_DOCS_PAD = full
anded, hits = li.block_step(p, jnp.asarray(d["queries"]), jnp.asarray(d["block_maps"]),
                            jnp.asarray(d["cand_docs"]))
np.savez(out_dir + "/ref.npz", words=np.asarray(words), anded=np.asarray(anded),
         hits=np.asarray(hits))

IS_AX = lambda x: isinstance(x, tuple) and all(isinstance(a, (str, type(None))) for a in x)
path_name = lambda path: ".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)

def shard(ax, shape, dtype, mesh, stacked=False):
    s = NamedSharding(mesh, spec_for_shape(ax, shape, mesh)).shard_shape(tuple(shape))
    s = list(s[1:] if stacked else s)
    return [s, int(np.prod(s)) * np.dtype(dtype).itemsize]

def lm_named(tree, cfg, is_leaf=None):
    # the reference's LMParams leaves under the port's names, stacked groups split
    _, n_groups, period = ref_tf._layer_split(cfg)
    out = {}
    def put(prefix, sub, stacked=False):
        for path, leaf in jax.tree_util.tree_leaves_with_path(sub, is_leaf=is_leaf):
            name = f"{prefix}.{path_name(path)}" if path else prefix
            out[name] = (leaf, stacked)
    put("embed", tree.embed)
    for i, sub in enumerate(tree.prefix):
        put(f"prefix.{i}", sub)
    for j, sub in enumerate(tree.stacked):
        for g in range(n_groups):
            put(f"stacked.{g * period + j}", sub, True)
    put("final_norm", tree.final_norm)
    if tree.lm_head is not None:
        put("lm_head", tree.lm_head)
    if tree.mtp is not None:
        put("mtp", tree.mtp)
    return out

res = {"li": {}, "grid": {}}
for mname, (shape, names) in MESHES.items():
    mesh = abstract_mesh(shape, names)
    specs = {**li.param_specs(),
             "queries": jax.ShapeDtypeStruct((li.Q_EXH, li.T), jnp.int32)}
    axes = {**li.PARAM_AXES, "queries": ("batch", None)}
    res["li"][mname + ":serve_queries"] = {n: shard(axes[n], s.shape, s.dtype, mesh)
                                           for n, s in specs.items()}
    specs = {**li.param_specs(),
             "queries": jax.ShapeDtypeStruct((li.Q_BLK, li.T), jnp.int32),
             "block_maps": jax.ShapeDtypeStruct((li.N_TERMS, -(-li.N_BLOCKS // 32)), jnp.uint32),
             "cand_docs": jax.ShapeDtypeStruct((li.Q_BLK, li.CAND_BLOCKS * li.BLOCK_SIZE),
                                               jnp.int32)}
    axes = {**li.PARAM_AXES, "queries": ("batch", None), "block_maps": ("terms", None),
            "cand_docs": ("batch", None)}
    res["li"][mname + ":serve_block"] = {n: shard(axes[n], s.shape, s.dtype, mesh)
                                         for n, s in specs.items()}

mesh = abstract_mesh(*MESHES["16x16"])
for arch, shape_name in GRID.items():
    cfg, shapes, _ = get_arch(arch)
    if cfg.family == "lm":
        box = {}
        def init(k):
            params, box["axes"] = ref_tf.init_lm(k, cfg, ref_steps._lm_param_dtype(cfg))
            return params
        specs = jax.eval_shape(init, jax.random.key(0))
        axes_tree, opt_cfg = box["axes"], ref_steps._lm_opt_cfg(cfg)
        named = lambda t, **kw: lm_named(t, cfg, **kw)
    else:
        cell = ref_steps.build_cell(cfg, next(s for s in shapes if s.name == shape_name))
        specs, axes_tree, opt_cfg = cell.param_specs, cell.param_axes, cell.opt_cfg
        named = lambda t, is_leaf=None: {path_name(p): (leaf, False) for p, leaf in
                                         jax.tree_util.tree_leaves_with_path(t, is_leaf=is_leaf)}
    opt = jax.eval_shape(lambda q: init_train_state(q, opt_cfg), specs)
    opt_axes = _opt_axes_like(axes_tree, opt)
    cell_out = {}
    for part, tree, ax_tree in (("params", specs, axes_tree), ("m", opt.m, opt_axes.m),
                                ("v", opt.v, opt_axes.v)):
        leaves, axes = named(tree), named(ax_tree, is_leaf=IS_AX)
        cell_out[part] = {n: shard(axes[n][0], leaf.shape, leaf.dtype, mesh, stacked)
                          for n, (leaf, stacked) in leaves.items()}
    res["grid"][arch] = cell_out
with open(out_dir + "/ref.json", "w") as f:
    json.dump(res, f)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from repro_torch.distributed.comm import run_world

    d = tmp_path_factory.mktemp("torch_dryrun_li")
    np.savez(d / "inputs.npz", **_inputs())
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu", PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    ref = subprocess.Popen([sys.executable, "-c", REF, str(d), json.dumps(MESHES),
                            json.dumps(GRID)],
                           env=env, text=True, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    try:
        run_world(_world, 4, str(d / "inputs.npz"), str(d), backend="gloo", timeout_s=300.0)
    finally:
        out, err = ref.communicate(timeout=420)
    assert ref.returncode == 0, f"reference:\n{out}\n{err}"
    with open(d / "ref.json") as f:
        shards = json.load(f)
    return torch.load(d / "world.pt", weights_only=False), dict(np.load(d / "ref.npz")), shards


def _u32(x: torch.Tensor) -> np.ndarray:
    return x.numpy().view(np.uint32)


# ------------------------------------------------------------ the steps
def test_exhaustive_step_equals_reference_word_for_word(runs):
    from repro_torch.launch.dryrun_learned_index import exhaustive_step

    d = _inputs()
    words = _u32(exhaustive_step(_params(d), torch.from_numpy(d["queries"])))
    np.testing.assert_array_equal(words, runs[1]["words"])
    assert (words[2] == 0xFFFFFFFF).all()  # the all-pad query matches every doc
    assert 0 < np.unpackbits(words.view(np.uint8)).mean() < 1


def test_exhaustive_step_doc_sharded_over_the_world_equals_reference(runs):
    got = runs[0]
    if isinstance(got, str):
        pytest.fail(f"the world raised:\n{got}")
    np.testing.assert_array_equal(got.view(np.uint32), runs[1]["words"])


def test_block_step_equals_reference(runs):
    from repro_torch.launch.dryrun_learned_index import block_step

    d = _inputs()
    anded, hits = block_step(_params(d), torch.from_numpy(d["queries"]),
                             torch.from_numpy(d["block_maps"].view(np.int32)),
                             torch.from_numpy(d["cand_docs"]))
    np.testing.assert_array_equal(_u32(anded), runs[1]["anded"])
    np.testing.assert_array_equal(hits.numpy(), runs[1]["hits"])
    assert 0 < hits.float().mean() < 1


def test_exhaustive_step_scores_on_the_kernel_wrappers(monkeypatch):
    """One membership call over the valid slots, one bitset call for the AND."""
    from repro_torch.launch import dryrun_learned_index as li

    calls = []
    for name in ("membership_bitmask", "block_candidates"):
        real = getattr(li, name)
        monkeypatch.setattr(li, name, lambda *a, _r=real, _n=name, **k: (calls.append(
            (_n, tuple(a[0].shape))), _r(*a, **k))[1])
    d = _inputs()
    li.exhaustive_step(_params(d), torch.from_numpy(d["queries"]))
    n_valid = int((d["queries"] >= 0).sum())
    assert calls == [("membership_bitmask", (n_valid, E)), ("block_candidates", (1, 1))]


# ------------------------------------------------------------ shardings
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("cell", ["serve_queries", "serve_block"])
def test_learned_index_cells_per_rank_shapes_equal_reference(runs, mesh, cell):
    from repro_torch.launch.dryrun_learned_index import run

    rec = next(r for r in run(mesh == "2x16x16") if r["shape"] == cell)
    want = runs[2]["li"][f"{mesh}:{cell}"]
    assert set(rec["args"]) == set(want)
    for name, (shape, nbytes) in want.items():
        assert rec["args"][name]["shard_shape"] == shape, name
        assert rec["args"][name]["bytes"] == nbytes, name
    assert rec["argument_bytes"] == sum(b for _, b in want.values())
    assert rec["mesh"] == mesh and rec["n_devices"] == np.prod(MESHES[mesh][0])


def test_main_writes_both_cells(tmp_path):
    from repro_torch.launch.dryrun_learned_index import main

    out = tmp_path / "li.json"
    main(["--out", str(out)])
    recs = json.loads(out.read_text())
    assert [r["shape"] for r in recs] == ["serve_queries", "serve_block"]
    # one rank's 3,138,816 x 128 bf16 doc shard
    assert recs[0]["args"]["doc_embed"]["shard_shape"] == [3_138_816, 128]
    assert recs[0]["args"]["doc_embed"]["bytes"] == 3_138_816 * 128 * 2


@functools.cache
def _port_grid(arch: str):
    from repro_torch.common.sharding import abstract_mesh
    from repro_torch.configs import get_arch
    from repro_torch.launch import dryrun
    from repro_torch.launch.steps import build_cell

    cfg, shapes, _ = get_arch(arch)
    cell = build_cell(cfg, next(s for s in shapes if s.name == GRID[arch]))
    mesh = abstract_mesh(*MESHES["16x16"])
    opt = dryrun.opt_specs_like(cell.param_specs, cell.opt_cfg)
    params = dryrun.shardings_for(cell.param_axes, cell.param_specs, mesh)
    state = dryrun.shardings_for(dryrun._opt_axes_like(cell.param_axes, opt), opt, mesh)
    out = {"params": {n: [list(s.shard_shape), s.bytes] for n, s in params.items()}}
    for part in ("m", "v"):
        out[part] = {}
        for name, leaf in zip(sorted(cell.param_specs), getattr(state, part)):
            if isinstance(leaf, dict):  # an int8 moment: values and scales
                out[part].update({f"{name}.{k}": [list(s.shard_shape), s.bytes]
                                  for k, s in leaf.items()})
            else:
                out[part][name] = [list(leaf.shard_shape), leaf.bytes]
    return out


def _with_row_sharded_tables(arch: str, want: dict) -> dict:
    """The reference's per-rank shards with the port's one departure: an
    embedding table whose vocabulary the model axis (16) does not divide
    is row-sharded as ``torch.chunk`` splits it (rank 0 holds ceil(V / 16)
    rows) where the reference replicates it (``sharding.UNEVEN``)."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.steps import build_cell

    cfg, shapes, _ = get_arch(arch)
    cell = build_cell(cfg, next(s for s in shapes if s.name == GRID[arch]))
    out = dict(want)
    for name, axes in cell.param_axes.items():
        if axes[0] != "table_vocab":
            continue
        v, dim = cell.param_specs[name].shape
        if v % 16 and v >= 16:
            rows = -(-v // 16)
            assert want[name] == [[v, dim], v * dim * 4], name  # the reference replicates it
            out[name] = [[rows, dim], rows * dim * 4]
    return out


@pytest.mark.parametrize("arch", list(GRID))
def test_grid_cell_param_shards_equal_reference(runs, arch):
    got, want = _port_grid(arch)["params"], runs[2]["grid"][arch]["params"]
    assert got == _with_row_sharded_tables(arch, want)


@pytest.mark.parametrize("arch", list(GRID))
def test_grid_cell_optimizer_shards_equal_reference(runs, arch):
    got, want = _port_grid(arch), runs[2]["grid"][arch]
    for part in ("m", "v"):
        assert got[part] == _with_row_sharded_tables(arch, want[part]), part
    if arch.startswith("deepseek-v3"):  # int8 moments: 'q' mirrors the param, 'scale' drops
        assert any(n.endswith(".scale") for n in got["m"])
