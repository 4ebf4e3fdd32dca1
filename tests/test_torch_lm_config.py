"""The port's config registry, cells and logical sharding rules against the
reference's, on the CPU.  Everything here is exact: configs field for
field, parameter shapes and dtypes leaf for leaf at full width (the port's
from the meta device, the reference's from ``jax.eval_shape``), logical
axes and the mesh specs they resolve to."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common import sharding as ref_sharding
from repro.configs import ARCH_IDS as REF_ARCH_IDS
from repro.configs import get_arch as ref_get_arch
from repro.configs import reduce_config as ref_reduce
from repro.configs import shapes as ref_shapes
from repro.launch import steps as ref_steps
from repro.models import transformer as ref_tf
from repro_torch.common import sharding
from repro_torch.common.config import ShapeSpec
from repro_torch.common.sharding import DEFAULT_RULES, abstract_mesh, resolve_axis, spec_for_shape
from repro_torch.configs import ARCH_IDS, _MODULES, get_arch, reduce_config, shapes
from repro_torch.launch import steps
from repro_torch.models import transformer as tf

LM_ARCHS = [a for a in ARCH_IDS if get_arch(a)[0].family == "lm"]
ALL_IDS = list(_MODULES)
TRAIN = ShapeSpec(name="train_4k", kind="train", seq_len=4096, global_batch=256)


def _fields(cfg):
    return dataclasses.asdict(cfg)


def test_registry_names_the_same_archs():
    assert ARCH_IDS == REF_ARCH_IDS
    assert len(LM_ARCHS) == 5
    assert all(m.startswith("repro_torch.configs.") for m in _MODULES.values())


@pytest.mark.parametrize("arch_id", ALL_IDS)
def test_config_shapes_and_skips_equal_reference(arch_id):
    cfg, shp, skip = get_arch(arch_id)
    rcfg, rshp, rskip = ref_get_arch(arch_id)
    assert _fields(cfg) == _fields(rcfg)
    assert [_fields(s) for s in shp] == [_fields(s) for s in rshp]
    assert skip == rskip
    assert _fields(reduce_config(cfg)) == _fields(ref_reduce(rcfg))
    assert _fields(steps.skeleton(cfg)) == _fields(ref_steps.skeleton(rcfg))
    assert cfg.resolved_head_dim == rcfg.resolved_head_dim


def test_shape_sets_equal_reference():
    for name in ("LM_SHAPES", "GNN_SHAPES", "RECSYS_SHAPES"):
        assert [_fields(s) for s in getattr(shapes, name)] == \
            [_fields(s) for s in getattr(ref_shapes, name)]


def _ref_named(tree, cfg):
    """The reference's LMParams leaves under the port's state-dict names,
    the stacked group axis split off (entry g * period + j)."""
    _, n_groups, period = ref_tf._layer_split(cfg)
    out = {}

    def put(prefix, sub, g=None):
        for path, leaf in jax.tree_util.tree_leaves_with_path(sub):
            name = ".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
            out[f"{prefix}.{name}"] = leaf if g is None else (g, leaf)

    put("embed", tree.embed)
    for i, p in enumerate(tree.prefix):
        put(f"prefix.{i}", p)
    for j, p in enumerate(tree.stacked):
        for g in range(n_groups):
            put(f"stacked.{g * period + j}", p, g)
    put("final_norm", tree.final_norm)
    if tree.lm_head is not None:
        put("lm_head", tree.lm_head)
    if tree.mtp is not None:
        put("mtp", tree.mtp)
    return out


def _leaf(entry):
    return entry[1] if isinstance(entry, tuple) and len(entry) == 2 and isinstance(entry[0], int) \
        else entry


def _ref_init_shapes(rcfg, dtype):
    """(LMParams of ShapeDtypeStructs, logical-axes LMParams) of the
    reference's init_lm, traced once without allocating."""
    box = {}

    def init(k):
        params, box["axes"] = ref_tf.init_lm(k, rcfg, dtype)
        return params

    return jax.eval_shape(init, jax.random.key(0)), box["axes"]


@pytest.mark.parametrize("arch_id", LM_ARCHS)
def test_full_width_param_specs_and_axes_equal_reference(arch_id):
    cfg, rcfg = get_arch(arch_id)[0], ref_get_arch(arch_id)[0]
    cell = steps.lm_cell(cfg, TRAIN)
    pdtype = ref_steps._lm_param_dtype(rcfg)
    assert str(steps._lm_param_dtype(cfg)).removeprefix("torch.") == jnp.dtype(pdtype).name
    ref_tree, ref_axes = _ref_init_shapes(rcfg, pdtype)
    ref_specs = _ref_named(ref_tree, rcfg)
    assert set(cell.param_specs) == set(ref_specs)
    for name, entry in ref_specs.items():
        leaf = _leaf(entry)
        shape = leaf.shape[1:] if isinstance(entry, tuple) else leaf.shape
        spec = cell.param_specs[name]
        assert spec.shape == tuple(shape), name
        assert str(spec.dtype).removeprefix("torch.") == str(leaf.dtype), name
    n = sum(int(np.prod(s.shape)) for s in cell.param_specs.values())
    assert n == sum(int(np.prod(leaf.shape)) for leaf in jax.tree.leaves(ref_tree))
    if arch_id == "gemma2-2b":
        assert n == 2_614_341_888
    # logical axes: the reference's, less the stacked 'layers' axis
    assert set(cell.param_axes) == set(ref_specs)
    for name, axes in cell.param_axes.items():
        assert axes == _ref_axes_of(name, ref_axes, rcfg), name
    assert cell.opt_cfg.moment_dtype == ref_steps._lm_opt_cfg(rcfg).moment_dtype


def _ref_axes_of(name, ref_axes, rcfg):
    """Logical axes the reference gives the leaf the port calls ``name``."""
    head, *rest = name.split(".")
    _, _, period = ref_tf._layer_split(rcfg)
    is_ax = lambda x: isinstance(x, tuple) and all(isinstance(a, (str, type(None))) for a in x)
    if head in ("prefix", "stacked"):
        i, rest = int(rest[0]), rest[1:]
        node = ref_axes.prefix[i] if head == "prefix" else ref_axes.stacked[i % period]
    else:
        node = getattr(ref_axes, head)
    for k in rest:
        node = node[k]
    assert is_ax(node)
    if head == "stacked":
        assert node[0] == "layers"
        return tuple(node[1:])
    return tuple(node)


@pytest.mark.parametrize("arch_id", LM_ARCHS)
def test_sharding_specs_of_every_leaf_equal_reference(arch_id):
    cfg = get_arch(arch_id)[0]
    cell = steps.lm_cell(cfg, TRAIN)
    for shape, names in (((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model"))):
        mesh = abstract_mesh(shape, names)
        ref_mesh = ref_sharding.abstract_mesh(shape, names)
        for name, axes in cell.param_axes.items():
            dims = cell.param_specs[name].shape
            got = spec_for_shape(axes, dims, mesh)
            # the stacked leaves carry a leading 'layers' axis (never sharded) there
            want = tuple(ref_sharding.spec_for_shape(axes, dims, ref_mesh))
            assert got == want, (name, got, want)
            assert sharding.partition_spec(axes, mesh) == \
                tuple(ref_sharding.partition_spec(axes, ref_mesh))
            if name.startswith("stacked."):
                stacked = tuple(ref_sharding.spec_for_shape(("layers", *axes), (13, *dims), ref_mesh))
                assert stacked == (None, *got)


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_serve_cells_and_cache_specs_equal_reference(kind):
    cfg, rcfg = get_arch("gemma2-2b")[0], ref_get_arch("gemma2-2b")[0]
    shape = ShapeSpec(name=f"{kind}_32k", kind=kind, seq_len=32768, global_batch=128)
    cell = steps.build_cell(cfg, shape)
    assert cell.kind == kind and cell.opt_cfg is None
    if kind == "prefill":
        assert cell.input_specs == {"tokens": (( 128, 32768), torch.int32)}
        return
    # the reference stacks each period position over its groups
    ref_caches = jax.eval_shape(lambda: ref_tf.init_cache(rcfg, 128, 32768, jnp.bfloat16))
    ref_axes = ref_steps._cache_axes(rcfg, ref_caches)[-1]
    _, n_groups, period = ref_tf._layer_split(rcfg)
    want = [(tuple(kv.k.shape[1:]), tuple(kv.v.shape[1:]))
            for _ in range(n_groups) for kv in ref_caches[-1]]
    assert tf.cache_spec(cfg, 128, 32768) == want
    assert [(c.k.shape, c.v.shape) for c in cell.input_specs["caches"]] == want
    assert all(c.k.dtype == torch.bfloat16 for c in cell.input_specs["caches"])
    for i, ax in enumerate(cell.input_axes["caches"]):
        assert ax.k == tuple(ref_axes[i % period].k[1:]) == ("batch", "seq_sharded", None, None)
        assert ax.v == tuple(ref_axes[i % period].v[1:])


@pytest.mark.parametrize("arch_id", ["meshgraphnet", "dlrm-mlperf"])
def test_build_cell_refuses_the_next_slices_families(arch_id):
    """The GNN and recsys families, refused until their slice, are built
    now (``tests/test_torch_gnn.py``, ``tests/test_torch_recsys_cells.py``
    hold them to the reference); only a family no module serves is refused."""
    cfg, shp, _ = get_arch(arch_id)
    cell = steps.build_cell(cfg, shp[0])
    assert cell.kind == "train" and cell.param_specs
    with pytest.raises(ValueError):
        steps.build_cell(dataclasses.replace(cfg, family="vision"), shp[0])


# ------------------------------------------------ the reference's sharding tests
@pytest.fixture(scope="module")
def mesh():
    return abstract_mesh((16, 16), ("data", "model"))


@pytest.fixture(scope="module")
def pod_mesh():
    return abstract_mesh((2, 16, 16), ("pod", "data", "model"))


def test_basic_resolution(mesh):
    assert spec_for_shape(("batch", None), (256, 4), mesh) == ("data", None)
    assert spec_for_shape(("embed", "mlp"), (2048, 8192), mesh) == ("data", "model")


def test_divisibility_fallback_replicates(mesh):
    assert spec_for_shape(("embed", "kv_heads", None), (2048, 1, 256), mesh) == ("data", None, None)
    assert spec_for_shape((None, "heads", None), (2048, 24, 128), mesh) == (None, None, None)


def test_axis_dedup_first_claim_wins(mesh):
    spec = spec_for_shape(("experts", "embed", "mlp"), (256, 7168, 2048), mesh)
    assert spec == (("data", "model"), None, None)


def test_fallback_chain_heads_then_seq(mesh):
    spec = spec_for_shape(("batch", "heads", "seq_sharded", None), (16, 24, 4096, 4096), mesh)
    assert spec == ("data", None, "model", None)
    spec = spec_for_shape(("batch", "heads", "seq_sharded", None), (16, 32, 4096, 4096), mesh)
    assert spec == ("data", "model", None, None)


def test_partial_tuple_drop(mesh):
    assert spec_for_shape(("edges",), (16 * 3,), mesh) == ("data",)


def test_multi_pod_batch_folds_pod(pod_mesh):
    assert spec_for_shape(("batch", None), (256, 4), pod_mesh) == (("pod", "data"), None)


def test_empty_axes_scalar(mesh):
    assert spec_for_shape((), (), mesh) == ()


def test_resolve_axis_missing_mesh_axis(mesh):
    assert resolve_axis("batch", mesh) == "data"
    assert resolve_axis(None, mesh) is None


def test_rules_cover_all_model_axes():
    used_by_models = {
        "batch", "embed", "vocab", "heads", "kv_heads", "mlp", "experts",
        "seq_sharded", "layers", "nodes", "edges", "table_vocab", "candidates",
        "docs", "terms", "blocks",
    }
    assert used_by_models <= set(k for k in DEFAULT_RULES if k is not None)
    assert DEFAULT_RULES == ref_sharding.DEFAULT_RULES


def test_constrain_is_the_identity_in_one_process():
    x = torch.arange(6.0).reshape(2, 3)
    assert sharding.constrain(x, "batch", None) is x
    with pytest.raises(ValueError, match="align"):
        abstract_mesh((16,), ("data", "model"))
