"""The port's recsys cells, their top-100 and the training launcher against
the reference, on the CPU.

Everything here is exact: parameter and input shapes, dtypes and logical
axes at full width (the port's from the meta device, the reference's from
``jax.eval_shape``); the retrieval cell's top-100 ids and values, ties to
the lower index, on scores with planted ties (exact copies of one score,
so the two packages' fp32 rounding cannot reorder them); every cell of
every arch built; kill-and-resume bit for bit.  The reduced cells' steps
are held to finite outputs, the reference smoke test's bar.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.launch import steps as ref_steps
from repro.models import recsys as ref_rec
from repro_torch.checkpoint import latest_step
from repro_torch.common.config import ShapeSpec
from repro_torch.configs import ARCH_IDS, get_arch, reduce_config
from repro_torch.configs.shapes import RECSYS_SHAPES
from repro_torch.launch import steps
from repro_torch.launch.train import main as train_main
from repro_torch.models import recsys
from repro_torch.models.moe import top_k_lowest_index
from repro_torch.train import init_train_state
from test_torch_recsys import _pair, path_name

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["dlrm-mlperf", "fm", "bst", "mind"]
# the reference smoke test's shapes (tests/test_models.py:20-28)
SMALL = {
    "rec_train": ShapeSpec(name="train_batch", kind="train", global_batch=16),
    "rec_serve": ShapeSpec(name="serve_p99", kind="serve", global_batch=8),
    "rec_ret": ShapeSpec(name="retrieval_cand", kind="retrieval", global_batch=1,
                         n_candidates=300),
}
IS_AX = lambda x: isinstance(x, tuple) and all(isinstance(a, (str, type(None))) for a in x)


@pytest.mark.parametrize("shape", RECSYS_SHAPES, ids=lambda s: s.name)
@pytest.mark.parametrize("arch", ARCHS)
def test_recsys_cell_equals_reference(arch, shape):
    cfg, rcfg = get_arch(arch)[0], ref_get_arch(arch)[0]
    cell, ref = steps.build_cell(cfg, shape), ref_steps.build_cell(rcfg, shape)
    assert cell.kind == ref.kind == shape.kind
    assert (cell.opt_cfg is None) == (ref.opt_cfg is None)
    want = {path_name(p): leaf for p, leaf in jax.tree_util.tree_leaves_with_path(ref.param_specs)}
    assert set(cell.param_specs) == set(want)
    for n, leaf in want.items():
        assert cell.param_specs[n].shape == leaf.shape and cell.param_specs[n].dtype == torch.float32
    assert cell.param_axes == {path_name(p): tuple(a) for p, a in
                               jax.tree_util.tree_leaves_with_path(ref.param_axes, is_leaf=IS_AX)}
    assert {k: (s.shape, str(s.dtype).removeprefix("torch.")) for k, s in cell.input_specs.items()} \
        == {k: (s.shape, str(s.dtype)) for k, s in ref.input_specs.items()}
    assert cell.input_axes == ref.input_axes


def test_every_cell_of_every_arch_builds():
    """build_cell on every shape of every arch's SHAPES but its SKIP_SHAPES
    (allocation-free: parameters from the meta device)."""
    built = 0
    for arch in ARCH_IDS:
        cfg, shapes, skips = get_arch(arch)
        for shape in shapes:
            if shape.name in skips:
                continue
            cell = steps.build_cell(cfg, shape)
            assert cell.kind == shape.kind and cell.param_specs and \
                set(cell.param_axes) == set(cell.param_specs), (arch, shape.name)
            built += 1
    ref = sum(len(shapes) - len(skips) for shapes, skips in
              (ref_get_arch(a)[1:] for a in ARCH_IDS))
    assert built == ref == 38  # the 40-cell grid less its two skips


@pytest.mark.parametrize("arch", ARCHS)
def test_small_cells_step_finite_and_axes_match_names(arch):
    """The reference smoke test's recsys cases (train, serve, retrieval), on
    the port."""
    rc = reduce_config(get_arch(arch)[0])
    rng = np.random.default_rng(11)
    for case, sh in SMALL.items():
        cell = steps.build_cell(rc, sh)
        model = cell.init_fn(0, "cpu")
        assert list(dict(model.named_parameters())) == list(cell.param_axes)
        batch = {k: torch.from_numpy(
            rng.integers(0, 3, s.shape).astype(np.int32) if s.dtype == torch.int32
            else rng.integers(0, 2, s.shape).astype(np.float32) if "label" in k
            else rng.standard_normal(s.shape).astype(np.float32)) for k, s in cell.input_specs.items()}
        if cell.kind == "train":
            m = cell.step(model, init_train_state(model, cell.opt_cfg), batch)
            assert np.isfinite(float(m["loss"])) and np.isfinite(float(m["grad_norm"]))
            continue
        out = cell.step(model, batch)
        outs = out if isinstance(out, tuple) else (out,)
        assert all(torch.isfinite(o.float()).all() for o in outs), case
        if cell.kind == "retrieval":
            assert out[0].shape == out[1].shape == (100,)


def test_top_k_lowest_index_equals_lax_top_k_with_planted_ties():
    rng = np.random.default_rng(7)
    scores = rng.integers(0, 9, (3, 1000)).astype(np.float32) * 0.25  # 9 values, ~110 copies each
    scores[1, ::7] = -0.5
    scores[2] = np.float32(1.5)  # all tied
    want_v, want_i = jax.lax.top_k(jnp.asarray(scores), 100)
    got_v, got_i = top_k_lowest_index(torch.from_numpy(scores), 100)
    assert np.array_equal(got_i.numpy(), np.asarray(want_i))
    assert np.array_equal(got_v.numpy(), np.asarray(want_v))
    assert np.array_equal(got_i[2].numpy(), np.arange(100))


@pytest.mark.parametrize("arch", ARCHS)
def test_retrieval_cell_top100_equals_reference_with_planted_ties(arch):
    """The retrieval cell on 600 candidates drawn from 20 ids, so each id's
    copies tie: its top-100 is ``lax.top_k`` of its own scores, ids and
    values exactly, and its scores are the reference's (1e-5 / 1e-4).  Where
    both packages score every copy of an id alike (FM's and MIND's
    per-candidate products), the ids and values are the reference cell's
    exactly; DLRM's and BST's MLPs run on the CPU as a GEMM whose edge
    rows sum in another order, so there the copies lie an ulp apart."""
    rc, tc, params, model = _pair(arch)
    shape = ShapeSpec(name="retrieval_cand", kind="retrieval", global_batch=1, n_candidates=600)
    cell, ref = steps.build_cell(tc, shape), ref_steps.build_cell(rc, shape)
    rng = np.random.default_rng(9)
    batch = {k: rng.integers(-1, 5, s.shape).astype(np.int32) if s.dtype == torch.int32
             else rng.standard_normal(s.shape).astype(np.float32)
             for k, s in cell.input_specs.items()}
    batch["candidates"] = rng.integers(0, 20, 600).astype(np.int32)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    got_v, got_i = cell.step(model, tb)
    with torch.no_grad():
        scores = recsys.RETRIEVAL[arch](model, tc, {k: v for k, v in tb.items()
                                                    if k != "candidates"}, tb["candidates"])
    want_v, want_i = jax.lax.top_k(jnp.asarray(scores.numpy()), 100)
    assert np.array_equal(got_i.numpy(), np.asarray(want_i))
    assert np.array_equal(got_v.numpy(), np.asarray(want_v))
    rest = {k: v for k, v in batch.items() if k != "candidates"}
    ref_scores = np.asarray(jax.jit(lambda p, b, c: ref_rec.RETRIEVAL[arch](p, rc, b, c))(
        params, rest, batch["candidates"]))
    np.testing.assert_allclose(scores.numpy(), ref_scores, atol=1e-5, rtol=1e-4)
    ref_v, ref_i = jax.jit(ref.step)(params, batch)
    if arch in ("fm", "mind"):
        assert np.array_equal(got_i.numpy(), np.asarray(ref_i))
        assert all(np.ptp(scores.numpy()[batch["candidates"] == u]) == 0
                   for u in np.unique(batch["candidates"]))
    else:  # the same ids, up to the order within each id's copies
        assert np.array_equal(np.sort(batch["candidates"][got_i.numpy()]),
                              np.sort(batch["candidates"][np.asarray(ref_i)]))
    np.testing.assert_allclose(got_v.numpy(), np.asarray(ref_v), atol=1e-5, rtol=1e-4)
    # ties were planted, and went to the lower index
    v, i = got_v.numpy(), got_i.numpy()
    assert len(set(batch["candidates"][i].tolist())) < 100
    assert all(i[j] < i[j + 1] for j in range(99) if v[j] == v[j + 1])


def test_launcher_kill_and_resume_is_bit_for_bit(tmp_path):
    """``python -m repro_torch.launch.train --arch fm --reduced`` killed after 2
    steps (a subprocess) and resumed to 4 in this process, against 4 steps
    straight: the same parameters and moments, bit for bit."""
    args = ["--arch", "fm", "--reduced", "--device", "cpu", "--batch", "64"]
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
    sd = resumed.state_dict()
    assert sd["w0"].shape == () and len([n for n in sd if n.startswith("tables.")]) == 39
    for name, p in straight.state_dict().items():
        assert torch.equal(p, sd[name]), name
    for a, b in zip(opt_a.m + opt_a.v, opt_b.m + opt_b.v):
        assert torch.equal(a, b)
