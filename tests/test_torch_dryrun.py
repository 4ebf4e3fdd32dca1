"""The port's grid dry-run (``repro_torch.launch.dryrun``: ``dryrun_cell``,
``run_all``, ``main``) on the CPU, at reduced configs on the production
16x16 mesh of a fake world, against the reference's ``dryrun_cell``.

One subprocess runs the reference's dry run of reduced gemma2-2b's
``train_4k`` and ``prefill_32k`` cells (``get_arch`` patched inside it to
the reduced config, the JAX package untouched) while this process runs the
port's cells; each check is its own test case.
"""
import json
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.join(os.path.dirname(__file__), "..")
SRC = os.path.join(ROOT, "src")

# a reduced cell of each family, gemma2-2b's two the reference also runs
CELLS = [("gemma2-2b", "train_4k"), ("gemma2-2b", "prefill_32k"),
         ("deepseek-v3-671b", "prefill_32k"), ("dlrm-mlperf", "train_batch"),
         ("meshgraphnet", "molecule")]
MEMORY_KEYS = {"argument_bytes", "output_bytes", "temp_bytes", "alias_bytes", "code_bytes"}
COLLECTIVE_KINDS = {"all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                    "collective-permute"}

REF = r"""
import json, sys
import repro.launch.dryrun as D
from repro.configs import get_arch, reduce_config
full = D.get_arch
D.get_arch = lambda a: (reduce_config(full(a)[0]),) + tuple(full(a)[1:])
out = {s: D.dryrun_cell("gemma2-2b", s) for s in ("train_4k", "prefill_32k")}
print(json.dumps({s: {"keys": sorted(r), "memory_keys": sorted(r["memory"]),
                      **{k: r["memory"][k] for k in ("argument_bytes", "output_bytes",
                                                     "temp_bytes")}}
                  for s, r in out.items()}))
"""


def _reduced(arch):
    from repro_torch.configs import get_arch, reduce_config

    cfg, shapes, skips = get_arch(arch)
    return reduce_config(cfg), shapes, skips


@pytest.fixture(scope="module")
def runs():
    import torch.distributed as dist

    from repro_torch.launch import dryrun

    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    ref = subprocess.Popen([sys.executable, "-c", REF], env=env, text=True,
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    full, dryrun.get_arch = dryrun.get_arch, _reduced
    try:
        got = {}
        for arch, shape in CELLS:
            got[(arch, shape)] = dryrun.dryrun_cell(arch, shape, device="cpu")
            got[(arch, shape), "world_after"] = dist.is_initialized()
    finally:
        dryrun.get_arch = full
        out, err = ref.communicate(timeout=600)
    assert ref.returncode == 0, f"reference:\n{err[-4000:]}"
    return got, json.loads(out.strip().splitlines()[-1])


@pytest.mark.parametrize("cell", CELLS, ids=["/".join(c) for c in CELLS])
def test_reduced_cell_is_ok_with_the_reference_keys(runs, cell):
    """Each family's reduced cell runs its step on one rank of the 16x16
    mesh and reports ``ok`` with every key of the reference's result (and
    the port's own ``peak_bytes`` and ``largest_collectives``)."""
    got, ref = runs
    r = got[cell]
    assert r["status"] == "ok", r
    assert set(ref["train_4k"]["keys"]) <= set(r), set(ref["train_4k"]["keys"]) - set(r)
    assert set(r["memory"]) == set(ref["train_4k"]["memory_keys"]) == MEMORY_KEYS
    assert r["mesh"] == "16x16" and r["n_devices"] == 256
    assert set(r["collective_bytes_per_device"]) <= COLLECTIVE_KINDS
    assert r["flops_per_device"] > 0 and r["bytes_per_device"] > 0
    assert r["memory"]["code_bytes"] == 0 and r["memory"]["temp_bytes"] >= 0
    assert r["peak_bytes"] == r["memory"]["argument_bytes"] + r["memory"]["temp_bytes"]
    assert len(r["largest_collectives"]) <= 3
    for e in r["largest_collectives"]:  # each with the op and the place that caused it
        assert e["kind"] in COLLECTIVE_KINDS and e["op"].startswith("aten.") and e["where"]
    assert not got[cell, "world_after"]  # the fake world is destroyed with the cell


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k"])
def test_argument_bytes_equal_the_reference(runs, shape):
    """Per-rank argument bytes (parameters, optimizer state and inputs, by
    ``shardings_for``) equal the reference's XLA ``argument_size_in_bytes``
    for reduced gemma2-2b: its ``train_4k`` cell (fp32 AdamW moments and
    the int32 step counter) and its ``prefill_32k`` cell."""
    got, ref = runs
    assert got[("gemma2-2b", shape)]["memory"]["argument_bytes"] == ref[shape]["argument_bytes"]


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k"])
def test_peak_within_three_times_the_reference_plan(runs, shape):
    """Per-rank peak of reduced gemma2-2b at most 3x the reference's XLA
    plan (argument + output + temp bytes): the port splits attention's
    fp32 scores over ``model`` as the reference does (here by query
    position: 4 heads do not split 16 ways), where a rank once computed
    every query's scores of its sequences (5.9x and 44.8x)."""
    got, ref = runs
    plan = sum(ref[shape][k] for k in ("argument_bytes", "output_bytes", "temp_bytes"))
    peak = got[("gemma2-2b", shape)]["peak_bytes"]
    print(f"{shape}: port peak {peak:,} bytes a rank, reference plan {plan:,} "
          f"({peak / plan:.2f}x)")  # shown with pytest -s
    assert peak <= 3 * plan, (peak, plan)


def test_kinds_and_train_outputs(runs):
    """A train step's outputs are its metrics and the parameters and
    moments it updates in place (aliased); a prefill step aliases nothing;
    the MoE cell's collectives include the expert all-to-all or the
    grouped path's gathers, and the tables' cell has a gradient reduction."""
    got, _ = runs
    train, prefill = got[("gemma2-2b", "train_4k")], got[("gemma2-2b", "prefill_32k")]
    assert (train["kind"], prefill["kind"]) == ("train", "prefill")
    assert 0 < train["memory"]["alias_bytes"] <= train["memory"]["output_bytes"]
    assert train["memory"]["alias_bytes"] <= train["memory"]["argument_bytes"]
    assert prefill["memory"]["alias_bytes"] == 0
    assert got[("dlrm-mlperf", "train_batch")]["collective_bytes_per_device"]


def test_skips_equal_the_reference():
    """The documented skips are ``get_arch``'s in both packages: 2 of the
    40 (arch, shape) pairs, and ``dryrun_cell`` reports them ``skipped``
    with their reason, touching no process group."""
    import torch.distributed as dist
    from repro.configs import ARCH_IDS as REF_IDS, get_arch as ref_get_arch

    from repro_torch.configs import ARCH_IDS, get_arch
    from repro_torch.launch import dryrun

    assert tuple(ARCH_IDS) == tuple(REF_IDS)
    skipped = []
    for arch in ARCH_IDS:
        _, shapes, skips = get_arch(arch)
        assert skips == ref_get_arch(arch)[2], arch
        assert [s.name for s in shapes] == [s.name for s in ref_get_arch(arch)[1]], arch
        for name in skips:
            r = dryrun.dryrun_cell(arch, name, device="cpu")
            assert r == {"arch": arch, "shape": name, "status": "skipped",
                         "reason": skips[name]}
            skipped.append((arch, name))
    assert sum(len(get_arch(a)[1]) for a in ARCH_IDS) == 40
    assert sorted(skipped) == [("gemma-2b", "long_500k"), ("phi4-mini-3.8b", "long_500k")]
    assert not dist.is_initialized()


def test_flops_are_one_ranks_not_the_global_count():
    """(2,048 x 4,096) [Shard(0), Replicate()] @ (4,096 x 16,384)
    [Replicate(), Shard(1)] on the 16x16 mesh: ``FlopCounterMode`` around
    the DTensor product counts the global 2.749e11 FLOPs; the dry run's
    count is one rank's (128 x 4,096) @ (4,096 x 1,024) block, 2.749e11 /
    256 = 1.074e9."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.common.sharding import concrete_mesh
    from repro_torch.launch import dryrun

    with dryrun.fake_world(256):
        mesh = concrete_mesh((16, 16), ("data", "model"), device_type="cpu")
        fake = FakeTensorMode()
        with fake:
            a = distribute_tensor(torch.empty(2048, 4096), mesh, [Shard(0), Replicate()],
                                  src_data_rank=None)
            b = distribute_tensor(torch.empty(4096, 16384), mesh, [Replicate(), Shard(1)],
                                  src_data_rank=None)
            with FlopCounterMode(display=False) as whole:
                a @ b
            ops = dryrun._rank_ops_mode()
            with ops:
                a @ b
    assert whole.get_total_flops() == 2 * 2048 * 4096 * 16384 == 274_877_906_944
    assert ops.flops == 2 * 128 * 4096 * 1024 == 274_877_906_944 // 256


def test_one_rank_flops_equal_flop_counter_on_the_real_step():
    """On a (1, 1) mesh the dry run's FLOPs equal ``FlopCounterMode`` around
    the same step run for real, exactly: reduced gemma2-2b's prefill and
    train steps and FM's train step, at small shapes (the body of
    ``dryrun_cell``, as ``chip_smoke.py``'s phase P holds it on the card)."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.common.config import ShapeSpec
    from repro_torch.common.sharding import concrete_mesh
    from repro_torch.launch import dryrun
    from repro_torch.launch.steps import build_cell
    from repro_torch.train import init_train_state

    for arch, shape in (("gemma2-2b", ShapeSpec(name="p", kind="prefill", seq_len=32,
                                                global_batch=2)),
                        ("gemma2-2b", ShapeSpec(name="t", kind="train", seq_len=32,
                                                global_batch=2)),
                        ("fm", ShapeSpec(name="t", kind="train", global_batch=64))):
        cell = build_cell(_reduced(arch)[0], shape)
        with dryrun.fake_world(1):
            res = dryrun._dryrun_bundle(cell, concrete_mesh((1, 1), ("data", "model"),
                                                            device_type="cpu"), device="cpu")
        model = cell.init_fn(0, "cpu")
        gen = torch.Generator().manual_seed(0)
        batch = {k: (torch.randint(0, 8, s.shape, generator=gen, dtype=s.dtype)
                     if s.dtype == torch.int32 else torch.rand(s.shape, generator=gen))
                 for k, s in cell.input_specs.items()}
        with FlopCounterMode(display=False) as real:
            if cell.kind == "train":
                cell.step(model, init_train_state(model, cell.opt_cfg), batch)
            else:
                cell.step(model, batch["tokens"])
        assert res["flops_per_device"] == real.get_total_flops(), (arch, shape.kind)
        assert res["flops_per_device"] > 0 or arch == "fm"  # FM's step has no product


def test_compare_sets_each_port_peak_beside_the_reference_plan():
    """``--compare``: the reference's argument + output + temp bytes of each
    ``ok`` cell beside each port run's peak and ratio (a cell a run lacks
    gets None; skipped cells drop out)."""
    from repro_torch.launch import dryrun

    mem = {"argument_bytes": 100, "output_bytes": 20, "temp_bytes": 80}
    ref = [{"arch": "a", "shape": "s", "status": "ok", "memory": mem},
           {"arch": "a", "shape": "t", "status": "skipped"}]
    rows = dryrun.compare(ref, [{"arch": "a", "shape": "s", "peak_bytes": 300}], [])
    assert rows == [{"arch": "a", "shape": "s", "reference_bytes": 200,
                     "reference_flops": None, "flops_note": None,
                     "port": [{"peak_bytes": 300, "ratio": 1.5, "flops": None,
                               "flops_ratio": None},
                              {"peak_bytes": None, "ratio": None, "flops": None,
                               "flops_ratio": None}]}]


def test_compare_sets_flops_a_rank_beside_the_reference_but_for_scanned_layers():
    """``--compare`` puts each port run's FLOPs a rank and their ratio beside
    the reference's; an LM cell, whose reference scans its layers (XLA
    counts one scan body), is marked and gets no ratio."""
    from repro_torch.launch import dryrun

    mem = {"argument_bytes": 100, "output_bytes": 20, "temp_bytes": 80}
    ref = [{"arch": "bst", "shape": "serve_p99", "status": "ok", "memory": mem,
            "flops_per_device": 4.0e6},
           {"arch": "gemma2-2b", "shape": "train_4k", "status": "ok", "memory": mem,
            "flops_per_device": 1.0e9}]
    port = [{"arch": "bst", "shape": "serve_p99", "peak_bytes": 200, "flops_per_device": 5.0e6},
            {"arch": "gemma2-2b", "shape": "train_4k", "peak_bytes": 100,
             "flops_per_device": 3.0e10}]
    bst, lm = dryrun.compare(ref, port)
    assert (bst["reference_flops"], bst["flops_note"]) == (4.0e6, None)
    assert bst["port"] == [{"peak_bytes": 200, "ratio": 1.0, "flops": 5.0e6,
                            "flops_ratio": 1.25}]
    assert lm["flops_note"] == dryrun.SCAN_NOTE == "reference counts one scan body"
    assert lm["port"] == [{"peak_bytes": 100, "ratio": 0.5, "flops": 3.0e10,
                           "flops_ratio": None}]
    line = dryrun._compare_line(lm)
    assert line.endswith("[reference counts one scan body]") and "x)" in line.split("|")[0]
    assert "(1.25x)" in dryrun._compare_line(bst)
