"""``correct`` comes out false for the control and for each fault a cell can
have, and true for the program, at a size a test run holds on the CPU.

Each run skips the harness's look for a card and drives the rest of a run:
the system built from the seed, the traffic, the window, the reference.
The faults are planted in the timed path, underneath the harness: an answer
altered where it is produced, and half of a batch's answers left out.
"""
from __future__ import annotations

import time

import pytest
import torch

from port_bench.harness import Bench, run_cell

SEED = 2 ** 31 + 99
CELLS = ("robust04-boolean-block", "clueweb09b-exhaustive")


def run(root, cell, **kw):
    return run_cell(Bench(root), cell, SEED, 0.5, False, "cpu", time.perf_counter(), **kw)


@pytest.mark.parametrize("cell", CELLS)
def test_the_program_is_correct_and_the_control_is_not(tiny_root, cell):
    good = run(tiny_root, cell)
    assert good["correct"], good["checks"]
    assert good["attempted"] > 0 and good["failed"] == 0
    bad = run(tiny_root, cell, control=True)
    assert not bad["correct"], bad["checks"]


def _boolean_fault(monkeypatch, kind):
    from repro_torch.serve import shard

    real = shard.ShardEngine.execute

    def execute(self, q, *a, **kw):
        out = real(self, q, *a, **kw)
        if kind == "altered":
            out[:, 0] ^= 1  # document 0 of the shard flipped in every answer
        else:
            out[out.shape[0] // 2:] = 0  # the second half of the batch left out
        return out

    monkeypatch.setattr(shard.ShardEngine, "execute", execute)


def _step_fault(monkeypatch, kind):
    from repro_torch.launch import dryrun_learned_index as li

    real = li.exhaustive_step

    def step(params, queries):
        out = real(params, queries)
        if kind == "altered":
            out[:, 0] ^= 1
        else:
            out[out.shape[0] // 2:] = 0
        return out

    monkeypatch.setattr(li, "exhaustive_step", step)


@pytest.mark.parametrize("kind", ["altered", "half_left_out"])
@pytest.mark.parametrize("cell", CELLS)
def test_faults_in_the_timed_path_come_out_not_correct(tiny_root, monkeypatch, cell, kind):
    (_boolean_fault if cell.startswith("robust04") else _step_fault)(monkeypatch, kind)
    r = run(tiny_root, cell)
    assert not r["correct"], r["checks"]


@pytest.mark.cuda
def test_the_step_cell_on_the_card(tiny_root):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    r = run_cell(Bench(tiny_root), "clueweb09b-exhaustive", SEED, 0.5, True, "cuda",
                 time.perf_counter())
    assert r["correct"], r["checks"]
    assert r["device"]["busy_s"] > 0
    bad = run_cell(Bench(tiny_root), "clueweb09b-exhaustive", SEED, 0.5, False, "cuda",
                   time.perf_counter(), control=True)
    assert not bad["correct"]
