"""The port's public surfaces against the reference's: each shared package's
exports, the serving launcher's flags, and ``GuidedPostings.rank``.

Names of the reference's modules that are not ported (the LM-side stack:
``common.sharding``, ``ArchConfig``, ``MeshConfig``, and ``data.loader``'s
LM batches) are left out of the export check.  Ranks and probe statistics
are integers: equal.
"""
import importlib

import numpy as np
import pytest

from repro.postings import hybrid as ref_hybrid
from repro.postings.search import GuidedPostings as RefGuided
from repro_torch.postings import hybrid
from repro_torch.postings.search import GuidedPostings

NOT_PORTED = {"ArchConfig", "MeshConfig", "logical_to_sharding", "shard_params", "with_sharding",
              "PrefetchLoader", "lm_token_batches"}
SHARED = ["common", "core", "data", "index", "kernels", "launch", "obs", "postings", "rank",
          "serve", "serve.sched", "train"]


@pytest.mark.parametrize("package", SHARED)
def test_package_exports_cover_the_reference(package):
    ref = importlib.import_module("repro." + package)
    port = importlib.import_module("repro_torch." + package)
    want = set(getattr(ref, "__all__", ())) - NOT_PORTED
    got = set(getattr(port, "__all__", ()))
    assert want <= got, sorted(want - got)
    assert all(hasattr(port, name) for name in got)


def test_public_imports_of_this_slice():
    from repro_torch.common import LearnedIndexConfig, OptimizerConfig, TrainConfig  # noqa: F401
    from repro_torch.core import (  # noqa: F401
        estimate_gain, false_positive_rate, init_membership, predict)
    from repro_torch.serve import ShardEngine, TopKResult, plan_batch, slice_bloom  # noqa: F401
    from repro_torch.train import (  # noqa: F401
        apply_remat, dequantize_blockwise, make_eval_step, quantize_blockwise, sgd_update)


def test_launcher_accepts_use_kernel(monkeypatch, capsys):
    """``--use-kernel`` parses and reaches ``ServeConfig(use_kernel=)``, as
    in the reference's launcher; the run stays exact."""
    from repro_torch.launch import serve as launcher

    seen = []
    real = launcher.ServeConfig

    def recording(*args, **kwargs):
        seen.append(kwargs.get("use_kernel"))
        return real(*args, **kwargs)

    monkeypatch.setattr(launcher, "ServeConfig", recording)
    launcher.main(["--device", "cpu", "--use-kernel", "--docs", "300", "--terms", "1200",
                   "--train-steps", "5", "--queries", "16", "--topk", "0"])
    assert seen == [True]
    assert "verified mode: all results exact" in capsys.readouterr().out


def _lists(seed=29, n_terms=24, universe=1 << 20):
    """Smooth lists (the learned codecs win) and rough ones (a classical
    codec wins)."""
    rng = np.random.default_rng(seed)
    lists = []
    for r in range(n_terms):
        df = max(20, int(2000 * (r + 1) ** -0.9))
        if r % 3:
            gaps = np.maximum(1, rng.normal(universe / (df + 1), 3.0, df)).astype(np.int64)
            ids = np.cumsum(gaps)
            ids = ids[ids < universe]
        else:
            ids = rng.choice(universe, df, replace=False)
        lists.append(np.unique(ids).astype(np.int32))
    offsets = np.zeros(len(lists) + 1, np.int64)
    np.cumsum([len(x) for x in lists], out=offsets[1:])
    return offsets, np.concatenate(lists), universe


def test_guided_rank_matches_reference_with_stats():
    offsets, ids, universe = _lists()
    port = hybrid.HybridPostings.build(offsets, ids, universe)
    ref = ref_hybrid.HybridPostings.build(offsets, ids, universe)
    gp, gr = GuidedPostings(port, device="cpu"), RefGuided(ref)
    rng = np.random.default_rng(4)
    learned = classical = 0
    for t in range(port.n_terms):
        lst = ref.postings(t)
        cands = np.unique(np.concatenate([rng.choice(lst, min(len(lst), 40), replace=False),
                                          rng.integers(0, universe, 60), lst[:1] + 1]))
        got, want = gp.rank(t, cands), gr.rank(t, cands)
        assert np.array_equal(got, want), t
        assert np.array_equal(got, np.searchsorted(lst, cands, side="left"))
        learned += gp.is_guided(t)
        classical += not gp.is_guided(t)
    assert learned and classical
    got, want = gp.stats.as_dict(), gr.stats.as_dict()
    assert {k: got[k] for k in want} == want
