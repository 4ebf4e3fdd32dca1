"""The benchmark's own arithmetic: percentiles over every request, spreads,
span unions, and roofline and mfu shares with the peak chosen by dtype."""
from __future__ import annotations

import pytest
import torch

from port_bench import roofline, stats
from port_bench.harness import load_module, ROOT
from port_bench.spans import span_ms


def reader(name):
    return load_module(ROOT / "port_bench" / "metrics" / f"{name}.py", "metric").read


def test_percentile_is_nearest_rank_over_all_values():
    xs = list(range(1, 101))
    assert stats.percentile(xs, 95) == 95.0
    assert stats.percentile(xs[::-1], 95) == 95.0
    assert stats.percentile([5.0], 95) == 5.0
    assert stats.percentile(list(range(1, 21)), 95) == 19.0
    assert stats.percentile([], 95) is None


def test_union_counts_overlap_once():
    assert stats.union_seconds([(0, 2), (1, 3), (5, 6), (5.5, 5.7)]) == pytest.approx(4.0)
    spans = [("decode.batch", 1, 1, 0.0, 2000.0), ("decode.postings", 1, 1, 500.0, 100.0),
             ("decode.batch", 2, 1, 0.0, 1000.0), ("shard.verify", 1, 1, 0.0, 9000.0)]
    assert span_ms(spans, lambda n: n.startswith("decode.")) == pytest.approx(3.0)


def test_peaks_by_dtype_and_what_bounds_the_work():
    assert roofline.peak_flops(torch.bfloat16) == 989e12
    assert roofline.peak_flops("tf32") == 495e12
    assert roofline.peak_flops(torch.float32) == 67e12
    slots, docs, e = 900, 3_138_816, 128
    assert roofline.membership_flops(slots, docs, e) == 2 * e * slots * docs
    nbytes = docs * e * 2 + slots * (e * 4 + 4) + slots * (docs // 32) * 4
    assert roofline.membership_bytes(slots, docs, e) == nbytes
    t, by = roofline.membership_least_time(slots, docs, e)
    assert by == "operations" and t == pytest.approx(2 * e * slots * docs / 989e12)
    t, by = roofline.membership_least_time(1, docs, e)
    assert by == "bytes" and t == pytest.approx(roofline.membership_bytes(1, docs, e) / 3.35e12)
    t32, _ = roofline.membership_least_time(slots, docs, e, torch.float32)
    assert t32 == pytest.approx(t * 0 + 2 * e * slots * docs / 67e12)


def test_roofline_and_mfu_readers():
    work = {"least_s": 0.5e-3, "flops": 0.5e-3 * 989e12}
    rec = {"stepped": [work] * 10, "completed": [work] * 8, "window_s": 1.0,
           "kernel_s": {"void membership_kernel<false>(Args, int, int)": 0.010,
                        "bitset_kernel": 0.001},
           "busy_s": 0.25, "traced_window_s": 1.0, "batch": 4}
    assert reader("membership_roofline")(rec) == pytest.approx(50.0)
    assert reader("step_mfu")(rec) == pytest.approx(0.4)
    assert reader("idle_share.step")(rec) == pytest.approx(75.0)
    assert reader("step_qps")(rec) == pytest.approx(32.0)
    # nothing to read: no value, never a 0 share
    assert reader("membership_roofline")({"kernel_s": {}}) is None
    assert reader("step_mfu")({"completed": [], "window_s": 1.0}) is None


def test_request_readers():
    rec = {"answered_in_window": 50, "window_s": 2.0, "latency_s": [i / 100 for i in range(1, 101)],
           "queue_us": [1000.0, 3000.0], "attempted": 4,
           "spans": [("shard.verify", 7, 1, 0.0, 4000.0), ("shard.candidate_mask", 7, 1, 0, 400.0)],
           "smi": [(0.0, 10.0, 100.0), (0.1, 30.0, 100.0)],
           "footprint": {"store_bytes": 100, "model_bytes": 28, "postings": 64, "eq2_bits": 640},
           "setup": {"tier2_build": 12.5}, "setup_s": 30.0}
    assert reader("qps")(rec) == 25.0
    assert reader("request_p95_ms.boolean")(rec) == pytest.approx(950.0)
    assert reader("sched_queue_ms")(rec) == pytest.approx(2.0)
    assert reader("verify_ms_per_query")(rec) == pytest.approx(1.0)
    assert reader("candidates_ms_per_query")(rec) == pytest.approx(0.1)
    assert reader("idle_share.served")(rec) == pytest.approx(80.0)
    assert reader("store_bits_per_posting")(rec) == pytest.approx(16.0)
    assert reader("eq2_bits_per_posting")(rec) == pytest.approx(10.0)
    assert reader("tier2_build_s")(rec) == 12.5
    assert reader("setup_s")(rec) == 30.0
