#!/usr/bin/env python3
"""Time the three mlp_membership launches alone on a synthetic batch shaped
like a K=4 shard of phase M (``chip_smoke.py``).

    python3 src/repro_torch/kernels/mlp_membership/bench.py                  # this checkout
    python3 src/repro_torch/kernels/mlp_membership/bench.py --src OTHER/src  # another checkout's
    python3 src/repro_torch/kernels/mlp_membership/bench.py --gelu newton    # a GELU variant

Run it by path: ``--src`` names the directory holding the ``repro_torch``
package to drive (run it once per checkout, in the order parent, change,
change, parent).  ``--gelu`` times this package with the body of the
kernel's ``gelu4`` replaced (``VARIANTS``): the copy is written under
``build/mlp_bench/<variant>/`` (gitignored) and its kernels built there.
The batch, made from ``--seed`` with a random head and no training: 132,000
docs, H1 = 128 (dims (128, 1)), 128 queries of 1 to 5 terms drawn by
popularity from 3,000 terms whose document frequencies fall off as a power
law (398 valid slots on the default seed, as in phase M), each term's
postings drawn uniformly, its block bitmap (blocks of 1,024 docs) and its tier-1 row (its
4,000 lowest ids) cut from them, and per-slot thresholds that pass about 70%
of the docs.  Modes: ``dense`` (every (slot, doc) pair, Algorithm 1),
``masked`` (the live blocks of each slot's query, Algorithm 3) and
``two_tier`` (the union of each query's tier-1 lists, Algorithm 2).  Each
launch's bits must equal its plain version's outside the margin of tau (the
dense launch's logits within the margin of the plain ones).  One JSON line:
the card, the batch's counts, and per mode the device time (20 calls in a
CUDA graph, replayed) and the eager time (the same calls one by one).
"""
from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np

ITERS = 20
ROOT = Path(__file__).resolve().parents[4]
# the committed body of gelu4 (the GELU of 4 units, csrc/mlp_membership.cu):
# ex2 on the SFU for each unit, one rcp for each pair of units
GELU_BODY = """  const float d0 = denom(x.x), d1 = denom(x.y), d2 = denom(x.z), d3 = denom(x.w);
  const float r01 = rcp_approx(d0 * d1), r23 = rcp_approx(d2 * d3);
  return make_float4(x.x * (r01 * d1), x.y * (r01 * d0), x.z * (r23 * d3), x.w * (r23 * d2));
"""
NEWTON = """  auto newton = [](float v) {  // the reciprocal on the FMA pipe
    const float t = fminf(v * fmaf(C3, v * v, C1), 126.0f);
    const float d = 1.0f + ex2_approx(t);
    float r = __int_as_float(0x7ef311c3 - __float_as_int(d));  // 12% off
    r = fmaf(r, fmaf(-d, r, 1.0f), r);
    r = fmaf(r, fmaf(-d, r, 1.0f), r);
    r = fmaf(r, fmaf(-d, r, 1.0f), r);
    return v * r;
  };
"""
VARIANTS = {
    # (a) ex2 and rcp on the SFU for each unit
    "sfu": "  return make_float4(gelu_tanh(x.x), gelu_tanh(x.y), gelu_tanh(x.z), "
           "gelu_tanh(x.w));\n",
    # (b) ex2 on the SFU, the reciprocal as Newton steps on the FMA pipe
    "newton": NEWTON + "  return make_float4(newton(x.x), newton(x.y), newton(x.z), "
                       "newton(x.w));\n",
    # (a) for units 0 and 2, (b) for 1 and 3: both pipes loaded
    "mixed": NEWTON + "  return make_float4(gelu_tanh(x.x), newton(x.y), gelu_tanh(x.z), "
                      "newton(x.w));\n",
    # one rcp for four units, t capped at 31
    "quad": """  auto d = [](float v) { return 1.0f + ex2_approx(fminf(v * fmaf(C3, v * v, C1), 31.0f)); };
  const float d0 = d(x.x), d1 = d(x.y), d2 = d(x.z), d3 = d(x.w);
  const float p01 = d0 * d1, p23 = d2 * d3;
  const float r = rcp_approx(p01 * p23), r01 = r * p23, r23 = r * p01;
  return make_float4(x.x * (r01 * d1), x.y * (r01 * d0), x.z * (r23 * d3), x.w * (r23 * d2));
""",
    # the library tanhf of the first kernel, in this design
    "tanhf": """  auto g = [](float v) {
    return 0.5f * v * (1.0f + tanhf(0.7978845608028654f * (v + 0.044715f * (v * v * v))));
  };
  return make_float4(g(x.x), g(x.y), g(x.z), g(x.w));
""",
}


def variant_src(src: Path, name: str) -> Path:
    """A copy of ``src``'s repro_torch with gelu4's body replaced ->
    the directory to put on the path (its kernels build beside it)."""
    out = ROOT / "build" / "mlp_bench" / name / "src"
    shutil.rmtree(out.parent, ignore_errors=True)
    shutil.copytree(src / "repro_torch", out / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    cu = out / "repro_torch" / "kernels" / "csrc" / "mlp_membership.cu"
    text = cu.read_text()
    if text.count(GELU_BODY) != 1:
        raise SystemExit("bench: gelu4's body is not the one the variants replace")
    cu.write_text(text.replace(GELU_BODY, VARIANTS[name]))
    return out


def synthetic_batch(seed: int, D: int = 132_000, H: int = 128, k: int = 4000, Q: int = 128,
                    T: int = 8, n_terms: int = 3000, block_size: int = 1024):
    """-> numpy dict of the batch's arrays, and the bias."""
    rng = np.random.default_rng(seed)
    df = np.minimum(D, np.maximum(8, (0.4 * D / np.arange(1, n_terms + 1) ** 0.75))).astype(np.int64)
    pop = 1.0 / np.arange(1, n_terms + 1) ** 0.9
    pop /= pop.sum()
    queries = np.full((Q, T), -1, np.int32)
    for q in range(Q):
        w = int(rng.integers(1, 6))
        queries[q, :w] = rng.choice(n_terms, size=w, replace=False, p=pop)
    words = -(-D // 32)
    Wb = -(-words // block_size)
    tier1 = np.full((n_terms, k), D, np.int32)
    lens = np.zeros(n_terms, np.int32)
    table = np.zeros((n_terms, Wb), np.uint32)
    for t in np.unique(queries[queries >= 0]):
        ids = np.sort(rng.choice(D, size=int(df[t]), replace=False))
        tier1[t, : min(k, len(ids))] = ids[:k]
        lens[t] = min(k, len(ids))
        blocks = np.zeros(Wb * 32, bool)
        blocks[ids // block_size] = True
        table[t] = np.packbits(blocks, bitorder="little").view(np.uint32)
    flat = queries.reshape(-1)
    valid = np.nonzero(flat >= 0)[0]
    S = len(valid)
    slots = np.full(Q * T, -1, np.int32)
    slots[valid] = np.arange(S, dtype=np.int32)
    a = (rng.standard_normal((S, H)) * 0.7).astype(np.float32)
    bd = (rng.standard_normal((D, H)) * 0.7).astype(np.float32)
    later = np.concatenate([(rng.standard_normal(H) / np.sqrt(H)).astype(np.float32),
                            np.float32([0.1])])
    return dict(tier1=tier1, lens=lens, queries=queries, slots=slots.reshape(Q, T), table=table,
                slot_query=(valid // T).astype(np.int32), a=a, bd=bd, later=later,
                block_size=block_size), 0.05


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", type=Path, default=ROOT / "src",
                    help="the directory that holds the repro_torch package to drive")
    ap.add_argument("--gelu", choices=sorted(VARIANTS),
                    help="time a copy of the package whose gelu4 is this variant")
    ap.add_argument("--seed", type=int, default=206)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("bench: no CUDA device", file=sys.stderr)
        return 1
    src = variant_src(args.src.resolve(), args.gelu) if args.gelu else args.src.resolve()
    sys.path.insert(0, str(src))
    from repro_torch.core.learned_bloom import NUMERIC_MARGIN
    from repro_torch.kernels.mlp_membership import kernel, ref
    from repro_torch.kernels.two_tier.ref import tier1_union

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    arrays, bias = synthetic_batch(args.seed)

    def put(x):
        x = np.ascontiguousarray(x)
        return torch.from_numpy(x.view(np.int32) if x.dtype == np.uint32 else x).to(dev)

    b = {n: put(v) if isinstance(v, np.ndarray) else v for n, v in arrays.items()}
    a, bd, later = b["a"], b["bd"], b["later"]
    S, H = a.shape
    D = bd.shape[0]
    dims = (H, 1)
    tile = ref.doc_tile(S, H)
    logits = torch.cat([ref.mlp_logits_ref(a, bd[d0: d0 + tile], later, dims, bias)
                        for d0 in range(0, D, tile)], dim=1)
    tau = torch.quantile(logits[:, :4096], 0.3, dim=1).contiguous()
    near = (logits - tau[:, None]).abs() <= NUMERIC_MARGIN * (1 + tau.abs()[:, None])
    valid = b["queries"] >= 0
    most = int(torch.where(valid, b["lens"][b["queries"].clamp(min=0).long()], 0).sum(1).max())
    union = tier1_union(b["tier1"], b["lens"], b["queries"], D)
    n_slots = valid.sum(dim=1)
    counts = {"slots": S, "docs": D, "dims": list(dims), "pairs": S * D,
              "union_pairs": int((union.sum(dim=1) * n_slots).sum()),
              "union_docs": int(union.sum()), "max_candidates": most}
    calls = {"dense": (lambda: kernel.mlp_membership(a, bd, later, dims, tau, bias),
                       lambda: ref.mlp_membership_ref(a, bd, later, dims, tau, bias))}
    if hasattr(kernel, "mlp_two_tier"):  # a package with the masked and two-tier launches
        live = ref.LiveBlocks(b["table"], b["queries"], b["slot_query"], b["block_size"])
        alive = ref.live_words(live, -(-D // 32))
        counts.update(live_words=int(alive.sum()), words=int(alive.numel()))
        calls["masked"] = (
            lambda: kernel.mlp_membership(a, bd, later, dims, tau, bias, live=live),
            lambda: ref.mlp_membership_ref(a, bd, later, dims, tau, bias, live))
        calls["two_tier"] = (
            lambda: kernel.mlp_two_tier(b["tier1"], b["lens"], b["queries"], b["slots"], a, bd,
                                        later, dims, tau, bias, max_candidates=most),
            lambda: ref.mlp_two_tier_ref(b["tier1"], b["lens"], b["queries"], b["slots"], a, bd,
                                         later, dims, tau, bias))
    shifts = torch.arange(32, device=dev, dtype=torch.int32)

    def bits(w):
        return ((w.unsqueeze(-1) >> shifts) & 1).reshape(w.shape[0], -1)[:, :D].bool()

    kernel_logits = torch.empty_like(logits)
    kernel.mlp_membership(a, bd, later, dims, tau, bias, logits=kernel_logits)
    far = int((((kernel_logits - logits).abs()) > NUMERIC_MARGIN * (1 + logits.abs())).sum())
    if far:
        raise AssertionError(f"dense: {far} logits differ from the plain ones by more than the "
                             f"margin")
    err = float((kernel_logits - logits).abs().max())
    del kernel_logits
    results = {}
    for mode, (fn, plain) in calls.items():
        got, want = fn(), plain()
        differ = bits(got ^ want)
        if mode == "two_tier":  # a query's bit: near for any of its valid slots
            qs, ds = differ.nonzero(as_tuple=True)
            slot_rows = b["slots"][qs].long()
            ok = torch.zeros(len(qs), dtype=torch.bool, device=dev)
            for t in range(slot_rows.shape[1]):
                r = slot_rows[:, t]
                ok |= (r >= 0) & near[r.clamp(min=0), ds]
            outside = int((~ok).sum())
        else:
            outside = int((differ & ~near).sum())
        if outside:
            raise AssertionError(f"{mode}: {outside} bits differ outside the margin")
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(3):
                fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(ITERS):
                fn()
        graph.replay()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / ITERS
        start.record()
        for _ in range(ITERS):
            fn()
        end.record()
        torch.cuda.synchronize()
        results[mode] = {"ms": ms, "eager_ms": start.elapsed_time(end) / ITERS,
                         "differing_bits": int(differ.sum()), "hits": int(bits(got).sum())}
        del graph
    print(json.dumps({"bench": "mlp_membership", "src": str(src), "gelu": args.gelu or "committed",
                      "card": card, **counts, "max_abs_logit_err": err, "modes": results}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
