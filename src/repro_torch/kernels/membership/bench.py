#!/usr/bin/env python3
"""Time the membership launches alone at the shapes of PERF.md §6 rows 1-1d.

    python3 src/repro_torch/kernels/membership/bench.py                  # this checkout
    python3 src/repro_torch/kernels/membership/bench.py --src OTHER/src  # another checkout's
    python3 src/repro_torch/kernels/membership/bench.py --shapes 1b,1d4  # some shapes only

Run it by path: ``--src`` names the directory holding the ``repro_torch``
package to drive (run it once per checkout, in the order parent, change,
change, parent).  Inputs are made on the card from ``--seed``: N(0, 1/E)
slot rows, N(0, 1) doc rows, thresholds that pass about 30% of the docs.
Shapes (E = 128): ``1`` 398 slots x 528,000 docs (phase A's K=1 batch),
``1b`` 398 x 132,000 (its K=4 shard), ``1c`` 2,045 x 3,138,816 with the doc
table in bf16 (phase W's ``exhaustive_step``; a package without bf16 input
is handed the table widened to fp32, as its W step did), ``1d1`` and
``1d4`` the masked launch (Algorithm 3) on a K=1 and a K=4 shard batch:
128 queries of 1 to 5 terms drawn by popularity from 3,000 terms, each
term's postings drawn uniformly with power-law document frequencies, its
block bitmap (blocks of 1,024 docs) cut from them.  Per shape: the dense
launch's words equal the plain version's outside the margin of tau on the
first 65,536 docs (the bf16 table's words equal the widened fp32 table's,
word for word); the masked launch's equal the dense launch's in live words
(the same arithmetic) and are zero in dead ones.  Times: device ms (``1c``:
CUDA events over 3 calls; else 20 calls in a CUDA graph, replayed), eager
ms, ``torch.matmul`` of the same fp32 product (logits only; ``1c`` in 4
doc chunks) and, for the masked shapes, the dense launch at the same shape.
One JSON line a shape; the first line names the card and holds ptxas's
report of each kernel (registers, stack and spill bytes).  ``--sass`` also
writes the kernels' SASS to ``build/membership_bench/sass.txt`` and prints
each kernel's instruction mix and that of its hottest block.
"""
from __future__ import annotations

import argparse
import inspect
import json
import re
import subprocess
import sys
from collections import Counter
from pathlib import Path

ITERS = 20
ROOT = Path(__file__).resolve().parents[4]
E = 128
SHAPES = {"1": (398, 528_000), "1b": (398, 132_000), "1c": (2045, 3_138_816),
          "1d1": (None, 528_000), "1d4": (None, 132_000)}
def live_batch(seed: int, D: int, block_size: int = 1024, Q: int = 128, T: int = 8,
               n_terms: int = 3000):
    """-> numpy (table (n_terms, Wb) uint32, terms (Q, T) int32, slot_query
    (S,) int32)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    df = np.minimum(D, np.maximum(8, (0.2 * D / np.arange(1, n_terms + 1) ** 0.75))).astype(np.int64)
    pop = 1.0 / np.arange(1, n_terms + 1) ** 0.9
    pop /= pop.sum()
    terms = np.full((Q, T), -1, np.int32)
    for q in range(Q):
        w = int(rng.integers(1, 6))
        terms[q, :w] = rng.choice(n_terms, size=w, replace=False, p=pop)
    words = -(-D // 32)
    Wb = -(-words // block_size)
    table = np.zeros((n_terms, Wb), np.uint32)
    for t in np.unique(terms[terms >= 0]):
        blocks = np.zeros(Wb * 32, bool)
        blocks[rng.choice(D, size=int(df[t]), replace=False) // block_size] = True
        table[t] = np.packbits(blocks, bitorder="little").view(np.uint32)
    valid = np.nonzero(terms.reshape(-1) >= 0)[0]
    return table, terms, (valid // T).astype(np.int32)


def timed(fn, graph: bool) -> float:
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if not graph:
        torch.cuda.synchronize()
        start.record()
        for _ in range(3):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / 3
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(ITERS):
            fn()
    g.replay()
    torch.cuda.synchronize()
    start.record()
    g.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / ITERS


def eager_ms(fn) -> float:
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(ITERS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / ITERS


def hot_block(lines: list[str]) -> dict:
    """The straight-line block of a kernel's SASS with the most FFMA: its
    instruction counts, and its FFMA that read two registers of one parity
    from the register file (operands not marked .reuse), which stall a
    cycle if the file has two banks by register parity."""
    blocks, cur = [], []
    for line in lines:
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)(.*)", line)
        if not m:
            continue
        cur.append((m.group(2), m.group(3)))
        if m.group(2).split(".")[0] in ("BRA", "EXIT", "SYNCS", "BAR", "WARPSYNC"):
            blocks.append(cur)
            cur = []
    blocks.append(cur)
    best = max(blocks, key=lambda b: sum(op == "FFMA" for op, _ in b))
    ffma = [rest for op, rest in best if op == "FFMA"]
    clash = 0
    for rest in ffma:
        srcs = re.findall(r"R(\d+)(\.reuse)?", rest.split(";")[0])[1:]
        parity = [int(r) % 2 for r, reuse in srcs if not reuse]
        clash += len(parity) != len(set(parity))
    return {"instructions": len(best), "ops": dict(Counter(op.split(".")[0] for op, _ in best)),
            "ffma": len(ffma),
            "ffma_with_reuse": sum(".reuse" in r for r in ffma),
            "ffma_parity_clash": clash}


def sass_mix(lib: Path, out: Path) -> dict:
    """The SASS of ``lib`` into ``out`` -> per kernel, its instruction counts
    (opcode without modifiers) and its hottest block (``hot_block``)."""
    cuobjdump = "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(text)
    mix: dict[str, Counter] = {}
    body: dict[str, list[str]] = {}
    name = None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            mix[name], body[name] = Counter(), []
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", line)
        if m and name:
            mix[name][m.group(2)] += 1
            body[name].append(line)
    return {n: dict(c.most_common(8)) | {"total": sum(c.values()), "hot": hot_block(body[n])}
            for n, c in mix.items() if "membership_kernel" in n}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", type=Path, default=ROOT / "src",
                    help="the directory that holds the repro_torch package to drive")
    ap.add_argument("--shapes", default=",".join(SHAPES))
    ap.add_argument("--seed", type=int, default=27)
    ap.add_argument("--sass", action="store_true")
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("bench: no CUDA device", file=sys.stderr)
        return 1
    src = args.src.resolve()
    sys.path.insert(0, str(src))
    from repro_torch.core.learned_bloom import NUMERIC_MARGIN
    from repro_torch.kernels import cuda
    from repro_torch.kernels.membership import kernel, ref

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    reports = cuda.build_all()
    ptxas = [ln.strip() for ln in reports.get("membership", "").splitlines()
             if "registers" in ln or "spill" in ln or "Function properties" in ln]
    masked_ok = "live" in inspect.signature(kernel.membership_bitmask).parameters
    head = {"bench": "membership", "src": str(src), "card": card, "ptxas": ptxas,
            "masked_entry": masked_ok}
    if args.sass:
        head["sass"] = sass_mix(cuda.BUILD_DIR / "libmembership.so",
                                ROOT / "build" / "membership_bench" / "sass.txt")
    print(json.dumps(head), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    shifts = torch.arange(32, device=dev, dtype=torch.int32)

    def bits(w, n):
        return ((w.unsqueeze(-1) >> shifts) & 1).reshape(w.shape[0], -1)[:, :n].bool()

    for shape in args.shapes.split(","):
        S, D = SHAPES[shape]
        masked = shape.startswith("1d")
        if masked and not masked_ok:
            continue
        live = None
        if masked:
            table, terms, slot_query = live_batch(args.seed, D)
            S = len(slot_query)
            live = ref.LiveBlocks(torch.from_numpy(table.view(np.int32)).to(dev),
                                  torch.from_numpy(terms).to(dev),
                                  torch.from_numpy(slot_query).to(dev), 1024)
        q = torch.randn((S, E), generator=gen, device=dev) / E ** 0.5
        d = torch.randn((D, E), generator=gen, device=dev)
        if shape == "1c":
            d = d.to(torch.bfloat16)
        d32 = d.float() if d.dtype != torch.float32 else d
        tau = torch.quantile(q @ d32[:4096].T, 0.7, dim=1).contiguous()
        d_in = d if masked_ok else d32
        dense = lambda: kernel.membership_bitmask(q, d_in, tau, 0.0)  # noqa: E731
        got = dense()
        n = min(D, 65_536)
        logits = q @ d32[:n].T
        want = ref.membership_bitmask_ref(q, d32[:n], tau, 0.0)
        near = (logits - tau[:, None]).abs() <= NUMERIC_MARGIN * (1 + tau.abs()[:, None])
        differ = bits(got[:, : n // 32] ^ want, n)
        outside = int((differ & ~near).sum())
        if outside:
            raise AssertionError(f"{shape}: {outside} bits differ outside the margin")
        row = {"shape": shape, "S": S, "D": D, "E": E, "doc_dtype": str(d_in.dtype),
               "differing_bits_first_docs": int(differ.sum()),
               "bits_outside_margin_first_docs": outside}
        del logits, want, near, differ
        if d.dtype == torch.bfloat16 and masked_ok:
            row["bf16_words_equal_fp32"] = bool(torch.equal(
                got, kernel.membership_bitmask(q, d32, tau, 0.0)))
            if not row["bf16_words_equal_fp32"]:
                raise AssertionError(f"{shape}: bf16 words differ from the widened table's")
        if masked:
            fn = lambda: kernel.membership_bitmask(q, d, tau, 0.0, live=live)  # noqa: E731
            words = fn()
            alive = ref.live_words(live, words.shape[1])
            if not torch.equal(words, torch.where(alive, got, 0)):
                raise AssertionError(f"{shape}: masked words differ from the dense ones")
            row.update(live_words=int(alive.sum()), words=int(alive.numel()),
                       live_share=float(alive.float().mean()),
                       dense_ms=timed(dense, True))
            del alive
        else:
            fn = dense
        big = shape == "1c"
        row["ms"] = timed(fn, not big)
        row["eager_ms"] = eager_ms(fn) if not big else row["ms"]
        chunks = d32.split(-(-D // 4)) if big else (d32,)
        row["library_ms"] = timed(lambda: [torch.matmul(q, c.T) for c in chunks], not big)
        flop = 2 * S * D * E * (row["live_share"] if masked else 1)
        row["tflop_s"] = flop / row["ms"] / 1e9
        row["bound_ms"] = flop / 67e12 * 1e3
        print(json.dumps(row), flush=True)
        del q, d, d32, got, chunks
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
