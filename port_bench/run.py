#!/usr/bin/env python3
"""The port's benchmark: one run of one cell of ``BENCHMARK.json``.

    python3 port_bench/run.py --workload NAME --seed N --seconds S --trace 0|1

Run from the checkout's root on a machine with the cell's cards.  It makes
the cell's inputs from the seed, builds and warms the port's path (set-up),
measures it for ``--seconds``, checks what it produced against the plain
reference, and prints the result as the last line of standard output (with
``--trace 0`` the cell's end-to-end metrics, with ``--trace 1`` its
per-layer ones) and each checked number beside its limit as the last lines
of standard error.  Without CUDA, with fewer cards than the cell asks for,
or with JAX or the JAX package loaded after the window, it exits non-zero
and prints no result.  ``--control`` runs the cell's control in the
program's place (the limits' upper readings).
"""
from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# the JAX package and the libraries it needs; the port's own name begins
# with the package's, so names are compared whole
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)

    # the program's and the compilers' caches at fixed paths of the checkout
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "torch_extensions"))
    for p in (ROOT / "src", ROOT):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))
    import torch

    from port_bench.harness import Bench, run_cell

    bench = Bench(ROOT)
    chips = bench.workload(args.workload)["chips"]
    if not torch.cuda.is_available():
        print("port_bench: CUDA is not available", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < chips:
        print(f"port_bench: {torch.cuda.device_count()} cards, the cell needs {chips}",
              file=sys.stderr)
        return 2
    result = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace),
                      "cuda", T_PROCESS, control=args.control)
    bad = forbidden_modules()
    if bad:
        print(f"port_bench: loaded after the window: {', '.join(bad)}", file=sys.stderr)
        return 3
    print(f"[port_bench] whole run {time.perf_counter() - T_PROCESS:.3f} s", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
