"""Training launcher: any --arch at any scale, with checkpoint/restart
and a straggler watchdog.

  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2-2b --reduced \\
      --device cpu --steps 4 --batch 2 --seq 32
  PYTHONPATH=src python -m repro_torch.launch.train --arch meshgraphnet --reduced \\
      --device cpu --steps 4 --batch 4        # a graph of 16 x batch nodes
  PYTHONPATH=src python -m repro_torch.launch.train --arch fm --reduced \\
      --device cpu --steps 4 --batch 64
  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2-2b \\
      --steps 3 --batch 1 --seq 4096 --checkpoint-every 0    # one card

``--arch`` is any of ``configs.ARCH_IDS``: the LM archs, meshgraphnet, and
dlrm-mlperf, fm, bst and mind.  A run resumes from the newest checkpoint in
``--ckpt-dir``.
"""
from __future__ import annotations

import argparse
import itertools
import os
import tempfile
import time
from collections import deque

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.common.config import ShapeSpec, TrainConfig
from repro_torch.common.device import resolve_device
from repro_torch.configs import get_arch, reduce_config
from repro_torch.data.loader import PrefetchLoader
from repro_torch.launch.steps import build_cell
from repro_torch.train import init_train_state


def synthetic_batches(cell, seed=0):
    """Spec-shaped random numpy batches for a cell (host-side producer)."""
    rng = np.random.default_rng(seed)

    def mk(name, spec):
        if spec.dtype == torch.int32:
            return rng.integers(0, 3, size=spec.shape).astype(np.int32)
        if "mask" in name:
            return np.ones(spec.shape, np.float32)
        if "label" in name:
            return rng.integers(0, 2, size=spec.shape).astype(np.float32)
        return rng.standard_normal(spec.shape).astype(np.float32)

    while True:
        yield {name: mk(name, spec) for name, spec in cell.input_specs.items()}


def train_loop(cell, cfg: TrainConfig, *, data_it=None, device: str | torch.device = "cuda",
               history: list | None = None):
    """-> (model, opt_state, last metrics).  Resumes from the newest
    checkpoint in ``cfg.checkpoint_dir`` and saves one every
    ``cfg.checkpoint_every`` steps (never when 0).  ``history``,
    when given, gets one dict a step: step, loss, grad_norm, ms (host clock
    around the step, which reads its loss back)."""
    dev = resolve_device(device)
    model = cell.init_fn(cfg.seed, dev)
    opt_state = init_train_state(model, cell.opt_cfg)
    ckpt = CheckpointManager(cfg.checkpoint_dir)

    start = 0
    restored = ckpt.restore_latest({"params": model.state_dict(), "opt": opt_state}, device=dev)
    if restored is not None:
        start, tree = restored
        model.load_state_dict(tree["params"])
        opt_state = tree["opt"]
        print(f"[train] resumed from step {start}")

    if data_it is None:  # a resumed run reads on where the stream left off
        data_it = itertools.islice(synthetic_batches(cell), start, None)
    data = PrefetchLoader(data_it, depth=2)
    times: deque[float] = deque(maxlen=20)
    metrics: dict = {}
    try:
        for step in range(start, cfg.steps):
            batch = next(data, None)
            if batch is None:
                break
            t0 = time.perf_counter()
            batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
            metrics = cell.step(model, opt_state, batch)
            loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
            dt = time.perf_counter() - t0
            # straggler watchdog: flag steps far beyond the trailing median
            if len(times) >= 5 and dt > cfg.straggler_factor * float(np.median(times)):
                print(f"[watchdog] step {step} took {dt:.2f}s "
                      f"(median {float(np.median(times)):.2f}s) — raising prefetch")
                data.close()
                data = PrefetchLoader(data_it, depth=4)
            times.append(dt)
            if history is not None:
                history.append({"step": step, "loss": loss, "grad_norm": gnorm, "ms": dt * 1e3})
            if step % cfg.log_every == 0:
                print(f"[train] step {step} loss {loss:.4f} grad_norm {gnorm:.3f} {dt*1e3:.0f} ms")
            if cfg.checkpoint_every and (step + 1) % cfg.checkpoint_every == 0:
                ckpt.save(step + 1, {"params": model.state_dict(), "opt": opt_state})
    finally:
        data.close()
    return model, opt_state, metrics


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true", help="CPU-scale config")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_train_ckpt"))
    ap.add_argument("--checkpoint-every", type=int, default=10)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--remat", default="dots", choices=("none", "dots", "full"),
                    help="per-block activation checkpointing")
    args = ap.parse_args(argv)

    arch, _, _ = get_arch(args.arch)
    if args.reduced:
        arch = reduce_config(arch)
    if arch.family == "lm":
        shape = ShapeSpec(name="train", kind="train", seq_len=args.seq, global_batch=args.batch)
    elif arch.family == "gnn":
        shape = ShapeSpec(name="train", kind="train", n_nodes=args.batch * 16,
                          n_edges=args.batch * 64, d_feat=16)
    else:
        shape = ShapeSpec(name="train", kind="train", global_batch=args.batch)
    kw = {"remat": args.remat} if arch.family == "lm" else {}
    cell = build_cell(arch, shape, **kw)
    tcfg = TrainConfig(steps=args.steps, checkpoint_dir=args.ckpt_dir,
                       checkpoint_every=args.checkpoint_every, log_every=5)
    return train_loop(cell, tcfg, device=args.device)


if __name__ == "__main__":
    main()
