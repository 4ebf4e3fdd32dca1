"""End-to-end driver: train a ~100M-parameter LM (a gemma2-family config)
for a few hundred steps on synthetic tokens, with checkpoints, then resume.

  python -m repro_torch.launch.train_lm                     # on the card
  PYTHONPATH=src python -m repro_torch.launch.train_lm --device cpu --steps 24 \\
      --batch 4 --seq 32 --d-model 64 --layers 2 --vocab 512 --checkpoint-every 8 \\
      --resume-steps 2 --ckpt-dir /tmp/lm

The port of ``examples/train_lm.py``: gemma2-100m (8 layers, d 512, 8 heads,
4 kv heads, head_dim 64, d_ff 2,048, a 32,000 vocab, local and global
attention with window 64, attention and logit softcaps, tied embeddings)
through ``build_cell(..., remat="none")``, ``lm_token_batches`` and
``train_loop``: a checkpoint every 100 steps into ``--ckpt-dir`` (emptied
first), then 20 more steps resumed from the last one.  The resumed run
reads the token stream on from the step it resumes at (the example hands
it the iterator the first run's prefetch had read ahead of), so it is the
uninterrupted run's, bit for bit.  It raises unless the final loss beats a
uniform guess (ln V) and the resume starts from the saved step.
``--d-model``, ``--layers`` and ``--vocab`` shrink the model (the CPU
tests).
"""
from __future__ import annotations

import argparse
import itertools
import math
import os
import shutil
import tempfile
import time

import torch

from repro_torch.common.config import ArchConfig, ShapeSpec, TrainConfig
from repro_torch.common.device import resolve_device
from repro_torch.data.loader import lm_token_batches
from repro_torch.launch.steps import build_cell
from repro_torch.launch.train import train_loop

RESUME_STEPS = 20


def gemma2_100m(d_model: int = 512, layers: int = 8, vocab: int = 32000) -> ArchConfig:
    """The example's config; ``d_model`` scales the heads' width (8 heads,
    4 kv heads) and d_ff (4 d_model)."""
    return ArchConfig(
        name="gemma2-100m", family="lm", n_layers=layers, d_model=d_model, n_heads=8,
        n_kv_heads=4, head_dim=d_model // 8, d_ff=4 * d_model, vocab_size=vocab,
        activation="geglu", attn_types=("local", "global"), window_size=64,
        attn_softcap=50.0, logit_softcap=30.0, embed_scale=True, tie_embeddings=True,
    )


def run(*, steps: int = 300, batch: int = 8, seq: int = 128, ckpt_dir: str | None = None,
        device: str = "cuda", d_model: int = 512, layers: int = 8, vocab: int = 32000,
        checkpoint_every: int = 100, resume_steps: int = RESUME_STEPS, log_every: int = 20,
        seed: int = 0) -> dict:
    """Train ``steps``, then resume for ``resume_steps`` more -> the final
    loss, the step the resume started at, both runs' per-step history, the
    resumed model and optimizer state, the peak device bytes (CUDA only)
    and the seconds of each run."""
    cfg = gemma2_100m(d_model, layers, vocab)
    shape = ShapeSpec(name="train", kind="train", seq_len=seq, global_batch=batch)
    cell = build_cell(cfg, shape, remat="none")
    ckpt_dir = ckpt_dir or os.path.join(tempfile.gettempdir(), "repro_torch_train_lm")
    shutil.rmtree(ckpt_dir, ignore_errors=True)

    def stream(start: int):
        return itertools.islice(lm_token_batches(vocab_size=cfg.vocab_size, batch=batch,
                                                 seq_len=seq, seed=seed), start, None)

    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    history: list[dict] = []
    t0 = time.perf_counter()
    _, _, metrics = train_loop(cell, TrainConfig(steps=steps, checkpoint_dir=ckpt_dir,
                                                 checkpoint_every=checkpoint_every,
                                                 log_every=log_every),
                               data_it=stream(0), device=device, history=history)
    train_s = time.perf_counter() - t0
    final = float(metrics["loss"])
    print(f"final loss {final:.3f} (uniform-random baseline ~{math.log(cfg.vocab_size):.2f})")
    if not final < math.log(cfg.vocab_size):
        raise AssertionError(f"final loss {final} does not beat uniform {math.log(vocab)}")

    saved = steps - steps % checkpoint_every if checkpoint_every else 0
    resumed: list[dict] = []
    t0 = time.perf_counter()
    model, opt, _ = train_loop(cell, TrainConfig(steps=steps + resume_steps,
                                                 checkpoint_dir=ckpt_dir, checkpoint_every=0,
                                                 log_every=log_every),
                               data_it=stream(saved), device=device, history=resumed)
    resume_s = time.perf_counter() - t0
    if not resumed or resumed[0]["step"] != saved:
        raise AssertionError(f"resume started at {resumed[:1]}, not step {saved}")
    print(f"resume from checkpoint OK (step {saved})")
    return {"final_loss": final, "resumed_from": saved, "history": history,
            "resumed": resumed, "model": model, "opt_state": opt, "cell": cell,
            "train_s": train_s, "resume_s": resume_s,
            "peak_bytes": torch.cuda.max_memory_allocated() if dev.type == "cuda" else None}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=100)
    ap.add_argument("--resume-steps", type=int, default=RESUME_STEPS)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--d-model", type=int, default=512)
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--vocab", type=int, default=32000)
    args = ap.parse_args(argv)
    out = run(steps=args.steps, batch=args.batch, seq=args.seq, ckpt_dir=args.ckpt_dir,
              device=args.device, d_model=args.d_model, layers=args.layers, vocab=args.vocab,
              checkpoint_every=args.checkpoint_every, resume_steps=args.resume_steps)
    ms = [h["ms"] for h in out["history"][1:]] or [h["ms"] for h in out["history"]]
    print(f"{sum(ms) / len(ms):.1f} ms a step, "
          f"{args.batch * args.seq * 1e3 / (sum(ms) / len(ms)):.0f} tokens/s, "
          f"peak bytes {out['peak_bytes']}")
    return out


if __name__ == "__main__":
    main()
