"""``repro_torch.launch.train_lm`` (the port of ``examples/train_lm.py``) on
the CPU at reduced widths: its config is the example's, it trains past a
uniform guess, checkpoints, and a resumed run is the uninterrupted run's,
bit for bit."""
import ast
import itertools
import math
import os

import pytest
import torch

ROOT = os.path.join(os.path.dirname(__file__), "..")
SMALL = dict(batch=4, seq=32, d_model=64, layers=2, vocab=512)


def _example_config_kwargs() -> dict:
    """The keyword literals of the ``ArchConfig(...)`` call in
    ``examples/train_lm.py`` (read, not run: the example imports JAX)."""
    tree = ast.parse(open(os.path.join(ROOT, "examples", "train_lm.py")).read())
    call = next(n for n in ast.walk(tree) if isinstance(n, ast.Call)
                and getattr(n.func, "id", None) == "ArchConfig")
    return {k.arg: ast.literal_eval(k.value) for k in call.keywords}


def test_config_is_the_examples():
    from repro.common.config import ArchConfig as RefArchConfig

    from repro_torch.launch.train_lm import gemma2_100m

    want = RefArchConfig(**_example_config_kwargs())
    got = gemma2_100m()
    for field, value in vars(want).items():
        got_value = getattr(got, field)
        assert (list(got_value) if isinstance(got_value, tuple) else got_value) == \
            (list(value) if isinstance(value, tuple) else value), field


def test_train_checkpoint_kill_and_resume_is_bit_for_bit(tmp_path):
    """24 steps with a checkpoint every 8, then a fresh model and optimizer
    restored from step 24 run 4 more on the stream read on from step 24:
    parameters, both moments and each resumed step's loss equal 28 steps
    straight through.  The final loss beats a uniform guess (ln 512)."""
    from repro_torch.checkpoint import latest_step
    from repro_torch.common.config import TrainConfig
    from repro_torch.data.loader import lm_token_batches
    from repro_torch.launch import train_lm
    from repro_torch.launch.train import train_loop

    r = train_lm.run(steps=24, checkpoint_every=8, resume_steps=4, device="cpu", log_every=100,
                     ckpt_dir=str(tmp_path / "run"), **SMALL)
    assert r["resumed_from"] == 24 and latest_step(str(tmp_path / "run")) == 24
    assert r["final_loss"] < math.log(SMALL["vocab"])
    assert [h["step"] for h in r["resumed"]] == [24, 25, 26, 27]

    stream = itertools.islice(lm_token_batches(vocab_size=SMALL["vocab"], batch=SMALL["batch"],
                                               seq_len=SMALL["seq"], seed=0), 0, None)
    straight: list[dict] = []
    model, opt, _ = train_loop(r["cell"], TrainConfig(steps=28, checkpoint_every=0,
                                                      checkpoint_dir=str(tmp_path / "straight"),
                                                      log_every=100),
                               data_it=stream, device="cpu", history=straight)
    assert [h["loss"] for h in straight[:24]] == [h["loss"] for h in r["history"]]
    assert [h["loss"] for h in straight[24:]] == [h["loss"] for h in r["resumed"]]
    for name, p in model.state_dict().items():
        assert torch.equal(p, r["model"].state_dict()[name]), name
    assert opt.step == r["opt_state"].step == 28
    for a, b in zip(opt.m + opt.v, r["opt_state"].m + r["opt_state"].v):
        assert torch.equal(a, b)


def test_launcher_main_on_the_cpu(tmp_path, capsys):
    """``main()`` with reduced widths: trains, resumes from its last saved
    step, reports its step time; a CUDA run refuses a machine without a
    card."""
    from repro_torch.launch import train_lm

    args = ["--device", "cpu", "--steps", "24", "--batch", "4", "--seq", "32", "--d-model", "64",
            "--layers", "2", "--vocab", "512", "--ckpt-dir", str(tmp_path),
            "--checkpoint-every", "16", "--resume-steps", "2"]
    out = train_lm.main(args)
    printed = capsys.readouterr().out
    assert "resume from checkpoint OK (step 16)" in printed and "ms a step" in printed
    assert out["resumed_from"] == 16 and [h["step"] for h in out["resumed"]] == list(range(16, 26))
    assert out["peak_bytes"] is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            train_lm.main(args[2:])
