"""Train a small LM end to end (reduced llama3-family config): data
pipeline -> AdamW -> remat'd train step -> checkpoint/resume -> PCSTALL
DVFS energy report (port of ``examples/train_lm.py``). On the card the
attention runs K6, and its gradient K6's backward.

  PYTHONPATH=src python examples_torch/train_lm.py CKPT_DIR      # the card
  PYTHONPATH=src python examples_torch/train_lm.py CKPT_DIR --device cpu
"""
import argparse

from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ShapeConfig, TrainConfig
from repro_torch.launch.train import train


MICROBATCHES = 2


def main(ckpt_dir, device="cuda", steps=60, seq_len=128, batch=8,
         checkpoint_every=25):
    """Trains ``steps`` steps with checkpoints under ``ckpt_dir`` (resuming
    from the latest there); prints and returns the losses. The loss must
    fall."""
    cfg = get_smoke_config("llama3-405b")
    shape = ShapeConfig("demo", seq_len=seq_len, global_batch=batch,
                        kind="train")
    tc = TrainConfig(lr=3e-3, total_steps=steps,
                     warmup_steps=max(steps // 10, 1),
                     microbatches=MICROBATCHES, checkpoint_dir=ckpt_dir,
                     checkpoint_every=checkpoint_every)
    _, losses = train(cfg, tc, shape, steps=steps, dvfs=True, device=device)
    assert losses[-1] < losses[0], "loss should decrease"
    print(f"OK: loss {losses[0]:.3f} -> {losses[-1]:.3f}")
    return losses


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("ckpt_dir")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    main(args.ckpt_dir, device=args.device)
