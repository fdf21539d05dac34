"""End-to-end training driver (port of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch glm4-9b \
        --smoke --device cpu --steps 50 --microbatches 2 --dvfs  # the CPU
    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch musicgen-medium --steps 4 --microbatches 2        # the card

Checkpoint and restart (atomic, resumable mid-run), deterministic data
(``data.pipeline.make_batch``) and, with ``dvfs``, the simulated PCSTALL
DVFS report of the job (``DVFSManager``: each step's seconds observed,
the report at the end on K4). The reference's straggler detection and
elastic re-mesh (``train/elastic.py``) are left out: they have no meaning
on one card. Every family of the model zoo trains (``models.model.loss_fn``).
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import Optional

from repro_torch import DeviceLike, resolve_device
from repro_torch.configs import TRAIN_4K, get_config, get_smoke_config
from repro_torch.configs.base import ShapeConfig, TrainConfig
from repro_torch.data.pipeline import make_batch
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.train_step import init_state, make_train_step


def train(cfg, tc: TrainConfig, shape: ShapeConfig, *, steps: int,
          resume: bool = True, dvfs: bool = False, log_every: int = 10,
          device: DeviceLike = "cuda", log: Optional[dict] = None,
          save_final: bool = True):
    """Train ``steps`` steps (from the latest checkpoint in
    ``tc.checkpoint_dir`` if ``resume``), saving every
    ``tc.checkpoint_every`` steps and, with ``save_final``, at the end.
    Returns (state, losses). If ``log`` is a dict it is filled with
    ``steps`` (each step's metrics as floats and its seconds), ``save_s``
    (the final save; absent without one) and, with ``dvfs``, the ``dvfs``
    report."""
    dev = resolve_device(device)
    state = init_state(cfg, tc, tc.seed, dev)
    start = 0
    if resume:
        try:
            state, start = ckpt.restore(state, tc.checkpoint_dir)
            start += 1
            print(f"[train] resumed from step {start - 1}")
        except FileNotFoundError:
            pass
    step_fn = make_train_step(cfg, tc)
    dvfs_mgr = None
    if dvfs:
        from repro_torch.dvfs_runtime.manager import DVFSManager
        dvfs_mgr = DVFSManager.for_model(cfg, shape, device=dev)
    log = {} if log is None else log
    log["steps"] = []

    losses = []
    for step in range(start, steps):
        t0 = time.perf_counter()
        batch = make_batch(cfg, shape, step, microbatches=tc.microbatches,
                           device=dev)
        state, metrics = step_fn(state, batch)
        metrics = {k: float(v) for k, v in metrics.items()}
        dt = time.perf_counter() - t0
        losses.append(metrics["loss"])
        log["steps"].append({"step": step, "seconds": dt, **metrics})
        if dvfs_mgr is not None:
            dvfs_mgr.observe_step(step, dt)
        if step % log_every == 0 or step == steps - 1:
            print(f"step {step:5d} loss {metrics['loss']:.4f} "
                  f"gnorm {metrics['grad_norm']:.3f} {dt * 1e3:.0f}ms")
        if tc.checkpoint_every and step and step % tc.checkpoint_every == 0:
            path = ckpt.save(state, tc.checkpoint_dir, step)
            print(f"[ckpt] saved {path}")
    if save_final:
        t0 = time.perf_counter()
        ckpt.save(state, tc.checkpoint_dir, steps - 1)
        log["save_s"] = time.perf_counter() - t0
    if dvfs_mgr is not None:
        rep = log["dvfs"] = dvfs_mgr.report()
        print(f"[dvfs] simulated energy {rep['energy_norm']:.3f}x static-1.7, "
              f"accuracy {rep['accuracy']:.3f}")
    return state, losses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="glm4-9b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--grad-compression", default="none")
    ap.add_argument("--dvfs", action="store_true")
    ap.add_argument("--no-resume", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    shape = (ShapeConfig("custom", args.seq, args.batch, "train")
             if args.smoke else TRAIN_4K)
    tc = TrainConfig(lr=args.lr, total_steps=args.steps,
                     warmup_steps=max(args.steps // 10, 5),
                     microbatches=args.microbatches,
                     checkpoint_dir=args.ckpt_dir,
                     checkpoint_every=args.ckpt_every,
                     grad_compression=args.grad_compression)
    state, losses = train(cfg, tc, shape, steps=args.steps,
                          resume=not args.no_resume, dvfs=args.dvfs,
                          device=args.device)
    if losses:
        print(f"final loss {losses[-1]:.4f} (first {losses[0]:.4f})")


if __name__ == "__main__":
    main()
