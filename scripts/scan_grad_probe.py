"""The gradients of K7 and K8 on one CUDA card, at the training layouts.

    PYTHONPATH=src python3 scripts/scan_grad_probe.py [--train ARCH ...]

Prints nvcc's report for the K8 backward kernel (registers, spills,
shared memory), then holds it against its plain version at hymba-1.5b's
training layout (B 4, S 4096, 25 heads of 64, N 16, from a non-zero h0
and g_hout), checks two calls bit for bit, and times it by
``scripts/devtime.py`` beside its bound (bytes at 3.35e12 B/s); times
the K7 backward (PyTorch operations) at rwkv6-3b's layout (B 1, S 4096,
40 heads of 64) and holds it against autograd through the plain
version. With ``--train`` it trains each named model at full width for
``--steps`` steps of 8 x 4096 tokens in ``--microbatches`` microbatches
through ``make_train_step`` and prints step seconds and peak memory.
"""
from __future__ import annotations

import argparse
import re
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
import devtime as DT  # noqa: E402

from repro_torch import kernels as K  # noqa: E402
from repro_torch import no_tf32  # noqa: E402
from repro_torch.kernels import rwkv_chunk as RC  # noqa: E402
from repro_torch.kernels import ssm_scan as SS  # noqa: E402

HBM_BYTES_PER_S = 3.35e12


def card() -> str:
    import subprocess
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]


def rel(a, b) -> float:
    return float((a.double() - b.double()).abs().max() / b.abs().max())


def k8_bwd(dev, name):
    B, S, H, hd, N = 4, 4096, 25, 64, 16
    rng = np.random.default_rng(5)
    f = np.float32
    arrs = (rng.standard_normal((B, S, H, hd)), rng.uniform(0.01, 1.5,
                                                            (B, S, H)),
            rng.standard_normal((B, S, N)), rng.standard_normal((B, S, N)),
            -rng.uniform(0.2, 2.0, H), rng.standard_normal((B, H, hd, N)) * .5,
            rng.standard_normal((B, S, H, hd)),
            rng.standard_normal((B, H, hd, N)))
    args = [torch.as_tensor(a.astype(f)).to(dev) for a in arrs]
    got = SS.ssm_scan_bwd(*args)
    again = SS.ssm_scan_bwd(*args)
    t0 = time.perf_counter()
    want = SS.ssm_scan_bwd_ref(*args)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    for n, g, w in zip(("dxh", "ddt", "dB_", "dC_", "dA", "dh0"), got, want):
        print(f"K8 bwd {n}: max |err| {float((g - w).abs().max()):.3e}, "
              f"{rel(g, w):.3e} of its largest magnitude", flush=True)
    print(f"K8 bwd two calls bitwise equal: "
          f"{all(torch.equal(a, b) for a, b in zip(got, again))}")
    ms = DT.device_ms(lambda: SS.ssm_scan_bwd(*args), 20)
    nb = sum(t.numel() * 4 for t in args) + sum(t.numel() * 4 for t in got)
    print(f"K8 bwd at hymba's training layout (B {B} S {S} H {H} hd {hd} N "
          f"{N}): device {ms} ms per call, bound "
          f"{nb / HBM_BYTES_PER_S * 1e3:.4f} ms (bytes {nb / 1e6:.1f} MB), "
          f"plain {plain_s * 1e3:.1f} ms, on {name}", flush=True)


def k7_bwd(dev, name):
    B, T, H, hd = 1, 4096, 40, 64
    rng = np.random.default_rng(6)
    f = np.float32
    r, k, v, gy = (torch.as_tensor(rng.standard_normal(
        (B, T, H, hd)).astype(f) * 0.5).to(dev) for _ in range(4))
    w = torch.as_tensor(rng.uniform(0.6, 0.999, (B, T, H, hd)).astype(
        f)).to(dev)
    u = torch.as_tensor(rng.standard_normal((H, hd)).astype(f) * .1).to(dev)
    got = RC.rwkv_chunked_bthd_bwd(r, k, v, w, u, gy)
    ins = [t.clone().requires_grad_() for t in (r, k, v, w, u)]
    want = torch.autograd.grad(RC.rwkv_chunked_bthd_ref(*ins), ins, gy)
    for n, g, wt in zip("rkvwu", got, want):
        print(f"K7 bwd d{n}: {rel(g, wt):.3e} of its largest magnitude",
              flush=True)
    ms = DT.events_ms(lambda: RC.rwkv_chunked_bthd_bwd(r, k, v, w, u, gy),
                      reps=10, warm=2)
    print(f"K7 bwd at rwkv6-3b's layout (B {B} T {T} H {H} hd {hd}): "
          f"{ms:.3f} ms per call (events) on {name}", flush=True)


def train(arch, steps, mb, dev, name):
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig, TrainConfig
    from repro_torch.data.pipeline import make_batch
    from repro_torch.train.train_step import init_state, make_train_step
    cfg = get_config(arch)
    tc = TrainConfig(total_steps=steps, warmup_steps=1, microbatches=mb)
    shape = ShapeConfig("probe", 4096, 8, "train")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state = init_state(cfg, tc, 0, dev)
    step = make_train_step(cfg, tc)
    print(f"{arch}: state {torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB "
          f"after init", flush=True)
    for i in range(steps):
        batch = make_batch(cfg, shape, i, microbatches=mb, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        loss = float(m["loss"])
        print(f"{arch} step {i}: {time.perf_counter() - t0:.3f} s, loss "
              f"{loss:.4f}, grad_norm {float(m['grad_norm']):.4f}, peak "
              f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB on "
              f"{name}", flush=True)
    del state, step


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--train", nargs="*", default=[])
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--microbatches", type=int, default=2)
    ap.add_argument("--only-train", action="store_true")
    args = ap.parse_args()
    dev = torch.device("cuda", 0)
    name = card()
    print(f"card: {name}", flush=True)
    no_tf32()
    K.library()
    log = K.BUILD["log"]
    sec = log[log.index("== ssm_scan_bwd.cu"):]
    print(re.split(r"\n== ", sec)[0], flush=True)
    if not args.only_train:
        k8_bwd(dev, name)
        k7_bwd(dev, name)
    for arch in args.train:
        train(arch, args.steps, args.microbatches, dev, name)


if __name__ == "__main__":
    main()
