"""Serving driver: batched prefill, then a greedy decode loop over a KV or
state cache (port of ``repro.launch.serve``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-3b \
        --prompt-len 2048 --gen 32 --batch 4 --dvfs            # the card
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-3b \
        --smoke --device cpu --prompt-len 64 --gen 8           # the CPU

The prefill runs the model's kernels (K6 for attention, K7 for the RWKV
WKV, K8 for the hybrid family's selective scan) on a CUDA device. For the
vision frontend (paligemma-3b) the prompt is ``n_patches`` patch
embeddings, drawn in bf16 as the reference draws them, then
``prompt_len - n_patches`` text tokens. The decode steps are plain
PyTorch (K8 in the hybrid family's), the argmax
stays on the device (no host sync per token). With ``dvfs`` the loop's
per-step telemetry streams through :class:`DVFSService` every
``dvfs_stride`` tokens, as the reference's does.

As in the reference, the decode cache starts as a zero cache at
``pos = prompt_len``: the prefill's keys, values and states are not
written into it.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.models.model import (decode_step, init_cache, init_params,
                                      prefill)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve(cfg, *, batch: int, prompt_len: int, gen: int, seed: int = 0,
          dvfs: bool = False, dvfs_stride: int = 16,
          device: DeviceLike = "cuda"):
    dev = resolve_device(device)
    params = init_params(cfg, seed, dev)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    vision = cfg.frontend == "vision"
    St = prompt_len - cfg.n_patches if vision else prompt_len
    pbatch = {"tokens": torch.randint(0, cfg.vocab, (batch, St),
                                      generator=g, device=dev)}
    if vision:
        pbatch["patch_embeds"] = torch.randn(
            (batch, cfg.n_patches, cfg.d_model), generator=g, device=dev,
            dtype=torch.bfloat16)

    _sync(dev)
    t0 = time.perf_counter()
    first = prefill(params, cfg, pbatch)
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    svc = futs = window = None
    if dvfs:
        from repro_torch.dvfs_runtime.service import DVFSService
        shape = ShapeConfig("serve", prompt_len + gen, batch, "decode")
        svc = DVFSService.for_model(cfg, shape, coalesce_s=0.001,
                                    device=dev)
        futs, window = [], []

    cache = init_cache(cfg, batch, prompt_len + gen, fill=prompt_len,
                       device=dev)
    tok = first.argmax(-1).to(torch.int32)
    out = [tok]
    t0 = time.perf_counter()
    t_prev = t0
    for step in range(gen):
        logits, cache = decode_step(params, cfg, cache, tok)
        tok = logits.argmax(-1).to(torch.int32)
        out.append(tok)
        if svc is not None:
            # dispatch-cadence telemetry: wall time between decode
            # dispatches, no extra device syncs on the decode loop
            t_now = time.perf_counter()
            window.append((step, t_now - t_prev))
            t_prev = t_now
            if (step + 1) % dvfs_stride == 0 or step == gen - 1:
                futs.append(svc.submit(svc.default_program,
                                       telemetry=window))
                window = []
    _sync(dev)
    t_decode = (time.perf_counter() - t0) / gen
    report = {"prefill_s": t_prefill, "decode_s_per_tok": t_decode,
              "tokens": torch.stack(out, 1), "prefill_logits": first,
              "last_logits": logits}
    if svc is not None:
        with svc:
            results = [f.result() for f in futs]
        report["dvfs"] = results[-1]["report"]
        report["dvfs_requests"] = len(results)
        report["dvfs_stream"] = svc.stats()
    return report


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="rwkv6-3b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--dvfs", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    rep = serve(cfg, batch=args.batch, prompt_len=args.prompt_len,
                gen=args.gen, dvfs=args.dvfs, device=args.device)
    print(f"prefill {rep['prefill_s'] * 1e3:.1f}ms  "
          f"decode {rep['decode_s_per_tok'] * 1e3:.2f}ms/tok  "
          f"out shape {tuple(rep['tokens'].shape)}")
    if "dvfs" in rep:
        d, s = rep["dvfs"], rep["dvfs_stream"]
        print(f"[dvfs] energy {d['energy_norm']:.3f}x acc {d['accuracy']:.3f}"
              f"  steps {d['step_time']['n_steps']}  "
              f"stream {rep['dvfs_requests']} reqs "
              f"p99 {s['p99_latency_s'] * 1e3:.0f}ms")


if __name__ == "__main__":
    main()
