"""How far a token-by-token decode lands from the prefill's logits at full
width, and how much of that the bf16 arithmetic alone explains.

    PYTHONPATH=src python3 scripts/decode_gap_probe.py

For glm4-9b and rwkv6-3b at their published widths and depths (random
weights from a seed), on one CUDA card, for the model in bf16 (as served)
and in f32:

* ``decode``: the logits after decoding 256 tokens one by one from an
  empty cache, against the prefill of the same 256 tokens (B = 1);
* ``batch``: the prefill of the same sequence as row 0 of a batch of 4,
  against the B = 1 prefill. The function is the same; only the matrix
  products' shapes, and so cuBLAS's summation order, differ. This is the
  arithmetic's own noise floor for the model in that dtype.

Prints, for each, the max abs difference, the max relative to the logits'
largest magnitude, and whether the argmax agrees, beside the card's name
and power limit.
"""
from __future__ import annotations

import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch import no_tf32  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import model as LM  # noqa: E402

S = 256


def gap(a: torch.Tensor, b: torch.Tensor) -> str:
    d = (a.double() - b.double()).abs()
    scale = float(b.double().abs().max())
    agree = bool((a.argmax(-1) == b.argmax(-1)).all())
    return (f"max abs {float(d.max()):.3e}, max / max|logit| "
            f"{float(d.max()) / scale:.3e} (max|logit| {scale:.3f}), "
            f"argmax {'agrees' if agree else 'differs'}")


def main() -> int:
    if not torch.cuda.is_available():
        print("decode_gap_probe: needs a CUDA card", file=sys.stderr)
        return 2
    no_tf32()
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    for arch in ("glm4-9b", "rwkv6-3b"):
        for dtype in ("bfloat16", "float32"):
            cfg = dataclasses.replace(get_config(arch), dtype=dtype)
            torch.cuda.empty_cache()
            params = LM.init_params(cfg, 1, dev)
            rng = np.random.default_rng(8)
            toks = torch.as_tensor(rng.integers(0, cfg.vocab, (4, S))).to(dev)
            one = LM.prefill(params, cfg, {"tokens": toks[:1]})
            four = LM.prefill(params, cfg, {"tokens": toks})
            cache = LM.init_cache(cfg, 1, S, device=dev)
            for i in range(S):
                logits, cache = LM.decode_step(params, cfg, cache,
                                               toks[:1, i])
            torch.cuda.synchronize()
            print(f"{arch} {dtype} decode x {S} vs prefill: "
                  f"{gap(logits, one)} on {card}", flush=True)
            print(f"{arch} {dtype} prefill in a batch of 4 vs alone: "
                  f"{gap(four[:1], one)} on {card}", flush=True)
            del params, cache
    return 0


if __name__ == "__main__":
    sys.exit(main())
