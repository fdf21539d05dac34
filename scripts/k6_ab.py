"""K6 (bf16) at the served prefill layouts, from the package of one source
tree, timed by ``scripts/devtime.py``'s method; run it on two trees in
turns (A, B, B, A) in one call to compare two versions of the kernel on
one card.

    git archive <commit> | tar -x -C build/parent
    python3 scripts/k6_ab.py --src build/parent/src --out chiprun_out/a1.json
    python3 scripts/k6_ab.py --src src --out chiprun_out/b1.json
    ...
    python3 scripts/k6_ab.py --compare chiprun_out/{a1,b1,b2,a2}.json

Each run builds the tree's kernel library (under the tree's own
``build/``), then times ``flash_attention_bshd`` at batch 4 and 2048
tokens at each layout the tree's K6 takes (the model's window, and its
prefix where the tree has ``prefix_len``), inputs from numpy seed 41;
and the entry the models call, ``ops.flash_attention`` (over inputs that
need no gradient, as a prefill's), by the same method and by events over
back-to-back calls (with the host). ``--compare`` prints each layout's
microseconds per call, run by run, and the card's name and power
limit.
"""
from __future__ import annotations

import argparse
import inspect
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
B, S = 4, 2048
# (name, query heads, KV heads, head dim, window, prefix)
LAYOUTS = [("glm4-9b", 32, 2, 128, 0, 0), ("phi3-mini-3.8b", 32, 32, 96, 0, 0),
           ("musicgen-medium", 24, 24, 64, 0, 0),
           ("granite-moe-1b-a400m", 16, 8, 64, 0, 0),
           ("qwen2-moe-a2.7b", 16, 16, 128, 0, 0),
           ("hymba-1.5b", 25, 5, 64, 1024, 0),
           ("paligemma-3b", 8, 1, 256, 0, 256)]


def run(src: Path, out: Path) -> int:
    sys.path.insert(0, str(src.resolve()))
    sys.path.insert(0, str(ROOT / "scripts"))
    import torch

    import devtime as DT
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ops
    if not torch.cuda.is_available():
        print("k6_ab: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    has_prefix = "prefix_len" in inspect.signature(
        FA.flash_attention_bshd).parameters
    res = {"src": str(src), "card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0], "us": {}, "ops_us": {},
        "ops_events_us": {}}
    for name, H, Hkv, hd, window, prefix in LAYOUTS:
        if hd not in FA.HEAD_DIMS or (prefix and not has_prefix):
            continue
        rng = np.random.default_rng(41)
        q, k, v = (torch.as_tensor(rng.standard_normal(s).astype(np.float32))
                   .to(dev, torch.bfloat16)
                   for s in ((B, S, H, hd), (B, S, Hkv, hd), (B, S, Hkv, hd)))
        kw = dict(causal=True, window=window)
        if prefix:
            kw["prefix_len"] = prefix
        ms = DT.device_ms(lambda: FA.flash_attention_bshd(q, k, v, **kw), 100)
        res["us"][name] = None if ms is None else ms * 1e3
        ms = DT.device_ms(lambda: ops.flash_attention(q, k, v, **kw), 100)
        res["ops_us"][name] = None if ms is None else ms * 1e3
        res["ops_events_us"][name] = DT.events_ms(
            lambda: ops.flash_attention(q, k, v, **kw)) * 1e3
    out.write_text(json.dumps(res))
    print(json.dumps(res), flush=True)
    return 0


def compare(paths) -> int:
    runs = [json.loads(Path(p).read_text()) for p in paths]
    print(f"k6_ab on {runs[0]['card']}: us per call, "
          + ", ".join(f"{Path(p).stem} ({r['src']})"
                      for p, r in zip(paths, runs)))
    for key, what in (("us", "flash_attention_bshd, device"),
                      ("ops_us", "ops.flash_attention, device"),
                      ("ops_events_us", "ops.flash_attention, with the host")):
        print(f" {what}:")
        for name, *_ in LAYOUTS:
            vals = [r.get(key, {}).get(name) for r in runs]
            print(f"  {name}: " + " / ".join(
                "-" if v is None else f"{v:.2f}" for v in vals))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", type=Path)
    ap.add_argument("--out", type=Path)
    ap.add_argument("--compare", nargs="+")
    args = ap.parse_args()
    if args.compare:
        return compare(args.compare)
    return run(args.src, args.out)


if __name__ == "__main__":
    sys.exit(main())
