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
back-to-back calls (with the host). At musicgen-medium's training layout
(batch 4, 4096 tokens, causal) it times K6 without the log-sum-exp and,
where the tree's K6 has ``return_lse``, with it (what training's forward
asks for); where the tree has K6's backward (``flash_attention_bshd_bwd``)
it times that by the same method at musicgen-medium's and hymba-1.5b's
training layouts (batch 4, 4096 tokens; 24 heads of 64, causal; 25 over 5
heads of 64, window 1024), inputs from numpy seed 45. Each run also
records a digest of the SASS of the tree's bf16 forward kernels
(``flash_attention_kernel_wgmma``, by ``cuobjdump -sass`` of its library,
names stripped of their per-build namespace tag): two trees whose K6
forward compiles to the same machine code print the same digest.
``--compare`` prints each layout's microseconds per call, run by run,
the digests, and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import hashlib
import inspect
import json
import re
import shutil
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
# musicgen-medium's training layout: (batch, tokens, heads, head dim)
TRAIN = (4, 4096, 24, 64)
TRAIN_ROWS = ("musicgen-medium train", "musicgen-medium train, lse")
# K6's backward at the training layouts: (name, batch, tokens, query heads,
# KV heads, head dim, window)
BWD_ROWS = [("musicgen-medium train, backward", 4, 4096, 24, 24, 64, 0),
            ("hymba-1.5b train, backward", 4, 4096, 25, 5, 64, 1024)]


def sass_digest(lib: Path) -> str | None:
    """sha256 (16 hex digits) of the SASS of every bf16 K6 forward kernel
    in ``lib``, function by function in name order, or None where
    cuobjdump is missing."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return None
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, timeout=600).stdout
    funcs = [re.sub(r"_GLOBAL__N__\w+?_cu_[0-9a-f]{8}", "anon", f)
             for f in re.split(r"\n\s*Function : ", text)
             if f.lstrip().startswith("_Z")
             and "flash_attention_kernel_wgmma" in f.split("\n", 1)[0]]
    h = hashlib.sha256()
    for f in sorted(funcs):
        h.update(f.encode())
    return f"{len(funcs)} kernels, {h.hexdigest()[:16]}"


def run(src: Path, out: Path) -> int:
    sys.path.insert(0, str(src.resolve()))
    sys.path.insert(0, str(ROOT / "scripts"))
    import torch

    import devtime as DT
    from repro_torch import kernels as K
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
    has_lse = "return_lse" in inspect.signature(
        FA.flash_attention_bshd).parameters
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
    Bt, St, Ht, hdt = TRAIN
    rng = np.random.default_rng(44)
    q, k, v = (torch.as_tensor(rng.standard_normal((Bt, St, Ht, hdt)).astype(
        np.float32)).to(dev, torch.bfloat16) for _ in range(3))
    for name, lse in zip(TRAIN_ROWS, (False, True)):
        if lse and not has_lse:
            continue
        kw = dict(return_lse=True) if lse else {}
        ms = DT.device_ms(lambda: FA.flash_attention_bshd(q, k, v, **kw), 100)
        res["us"][name] = None if ms is None else ms * 1e3
    if hasattr(FA, "flash_attention_bshd_bwd"):
        for name, Bb, Sb, Hb, Hkvb, hdb, wb in BWD_ROWS:
            rng = np.random.default_rng(45)
            q, do = (torch.as_tensor(rng.standard_normal(
                (Bb, Sb, Hb, hdb)).astype(np.float32)).to(
                    dev, torch.bfloat16) for _ in range(2))
            k, v = (torch.as_tensor(rng.standard_normal(
                (Bb, Sb, Hkvb, hdb)).astype(np.float32)).to(
                    dev, torch.bfloat16) for _ in range(2))
            o, lse = FA.flash_attention_bshd(q, k, v, window=wb,
                                             return_lse=True)
            ms = DT.device_ms(lambda: FA.flash_attention_bshd_bwd(
                q, k, v, o, do, lse, window=wb), 20)
            res["us"][name] = None if ms is None else ms * 1e3
            del q, k, v, do, o, lse
            torch.cuda.empty_cache()
    K.library()
    res["forward_sass"] = sass_digest(K._BUILD_ROOT / K._digest() / K._LIB_NAME)
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
        for name in ([row[0] for row in LAYOUTS] + list(TRAIN_ROWS)
                     + [row[0] for row in BWD_ROWS]):
            vals = [r.get(key, {}).get(name) for r in runs]
            if all(x is None for x in vals):
                continue
            print(f"  {name}: " + " / ".join(
                "-" if v is None else f"{v:.2f}" for v in vals))
    print(" forward SASS: " + " / ".join(
        str(r.get("forward_sass")) for r in runs))
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
