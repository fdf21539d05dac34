"""Where K4 and its plain version part in ``react_i0`` at the managers'
layout, on one NVIDIA GPU.

    python3 scripts/react_i0_probe.py

Builds ``chip_smoke.py``'s K4 case at ``DVFSManager.for_model``'s layout
(16 CUs x 40 WFs, 16 tables, the llama3-405b and qwen2-moe-a2.7b
training-step programs, one row per traced id 0-6), runs the kernel and
the plain version, and prints, per row, the element of ``react_i0`` worst
against the standard limit (1e-4 + 1e-5 |ref|) beside the CU's committed
work over T, the scale of the estimate's operands; then every element
past that limit.
"""
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as C  # noqa: E402


def main() -> None:
    dev = torch.device("cuda", 0)
    progs = [C.arch_program(C.get_config(a), C.TRAIN_4K, device=dev)
             for a in C.MANAGER_ARCHS]
    ids = list(range(7))
    args, kw = C.fork_rows_case(ids, progs, 27, dev, cu=C.MANAGER_CU,
                                tables=C.MANAGER_CU)
    got = C.out_fields(C.KEF.epoch_fused_rows(*args, **kw))
    want = C.out_fields(C.KEF.epoch_fused_rows_ref(*args, **kw))
    torch.cuda.synchronize()
    T = kw["scal"][:, :1].cpu().double()
    g, w = got["react_i0"].cpu().double(), want["react_i0"].cpu().double()
    err = (g - w).abs()
    ratio = err / (C.ATOL + C.RTOL * w.abs())
    work_t = want["work"].cpu().double() / T
    eps = torch.finfo(torch.float32).eps
    print(C.card_line())
    for r in ids:
        c = int(ratio[r].argmax())
        print(f"id {r} cu {c}: ref {w[r, c]:.6f} got {g[r, c]:.6f} err "
              f"{err[r, c]:.3e} (err/limit {ratio[r, c]:.3f}); work/T "
              f"{work_t[r, c]:.3f}, its ulp {eps * work_t[r, c]:.3e}")
    over = (ratio > 1).nonzero().tolist()
    print(f"elements past the standard limit: {len(over)} of "
          f"{ratio.numel()}")
    for r, c in over:
        print(f"  id {r} cu {c}: ref {w[r, c]:.6f} err {err[r, c]:.3e} "
              f"work/T {work_t[r, c]:.3f}")


if __name__ == "__main__":
    main()
