"""The epoch kernels of one checkout: their outputs, to compare two
checkouts bit for bit, and their device times, to compare them in turns
(needs one CUDA card).

    python3 <checkout>/scripts/epoch_ab.py [--out run.pt]
    python3 scripts/epoch_ab.py --compare a.pt b.pt

Each run imports the ``chip_smoke.py`` and ``src/`` of the checkout that
holds this script and feeds that checkout's ``epoch_fused`` /
``epoch_fused_rows`` the same numpy-seeded inputs: K3 (pc, reactive) at
64 x 40, K4 at the Fig-15 grid's 40 rows in both math modes and at the
managers' 16 x 40, and K5 at the service's 8 rows of 304 x 40 in blocks
of 38. It saves every output and prints each call's device time
(``scripts/devtime.py``: CUDA events around 100 calls queued behind a
spin kernel) and its split by kernel (torch.profiler means). ``--compare``
prints, per case, the outputs that are not bitwise equal.
"""
from __future__ import annotations

import argparse
import re
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "scripts"))

import torch  # noqa: E402

import devtime as DT  # noqa: E402


def _cases(CS, dev):
    from repro_torch.core import simulate as SIM
    from repro_torch.kernels import epoch_fused as KEF
    out = {}
    for fam, est, model in (("pc", False, None), ("reactive", False,
                                                  "crisp")):
        args, kw = CS.epoch_case(fam, est, model, 11, dev)
        out[f"K3 {fam}"] = lambda a=args, k=kw: KEF.epoch_fused(*a, **k)
    ids40 = [SIM.FORK_MECH_IDS[m] for m in ("crisp", "accreac", "pcstall",
                                            "accpc")]
    a40, k40 = CS.fork_rows_case([i for i in ids40 for _ in range(10)],
                                 CS.FIG15_WORKLOADS, 31, dev)
    out["K4 R=40"] = lambda: KEF.epoch_fused_rows(*a40, **k40)
    out["K4 R=40 exact"] = lambda: KEF.epoch_fused_rows(*a40, **k40,
                                                        lean=False)
    progs = [CS.arch_program(CS.get_config(a), CS.TRAIN_4K, device=dev)
             for a in CS.MANAGER_ARCHS]
    am, km = CS.fork_rows_case(list(range(7)), progs, 27, dev,
                               cu=CS.MANAGER_CU, tables=CS.MANAGER_CU)
    out["K4 managers"] = lambda: KEF.epoch_fused_rows(*am, **km)
    a8, k8 = CS.fork_rows_case([0, 1, 2, 3, 4, 5, 6, 5],
                               list(CS.SVC_WORKLOADS), 25, dev,
                               lens=[1024, 768, 896, 512], cu=304, wf=40,
                               tables=304)
    out["K5 R=8"] = lambda: KEF.epoch_fused_rows(*a8, **k8, block_cu=38)
    return out


def _kernels(fn):
    """The names of the CUDA kernels one call of ``fn`` launches."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [ev.key for ev in prof.key_averages() if ev.count]


def _short(name):
    m = re.search(r"(\w+<\d+>|\w+_kernel\w*)\(", name)
    return m.group(1) if m else name.split("<")[0].split("::")[-1]


def run(out_path: str) -> int:
    import chip_smoke as CS
    from repro_torch import no_tf32
    dev = torch.device("cuda", 0)
    no_tf32()
    print("card:", CS.card_line(), "checkout:", ROOT, flush=True)
    saved = {}
    for label, fn in _cases(CS, dev).items():
        saved[label] = {k: v.detach().cpu()
                        for k, v in CS.out_fields(fn()).items()}
        torch.cuda.synchronize()
        ms = DT.device_ms(fn)
        if ms is None:
            print(f"{label}: the host did not queue inside the spin",
                  flush=True)
            return 1
        means = DT.kernel_means(fn, _kernels(fn))
        print(f"{label}: {ms * 1e3:.2f} us per call (by kernel: " + ", ".join(
            f"{_short(k)} {m * 1e3:.2f} ({c})" for k, (m, c) in means.items())
            + ")", flush=True)
    if out_path:
        torch.save(saved, out_path)
    return 0


def compare(a_path: str, b_path: str) -> int:
    a, b = torch.load(a_path), torch.load(b_path)
    for label in a:
        differ = [k for k in a[label]
                  if not torch.equal(a[label][k], b[label][k])]
        print(f"{label}: " + ("bitwise equal in every output" if not differ
                              else "differ in " + ", ".join(differ)))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out")
    ap.add_argument("--compare", nargs=2)
    a = ap.parse_args()
    if a.compare:
        return compare(*a.compare)
    if not torch.cuda.is_available():
        print("epoch_ab: CUDA is not available", file=sys.stderr)
        return 2
    return run(a.out)


if __name__ == "__main__":
    sys.exit(main())
