"""Serve a reduced RWKV6 (attention-free: O(1)-state decode) with batched
requests: prefill + 48 decode steps, plus the DVFS phase report (port of
``examples/serve_batched.py``). On the card a prompt longer than the
WKV's 128-token chunk, and a multiple of it, runs the chunked WKV kernel
(K7); the reference's 64-token prompt takes the token scan, as in the
reference; call ``main(prompt_len=256)`` to drive K7.

  PYTHONPATH=src python examples_torch/serve_batched.py          # the card
  PYTHONPATH=src python examples_torch/serve_batched.py --device cpu
"""
import argparse

from repro_torch.configs import get_smoke_config
from repro_torch.launch.serve import serve


ARCH = "rwkv6-3b"


def main(device="cuda", batch=4, prompt_len=64, gen=48, dvfs=True):
    """Prints and returns ``serve``'s report (``prefill_s``,
    ``decode_s_per_tok``, ``tokens`` and, with ``dvfs``, ``dvfs``: the
    service's 400 epochs of the job's program)."""
    cfg = get_smoke_config(ARCH)
    rep = serve(cfg, batch=batch, prompt_len=prompt_len, gen=gen, dvfs=dvfs,
                device=device)
    print(f"prefill {rep['prefill_s'] * 1e3:.1f}ms, "
          f"decode {rep['decode_s_per_tok'] * 1e3:.2f}ms/tok")
    if dvfs:
        print(f"dvfs energy {rep['dvfs']['energy_norm']:.3f}x static, "
              f"accuracy {rep['dvfs']['accuracy']:.3f}")
    return rep


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    main(device=ap.parse_args().device)
