"""Device time on one CUDA card: the one method of the port's kernel
times (``chip_smoke.py``, ``scripts/epoch_ab.py``).

``device_ms(fn)`` is CUDA events around ``reps`` calls queued behind a
spin kernel (``torch.cuda._sleep``): the host queues every call while the
card spins, so the card then works through them back to back and the
window holds device time only, whatever the host costs per call. The
host must finish queueing before the spin ends, so the spin lasts ten
times the host's queueing time of a warm-up pass and at least 50 ms; a
reading where the host still outlasts it (a host that shares its cores
can stall) is taken again with a spin twice as long, and refused (None)
after four. The time is everything a call launches on the card: a
wrapper that packs its scalar operands with small PyTorch kernels pays
for them too.

``events_ms(fn)`` is CUDA events over back-to-back calls with no spin:
the time per call with the host, where the host is the slower side.

``kernel_counts(fn, reps)`` is what ``reps`` calls run on the card
(kernels, memsets, copies), by name and count, from one torch.profiler
session: the launches a call makes.

``kernel_means(fn, names)`` splits a call by kernel with torch.profiler:
each named kernel's mean duration over the records the trace kept, and
how many it kept. CUPTI drops a few kernel records per session in a
process that has traced a few thousand kernels
(``scripts/timing_probe.py``), so the split is a mean over the kept
records, never a call's time.
"""
from __future__ import annotations

import time

import torch

# the spin kernel's clock: the H100's boost clock, near enough (the
# reading checks that the spin outlasted the host's queueing)
SPIN_HZ = 1.98e9
# the spin: this many times the warm-up pass's queueing time, and no less
# than SPIN_MIN_S
SPIN_MARGIN, SPIN_MIN_S = 10.0, 0.05


def device_ms(fn, reps: int = 100, tries: int = 4):
    """ms of device time per call of ``fn`` (see the module docstring),
    or None where the host did not finish queueing inside the spin in any
    of ``tries`` readings (each spins twice as long as the one before)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    queue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    for k in range(tries):
        spin, start, end = (torch.cuda.Event(enable_timing=True)
                            for _ in range(3))
        spin.record()
        spin_s = 2 ** k * max(SPIN_MARGIN * queue_s, SPIN_MIN_S)
        torch.cuda._sleep(int(spin_s * SPIN_HZ))
        start.record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        queued_ms = (time.perf_counter() - t0) * 1e3
        end.record()
        torch.cuda.synchronize()
        if queued_ms < spin.elapsed_time(start):
            return start.elapsed_time(end) / reps
    return None


def events_ms(fn, reps: int = 200, warm: int = 20) -> float:
    """ms per call of ``fn`` by CUDA events over ``reps`` back-to-back
    calls (includes host time when the host is the slower side)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def kernel_counts(fn, reps: int = 5):
    """{name: records} of everything ``reps`` calls of ``fn`` run on the
    card (not the runtime calls that launch it), from one torch.profiler
    session after one untraced call."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {ev.key: ev.count for ev in prof.key_averages()
            if ev.count and ev.device_type is not None
            and "cuda" in str(ev.device_type).lower()}


def kernel_means(fn, names, reps: int = 100):
    """{name: (ms per launch, records kept)} for the CUDA kernels whose
    names contain each of ``names``, from one torch.profiler session of
    ``reps`` calls."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for n in names:
        t, c = 0.0, 0
        for ev in prof.key_averages():
            if n in ev.key and ev.count:
                d = getattr(ev, "device_time_total", None)
                t += getattr(ev, "cuda_time_total", 0.0) if d is None else d
                c += ev.count
        out[n] = (t / c / 1e3 if c else None, c)
    return out
