"""Streaming DVFS service (port of ``repro.dvfs_runtime.service``):
asynchronous micro-batched grid dispatch.

Fine-grain DVFS is a continuous control problem; at fleet scale the
controller is a long-lived process absorbing a stream of (job, telemetry)
requests. This module turns the sweep layer into that service:

* ``submit`` never waits on the device: a request enqueues and resolves
  through a ``concurrent.futures.Future``;
* a dispatcher thread coalesces queued requests into micro-batches (up to
  ``max_batch`` jobs within a ``coalesce_s`` window), pads each batch to
  one of the executor's static shape ``buckets`` and dispatches it through
  the batched steps ``run_grid`` runs, so the whole stream is served by
  one build per family and every streamed row is bitwise equal to the
  one-shot grid answer, at every batch size (the executor floors
  dispatches at 2 rows);
* a depth-``depth`` semaphore bounds the batches in flight, so batch N+1's
  operand staging and host-to-device copies overlap batch N's kernels on
  the card; dispatch itself never synchronises;
* a collector thread alone synchronises: it waits for finished batches in
  dispatch order, cuts them into per-job traces, attaches manager-schema
  reports (``repro_torch.dvfs_runtime.manager.point_report``) and resolves
  the futures.

``stats()`` reports sustained jobs per second and latency percentiles.

Differences from the reference: there is no buffer donation (each
dispatch builds its initial carry and the loop releases it), and the
service runs on one card (``n_dev`` None or 1, as ``GridExecutor`` takes).
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from concurrent.futures import Future
from typing import Dict, Iterable, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch import DeviceLike
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core import mechanisms as MECH
from repro_torch.core.mechanisms import MechanismSpec
from repro_torch.core.simulate import SimConfig
from repro_torch.core.sweep import GridExecutor, PendingGrid
from repro_torch.core.workloads import Program
from repro_torch.dvfs_runtime.manager import StepLog, point_report
from repro_torch.dvfs_runtime.telemetry import arch_program

Mechanism = Union[str, MechanismSpec]

_SHUTDOWN = object()


@dataclasses.dataclass
class _Request:
    program: Program
    axes: dict
    telemetry: Tuple[Tuple[int, float], ...]
    future: Future
    t_submit: float


class DVFSService:
    """A long-lived streaming front-end over one :class:`GridExecutor`.

    ``submit(program, axes, telemetry)`` returns a Future at once; its
    result is ``{"traces", "report", "latency_s", "batch_size"}`` where
    ``traces`` is the job's ``{mechanism: trace}`` dict (bitwise equal to
    a one-shot ``run_grid`` over the same job) and ``report`` the
    manager-schema point report against the service baseline, with the
    request's own step-time telemetry stats.

    ``buckets`` is the set of static micro-batch shapes (default one
    bucket of ``max_batch``); ``coalesce_s`` is how long the dispatcher
    waits to fill a batch before dispatching short; ``depth`` is the
    number of batches in flight (2 = double buffering).
    """

    def __init__(self, static_cfg: SimConfig,
                 mechanism: Mechanism = "pcstall",
                 baseline: Mechanism = "static17", *,
                 max_batch: int = 8,
                 buckets: Optional[Sequence[int]] = None,
                 coalesce_s: float = 0.002,
                 depth: int = 2,
                 p_max: int = 1024,
                 n_dev: Optional[int] = None,
                 with_reports: bool = True):
        assert depth >= 1
        self.static_cfg = static_cfg
        self.baseline = MECH.resolve(baseline)
        self.mechanism = MECH.resolve(mechanism)
        specs = [self.baseline]
        if self.mechanism.name != self.baseline.name:
            specs.append(self.mechanism)
        if buckets is None:
            buckets = (max_batch,)
        self.executor = GridExecutor(static_cfg, specs, p_max=p_max,
                                     buckets=buckets, n_dev=n_dev)
        self.coalesce_s = coalesce_s
        self.depth = depth
        self.with_reports = with_reports

        self._q: "queue.SimpleQueue" = queue.SimpleQueue()
        self._done: "queue.SimpleQueue" = queue.SimpleQueue()
        self._inflight = threading.BoundedSemaphore(depth)
        self._lock = threading.Lock()
        self._lat: list = []
        self._batch_sizes: list = []
        self._t_first: Optional[float] = None
        self._t_last: Optional[float] = None
        self._closed = False
        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, name="dvfs-dispatch", daemon=True)
        self._collector = threading.Thread(
            target=self._collect_loop, name="dvfs-collect", daemon=True)
        self._dispatcher.start()
        self._collector.start()

    @classmethod
    def for_model(cls, cfg: ModelConfig, shape: ShapeConfig,
                  objective: str = "ed2p", n_cu: int = 16,
                  device: DeviceLike = "cuda", **kw) -> "DVFSService":
        """A service sized like ``DVFSManager.for_model`` (same
        ``SimConfig``), with the job's step program on ``device`` as
        ``default_program``."""
        sim = SimConfig(n_cu=n_cu, n_epochs=400, objective=objective)
        svc = cls(sim, **kw)
        svc.default_program = arch_program(cfg, shape, device=device)
        return svc

    # ------------------------------------------------------------------
    # accept loop
    # ------------------------------------------------------------------

    def submit(self, program: Program, axes: Optional[dict] = None,
               telemetry: StepLog = ()) -> Future:
        """Enqueue one (job, telemetry) request. Never waits on the
        device: returns a Future resolved by the collector thread."""
        fut: Future = Future()
        now = time.perf_counter()
        # the closed check and the enqueue share the lock with close(), so
        # no request slips in behind the shutdown token unresolved
        with self._lock:
            if self._closed:
                raise RuntimeError("DVFSService is closed")
            if self._t_first is None:
                self._t_first = now
            self._q.put(_Request(
                program, dict(axes or {}),
                tuple((int(s), float(t)) for s, t in telemetry), fut, now))
        return fut

    def map(self, requests: Iterable[tuple]) -> list:
        """Submit a whole request iterable, then gather the results in
        order. Each request is ``(program, axes)`` or ``(program, axes,
        telemetry)``. Blocks only on the gather."""
        futs = [self.submit(*r) for r in requests]
        return [f.result() for f in futs]

    # ------------------------------------------------------------------
    # worker threads
    # ------------------------------------------------------------------

    def _dispatch_loop(self) -> None:
        max_batch = self.executor.max_batch
        while True:
            req = self._q.get()
            if req is _SHUTDOWN:
                self._done.put(_SHUTDOWN)
                return
            batch = [req]
            stop = False
            deadline = time.perf_counter() + self.coalesce_s
            while max_batch is None or len(batch) < max_batch:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is _SHUTDOWN:
                    stop = True
                    break
                batch.append(nxt)
            # at most `depth` dispatched batches alive: this acquire is the
            # only backpressure, and it waits on the collector, never on
            # the device
            self._inflight.acquire()
            try:
                pending = self.executor.dispatch(
                    [(r.program, r.axes) for r in batch])
            except Exception as e:  # bad request: fail the batch, move on
                self._inflight.release()
                for r in batch:
                    r.future.set_exception(e)
            else:
                self._done.put((pending, batch))
            if stop:
                self._done.put(_SHUTDOWN)
                return

    def _collect_loop(self) -> None:
        while True:
            item = self._done.get()
            if item is _SHUTDOWN:
                return
            pending, batch = item
            pending: PendingGrid
            try:
                traces = pending.block_until_ready().traces()
            except Exception as e:
                for r in batch:
                    r.future.set_exception(e)
                self._inflight.release()
                continue
            self._inflight.release()
            t_done = time.perf_counter()
            lats = [t_done - r.t_submit for r in batch]
            with self._lock:
                self._lat.extend(lats)
                self._batch_sizes.append(len(batch))
                self._t_last = t_done
            for r, trs, lat in zip(batch, traces, lats):
                res = {"traces": trs, "latency_s": lat,
                       "batch_size": len(batch)}
                if self.with_reports:
                    epoch_us = float(r.axes.get(
                        "epoch_us", self.static_cfg.epoch_us))
                    res["report"] = point_report(
                        trs, epoch_us, self.baseline, self.mechanism,
                        self.static_cfg.power.n_freqs, r.telemetry)
                r.future.set_result(res)

    # ------------------------------------------------------------------
    # stats / lifecycle
    # ------------------------------------------------------------------

    def stats(self) -> Dict[str, float]:
        """Sustained throughput and latency percentiles over every job
        resolved so far (latency = submit -> result ready)."""
        with self._lock:
            lat = np.asarray(self._lat, np.float64)
            sizes = list(self._batch_sizes)
            wall = (self._t_last - self._t_first) \
                if (self._t_first is not None and self._t_last is not None) \
                else 0.0
        n = int(lat.size)
        return {
            "jobs": n,
            "batches": len(sizes),
            "mean_batch": float(np.mean(sizes)) if sizes else 0.0,
            "wall_s": wall,
            "jobs_per_sec": n / wall if wall > 0 else 0.0,
            "p50_latency_s": float(np.percentile(lat, 50)) if n else 0.0,
            "p99_latency_s": float(np.percentile(lat, 99)) if n else 0.0,
            "max_latency_s": float(lat.max()) if n else 0.0,
        }

    def reset_stats(self) -> None:
        """Zero the throughput and latency counters (the built steps
        stay): warm the service, reset, then measure the steady state."""
        with self._lock:
            self._lat.clear()
            self._batch_sizes.clear()
            self._t_first = self._t_last = None

    def close(self) -> None:
        """Drain: everything submitted before ``close`` still resolves
        (FIFO ahead of the shutdown token), then both threads exit."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._q.put(_SHUTDOWN)
        self._dispatcher.join()
        self._collector.join()

    def __enter__(self) -> "DVFSService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
