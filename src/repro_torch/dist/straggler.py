"""Windowed straggler detection for distributed drivers.

Counterpart of ``repro.dist.straggler``.  A straggler is a worker whose
*recent* step times are persistently slower than its peers'.  Distributed
CP-ALS is iteration-synchronous (every mode update ends in an all-reduce),
so one slow host gates the whole mesh: the medium-grained algorithm's known
failure mode when the non-zero partition is imbalanced.  The monitor is
runtime-only: it touches no device state.

Detection is relative, not absolute: a host is *slow* when the mean of its
last ``window`` step times exceeds ``threshold`` x the median of all
hosts' means, and *persistent* once that has held for ``patience``
consecutive :meth:`StragglerMonitor.check` calls.  The median makes the
baseline robust to the stragglers themselves; the patience counter
debounces one-off hiccups (GC pauses, checkpoint writes).

The drivers feed it through :func:`record_step_times`, which exchanges
the step times across the ranks of a ``torch.distributed`` run.
"""
from __future__ import annotations

import statistics
from collections import deque
from typing import Dict


class StragglerMonitor:
    """Track per-host step wall-times; flag persistently slow hosts.

    Args:
      window:    number of recent step times kept per host.
      threshold: a host is slow when its window mean exceeds
                 ``threshold`` x the median of all hosts' window means.
      patience:  consecutive slow ``check()`` results before a host is
                 escalated from ``"slow"`` to ``"persistent"``.
      warmup:    minimum samples a host needs before it participates in
                 ``check()`` at all (avoids flagging on compile-step
                 noise).
    """

    def __init__(self, window: int = 20, threshold: float = 1.5,
                 patience: int = 3, warmup: int = 2):
        if window < 1 or patience < 1 or warmup < 1:
            raise ValueError("window, patience and warmup must be >= 1")
        if warmup > window:
            raise ValueError(f"warmup ({warmup}) > window ({window}) would "
                             "never report: the rolling window can't fill")
        if threshold <= 1.0:
            raise ValueError("threshold must be > 1.0 (relative slowdown)")
        self.window = window
        self.threshold = threshold
        self.patience = patience
        self.warmup = warmup
        self._times: Dict[int, deque] = {}
        self._strikes: Dict[int, int] = {}

    def record(self, host: int, seconds: float) -> None:
        """Record one step's wall time for ``host``."""
        dq = self._times.get(host)
        if dq is None:
            dq = self._times[host] = deque(maxlen=self.window)
            self._strikes[host] = 0
        dq.append(float(seconds))

    def means(self) -> Dict[int, float]:
        """Window mean per host, warmed-up hosts only."""
        return {h: sum(dq) / len(dq) for h, dq in self._times.items()
                if len(dq) >= self.warmup}

    def check(self) -> Dict[int, str]:
        """Flag slow hosts: ``{host: "slow" | "persistent"}``.

        Returns ``{}`` during warmup (no host has ``warmup`` samples yet).
        A host whose window mean drops back under the threshold has its
        patience counter reset — recovery clears the flag immediately.
        """
        means = self.means()
        if not means:
            return {}
        baseline = statistics.median(means.values())
        flags: Dict[int, str] = {}
        for host, mean in means.items():
            if baseline > 0.0 and mean > self.threshold * baseline:
                self._strikes[host] += 1
                flags[host] = ("persistent"
                               if self._strikes[host] >= self.patience
                               else "slow")
            else:
                self._strikes[host] = 0
        if flags:
            # escalations feed the obs metrics registry (straggler.slow /
            # straggler.persistent counters) and the flight recorder
            from repro_torch.obs.metrics import get_registry
            from repro_torch.obs.recorder import record_event

            registry = get_registry()
            for host, flag in flags.items():
                registry.counter(f"straggler.{flag}").inc()
                record_event("straggler", host=int(host), flag=flag,
                             mean_s=means[host], baseline_s=baseline)
        return flags

    def reset(self) -> None:
        """Drop all history (e.g. after a rebalance or restart)."""
        self._times.clear()
        self._strikes.clear()


def record_step_times(monitor: StragglerMonitor, seconds: float) -> None:
    """Record one step's wall time under EVERY participating rank.

    Detection is relative, so each process's monitor needs its peers'
    times: with several ranks in the ``torch.distributed`` world this
    all-gathers the local wall time (every rank then holds the full picture
    and flags the same hosts), on the card under NCCL; a single process
    records host 0.  Every rank must call it at the same step."""
    import torch
    import torch.distributed as dist

    if dist.is_initialized() and dist.get_world_size() > 1:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if dist.get_backend() == "nccl" else torch.device("cpu"))
        mine = torch.tensor([float(seconds)], dtype=torch.float32,
                            device=device)
        times = mine.new_empty((dist.get_world_size(),))
        from .collectives import _all_gather

        _all_gather(times, mine, None)
        for host, t in enumerate(times.cpu().tolist()):
            monitor.record(host, float(t))
    else:
        monitor.record(0, float(seconds))
