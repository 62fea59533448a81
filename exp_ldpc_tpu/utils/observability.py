"""Logging, throughput metrics, and profiler tracing.

The reference has NO observability layer: its only instrumentation is a
per-sweep-point walltime column in the results CSV
(``/root/reference/python/qldpc/misc/p_sweep.py:25,30-33``) and ad-hoc
``warnings.warn`` calls (SURVEY.md §5).  This module is the package's
first-class replacement:

  * :func:`get_logger` — package-namespaced loggers; level from the
    ``EXP_LDPC_TPU_LOG`` env var (default WARNING, so library use is silent);
  * :class:`Metrics` — named monotonic counters with derived rates
    (shots decoded/s, BP iterations/s, ...), cheap enough to leave on;
  * :func:`profiler_trace` — context manager around ``jax.profiler`` that
    dumps a TensorBoard-viewable device trace of everything inside it;
  * :func:`timed` — walltime context manager that logs (and optionally
    accumulates into a :class:`Metrics`);
  * :func:`gpu_power_report` — the card's name and power limit, to print
    beside every device number.
"""
from __future__ import annotations

import contextlib
import logging
import os
import subprocess
import time
from dataclasses import dataclass, field
from typing import Dict, Iterator, Optional

__all__ = ["get_logger", "Metrics", "profiler_trace", "timed", "gpu_power_report"]

_ROOT = "exp_ldpc_tpu"
_configured = False


def get_logger(name: str = "") -> logging.Logger:
    """Logger under the ``exp_ldpc_tpu`` namespace.

    Level comes from ``EXP_LDPC_TPU_LOG`` (DEBUG/INFO/WARNING/ERROR); handlers
    are only attached once and only to the package root, so embedding
    applications keep full control via standard logging config.
    """
    global _configured
    root = logging.getLogger(_ROOT)
    if not _configured:
        level = os.environ.get("EXP_LDPC_TPU_LOG", "WARNING").upper()
        root.setLevel(getattr(logging, level, logging.WARNING))
        if not root.handlers:
            h = logging.StreamHandler()
            h.setFormatter(
                logging.Formatter("%(asctime)s %(name)s %(levelname)s %(message)s")
            )
            root.addHandler(h)
        _configured = True
    return root if not name else logging.getLogger(f"{_ROOT}.{name}")


@dataclass
class Metrics:
    """Named monotonic counters with wall-clock rates.

    >>> m = Metrics()
    >>> m.add("shots", 4096); m.add("bp_iters", 4096 * 32)
    >>> m.report()  # {'shots': ..., 'shots_per_s': ..., ...}
    """

    counters: Dict[str, float] = field(default_factory=dict)
    _t0: float = field(default_factory=time.perf_counter)

    def add(self, name: str, value: float = 1.0) -> None:
        self.counters[name] = self.counters.get(name, 0.0) + float(value)

    def elapsed(self) -> float:
        return time.perf_counter() - self._t0

    def reset(self) -> None:
        self.counters.clear()
        self._t0 = time.perf_counter()

    def report(self) -> Dict[str, float]:
        dt = max(self.elapsed(), 1e-12)
        out: Dict[str, float] = {"elapsed_s": dt}
        for k, v in self.counters.items():
            out[k] = v
            out[f"{k}_per_s"] = v / dt
        return out

    def log(self, logger: Optional[logging.Logger] = None, level=logging.INFO) -> None:
        (logger or get_logger("metrics")).log(
            level,
            " ".join(f"{k}={v:.6g}" for k, v in sorted(self.report().items())),
        )


@contextlib.contextmanager
def profiler_trace(log_dir: str, *, host_tracer_level: int = 2) -> Iterator[None]:
    """Capture a JAX/XLA device trace of the enclosed block.

    Writes a TensorBoard trace under ``log_dir`` (view with the TensorBoard
    profile plugin, or xprof).  Gracefully degrades to a no-op if the
    profiler backend is unavailable on this platform.
    """
    import jax

    try:
        jax.profiler.start_trace(log_dir)
        started = True
    except Exception as e:  # pragma: no cover - platform dependent
        get_logger("profiler").warning("profiler unavailable: %s", e)
        started = False
    try:
        yield
    finally:
        if started:
            try:
                jax.profiler.stop_trace()
            except Exception as e:  # pragma: no cover
                get_logger("profiler").warning("stop_trace failed: %s", e)


@contextlib.contextmanager
def timed(name: str, *, metrics: Optional[Metrics] = None,
          logger: Optional[logging.Logger] = None,
          level=logging.DEBUG) -> Iterator[None]:
    """Log the walltime of the enclosed block (and count it into metrics)."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        if metrics is not None:
            metrics.add(f"{name}_s", dt)
            metrics.add(f"{name}_calls", 1)
        (logger or get_logger("timing")).log(level, "%s took %.4fs", name, dt)


def gpu_power_report() -> str:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    (one line per card), or ``""`` where there is no ``nvidia-smi``.

    A card may be set below its maximum power limit and then runs slower
    under load, so every device time is reported beside this line.  Runs
    as a child process that never imports JAX."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError):
        return ""
    return out.stdout.strip()
