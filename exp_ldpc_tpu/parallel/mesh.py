"""Device-mesh helpers.

The reference's entire distribution story is a multiprocessing Pool fanning
shots over CPU workers (``/root/reference/python/qldpc/misc/p_sweep.py:18-29``).
The device equivalent (SURVEY.md §2.4): shard the Monte-Carlo shot batch
over a ``jax.sharding.Mesh`` data axis with ``shard_map``, reduce
logical-failure counts with ``psum``, and (for large codes) shard the check
partition over a second model axis.  Several hosts join the same mesh via
``init_distributed``.
"""
from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh

__all__ = ["make_mesh", "init_distributed", "DATA_AXIS", "MODEL_AXIS"]

DATA_AXIS = "data"
MODEL_AXIS = "model"


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> int:
    """Join a multi-host run; returns this host's process index.

    Call once per host before :func:`make_mesh`; afterwards ``jax.devices()``
    is the GLOBAL device list, so meshes built from it span every host.
    With no arguments, coordination parameters come from the environment
    (the standard ``jax.distributed.initialize()`` behavior) and failures
    degrade to single-process (the expected case on one host).
    With EXPLICIT coordination arguments a failure other than
    already-initialized re-raises — silently falling back would let every
    host run the full workload and report duplicated results as one.
    """
    explicit = coordinator_address is not None or num_processes is not None
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except RuntimeError as e:
        if explicit and "already" not in str(e).lower():
            raise
    return jax.process_index()


def make_mesh(
    n_devices: Optional[int] = None,
    model_parallel: int = 1,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Mesh of shape (data, model) over the available devices, in order.

    ``model_parallel`` devices cooperate on one decode (check-partition
    sharding).  The cards of one host reach each other all to all at the
    same rate, so the layout follows the device order alone.
    """
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    n = len(devices)
    if n % model_parallel != 0:
        raise ValueError(f"{n} devices not divisible by model_parallel={model_parallel}")
    shape = (n // model_parallel, model_parallel)
    grid = np.asarray(devices).reshape(shape)
    return Mesh(grid, (DATA_AXIS, MODEL_AXIS))
