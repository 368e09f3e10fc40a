"""Device-mesh construction and multi-host bootstrap.

The receiver's mesh has two named axes (config.time_axis, config.channel_axis):

* ``'time'``  — partitions the IF capture into contiguous blocks
  (sequence-parallel axis; halos are exchanged with ``lax.ppermute``),
* ``'channel'`` — partitions tracking channels / acquisition PRNs
  (data-parallel axis; no communication until observables are gathered).

On several hosts, call :func:`initialize_distributed` first (wraps
jax.distributed.initialize), then build the mesh over all global devices.
The cards of one GPU host are joined all to all, so the mesh is built in
plain device order: the algorithm alone decides its shape.
"""

from __future__ import annotations

import logging

import jax
import numpy as np
from jax.sharding import Mesh

from softgnss_tpu.config import ReceiverConfig

logger = logging.getLogger(__name__)


def initialize_distributed(coordinator_address: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None) -> None:
    """Bootstrap multi-host JAX (no-op on a single host).

    Arguments default to the standard cluster environment variables
    (JAX_COORDINATOR_ADDRESS etc.); pass them explicitly for manual runs.
    """
    if num_processes is not None and num_processes <= 1:
        return
    try:
        jax.distributed.initialize(coordinator_address=coordinator_address,
                                   num_processes=num_processes,
                                   process_id=process_id)
        logger.info("jax.distributed initialized: process %d/%d, %d global devices",
                    jax.process_index(), jax.process_count(), jax.device_count())
    except (ValueError, RuntimeError) as exc:  # already initialized / single host
        logger.debug("distributed init skipped: %s", exc)


def make_mesh(axis_sizes: dict[str, int], devices=None) -> Mesh:
    """Build a Mesh with the given {axis_name: size} layout."""
    shape = tuple(axis_sizes.values())
    if devices is None:
        n = int(np.prod(shape))
        avail = jax.devices()
        if n > len(avail):
            raise ValueError(f"mesh needs {n} devices, only {len(avail)} available")
        devices = np.asarray(avail[:n], dtype=object).reshape(shape)
    return Mesh(devices, tuple(axis_sizes.keys()))


def receiver_mesh(config: ReceiverConfig, n_time: int = 1,
                  n_channel: int | None = None) -> Mesh:
    """The receiver's ('time', 'channel') mesh over available devices.

    ``n_channel`` defaults to all remaining devices after the time axis.
    """
    total = jax.device_count()
    if n_channel is None:
        if total % n_time:
            raise ValueError(f"{total} devices not divisible by n_time={n_time}")
        n_channel = total // n_time
    return make_mesh({config.time_axis: n_time, config.channel_axis: n_channel})
