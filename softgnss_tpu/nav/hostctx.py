"""Host (CPU) device context for the cold-path f64 navigation math.

Navigation is float64 math on tiny arrays with ~1e-9 precision needs
(geodesy tolerances ~1e-12, SURVEY.md hard parts 4-5), where device
dispatch and compilation outweigh the arithmetic.  The device->host
boundary sits at the per-ms tracking observables: everything downstream
runs under :func:`host_context`.  The pin predates any GPU measurement
(the H100 has native f64); it stays until the card measures device
against host navigation.
"""

from __future__ import annotations

import contextlib

import jax


def host_device():
    """The CPU device, or None when no CPU backend exists."""
    try:
        return jax.local_devices(backend="cpu")[0]
    except RuntimeError:
        return None


def host_context():
    """Context manager pinning computation to the host CPU (no-op without one)."""
    cpu = host_device()
    return jax.default_device(cpu) if cpu is not None else contextlib.nullcontext()
