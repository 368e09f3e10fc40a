"""softgnss_tpu — a GPS L1 C/A software receiver framework in JAX.

A brand-new JAX/XLA implementation of a full GPS L1 C/A software
receiver: C/A (Gold) code generation, FFT-based parallel code-phase
acquisition over a Doppler grid, multi-channel DLL/PLL tracking with
integer-NCO carrier/code generators and early-prompt-late correlator banks,
bit/frame synchronization, nav-message parity checking and ephemeris
decoding, Kepler orbit propagation, and least-squares PVT with tropospheric
correction, DOP, and geodetic/UTM output.

Capability parity target: perrysou/SoftGNSS-python (see SURVEY.md).  This is
*not* a port — the architecture is accelerator-first:

* acquisition is one batched FFT/multiply/IFFT over the whole
  (PRN x Doppler x code-phase) tensor (reference: acquisition.py:92-133 loops
  PRN x bin in Python),
* tracking is a ``lax.scan`` over milliseconds with channels vmapped and
  shardable over a device mesh (reference: tracking.py:59,132 nested Python
  loops with per-iteration file reads),
* carrier and code phase run on exact integer NCOs (uint32 / Q40 fixed point)
  so the hot path is pure f32/int vector math — no float64 in the per-sample
  compute,
* the capture lives in device memory and is consumed with dynamic slices;
  there is no host I/O inside the hot loop.

The package enables ``jax_enable_x64`` at import: the code-phase NCO carries
Q40 fixed point in int64, and the cold-path geodesy/orbit math
(tolerances ~1e-12, reference geoFunctions/__init__.py:44,853) needs f64.
All hot-path arrays are explicitly float32/complex64/int32.
"""

import jax as _jax

_jax.config.update("jax_enable_x64", True)

from softgnss_tpu.config import ReceiverConfig, default_config, fast_config  # noqa: E402,F401

__version__ = "0.1.0"


def run_receiver(*args, **kwargs):
    """Convenience re-export of softgnss_tpu.pipeline.run_receiver."""
    from softgnss_tpu.pipeline import run_receiver as _run

    return _run(*args, **kwargs)
