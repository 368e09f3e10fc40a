"""Integer numerically-controlled oscillators (NCOs) for carrier and code.

The reference generates carrier/code phase with float64 ``linspace``/``arange``
per block (reference: tracking.py:166-201).  float32 phase ramps lose
~1e-2 rad at the end of a 38192-sample block (value ~6e4 rad, eps32
~1.2e-7), and float64 vector math in the per-sample hot path is costly on
accelerators.  We instead use *exact* integer phase accumulators — the
same trick real GNSS hardware NCOs use:

* **Carrier**: phase in uint32 "turns" (2^32 counts per cycle).  Per-sample
  phase ``p0 + w*k`` uses natural int32 wraparound == mod 2^32.  Converting to
  radians costs one f32 multiply; worst-case angle error is 2pi/2^24 ~ 4e-7
  rad, and frequency quantization fs/2^32 < 0.01 Hz.

* **Code**: chip phase in Q40 fixed point (int64).  Block sizes, ceil'd chip
  indices, and the per-ms phase remainder are computed with exact integer
  arithmetic, so the tracking recurrence is bit-reproducible for a given
  Q40 step sequence and invariant to channel/time sharding on a platform.
  Across platforms, the f64->Q40 quantization of the loop-filter output can
  differ by 1 ulp (f64 rounding differs by backend), occasionally moving
  a block boundary by one sample — the same class of divergence the
  float64 original has across BLAS variants.

Requires jax_enable_x64 (int64); enabled at package import.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

#: carrier phase fractional bits (uint32 turns)
CARRIER_FRAC_BITS = 32
#: code phase fractional bits (Q40 chips in int64)
CODE_FRAC_BITS = 40
#: one chip in Q40
CODE_ONE = 1 << CODE_FRAC_BITS

_TWO32 = float(2**32)
_RAD_PER_COUNT = jnp.float32(2.0 * jnp.pi / _TWO32)


def _wrap_u32_to_i32(x64):
    """Reduce an int64 to its low 32 bits, reinterpreted as int32."""
    low = jnp.bitwise_and(jnp.int64(x64), jnp.int64(0xFFFFFFFF))
    # values >= 2^31 become negative int32 — same bit pattern, mod-2^32 math
    return (low - (low >> 31 << 32)).astype(jnp.int32)


def carrier_angles(phase0_i32, step_i32, k_i32):
    """Phase angles (radians, f32) at sample offsets ``k``: (p0 + w*k) counts.

    int32 multiply/add wraps mod 2^32 — exactly the NCO semantics.  The
    returned angle is in [0, 2pi).
    """
    counts = phase0_i32 + step_i32 * k_i32
    # reinterpret int32 as unsigned turns
    u = counts.astype(jnp.uint32)
    return u.astype(jnp.float32) * _RAD_PER_COUNT


def code_step_q(code_freq_hz, sampling_freq: float):
    """Code NCO step in Q40 chips/sample: round(codeFreq/fs * 2^40), int64."""
    return jnp.int64(jnp.round(code_freq_hz / sampling_freq * float(CODE_ONE)))


def chips_to_q(chips: float) -> int:
    """Host-side: exact Q40 representation of a chip count."""
    return int(round(chips * CODE_ONE))


def q_to_chips(q):
    """Q40 -> float64 chips."""
    return jnp.asarray(q, jnp.int64).astype(jnp.float64) / float(CODE_ONE)


def ceil_chip_index(phase_q):
    """ceil(phase / 2^40) via arithmetic shift — exact for any sign.

    floor((x + 2^40 - 1) / 2^40) == ceil(x / 2^40); `>>` on int64 is an
    arithmetic (flooring) shift.
    """
    return ((phase_q + (CODE_ONE - 1)) >> CODE_FRAC_BITS).astype(jnp.int32)


def sin_turns(x):
    """sin(2*pi*x) for x in turns, via a fused minimax polynomial.

    A 5-term odd polynomial on the folded quadrant: pure multiply-adds
    that fuse into the surrounding elementwise graph, exact to ~4e-6
    absolute in f32 — far below the correlator noise floor.  Chosen on an
    earlier backend where jnp.sin/cos did not fuse; kept until a
    measurement on the card says jnp.sin is as cheap.
    """
    x = x - jnp.floor(x + 0.5)                        # [-0.5, 0.5)
    # fold |x| > 0.25 back onto the first quadrant: sin(pi - t) = sin(t)
    x = jnp.where(x > 0.25, 0.5 - x, x)
    x = jnp.where(x < -0.25, -0.5 - x, x)
    t2 = x * x
    # minimax coefficients for sin(2 pi x) on |x| <= 0.25
    return x * (6.2831853071795860
                + t2 * (-41.341702240399755
                        + t2 * (81.60524927607504
                                + t2 * (-76.70585975306136
                                        + t2 * 42.05869394489765))))


def carrier_turns(phase0_i32, step_i32, k_i32):
    """Carrier NCO phase at sample offsets ``k``, in turns [0, 1), f32.

    Built from the top 23 NCO bits directly as an f32 mantissa
    (1.0 + u/2^32 is exactly representable): 0x3F800000 | (u >> 9).  This
    skips the u32->f32 convert; the 2^-23-turn truncation (~7.5e-7 rad)
    is far below the sine polynomial's own ~4e-6 error.
    """
    counts = phase0_i32 + step_i32 * k_i32
    u = counts.astype(jnp.uint32)
    mant = (u >> jnp.uint32(9)) | jnp.uint32(0x3F800000)
    return jax.lax.bitcast_convert_type(mant, jnp.float32) - jnp.float32(1.0)


def carrier_sin_cos(phase0_i32, step_i32, k_i32):
    """(sin, cos) of the carrier NCO phase at sample offsets ``k``.

    Same phase semantics as :func:`carrier_angles` but in turns with the
    polynomial sine — fully fusing elementwise math.
    """
    turns = carrier_turns(phase0_i32, step_i32, k_i32)
    return sin_turns(turns), sin_turns(turns + 0.25)


def carrier_step_u32(freq_hz, sampling_freq: float):
    """Carrier NCO step: round(f/fs * 2^32) reduced to int32 wraparound counts.

    ``freq_hz`` may be a traced f64 scalar/array.
    """
    w = jnp.int64(jnp.round(jnp.asarray(freq_hz, jnp.float64) / sampling_freq * _TWO32))
    return _wrap_u32_to_i32(w)
