"""Satellite position/clock from broadcast ephemeris — vmapped Kepler.

Math identical to reference geoFunctions/__init__.py:745-885 (satpos,
check_t), re-designed as one jitted program: it computes every
satellite at once via ``vmap`` with a fixed-count Kepler iteration
(10 fixed-point steps, the reference's cap at :846 — convergence for GPS
eccentricities e<0.03 is far below its 1e-12 tolerance by then), instead
of a per-satellite Python loop with data-dependent early exit.

All math is float64 (enabled at package import): the meter-level position
math needs ~1e-9 relative precision.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from softgnss_tpu.nav.message import GPS_PI, Ephemeris

#: WGS-84 earth rotation rate, rad/s (reference: geoFunctions:805)
OMEGA_E_DOT = 7.2921151467e-5
#: WGS-84 earth gravitational parameter, m^3/s^2 (reference: geoFunctions:807)
GM = 3.986005e14
#: relativistic clock constant -2*sqrt(GM)/c^2, s/sqrt(m) (reference: geoFunctions:810)
F_REL = -4.442807633e-10
#: seconds in half a GPS week (reference: geoFunctions:761)
HALF_WEEK = 302400.0

#: ephemeris fields consumed by the orbit propagator, in array-pack order
ORBIT_FIELDS = ("t_oc", "a_f0", "a_f1", "a_f2", "t_gd", "sqrt_a", "t_oe",
                "delta_n", "m_0", "e", "omega", "c_uc", "c_us", "c_rc",
                "c_rs", "c_ic", "c_is", "i_0", "i_dot", "omega_0", "omega_dot")


def check_t(time):
    """Half-week crossover correction (reference: geoFunctions:745-770)."""
    t = jnp.asarray(time, jnp.float64)
    t = jnp.where(t > HALF_WEEK, t - 2 * HALF_WEEK, t)
    return jnp.where(t < -HALF_WEEK, t + 2 * HALF_WEEK, t)


def pack_ephemerides(ephs: list[Ephemeris]) -> np.ndarray:
    """Pack per-satellite ephemerides into a (S, len(ORBIT_FIELDS)) f64 array."""
    out = np.zeros((len(ephs), len(ORBIT_FIELDS)))
    for i, eph in enumerate(ephs):
        for j, name in enumerate(ORBIT_FIELDS):
            v = getattr(eph, name)
            if v is None:
                raise ValueError(f"ephemeris field {name} unset for satellite {i}")
            out[i, j] = float(v)
    return out


def _satpos_one(transmit_time, p):
    """ECEF position + clock correction of one satellite at transmit_time.

    ``p``: (len(ORBIT_FIELDS),) packed ephemeris.  Equations per reference
    geoFunctions:819-885.
    """
    (t_oc, a_f0, a_f1, a_f2, t_gd, sqrt_a, t_oe, delta_n, m_0, ecc, omega,
     c_uc, c_us, c_rc, c_rs, c_ic, c_is, i_0, i_dot, omega_0, omega_dot) = p

    two_pi = 2.0 * GPS_PI

    dt = check_t(transmit_time - t_oc)
    clk = (a_f2 * dt + a_f1) * dt + a_f0 - t_gd
    time = transmit_time - clk

    a = sqrt_a * sqrt_a
    tk = check_t(time - t_oe)
    n = jnp.sqrt(GM / a**3) + delta_n
    m = jnp.remainder(m_0 + n * tk + two_pi, two_pi)

    # Kepler's equation M = E - e sin E by fixed-point iteration; 10 steps
    # (the reference's cap); fixed count keeps the program branch-free.
    def body(_, e_anom):
        return m + ecc * jnp.sin(e_anom)

    e_anom = jax.lax.fori_loop(0, 10, body, m)
    e_anom = jnp.remainder(e_anom + two_pi, two_pi)

    dtr = F_REL * ecc * sqrt_a * jnp.sin(e_anom)

    nu = jnp.arctan2(jnp.sqrt(1.0 - ecc**2) * jnp.sin(e_anom), jnp.cos(e_anom) - ecc)
    phi = jnp.remainder(nu + omega, two_pi)

    cos2p, sin2p = jnp.cos(2 * phi), jnp.sin(2 * phi)
    u = phi + c_uc * cos2p + c_us * sin2p
    r = a * (1.0 - ecc * jnp.cos(e_anom)) + c_rc * cos2p + c_rs * sin2p
    inc = i_0 + i_dot * tk + c_ic * cos2p + c_is * sin2p

    lon_node = jnp.remainder(
        omega_0 + (omega_dot - OMEGA_E_DOT) * tk - OMEGA_E_DOT * t_oe + two_pi, two_pi)

    cu, su = jnp.cos(u), jnp.sin(u)
    co, so = jnp.cos(lon_node), jnp.sin(lon_node)
    ci = jnp.cos(inc)
    x = cu * r * co - su * r * ci * so
    y = cu * r * so + su * r * ci * co
    z = su * r * jnp.sin(inc)

    clk_corr = (a_f2 * dt + a_f1) * dt + a_f0 - t_gd + dtr
    return jnp.stack([x, y, z]), clk_corr


@jax.jit
def _satpos_batch(transmit_time, packed):
    return jax.vmap(partial(_satpos_one, transmit_time))(packed)


def satellite_positions(transmit_time, ephs_or_packed) -> tuple[np.ndarray, np.ndarray]:
    """Positions (3, S) and clock corrections (S,) for all satellites.

    ``ephs_or_packed``: list of :class:`Ephemeris` or a pre-packed
    (S, len(ORBIT_FIELDS)) array.  Returned layout matches the reference's
    satpos (geoFunctions:779-885): one column per satellite.
    """
    from softgnss_tpu.nav.hostctx import host_context

    packed = ephs_or_packed
    if not isinstance(packed, (np.ndarray, jnp.ndarray)):
        packed = pack_ephemerides(packed)
    # host backend: accelerators emulate f64 at ~1e-7 effective precision,
    # meters of error at orbit radius (jitted internals stay device-agnostic
    # for in-graph use by the epoch scan)
    with host_context():
        pos, clk = _satpos_batch(jnp.float64(transmit_time),
                                 jnp.asarray(packed, jnp.float64))
        return np.asarray(pos).T, np.asarray(clk)
