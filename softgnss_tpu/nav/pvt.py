"""Least-squares PVT solver — jitted, masked, fixed-iteration Gauss-Newton.

Math identical to reference geoFunctions/__init__.py:636-739
(leastSquarePos): 7 Gauss-Newton iterations; per satellite an
earth-rotation (Sagnac) correction by current travel time, topocentric
az/el, optional Goad-Goodman troposphere; residual
``omc = obs - |RotX - pos| - clock_bias - trop``; geometry rows
``[-(LOS)/obs, 1]`` (the reference normalizes by the observation, not the
range — reproduced for DOP parity); DOP from inv(A^T A).

Design differences (results equal to f64 roundoff):

* all satellites are processed as one vectorized batch with a validity
  mask instead of a Python loop — the channel dimension stays static so
  one compiled program serves every epoch and the epoch loop can be a
  ``lax.scan`` (see softgnss_tpu.nav.solve),
* the update solves the masked normal equations with a determinant guard
  replacing the reference's rank-4 check (geoFunctions:712-715),
* iteration count is fixed (the reference's constant 7) — no
  data-dependent control flow.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from softgnss_tpu.nav.atmosphere import tropo
from softgnss_tpu.nav.geodesy import e_r_corr, topocent

SPEED_OF_LIGHT = 299792458.0
_ITERATIONS = 7


def _det3(m):
    return (m[..., 0, 0] * (m[..., 1, 1] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 1])
            - m[..., 0, 1] * (m[..., 1, 0] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 0])
            + m[..., 0, 2] * (m[..., 1, 0] * m[..., 2, 1] - m[..., 1, 1] * m[..., 2, 0]))


def inv4(a):
    """Explicit adjugate inverse + determinant of a 4x4 matrix.

    The PVT normal equations are f64 and 4x4, so the solve/inverse is
    written as closed-form cofactors (exact in f64, no LU custom call).
    The form was forced by an earlier backend's f32-only LU; it stays
    until a measurement on the card favours LU.  Returns (inverse, det).
    """
    rows = [0, 1, 2, 3]
    cof = []
    for i in range(4):
        row = []
        for j in range(4):
            sub = a[[r for r in rows if r != i], :][:, [c for c in rows if c != j]]
            row.append(((-1.0) ** (i + j)) * _det3(sub))
        cof.append(jnp.stack(row))
    cof = jnp.stack(cof)                      # cofactor matrix C[i, j]
    det = jnp.sum(a[0, :] * cof[0, :])
    return cof.T / det, det


def solve_epoch(sat_pos, obs, mask, use_trop: bool, iono_tow=None):
    """One masked PVT solve, pure jnp (composable under jit/scan/vmap).

    sat_pos: (S, 3) f64, obs: (S,) f64, mask: (S,) bool.

    ``iono_tow``: optional ((8,) Klobuchar coefficients, GPS tow) —
    applies the broadcast ionospheric correction alongside the
    troposphere (beyond the reference, which ignores subframe 4's
    coefficients entirely; see nav.iono).

    Returns (pos[4], el, az, dop[5], resid) where ``resid`` is the (S,)
    post-fit pseudorange residual at the converged position (0 where
    masked) — the input to the RAIM fault test in nav.solve (beyond the
    reference, which discards its residuals, geoFunctions:704-719)."""
    s = sat_pos.shape[0]
    wgt = mask.astype(jnp.float64)
    pos0 = jnp.zeros(4, jnp.float64)
    safe_obs = jnp.where(mask, obs, 1.0)

    def body(i, carry):
        pos, _el, _az = carry

        def first_iter(_):
            rot_x = sat_pos
            trop = jnp.full(s, 2.0)
            el = jnp.zeros(s)
            az = jnp.zeros(s)
            return rot_x, trop, el, az

        def later_iter(_):
            rho = jnp.linalg.norm(sat_pos - pos[:3], axis=-1)
            travel = rho / SPEED_OF_LIGHT
            rot_x = e_r_corr(travel, sat_pos)
            # origin is the single receiver position: broadcasting it into
            # topocent would redo the 10-iteration togeod solve per
            # satellite; batching only the delta keeps one geodetic solve
            az, el, _ = topocent(pos[:3], rot_x - pos[:3])
            if use_trop:
                trop = tropo(jnp.sin(jnp.deg2rad(el)))
            else:
                trop = jnp.zeros(s)
            if iono_tow is not None:
                from softgnss_tpu.nav.geodesy import cart2geo
                from softgnss_tpu.nav.iono import klobuchar

                iono8, tow = iono_tow
                lat, lon, _h = cart2geo(pos[0], pos[1], pos[2], 4)
                trop = trop + SPEED_OF_LIGHT * klobuchar(
                    iono8, lat, lon, az, el, tow)
            return rot_x, trop, el, az

        rot_x, trop, el, az = jax.lax.cond(i == 0, first_iter, later_iter, None)

        diff = rot_x - pos[:3]
        dist = jnp.linalg.norm(diff, axis=-1)
        omc = jnp.where(mask, obs - dist - pos[3] - trop, 0.0)
        a = jnp.concatenate([-diff / safe_obs[:, None], jnp.ones((s, 1))], axis=1)
        a = a * wgt[:, None]

        ata = a.T @ a
        atb = a.T @ omc
        inv, det = inv4(ata)
        # rank guard: the reference bails with zeros when rank(A) < 4
        ok = jnp.abs(det) > 1e-12
        delta = jnp.where(ok, inv @ atb, jnp.zeros(4))
        return pos + delta, el, az

    pos, el, az = jax.lax.fori_loop(
        0, _ITERATIONS, body, (pos0, jnp.zeros(s), jnp.zeros(s)))

    # final-geometry DOP (reference: geoFunctions:727-737)
    rho = jnp.linalg.norm(sat_pos - pos[:3], axis=-1)
    rot_x = e_r_corr(rho / SPEED_OF_LIGHT, sat_pos)
    diff = rot_x - pos[:3]
    a = jnp.concatenate([-diff / safe_obs[:, None], jnp.ones((s, 1))], axis=1)
    a = a * wgt[:, None]
    q, _ = inv4(a.T @ a)
    dop = jnp.stack([
        jnp.sqrt(jnp.trace(q)),
        jnp.sqrt(q[0, 0] + q[1, 1] + q[2, 2]),
        jnp.sqrt(q[0, 0] + q[1, 1]),
        jnp.sqrt(q[2, 2]),
        jnp.sqrt(q[3, 3]),
    ])

    # post-fit residuals at the converged position (atmosphere evaluated
    # at the final elevations carried out of the loop); feeds the RAIM
    # chi-square test in nav.solve
    if use_trop:
        trop_f = tropo(jnp.sin(jnp.deg2rad(el)))
    else:
        trop_f = jnp.zeros(s)
    if iono_tow is not None:
        from softgnss_tpu.nav.geodesy import cart2geo
        from softgnss_tpu.nav.iono import klobuchar

        iono8, tow = iono_tow
        lat, lon, _h = cart2geo(pos[0], pos[1], pos[2], 4)
        trop_f = trop_f + SPEED_OF_LIGHT * klobuchar(iono8, lat, lon, az, el, tow)
    dist_f = jnp.linalg.norm(diff, axis=-1)
    resid = jnp.where(mask, obs - dist_f - pos[3] - trop_f, 0.0)
    return pos, el, az, dop, resid


_solve_jit = jax.jit(solve_epoch, static_argnums=(3,))


def least_squares_pos(sat_pos, obs, mask=None, use_trop: bool = True):
    """Receiver position/clock from satellite positions + pseudoranges.

    ``sat_pos``: (3, S) or (S, 3); ``obs``: (S,) meters; ``mask``: (S,)
    bool of usable satellites (default all).  Returns
    (pos[4] = x,y,z,dt, el (S,) deg, az (S,) deg, dop (5,)).
    """
    sat_pos = np.asarray(sat_pos, np.float64)
    if sat_pos.shape[0] == 3 and sat_pos.shape[-1] != 3:
        sat_pos = sat_pos.T
    obs = np.asarray(obs, np.float64)
    if mask is None:
        mask = np.ones(len(obs), bool)
    from softgnss_tpu.nav.hostctx import host_context

    # host backend + cached module-level jit: a fresh jit(partial(...)) per
    # call would retrace the 7-iteration solver every invocation
    with host_context():
        pos, el, az, dop, _resid = _solve_jit(jnp.asarray(sat_pos), jnp.asarray(obs),
                                              jnp.asarray(mask), bool(use_trop))
    return (np.asarray(pos), np.asarray(el), np.asarray(az), np.asarray(dop))
