"""Navigation orchestration: tracking output -> ephemerides -> PVT fixes.

Covers reference postNavigation.py:27-305 (calculatePseudoranges +
postNavigate): find preambles, integrate nav bits, decode ephemerides,
then per measurement epoch compute pseudoranges from the tracked
``absolute_sample`` counters, propagate satellites, and solve
least-squares PVT with elevation masking and geodetic/UTM conversion.

Array program: the measurement-epoch loop is ONE jitted ``lax.scan``
carrying the elevation mask — per epoch it does a masked min for
pseudoranges, a vmapped Kepler propagation, the fixed-iteration masked
Gauss-Newton PVT, and cart2geo — instead of the reference's Python loop
calling per-satellite routines (postNavigation.py:199-301).

Documented divergences (reference quirks NOT replicated, SURVEY.md §7):

* epoch capacity is sized from the data (the reference hardcodes 64
  epochs and overflows at 72, postNavigation.py:178-198),
* channels are indexed by channel number, not by position in the active
  list (postNavigation.py:122-125,566-570),
* channels whose decoded TOW disagrees with the majority are dropped with
  a warning (the reference silently uses the last channel's TOW,
  postNavigation.py:140,172),
* the UTM zone is computed once from the first valid fix and reused (the
  reference recomputes per epoch; it is constant for a static receiver).
"""

from __future__ import annotations

import logging
from collections import Counter
from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from softgnss_tpu.config import ReceiverConfig
from softgnss_tpu.nav.geodesy import cart2geo, cart2utm, find_utm_zone
from softgnss_tpu.nav.message import (Ephemeris, UtcParams, decode_ephemeris,
                                      decode_iono, decode_tow, decode_utc)
from softgnss_tpu.nav.orbit import _satpos_one, pack_ephemerides
from softgnss_tpu.nav.hostctx import host_context
from softgnss_tpu.nav.preamble import find_preambles
from softgnss_tpu.nav.pvt import inv4, solve_epoch

logger = logging.getLogger(__name__)

_MS_PER_BIT = 20

_FRAME_BITS = 1500

#: chi-square inverse CDF at confidence 0.999 (per-epoch false-alarm
#: probability 1e-3) for 1..16 degrees of freedom — the RAIM fault-test
#: thresholds on the normalized residual sum of squares
_CHI2_999 = np.array([10.828, 13.816, 16.266, 18.467, 20.515, 22.458,
                      24.322, 26.124, 27.877, 29.588, 31.264, 32.909,
                      34.528, 36.123, 37.697, 39.252])
#: minimum capture for a solution: 5 subframes + sync margin
#: (reference guard: postNavigation.py:104)
MIN_NAV_MS = 36000
#: minimum capture on which a WARM-START solution (externally supplied
#: ephemerides) is POSSIBLE: preamble confirmation needs two
#: 6000-ms-spaced hits plus the 60-bit TLM+HOW read for the TOW, then
#: >= 1 measurement epoch.  8 s suffices only when the first preamble
#: lands in the capture's first ~1.8 s (phase uniform over the 6 s
#: subframe => ~30% of starts); a fix is GUARANTEED (any preamble phase,
#: after PLL settling) from ~15 s.  The gate is the feasibility floor,
#: not the guarantee — below-guarantee captures are attempted and warn
#: if confirmation fails.
MIN_WARM_NAV_MS = 8000


@dataclass
class NavSolutions:
    """Per-epoch navigation solutions (E epochs, C channels).

    Field roles mirror the reference's navSolutions recarray
    (postNavigation.py:178-198) with data-sized epoch capacity.
    """

    x: np.ndarray            # (E,) ECEF, m
    y: np.ndarray
    z: np.ndarray
    dt: np.ndarray           # (E,) receiver clock bias, m
    latitude: np.ndarray     # (E,) deg
    longitude: np.ndarray    # (E,) deg
    height: np.ndarray       # (E,) m
    e: np.ndarray            # (E,) UTM easting
    n: np.ndarray            # (E,) UTM northing
    u: np.ndarray            # (E,) UTM up
    dop: np.ndarray          # (5, E) GDOP PDOP HDOP VDOP TDOP
    prn: np.ndarray          # (C, E) int, 0 where unused
    el: np.ndarray           # (C, E) deg
    az: np.ndarray           # (C, E) deg
    raw_p: np.ndarray        # (C, E) m
    corrected_p: np.ndarray  # (C, E) m
    utm_zone: int
    first_subframe: np.ndarray  # (C,) ms index of first preamble (0 = none)
    tow: float               # GPS time of week of the first epoch, s
    #: receiver ECEF velocity (E,) per axis + clock drift, from carrier
    #: Doppler (beyond the reference, which has no velocity solution)
    vx: np.ndarray | None = None
    vy: np.ndarray | None = None
    vz: np.ndarray | None = None
    clock_drift: np.ndarray | None = None   # (E,) m/s
    #: capture ms of epoch 0 (subframe sync + sol period); epoch k is at
    #: first_epoch_ms + k * nav_sol_period_ms
    first_epoch_ms: int = 0
    #: (8,) Klobuchar coefficients applied (decoded or supplied), or None
    iono: np.ndarray | None = None
    #: (E,) RAIM outcome per epoch (beyond the reference): 0 = residuals
    #: consistent, 1 = fault isolated & excluded (see raim_excluded_prn),
    #: 2 = fault detected but not isolable — epoch invalidated (NaN fix)
    raim_flag: np.ndarray | None = None
    #: (E,) PRN excluded by RAIM at each epoch (0 = none)
    raim_excluded_prn: np.ndarray | None = None
    #: GPS->UTC parameters decoded from subframe 4 page 18 (or supplied
    #: on warm start), or None; see utc_offset_s (the reference discards
    #: subframes 4-5 and has no UTC output)
    utc_params: UtcParams | None = None
    #: full GPS week number of the decoded ephemerides (reference decodes
    #: the 10-bit week + 1024 but never exposes it in navSolutions)
    week_number: int | None = None
    #: which filter produced the primary columns: 'lsq' (reference-parity
    #: per-epoch least squares) or 'ekf' (nav.ekf PV+clock filter)
    nav_filter: str = "lsq"
    #: with nav_filter='ekf': the per-epoch least-squares solution kept
    #: for comparison — (x, y, z, dt) arrays of shape (E,)
    lsq_x: np.ndarray | None = None
    lsq_y: np.ndarray | None = None
    lsq_z: np.ndarray | None = None
    lsq_dt: np.ndarray | None = None
    #: with nav_filter='ekf': (E,) accepted pseudorange updates per epoch
    #: (innovation-gated — an outlier-rejected satellite also lowers it)
    ekf_used: np.ndarray | None = None
    #: (E,) usable satellites per epoch (post elevation-mask / lock /
    #: RAIM masking) — < 4 marks an outage epoch the EKF bridges
    n_used: np.ndarray | None = None
    #: {prn: nav.message.Almanac} pages collected from subframe 4/5 of
    #: this capture (one page per 30-s frame; the reference discards
    #: subframes 4-5).  Convert via message.almanac_to_ephemeris for
    #: acquisition assistance (nav.assist)
    almanac: dict | None = None

    def utc_offset_s(self, epoch: int = 0) -> float | None:
        """GPS-minus-UTC offset (s) at a measurement epoch, from the
        broadcast UTC parameters — subtract from GPS time of week for UTC
        (IS-GPS-200 20.3.3.5.2.4).  None without utc_params/week."""
        if self.utc_params is None or self.week_number is None:
            return None
        tow = self.tow + (self.first_epoch_ms
                          + epoch * self._period_ms) / 1000.0
        return self.utc_params.gps_to_utc_offset(tow, self.week_number)

    @property
    def n_epochs(self) -> int:
        return self.x.shape[0]

    @property
    def ttff_ms(self) -> float:
        """Time to first fix: capture ms of the first finite solution
        (inf if none).  Beyond the reference, which reports no timing."""
        ok = np.flatnonzero(np.isfinite(self.x))
        if ok.size == 0:
            return float("inf")
        return float(self.first_epoch_ms + ok[0] * self._period_ms)

    #: filled at construction so ttff_ms needs no config
    _period_ms: int = 500


def calculate_pseudoranges(config: ReceiverConfig, absolute_sample: np.ndarray,
                           ms_of_signal: np.ndarray, channel_list: np.ndarray) -> np.ndarray:
    """Relative pseudoranges (m) at per-channel millisecond indices.

    ``absolute_sample``: (C, n_ms) tracked sample counters;
    ``ms_of_signal``: (C,) per-channel ms index; ``channel_list``: active
    channel indices.  Math per reference postNavigation.py:27-72.
    """
    c_ch = absolute_sample.shape[0]
    travel = np.full(c_ch, np.inf)
    for ch in channel_list:
        travel[ch] = absolute_sample[ch, int(ms_of_signal[ch])] / config.samples_per_code
    travel = travel - np.floor(travel.min()) + config.start_offset_ms
    return travel * config.speed_of_light / 1000.0


@partial(jax.jit, static_argnums=(0, 1))
def _epoch_scan(config: ReceiverConfig, use_trop: bool, packed_eph, base_mask,
                travel_time, transmit_times, doppler_meas, lock_ok,
                iono8=None, raim_sigma=np.inf, ekf_sigma=5.0):
    """Scan over measurement epochs.

    packed_eph: (C, F); base_mask: (C,) bool; travel_time: (C, E) ms units;
    transmit_times: (E,) s; doppler_meas: (C, E) measured carrier Doppler, Hz;
    lock_ok: (C, E) bool — False once a channel's tracking lock was lost
    (lock demotion, profiling.channel_lock_loss); iono8: optional (8,)
    Klobuchar coefficients (subframe 4 page 18) applied inside the solve;
    raim_sigma: one-sigma pseudorange error (m) for the RAIM fault test —
    jnp.inf disables detection (used for the sigma-calibration pass, which
    reuses this same compiled program); ekf_sigma: pseudorange one-sigma
    (m) of the EKF measurement model (used when config.nav_filter='ekf').
    """
    elev_mask = config.elevation_mask_deg
    c_light = config.speed_of_light
    lam = c_light / config.l1_freq
    use_ekf = config.nav_filter == "ekf"
    # the EKF needs a CONTINUOUS common travel anchor across epochs: the
    # LS path re-floors per epoch (removing the ~period-per-epoch common
    # receive-time advance AND stepping by whole ms as the minimum travel
    # crosses integers — fatal for a filter modeling clock bias as
    # continuous).  Anchor at the first epoch's floor plus the nominal
    # per-epoch advance; residual receiver clock drift stays in cdt.
    n_ep = travel_time.shape[1]
    anchors = (jnp.floor(jnp.min(jnp.where(
        base_mask, travel_time[:, 0], jnp.inf)))
        + config.nav_sol_period_ms * jnp.arange(n_ep, dtype=jnp.float64))

    def step(carry, inputs):
        sat_elev, ekf_state = carry
        travel, t_tx, doppler, locked, anchor = inputs
        mask = base_mask & locked & (sat_elev >= elev_mask)

        # pseudoranges: masked min (reference postNavigation.py:52-71)
        tmin = jnp.floor(jnp.min(jnp.where(mask, travel, jnp.inf)))
        raw_p = (travel - tmin + config.start_offset_ms) * c_light / 1000.0

        sat_pos, clk = jax.vmap(partial(_satpos_one, t_tx))(packed_eph)
        obs = raw_p + clk * c_light

        iono_tow = None if iono8 is None else (iono8, t_tx)
        pos, el, az, dop, resid = solve_epoch(sat_pos, obs, mask, use_trop,
                                              iono_tow)
        n_used = jnp.sum(mask)
        ok = n_used > 3

        # --- RAIM fault detection & exclusion (beyond the reference) ------
        # Normalized post-fit residual SSE ~ chi2(n_used - 4) under the
        # null; on a fault, leave-one-out re-solves isolate the faulty
        # satellite when redundancy allows (n_used >= 6), else the epoch
        # is invalidated.  The exclusion is per-epoch: the carry keeps the
        # excluded satellite's elevation so it is re-tested (and
        # re-excluded while the fault persists) at later epochs.
        c_ch = mask.shape[0]
        mask_eff = mask
        raim_flag = jnp.int32(0)
        excl_ch = jnp.int32(-1)
        sse_raw = jnp.sum(resid * resid)
        if config.raim:
            sigma2 = raim_sigma * raim_sigma
            dof = n_used - 4
            sse = sse_raw / sigma2
            thr = jnp.asarray(_CHI2_999)[jnp.clip(dof, 1, 16) - 1]
            fault = (dof >= 1) & (sse > thr)

            def exclude(_):
                excl_masks = mask[None, :] & ~jnp.eye(c_ch, dtype=bool)
                e_pos, e_el, e_az, e_dop, e_res = jax.vmap(
                    lambda m: solve_epoch(sat_pos, obs, m, use_trop,
                                          iono_tow))(excl_masks)
                e_sse = jnp.where(mask, jnp.sum(e_res * e_res, axis=1) / sigma2,
                                  jnp.inf)
                j = jnp.argmin(e_sse).astype(jnp.int32)
                thr_ex = jnp.asarray(_CHI2_999)[jnp.clip(dof - 1, 1, 16) - 1]
                isolated = e_sse[j] < thr_ex
                return (isolated, j, e_pos[j], e_el[j], e_az[j], e_dop[j],
                        excl_masks[j])

            def no_exclude(_):
                return (jnp.bool_(False), jnp.int32(-1), pos, el, az, dop, mask)

            isolated, j, x_pos, x_el, x_az, x_dop, x_mask = jax.lax.cond(
                fault & (n_used >= 6), exclude, no_exclude, None)
            pos = jnp.where(isolated, x_pos, pos)
            el = jnp.where(isolated, x_el, el)
            az = jnp.where(isolated, x_az, az)
            dop = jnp.where(isolated, x_dop, dop)
            mask_eff = jnp.where(isolated, x_mask, mask)
            raim_flag = jnp.where(fault,
                                  jnp.where(isolated, jnp.int32(1),
                                            jnp.int32(2)), jnp.int32(0))
            excl_ch = jnp.where(isolated, j.astype(jnp.int32), jnp.int32(-1))
            # a detected but non-isolated fault invalidates the epoch
            ok = ok & ~(fault & ~isolated)
            # a detected-but-unisolated fault must not leak into the EKF
            # through the 6-sigma innovation gate alone: drop the whole
            # epoch's measurements from the filter too (it coasts)
            mask_eff = mask_eff & (raim_flag != 2)
        # n_used is the POST-exclusion count (NavSolutions docstring)
        n_used = jnp.sum(mask_eff)

        # --- velocity from carrier Doppler (beyond the reference) ----------
        # rho_dot_i = e_i . (v_sat_i - v_rx) + clock_drift, with
        # rho_dot = -lambda * doppler; satellite ECEF velocity by central
        # finite difference of the broadcast orbit (~mm/s accurate)
        h = 0.05
        sat_a, clk_a = jax.vmap(partial(_satpos_one, t_tx - h))(packed_eph)
        sat_b, clk_b = jax.vmap(partial(_satpos_one, t_tx + h))(packed_eph)
        sat_vel = (sat_b - sat_a) / (2.0 * h)               # (C, 3)
        # satellite clock drift (a_f1 + 2 a_f2 dt + relativistic rate) enters
        # the measured Doppler exactly like geometric range rate
        # (reference blind spot: geoFunctions.py:819-885 has no velocity)
        clk_drift = (clk_b - clk_a) / (2.0 * h)             # (C,) s/s
        diff = sat_pos - pos[:3]
        rho = jnp.linalg.norm(diff, axis=-1)
        e_los = diff / jnp.maximum(rho, 1.0)[:, None]
        rho_dot = -lam * doppler
        vobs = jnp.where(mask_eff,
                         rho_dot + c_light * clk_drift
                         - jnp.sum(e_los * sat_vel, axis=-1), 0.0)
        a_v = jnp.concatenate([-e_los, jnp.ones((e_los.shape[0], 1))], axis=1)
        a_v = a_v * mask_eff.astype(jnp.float64)[:, None]
        inv_v, det_v = inv4(a_v.T @ a_v)
        vel4 = jnp.where((jnp.abs(det_v) > 1e-12) & ok,
                         inv_v @ (a_v.T @ vobs), jnp.nan)

        nan = jnp.float64(jnp.nan)
        pos = jnp.where(ok, pos, nan)
        dop = jnp.where(ok, dop, 0.0)
        el_out = jnp.where(ok & mask_eff, el, nan)
        az_out = jnp.where(ok & mask_eff, az, nan)
        corrected = jnp.where(mask_eff, raw_p + clk * c_light + pos[3], nan)

        # --- EKF navigation filter (config.nav_filter='ekf'; nav.ekf) ------
        if use_ekf:
            from softgnss_tpu.nav.ekf import ekf_epoch

            pr_f = ((travel - anchor + config.start_offset_ms)
                    * c_light / 1000.0 + clk * c_light)
            rr_f = -lam * doppler + c_light * clk_drift
            # the LS clock bias references this epoch's floor (tmin); the
            # filter's pseudoranges reference the fixed anchor — seed cdt
            # in the anchor frame or the first innovations sit whole
            # light-milliseconds off and the gate rejects everything
            ls_init = pos.at[3].add((tmin - anchor) * c_light / 1000.0)
            ekf_state, (e_pos, e_vel, e_cdt, e_cddt, e_used) = ekf_epoch(
                ekf_state, sat_pos, sat_vel, pr_f, rr_f, mask_eff,
                use_trop, iono_tow,
                t_step=config.nav_sol_period_ms / 1000.0,
                q_accel=config.ekf_accel_psd, q_clock=config.ekf_clock_psd,
                q_bias=config.ekf_clock_bias_psd,
                r_pr=ekf_sigma, r_rr=config.ekf_doppler_sigma,
                gate=config.ekf_gate_sigma, ls_pos=ls_init, ls_ok=ok,
                ls_vel=vel4)
            ekf_out = jnp.concatenate(
                [e_pos, e_vel, jnp.stack([e_cdt, e_cddt]),
                 e_used.astype(jnp.float64)[None]])
        else:
            ekf_out = jnp.zeros(9, jnp.float64)

        lat, lon, hgt = cart2geo(pos[0], pos[1], pos[2], 4)

        # carry: after a successful solve, masked-out satellites get NaN
        # elevations and stay excluded (reference behavior,
        # postNavigation.py:241 + the nan-initialized el columns); a FAILED
        # epoch keeps the previous elevations so a transient <4-satellite
        # gap does not blind every later epoch (the reference likewise only
        # updates satElev inside the >3-satellite branch).  The pre-RAIM
        # mask is used on purpose: a RAIM-excluded satellite keeps its
        # elevation and is re-tested at the next epoch (per-epoch FDE),
        # rather than being blinded for the rest of the run
        new_elev = jnp.where(ok, jnp.where(mask, el, nan), sat_elev)
        outs = (pos, dop, el_out, az_out,
                jnp.where(mask_eff, raw_p, nan), corrected,
                lat, lon, hgt, vel4, raim_flag, excl_ch, sse_raw, n_used,
                ekf_out)
        return (new_elev, ekf_state), outs

    from softgnss_tpu.nav.ekf import initial_ekf_state

    init_elev = jnp.full(base_mask.shape, jnp.inf)
    _, outs = jax.lax.scan(step, (init_elev, initial_ekf_state()),
                           (travel_time.T, transmit_times, doppler_meas.T,
                            lock_ok.T, anchors))
    return outs


def post_navigate(config: ReceiverConfig, track, ephemerides=None,
                  iono=None, utc=None,
                  ) -> tuple[NavSolutions | None, list[Ephemeris | None]]:
    """Full navigation stage on tracking output.

    ``track``: a TrackResults (softgnss_tpu.track.scan) or any object with
    ``i_p (C, n_ms)``, ``absolute_sample (C, n_ms)``, ``status``, ``prn``.

    ``ephemerides``: optional per-PRN list of 32 (warm start, beyond the
    reference — e.g. a previous run's decoded set via
    ``message.save_ephemerides``/``load_ephemerides``).  Channels whose
    PRN has a complete entry skip the 30 s in-signal frame decode and
    read only the 1.2 s TLM+HOW for the TOW, so fixes need as little as
    ``MIN_WARM_NAV_MS`` (8 s, preamble-phase permitting; guaranteed from
    ~15 s) of capture instead of ``MIN_NAV_MS`` (36 s); channels without
    an entry fall back to the full decode.

    Returns (solutions | None, per-PRN ephemeris list of length 32).
    """
    eph_by_prn: list[Ephemeris | None] = [None] * 32
    i_p = np.asarray(track.i_p)
    n_ms = i_p.shape[1]
    n_tracked = sum(1 for s in track.status if s != "-")
    min_ms = MIN_NAV_MS if ephemerides is None else MIN_WARM_NAV_MS
    if n_ms < min_ms or n_tracked < 4:
        logger.warning("Record too short or too few satellites tracked "
                       "(%d ms, %d channels).", n_ms, n_tracked)
        return None, eph_by_prn

    first_subframe, active = find_preambles(i_p, track.status)

    # --- ephemerides: in-signal decode (reference postNavigation.py:115-146)
    # --- or warm-start TOW-only read against the supplied set --------------
    ephs: dict[int, Ephemeris] = {}
    tows: dict[int, float] = {}
    # Klobuchar coefficients: supplied (warm start — no subframe 4 is
    # read, message.load_iono) or decoded below from subframe 4 page 18
    iono8 = None if iono is None else np.asarray(iono, np.float64)
    utc_params: UtcParams | None = utc
    for ch in list(active):
        start = int(first_subframe[ch])
        prn = int(track.prn[ch])
        provided = (ephemerides[prn - 1]
                    if ephemerides is not None and prn >= 1 else None)
        if (provided is not None and provided.complete
                and provided.health not in (None, 0)):
            logger.warning("Channel %d (PRN %d): supplied ephemeris has "
                           "health %d; excluded.", ch, prn,
                           int(provided.health))
            active = np.setdiff1d(active, ch)
            continue
        if provided is not None and provided.complete:
            if start - _MS_PER_BIT < 0 or start + 60 * _MS_PER_BIT > n_ms:
                active = np.setdiff1d(active, ch)
                continue
            window = i_p[ch, start - _MS_PER_BIT: start + 60 * _MS_PER_BIT]
            bits = np.where(window.reshape(-1, _MS_PER_BIT).sum(axis=1) > 0, 1, -1)
            ephs[ch] = provided
            tows[ch] = decode_tow(bits[1:], bits[0])
            eph_by_prn[prn - 1] = provided
            continue
        if start - _MS_PER_BIT < 0 or start + _FRAME_BITS * _MS_PER_BIT > n_ms:
            active = np.setdiff1d(active, ch)
            continue
        window = i_p[ch, start - _MS_PER_BIT: start + _FRAME_BITS * _MS_PER_BIT]
        bits = np.where(window.reshape(-1, _MS_PER_BIT).sum(axis=1) > 0, 1, -1)
        eph, tow = decode_ephemeris(bits[1:], bits[0])
        if not eph.complete:
            active = np.setdiff1d(active, ch)
            continue
        if eph.health not in (None, 0):
            # SV health word (subframe 1): nonzero = do not use.  The
            # reference decodes but never checks it (postNavigation.py
            # uses every decoded channel)
            logger.warning("Channel %d (PRN %d) broadcasts health %d; "
                           "excluded from navigation.", ch,
                           int(track.prn[ch]), int(eph.health))
            eph_by_prn[int(track.prn[ch]) - 1] = eph
            active = np.setdiff1d(active, ch)
            continue
        ephs[ch] = eph
        tows[ch] = tow
        eph_by_prn[int(track.prn[ch]) - 1] = eph
        if iono8 is None and config.use_iono_corr:
            iono8 = decode_iono(bits[1:], bits[0])
            if iono8 is not None:
                logger.info("Ionospheric coefficients decoded from channel "
                            "%d (PRN %d); Klobuchar correction enabled.",
                            ch, int(track.prn[ch]))
        if utc_params is None:
            utc_params = decode_utc(bits[1:], bits[0])
            if utc_params is not None:
                logger.info("UTC parameters decoded from channel %d "
                            "(PRN %d).", ch, int(track.prn[ch]))

    if len(active) < 4:
        logger.warning("Too few satellites with ephemeris data (%d).", len(active))
        return None, eph_by_prn

    # --- TOW consistency: drop channels locked to a different subframe ----
    tow_common, _ = Counter(tows[ch] for ch in active).most_common(1)[0]
    for ch in list(active):
        if tows[ch] != tow_common:
            logger.warning("Channel %d TOW %.0f disagrees with majority %.0f; dropped.",
                           ch, tows[ch], tow_common)
            active = np.setdiff1d(active, ch)
    if len(active) < 4:
        logger.warning("Too few TOW-consistent satellites (%d).", len(active))
        return None, eph_by_prn

    # --- almanac collection (beyond the reference, which discards
    # --- subframes 4-5 entirely, ephemeris.py:88-91) ------------------------
    # every satellite broadcasts the constellation almanac one page per
    # 30-s frame; merge whatever parity-valid pages each channel of this
    # capture yields (a channel whose pages all fail parity contributes
    # nothing and the next channel is still tried — see
    # message.decode_almanac_pages / almanac_to_ephemeris for acquisition
    # assistance from the result)
    from softgnss_tpu.nav.message import decode_almanac_pages

    almanac: dict[int, object] = {}
    lock_loss_alm = getattr(track, "lock_loss_ms", None)
    for ch in active:
        start = int(first_subframe[ch])
        end_ms = n_ms
        if lock_loss_alm is not None and np.isfinite(lock_loss_alm[ch]):
            # never decode pages from post-lock-loss noise bits (each
            # page is also parity-checked inside decode_almanac_pages)
            end_ms = min(end_ms, int(lock_loss_alm[ch]))
        n_sub = (end_ms - start) // (_MS_PER_BIT * 300)
        if n_sub < 1 or start < 2 * _MS_PER_BIT:
            continue
        window = i_p[ch, start - 2 * _MS_PER_BIT:
                     start + 300 * n_sub * _MS_PER_BIT]
        bits = np.where(window.reshape(-1, _MS_PER_BIT).sum(axis=1) > 0, 1, -1)
        pages = decode_almanac_pages(bits[2:], bits[1], d29star=bits[0])
        for prn, page in pages.items():
            almanac.setdefault(prn, page)
    if almanac:
        logger.info("Collected %d almanac page(s): PRNs %s.",
                    len(almanac), sorted(almanac))

    # --- epoch setup -------------------------------------------------------
    c_ch = i_p.shape[0]
    period = config.nav_sol_period_ms
    max_start = int(first_subframe[active].max())
    n_epochs = int((n_ms - max_start) // period)
    if n_epochs < 1:
        logger.warning("No full measurement epoch after subframe sync.")
        return None, eph_by_prn

    base_mask = np.zeros(c_ch, bool)
    base_mask[active] = True

    # --- lock demotion (beyond the reference, which tracks noise forever:
    # --- tracking.py:253-275 logs observables but never reacts) ------------
    # channels whose C/N0 or phase-lock collapsed are excluded from every
    # epoch at/after the collapse; earlier epochs (and the ephemeris decode,
    # protected by parity + the TOW vote above) still use them.
    lock_ok = np.ones((c_ch, n_epochs), bool)
    lock_loss = getattr(track, "lock_loss_ms", None)
    if (lock_loss is None and config.lock_demotion
            and hasattr(track, "q_p") and hasattr(track, "code_freq")):
        from softgnss_tpu.profiling import channel_lock_loss

        lock_loss = channel_lock_loss(config, track)
    if config.lock_demotion and lock_loss is not None:
        lock_loss = np.asarray(lock_loss, np.float64)
        for ch in active:
            ms_idx = first_subframe[ch] + period * np.arange(n_epochs)
            lock_ok[ch] = ms_idx < lock_loss[ch]
            if not lock_ok[ch].all():
                logger.warning("Channel %d (PRN %d) lost lock at %.0f ms; "
                               "demoted for %d of %d epochs.", ch,
                               int(np.asarray(track.prn)[ch]), lock_loss[ch],
                               int((~lock_ok[ch]).sum()), n_epochs)

    # per-channel travel times (ms units) at every epoch's measurement point.
    # The integer sample counter quantizes pseudoranges at c/fs meters (the
    # reference's fid.tell() resolution, tracking.py:255); when the tracker
    # provides the sub-sample boundary fraction (sample_frac, from the Q40
    # code NCO), subtract it for code-phase-exact pseudoranges.
    absolute_sample = np.asarray(track.absolute_sample, np.float64)
    frac = getattr(track, "sample_frac", None)
    if frac is not None:
        absolute_sample = absolute_sample - np.asarray(frac)
    travel = np.full((c_ch, n_epochs), np.inf)
    for ch in active:
        ms_idx = first_subframe[ch] + period * np.arange(n_epochs)
        travel[ch] = absolute_sample[ch, ms_idx] / config.samples_per_code

    # --- carrier smoothing (Hatch filter; beyond the reference) ------------
    # Epoch-to-epoch range change is measured ~wavelength-precisely by the
    # integrated carrier: delta_r = -lambda * sum((carr_freq - IF) * 1 ms).
    # Blending code travel times with carrier deltas cuts code noise by
    # ~sqrt(window).  Receiver clock drift is common-mode (absorbed by dt).
    n_smooth = config.carrier_smoothing_epochs
    carr_freq_raw = getattr(track, "carr_freq", None)
    carr_freq_arr = (None if carr_freq_raw is None
                     else np.asarray(carr_freq_raw, np.float64))
    if n_smooth > 1 and carr_freq_arr is not None and n_epochs > 1:
        lam_ms = (config.speed_of_light / config.l1_freq) / (
            config.speed_of_light / 1000.0)        # wavelength in travel-ms
        cyc = np.cumsum(carr_freq_arr
                        - config.intermediate_freq, axis=1) * 1e-3  # cycles
        for ch in active:
            ms_idx = first_subframe[ch] + period * np.arange(n_epochs)
            phi = cyc[ch, ms_idx]
            sm = travel[ch].copy()
            for n in range(1, n_epochs):
                alpha = 1.0 / min(n + 1, n_smooth)
                # predictor = previous smoothed travel + the nominal
                # per-epoch advance (epochs are `period` ms apart in
                # transmit time) + the carrier-measured delay change
                pred = sm[n - 1] + period - lam_ms * (phi[n] - phi[n - 1])
                sm[n] = alpha * travel[ch, n] + (1.0 - alpha) * pred
            travel[ch] = sm

    # packed ephemerides; inactive rows get a valid dummy (masked in solver)
    dummy = ephs[int(active[0])]
    packed = pack_ephemerides([ephs.get(ch, dummy) for ch in range(c_ch)])

    transmit_times = tow_common + period / 1000.0 * np.arange(n_epochs)

    # measured carrier Doppler at each epoch, averaged over a +-50 ms
    # window: the per-ms PLL frequency carries Hz-level noise that the
    # ~0.1 s-stationary true Doppler does not.  Without carr_freq the
    # Doppler is NaN so the velocity solution reports NaN rather than
    # solving an all-zero-Doppler system into garbage velocities.
    doppler = np.full((c_ch, n_epochs), np.nan)
    if carr_freq_arr is not None:
        half_w = 50
        for ch in active:
            ms_idx = first_subframe[ch] + period * np.arange(n_epochs)
            lo = np.maximum(ms_idx - half_w, 0)
            hi = np.minimum(ms_idx + half_w + 1, carr_freq_arr.shape[1])
            csum = np.concatenate([[0.0], np.cumsum(carr_freq_arr[ch])])
            doppler[ch] = (csum[hi] - csum[lo]) / (hi - lo) - config.intermediate_freq

    with host_context():
        scan_args = (jnp.asarray(packed), jnp.asarray(base_mask),
                     jnp.asarray(travel), jnp.asarray(transmit_times),
                     jnp.asarray(doppler), jnp.asarray(lock_ok),
                     None if iono8 is None else jnp.asarray(iono8))
        use_trop = bool(config.use_trop_corr)
        raim_sigma = np.inf
        if config.raim:
            if config.raim_sigma_m is not None:
                raim_sigma = float(config.raim_sigma_m)
            else:
                # sigma auto-calibration: run the same compiled scan with
                # detection off (sigma = inf) and take a robust per-epoch
                # scale from the raw residual SSE.  sse/median(chi2(dof))
                # estimates sigma^2 from each epoch; the median over
                # epochs rejects transiently faulty ones
                pre = _epoch_scan(config, use_trop, *scan_args, np.inf)
                sse_pre = np.asarray(pre[12])
                n_pre = np.asarray(pre[13])
                dof_pre = n_pre - 4
                sel = dof_pre >= 1
                if sel.any():
                    # median of chi2(k) ~ k*(1 - 2/(9k))^3 (Wilson-Hilferty)
                    med_k = dof_pre[sel] * (1.0 - 2.0 / (9.0 * dof_pre[sel])) ** 3
                    sigma_est = np.sqrt(np.median(sse_pre[sel] / med_k))
                else:
                    sigma_est = 0.0
                raim_sigma = max(float(sigma_est), config.raim_sigma_floor_m)
                logger.info("RAIM sigma auto-calibrated: %.2f m over %d "
                            "epochs.", raim_sigma, int(sel.sum()))
        ekf_sigma = (float(config.ekf_range_sigma_m)
                     if config.ekf_range_sigma_m is not None
                     else (raim_sigma if np.isfinite(raim_sigma)
                           else config.raim_sigma_floor_m))
        outs = _epoch_scan(config, use_trop, *scan_args, raim_sigma,
                           ekf_sigma)
        (pos, dop, el, az, raw_p, corrected, lat, lon, hgt, vel4,
         raim_flag, raim_excl_ch, _sse, _n_used, ekf_out) = map(
            np.asarray, outs)

        # --- EKF as the primary solution (config.nav_filter='ekf') ---------
        # the per-epoch LS columns are preserved as lsq_*; positions /
        # velocities / geodetic+UTM columns come from the filter
        lsq_cols = None
        ekf_used = None
        if config.nav_filter == "ekf":
            lsq_cols = (pos[:, 0].copy(), pos[:, 1].copy(),
                        pos[:, 2].copy(), pos[:, 3].copy())
            ekf_used = ekf_out[:, 8].astype(np.int64)
            pos = np.concatenate([ekf_out[:, 0:3], ekf_out[:, 6:7]], axis=1)
            vel4 = np.concatenate([ekf_out[:, 3:6], ekf_out[:, 7:8]], axis=1)
            fin = np.isfinite(pos[:, 0])
            lat = np.full(n_epochs, np.nan)
            lon = np.full(n_epochs, np.nan)
            hgt = np.full(n_epochs, np.nan)
            if fin.any():
                la, lo, hg = cart2geo(jnp.asarray(pos[fin, 0]),
                                      jnp.asarray(pos[fin, 1]),
                                      jnp.asarray(pos[fin, 2]), 4)
                lat[fin], lon[fin], hgt[fin] = (np.asarray(la),
                                                np.asarray(lo),
                                                np.asarray(hg))
            n_bridge = int(np.sum(fin & (_n_used <= 3)))
            if n_bridge:
                logger.info("EKF bridged %d epoch(s) with fewer than 4 "
                            "usable satellites.", n_bridge)

        # --- UTM conversion (zone fixed from the first valid fix) ----------
        valid = np.isfinite(lat)
        if valid.any():
            k = int(valid.nonzero()[0][0])
            utm_zone = find_utm_zone(float(lat[k]), float(lon[k]))
            e_utm, n_utm, u_utm = (np.asarray(v) for v in
                                   cart2utm(pos[:, 0], pos[:, 1], pos[:, 2], utm_zone))
        else:
            utm_zone = 0
            e_utm = n_utm = u_utm = np.full(n_epochs, np.nan)

    prn = np.zeros((c_ch, n_epochs), np.int64)
    prn[active] = np.asarray(track.prn)[active, None]

    prn_arr = np.asarray(track.prn, np.int64)
    raim_prn = np.where(raim_excl_ch >= 0,
                        prn_arr[np.clip(raim_excl_ch, 0, c_ch - 1)], 0)
    for flag, count in zip(*np.unique(raim_flag[raim_flag > 0],
                                      return_counts=True)):
        if flag == 1:
            logger.warning("RAIM excluded a faulty satellite at %d epoch(s) "
                           "(PRNs %s).", count,
                           sorted(set(raim_prn[raim_flag == 1].tolist())))
        else:
            logger.warning("RAIM detected non-isolable faults at %d "
                           "epoch(s); fixes invalidated.", count)

    solutions = NavSolutions(
        x=pos[:, 0], y=pos[:, 1], z=pos[:, 2], dt=pos[:, 3],
        latitude=lat, longitude=lon, height=hgt,
        e=e_utm, n=n_utm, u=u_utm,
        dop=dop.T, prn=prn, el=el.T, az=az.T,
        raw_p=raw_p.T, corrected_p=corrected.T,
        utm_zone=utm_zone, first_subframe=first_subframe, tow=float(tow_common),
        vx=vel4[:, 0], vy=vel4[:, 1], vz=vel4[:, 2], clock_drift=vel4[:, 3],
        first_epoch_ms=int(max_start), _period_ms=int(period), iono=iono8,
        raim_flag=raim_flag, raim_excluded_prn=raim_prn,
        n_used=_n_used.astype(np.int64), almanac=almanac or None,
        utc_params=utc_params,
        week_number=(int(ephs[int(active[0])].week_number)
                     if ephs[int(active[0])].week_number is not None else None),
        nav_filter=config.nav_filter,
        lsq_x=None if lsq_cols is None else lsq_cols[0],
        lsq_y=None if lsq_cols is None else lsq_cols[1],
        lsq_z=None if lsq_cols is None else lsq_cols[2],
        lsq_dt=None if lsq_cols is None else lsq_cols[3],
        ekf_used=ekf_used,
    )
    return solutions, eph_by_prn
