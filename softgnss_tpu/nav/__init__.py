"""Navigation layer: bit sync, nav-message codec, orbits, geodesy, PVT.

Covers the reference's postNavigation.py / ephemeris.py / geoFunctions
capability surface (SURVEY.md §2 components 10-19), re-designed as array
programs:

* parity checking and bit handling are vectorized array ops, not per-word
  Python string loops (reference: postNavigation.py:441-521, ephemeris.py),
* a nav-message *encoder* exists (`message.build_nav_stream`) — the reference
  ships no test data, so the framework synthesizes decodable signals,
* satellite position (Kepler) and least-squares PVT run as jitted, vmapped
  f64 JAX programs with fixed iteration counts (reference: geoFunctions
  loops with data-dependent early exit),
* the measurement-epoch loop is a `lax.scan` carrying the elevation mask
  (reference: postNavigation.py:199-301 Python loop).
"""

from softgnss_tpu.nav.parity import nav_parity_check, encode_word  # noqa: F401
from softgnss_tpu.nav.message import (  # noqa: F401
    Ephemeris,
    GPS_PI,
    PREAMBLE_BITS,
    build_nav_stream,
    decode_ephemeris,
    decode_iono,
    decode_tow,
    decode_utc,
    encode_subframe_source,
    load_ephemerides,
    load_iono,
    load_utc,
    save_ephemerides,
    UtcParams,
)
from softgnss_tpu.nav.preamble import find_preambles  # noqa: F401
from softgnss_tpu.nav.orbit import satellite_positions, check_t  # noqa: F401
from softgnss_tpu.nav.pvt import least_squares_pos  # noqa: F401
from softgnss_tpu.nav.geodesy import (  # noqa: F401
    cart2geo,
    cart2utm,
    deg2dms,
    dms2mat,
    e_r_corr,
    find_utm_zone,
    geo2cart,
    togeod,
    topocent,
)
from softgnss_tpu.nav.atmosphere import tropo  # noqa: F401
from softgnss_tpu.nav.assist import predict_doppler  # noqa: F401
from softgnss_tpu.nav.ekf import EkfState, ekf_epoch  # noqa: F401
from softgnss_tpu.nav.message import (  # noqa: F401
    Almanac,
    almanac_to_ephemeris,
    decode_almanac_pages,
    ephemeris_to_almanac,
)
from softgnss_tpu.nav.solve import (  # noqa: F401
    NavSolutions,
    calculate_pseudoranges,
    post_navigate,
)
