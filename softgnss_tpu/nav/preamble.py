"""Bit/frame synchronization: locate the TLM preamble in tracked I_P.

Same detection logic as reference postNavigation.py:524-631: correlate the
sign of prompt-correlator output with the 20-ms-upsampled 8-bit preamble,
keep candidates with |correlation| > 153 (at least 154 of 160 ms samples
agreeing), confirm a candidate iff another candidate lies exactly 6000 ms
later AND the two 30-bit words starting there pass parity after 20-ms bit
integration.

Vectorized: the correlation runs for ALL channels at once as a single
batched matmul against a (160,) kernel (one `jnp.convolve`-style valid
correlation per channel under vmap); candidate confirmation is tiny host
logic over the few surviving indices.  Parity is checked for all
candidates of a channel in one vectorized call.

Documented divergence: the reference indexes trackResults[channelNr] with
the *position* of the channel in activeChnList (postNavigation.py:566-570)
— correct only when tracking channels form a prefix; we index by actual
channel number.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from softgnss_tpu.nav.message import PREAMBLE_BITS
from softgnss_tpu.nav.parity import nav_parity_check

#: ms-domain detection threshold (reference: postNavigation.py:586)
_XCORR_THRESHOLD = 153
_MS_PER_BIT = 20
_SUBFRAME_MS = 6000


@jax.jit
def _preamble_correlation(bit_signs):
    """Valid-mode correlation of (C, n_ms) +/-1 signs with the 160-ms kernel."""
    kernel = jnp.asarray(np.repeat(2 * np.asarray(PREAMBLE_BITS) - 1, _MS_PER_BIT),
                         jnp.float32)

    def one(b):
        return jnp.correlate(b, kernel, mode="valid")

    return jax.vmap(one)(bit_signs.astype(jnp.float32))


def _confirm(i_p: np.ndarray, idx: np.ndarray) -> int:
    """First candidate index confirmed by 6000-ms spacing + double parity."""
    spaced = idx[np.isin(idx + _SUBFRAME_MS, idx)]
    # need 40 ms of history (2 star bits) and 60 bits ahead
    spaced = spaced[(spaced >= 40) & (spaced + _MS_PER_BIT * 60 <= len(i_p))]
    if spaced.size == 0:
        return 0
    # integrate 62 bits (2 previous + TLM + HOW) for every candidate at once
    windows = np.stack([i_p[i - 40:i + _MS_PER_BIT * 60] for i in spaced])
    bits = windows.reshape(len(spaced), 62, _MS_PER_BIT).sum(axis=2)
    bits = np.where(bits > 0, 1, -1)
    ok = (nav_parity_check(bits[:, 0:32]) != 0) & (nav_parity_check(bits[:, 30:62]) != 0)
    hits = spaced[ok]
    return int(hits[0]) if hits.size else 0


def find_preambles(i_p: np.ndarray, status: list[str],
                   search_start_offset: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Find the first confirmed preamble per channel.

    ``i_p``: (C, n_ms) prompt correlator outputs; ``status``: per-channel
    'T'/'-'.  Returns (first_subframe (C,) int — 0 if none, active channel
    indices).
    """
    i_p = np.asarray(i_p)
    n_ch = i_p.shape[0]
    first_subframe = np.zeros(n_ch, np.int64)
    tracked = [c for c in range(n_ch) if status[c] != "-"]
    if not tracked:
        return first_subframe, np.asarray([], np.int64)

    from softgnss_tpu.nav.hostctx import host_context

    signs = np.where(i_p[:, search_start_offset:] > 0, 1, -1)
    # host backend: a (C, n_ms) correlation is microseconds of work;
    # device dispatch + compile would dominate
    with host_context():
        xcorr = np.asarray(_preamble_correlation(jnp.asarray(signs)))

    active = []
    for c in tracked:
        idx = (np.abs(xcorr[c]) > _XCORR_THRESHOLD).nonzero()[0] + search_start_offset
        hit = _confirm(i_p[c], idx)
        if hit:
            first_subframe[c] = hit
            active.append(c)
    return first_subframe, np.asarray(active, np.int64)
