"""Per-channel tracking state as a structure-of-arrays pytree.

The reference gives each satellite channel its own OS process with Python
object state (``/root/reference/sydr/channel/channel.py:21`` and
``channel_l1ca_borre.py:106-140``). This design makes *channel* an
array axis: all per-channel state lives in one pytree of ``[n_channels]``
arrays, updated in lockstep by a single SPMD program (vmapped, then sharded
over a device mesh along the channel axis).

Precision notes (device state is float32):
  * ``carrier_freq`` holds IF + Doppler (|f| < ~50 kHz) — f32 exact to ~4 mHz.
  * ``code_freq_offset`` holds the offset from the nominal 1.023 MHz chip
    rate (|offset| < ~10 Hz); storing the offset rather than the absolute
    rate keeps sub-mHz DLL corrections representable.
  * Absolute sample positions are never stored on device; channels track an
    ``unread`` sample count relative to the stream write head (the reference
    keeps the same quantity implicitly via ``getNbUnreadSamples``,
    ``utils/circularbuffer.py:141``).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from sydr_tpu.constants import GPS_L1CA_CODE_FREQ
from sydr_tpu.signal import cacode

# Channel modes (mirrors reference ChannelState enum,
# utils/enumerations.py; OFF/IDLE merged).
MODE_IDLE = 0
MODE_ACQUIRING = 1
MODE_TRACKING = 2

# Tracking flag bits (mirrors reference TrackingFlags bitmask,
# utils/enumerations.py:120-138).
FLAG_CODE_LOCK = 1 << 0
FLAG_BIT_SYNC = 1 << 1
FLAG_SUBFRAME_SYNC = 1 << 2
FLAG_TOW_DECODED = 1 << 3
FLAG_EPH_DECODED = 1 << 4
FLAG_FINE_LOCK = 1 << 5


def _f32(n, value=0.0):
    return jnp.full((n,), value, dtype=jnp.float32)


def _i32(n, value=0):
    return jnp.full((n,), value, dtype=jnp.int32)


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class ChannelState:
    """All mutable per-channel DSP state, shape ``[n_channels]`` each."""

    mode: jax.Array              # int32: MODE_*
    flags: jax.Array             # int32 bitmask of FLAG_*
    carrier_freq: jax.Array      # f32 [Hz], IF + Doppler
    freq_anchor: jax.Array       # f32 [Hz] acquisition carrier (NCO rail)
    code_freq_offset: jax.Array  # f32 [Hz] offset from GPS_L1CA_CODE_FREQ
    rem_carrier: jax.Array       # f32 [rad]
    rem_code: jax.Array          # f32 [chips]
    dll_memory: jax.Array        # f32 last code discriminator value
    pll_memory: jax.Array        # f32 last phase discriminator value
    fll_memory: jax.Array        # f32 last freq discriminator value
    fll_vel: jax.Array           # f32 DLF velocity accumulator
    fll_acc: jax.Array           # f32 DLF acceleration accumulator
    i_prompt_prev: jax.Array     # f32
    q_prompt_prev: jax.Array     # f32
    unread: jax.Array            # int32 samples available to this channel
    code_counter: jax.Array      # int32 tracked code periods total
    ms_counter: jax.Array        # int32 free-running epoch counter mod 20
    edge_hist: jax.Array         # int32 [n_ch, 20] sign-flip position histogram
    bit_edge: jax.Array          # int32 declared bit-edge phase [0, 20)
    accum_count: jax.Array       # int32 prompt entries in current bit accum
    ip_sum: jax.Array            # f32 20-ms prompt accumulators (C/N0)
    qp_sum: jax.Array            # f32
    cn0_ratio_sum: jax.Array        # f32 sum of |iP| (wide-band power uses sq)
    ip_sq_sum: jax.Array         # f32 sum of iP^2
    qp_sq_sum: jax.Array         # f32 sum of qP^2
    cn0: jax.Array               # f32 [dB-Hz]
    pll_lock: jax.Array          # f32 lock indicator [-1, 1]
    fll_lock: jax.Array          # f32 lock indicator [0, 1]
    lock_state: jax.Array        # int32 Kaplan lock-state machine stage


def init_state(n_channels: int) -> ChannelState:
    return ChannelState(
        mode=_i32(n_channels, MODE_IDLE),
        flags=_i32(n_channels),
        carrier_freq=_f32(n_channels),
        freq_anchor=_f32(n_channels),
        code_freq_offset=_f32(n_channels),
        rem_carrier=_f32(n_channels),
        rem_code=_f32(n_channels),
        dll_memory=_f32(n_channels),
        pll_memory=_f32(n_channels),
        fll_memory=_f32(n_channels),
        fll_vel=_f32(n_channels),
        fll_acc=_f32(n_channels),
        i_prompt_prev=_f32(n_channels),
        q_prompt_prev=_f32(n_channels),
        unread=_i32(n_channels),
        code_counter=_i32(n_channels),
        ms_counter=_i32(n_channels),
        edge_hist=jnp.zeros((n_channels, 20), dtype=jnp.int32),
        bit_edge=_i32(n_channels),
        accum_count=_i32(n_channels),
        ip_sum=_f32(n_channels),
        qp_sum=_f32(n_channels),
        cn0_ratio_sum=_f32(n_channels),
        ip_sq_sum=_f32(n_channels),
        qp_sq_sum=_f32(n_channels),
        cn0=_f32(n_channels),
        pll_lock=_f32(n_channels),
        fll_lock=_f32(n_channels),
        lock_state=_i32(n_channels),
    )


# --- Packed scan-carry form -------------------------------------------------
# XLA can materialise one copy PER CARRIED BUFFER per lax.scan iteration;
# with ~29 tiny [n_ch] leaves that fixed cost is paid 50 times per
# signal-second at the product shape. Scans therefore carry the state as TWO
# dense matrices; pack/unpack are column slices/concats that fuse into the
# body for free.

_F32_FIELDS = tuple(
    f.name for f in dataclasses.fields(ChannelState)
    if f.name not in (
        "mode", "flags", "unread", "code_counter", "ms_counter",
        "edge_hist", "bit_edge", "accum_count", "lock_state"))
_I32_FIELDS = ("mode", "flags", "unread", "code_counter", "ms_counter",
               "bit_edge", "accum_count", "lock_state")


def pack_state(st: ChannelState):
    """ChannelState -> (f32 [n_ch, NF], i32 [n_ch, NI + 20]) carry form."""
    f = jnp.stack([getattr(st, n) for n in _F32_FIELDS], axis=1)
    i = jnp.concatenate(
        [jnp.stack([getattr(st, n) for n in _I32_FIELDS], axis=1),
         st.edge_hist], axis=1)
    return f, i


def unpack_state(f: jax.Array, i: jax.Array) -> ChannelState:
    """Inverse of :func:`pack_state`."""
    kw = {n: f[:, k] for k, n in enumerate(_F32_FIELDS)}
    kw.update({n: i[:, k] for k, n in enumerate(_I32_FIELDS)})
    kw["edge_hist"] = i[:, len(_I32_FIELDS):]
    return ChannelState(**kw)


def code_table(prns: list[int]) -> np.ndarray:
    """Stacked padded code tables ``[n_channels, 1025]`` for the given PRNs.

    PRN 0 entries (unassigned channels) get an all-zero code.
    """
    rows = []
    for prn in prns:
        if prn <= 0:
            rows.append(np.zeros(1025, dtype=np.float32))
        else:
            rows.append(cacode.padded_code(prn))
    return np.stack(rows)
