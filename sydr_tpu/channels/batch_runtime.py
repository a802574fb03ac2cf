"""Two-pass batched tracking runtime: dense block correlation + scalar replay.

The scanned runtime (``sydr_tpu.channels.runtime``) reproduces the
reference's per-millisecond feedback cadence exactly, but its sequential
1-ms epochs leave the device latency-bound. This runtime restructures a block
around the classic batch-receiver identity: with NCO rates *frozen for the
duration of one block*, code and carrier phase are **linear in the consumed
sample index**, so every epoch's correlation over the whole block becomes one
dense, embarrassingly parallel computation:

  Pass A (scalar scan, [n_ch] wide): epoch boundaries, per-epoch phases and
      active gating under frozen rates — identical exact-rational phase
      arithmetic to the scanned runtime.
  Pass B (dense): per-channel aligned sample regions -> carrier mix + chip
      reconstruction -> per-epoch correlators, either fused in one kernel
      (``ops.correlator_gpu``) or as the XLA dense pass (bit-packed words +
      cumulative sums differenced at the epoch bounds). No sequential
      dependence: this pass parallelises over time (the sequence-parallel
      axis) as well as channels.
  Pass C (replay scan, [n_ch] wide): per-epoch discriminators, loop filters,
      bit-edge histogram sync, C/N0 and lock indicators — the same update
      arithmetic as the scanned runtime, with the resulting NCO corrections
      taking effect at the next block boundary.

The feedback delay (loop updates applied per block instead of per epoch) is
handled two ways: (i) a *virtual NCO* — discriminator inputs in the replay
are compensated by the corrections already applied within the block, and the
accumulated virtual phase is realised into the NCO remainders at the block
boundary — and (ii) the delayed-feedback stability rule
``loop_bandwidth * block_length < ~0.15``: the Borre profile (<= 8 Hz) is
stable at 20-100 ms blocks; the Kaplan pull-in bandwidths (25-100 Hz) need
<= 5 ms blocks (or the scanned runtime) until NARROW_TRACK, after which the
receiver can lengthen blocks for throughput.

State layout, outputs, and flag semantics are identical to
``runtime.run_block`` — the two are drop-in interchangeable via
``TrackingConfig.runtime``.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from sydr_tpu.channels import runtime as runtime_mod
from sydr_tpu.channels.runtime import TrackingConfig
from sydr_tpu.channels.state import (
    FLAG_BIT_SYNC,
    FLAG_CODE_LOCK,
    MODE_TRACKING,
    ChannelState,
    pack_state,
    unpack_state,
)
from sydr_tpu.constants import (
    GPS_L1CA_CARRIER_FREQ,
    GPS_L1CA_CODE_FREQ,
    GPS_L1CA_CODE_LENGTH,
)
from sydr_tpu.ops import correlator_gpu as cg
from sydr_tpu.ops import tracking as trk
from sydr_tpu.signal import cacode

TWO_PI = 2.0 * jnp.pi

C0I_ROWS = 4          # packed-word rows for floor(frac + spacing) in [-1, 2]
C0I_MIN = -1


def _group_size(sampling_frequency: float) -> tuple[int, int]:
    """(group_size, local) such that the chip span packs into 24 bits.

    The +7 margin covers ceil rounding, the correlator spacing, and two
    extra headroom bits (per-ms anchor drift + spacing shift the bit index
    by up to 2 beyond the per-spacing-row range).
    """
    step0 = GPS_L1CA_CODE_FREQ / sampling_frequency
    g = 128
    while g > 8 and int(np.ceil((g - 1) * step0)) + 7 > 24:
        g //= 2
    return g, int(np.ceil((g - 1) * step0)) + 7


def tiled_code_bits(prns: list[int]) -> np.ndarray:
    """Per-channel 0/1 code bits tiled 4x with slack, ``[n_ch, 4160]``.

    ``tiled[ch, 1023 + u]`` is chip ``u mod 1023`` for u in [-1023, 3069) —
    the device rolls this once per block (or superblock) with a single
    dynamic_slice to fold the block's integer chip offset into a static
    word-building gather. Four tiles (not three): the roll window spans up
    to ``~1095`` chips from ``c_int - 8`` with ``c_int`` up to 1022, so a
    3x tiling would run real late-millisecond chip reads into the zero pad
    whenever ``c_int >~ 1008``.
    """
    rows = []
    for prn in prns:
        if prn <= 0:
            rows.append(np.zeros(1023, dtype=np.float32))
        else:
            rows.append(cacode.ca_code_bits(prn).astype(np.float32))
    bits = np.stack(rows)
    tiled = np.concatenate([bits] * 4, axis=1)
    pad = np.zeros((len(prns), 4160 - 4 * 1023), dtype=np.float32)
    return np.concatenate([tiled, pad], axis=1).astype(np.float32)


# ---------------------------------------------------------------------------
# Pass A: frozen-rate epoch geometry
# ---------------------------------------------------------------------------

def _pass_a(cfg: TrackingConfig, st: ChannelState):
    """Epoch boundaries and phases for the block under frozen rates.

    Returns dict of ``[block_ms(+1), n_ch]`` arrays: required, active,
    boundaries b (consumed-sample offsets), rem_code per epoch, rem_carrier
    per epoch, plus end-of-block unread and per-ms phase grids for Pass B.

    Two equivalent implementations (``cfg.pass_a``): the original
    epoch-recurrence scan, and a closed-form vectorised evaluation (no
    scan, no carry copies).
    """
    if cfg.pass_a == "closed":
        return _pass_a_closed(cfg, st)
    if cfg.pass_a == "scan":
        return _pass_a_scan(cfg, st)
    raise ValueError(
        f"TrackingConfig.pass_a must be 'closed' or 'scan', "
        f"got {cfg.pass_a!r}")


def _pass_a_scan(cfg: TrackingConfig, st: ChannelState):
    """Reference-structured pass A: one scan step per epoch."""
    spms = cfg.samples_per_ms
    fs = cfg.sampling_frequency

    doppler = st.carrier_freq - cfg.intermediate_frequency
    aiding = (
        doppler * (GPS_L1CA_CODE_FREQ / GPS_L1CA_CARRIER_FREQ)
        if cfg.carrier_aiding else 0.0
    )
    delta = st.code_freq_offset + aiding          # frozen for the block
    code_step = (GPS_L1CA_CODE_FREQ + delta) / fs
    omega = TWO_PI * st.carrier_freq / fs          # rad per sample

    def step(carry, e):
        rem_code, rem_carrier, unread, consumed = carry
        avail = (cfg.tail_ms + e + 1) * spms
        unread = jnp.minimum(unread + spms, avail)
        required = jnp.ceil(
            (GPS_L1CA_CODE_LENGTH - rem_code) / code_step
        ).astype(jnp.int32)
        active = (st.mode == MODE_TRACKING) & (unread >= required)
        req_eff = jnp.where(active, required, 0)
        new_rem_code = jnp.where(
            active,
            rem_code
            + GPS_L1CA_CODE_LENGTH * (required - spms).astype(jnp.float32) / spms
            + required.astype(jnp.float32) * (delta / fs),
            rem_code,
        )
        new_rem_carrier = jnp.where(
            active,
            jnp.mod(rem_carrier - omega * required.astype(jnp.float32), TWO_PI),
            rem_carrier,
        )
        out = {
            "required": required,
            "active": active,
            "b_start": consumed,
            "rem_code": rem_code,
            "rem_carrier": rem_carrier,
            "unread_after": unread - req_eff,
        }
        return (new_rem_code, new_rem_carrier, unread - req_eff,
                consumed + req_eff), out

    init = (st.rem_code, st.rem_carrier, st.unread,
            jnp.zeros_like(st.unread))
    # unroll: these are tiny [n_ch]-vector steps — the scan's per-iteration
    # sequencing overhead would dominate the arithmetic
    (rem_code_end, rem_carrier_end, unread_end, consumed_end), seq = \
        jax.lax.scan(step, init, jnp.arange(cfg.block_ms, dtype=jnp.int32),
                     unroll=True)
    seq["rem_code_end"] = rem_code_end
    seq["rem_carrier_end"] = rem_carrier_end
    seq["unread_end"] = unread_end
    seq["consumed_end"] = consumed_end
    seq["code_step"] = code_step
    seq["omega"] = omega
    seq["delta"] = delta
    return seq


def _pass_a_closed(cfg: TrackingConfig, st: ChannelState):
    """Closed-form pass A: all epoch boundaries in one vectorised shot.

    Under frozen rates the scan recurrence has an exact closed form: the
    cumulative samples consumed after epoch ``e`` is
    ``C(e) = ceil(((e+1)*L - rem0) / code_step)``. Evaluated naively that
    ceil sits on a ~2e5-sample magnitude (f32 ulp ~0.016 samples), so it
    is computed cancellation-free on SMALL values only:

        C(e)   = (e+1)*spms + ceil(-(rem0 + (e+1)*eps) / code_step)
        rem(e) = rem0 + e*eps + (C(e-1) - e*spms) * code_step

    with ``eps = spms * delta / fs`` (~1e-3 chips): exact in reals because
    ``spms * GPS_L1CA_CODE_FREQ / fs == L``, and finer than the scan's f32
    error accumulation (every operand stays O(10)). Carrier remainders use
    the same decomposition mod 2 pi.

    Semantics vs the scan: equivalent whenever a channel can run every
    epoch of the block (the production case — the session's window rail
    keeps ``spms <~ unread <~ tail*spms``). A channel that cannot (sample
    deficit right after acquisition handoff) runs NONE of the block's
    epochs instead of a suffix: ``active`` is all-or-nothing, the deficit
    fills while the state stays frozen, and the channel starts one block
    later. Numerics: the ceil() here is evaluated on different (smaller)
    operands than the scan's, so an epoch boundary sitting within f32
    rounding of an integer may tie-break one sample differently — each
    form is self-consistent with its own boundary (the epoch phases are
    derived from the same C(e)), so loop-filter trajectories match the
    scan to f32 rounding / one-sample boundary ties, not bit-exactly.
    Pinned by tests/test_pass_a_closed.py (IF=0 exact-geometry slice plus
    nonzero-IF tie-break-tolerant cases).
    """
    spms = cfg.samples_per_ms
    fs = cfg.sampling_frequency
    n_epochs = cfg.block_ms

    doppler = st.carrier_freq - cfg.intermediate_frequency
    aiding = (
        doppler * (GPS_L1CA_CODE_FREQ / GPS_L1CA_CARRIER_FREQ)
        if cfg.carrier_aiding else 0.0
    )
    delta = st.code_freq_offset + aiding
    code_step = (GPS_L1CA_CODE_FREQ + delta) / fs
    omega = TWO_PI * st.carrier_freq / fs

    e_i = jnp.arange(n_epochs, dtype=jnp.int32)[:, None]       # [E, 1]
    e_f = e_i.astype(jnp.float32)
    eps = delta * (float(spms) / fs)                           # [n_ch]

    # dd(e) = C(e) - (e+1)*spms, an O(10) integer; C(-1) = 0 -> dd0 row.
    g = -(st.rem_code[None, :] + (e_f + 1.0) * eps[None, :]) \
        / code_step[None, :]
    dd = jnp.ceil(g).astype(jnp.int32)                          # [E, n_ch]
    c_full = (e_i + 1) * spms + dd                              # C(e)
    c_prev = jnp.concatenate(
        [jnp.zeros((1,) + dd.shape[1:], jnp.int32), c_full[:-1]], axis=0)
    required = c_full - c_prev

    # Sample-budget feasibility, exact incl. the availability clamp:
    # w(e) = min(unread0 + (e+1)*spms, (tail+e+1)*spms) is the would-be
    # unread+consumed total; the block runs iff w(e) >= C(e) for all e.
    w = jnp.minimum(st.unread[None, :] + (e_i + 1) * spms,
                    (cfg.tail_ms + e_i + 1) * spms)
    tracking = st.mode == MODE_TRACKING
    all_ok = tracking[None, :] & jnp.all(w >= c_full, axis=0,
                                         keepdims=True)         # [1, n_ch]
    active = jnp.broadcast_to(all_ok, required.shape)

    d_prev = c_prev - e_i * spms                                # O(10) ints
    rem_code_seq = st.rem_code[None, :] + e_f * eps[None, :] \
        + d_prev.astype(jnp.float32) * code_step[None, :]
    # Carrier phase consumed before epoch e: omega * C(e-1), decomposed so
    # every operand entering mod stays small at any IF.
    om_ms = jnp.mod(omega * float(spms), TWO_PI)                # [n_ch]
    rem_carrier_seq = jnp.mod(
        st.rem_carrier[None, :]
        - (om_ms[None, :] * e_f + omega[None, :]
           * d_prev.astype(jnp.float32)),
        TWO_PI,
    )
    req_eff = jnp.where(active, required, 0)
    c_eff = jnp.where(active, c_full, 0)
    c_prev_eff = jnp.where(active, c_prev, 0)

    seq = {
        "required": required,
        "active": active,
        "b_start": c_prev_eff,
        "rem_code": jnp.where(active, rem_code_seq, st.rem_code[None, :]),
        "rem_carrier": jnp.where(active, rem_carrier_seq,
                                 st.rem_carrier[None, :]),
        "unread_after": w - c_eff,
    }
    last = n_epochs - 1
    e_end = jnp.float32(n_epochs)
    rem_code_end = st.rem_code + e_end * eps \
        + (c_full[last] - n_epochs * spms).astype(jnp.float32) * code_step
    rem_carrier_end = jnp.mod(
        st.rem_carrier - (om_ms * e_end + omega * (
            c_full[last] - n_epochs * spms).astype(jnp.float32)),
        TWO_PI,
    )
    act1 = all_ok[0]
    seq["rem_code_end"] = jnp.where(act1, rem_code_end, st.rem_code)
    seq["rem_carrier_end"] = jnp.where(act1, rem_carrier_end,
                                       st.rem_carrier)
    seq["unread_end"] = w[last] - jnp.where(act1, c_full[last], 0)
    seq["consumed_end"] = jnp.where(act1, c_full[last], 0)
    seq["code_step"] = code_step
    seq["omega"] = omega
    seq["delta"] = delta
    return seq


# ---------------------------------------------------------------------------
# Pass B: dense correlation over per-channel aligned regions
# ---------------------------------------------------------------------------

# Superblock-hoisted word tables: the code-phase intercept drifts only at the
# code-Doppler rate (|delta| <= code_rail_hz + aiding <= ~10 chips/s), so a
# word table whose C0I row axis is EXTENDED by the possible integer-chip
# drift range, built once at superblock start, covers every block: the
# per-block "roll" collapses to a row pick at the per-channel integer drift
# ``d``, replacing the per-channel dynamic-slice roll + word gather done 50x
# per signal-second. The identity making this free: column dc of a per-offset table stack equals
# row dc + v of the extended table, since the packed word for (offset dc,
# C0I row v) depends only on dc + v.
DRIFT_CHIPS_PER_S = 10.0  # bound guaranteed by code_rail_hz + the freq rail


def _wordpack_geometry(t_sb_s: float) -> tuple[int, int]:
    """(DC, LEAD) for a superblock of duration ``t_sb_s`` seconds.

    ``d = LEAD + drift`` must stay in [0, DC) for drift in ``[-M, M]`` with
    ``M = ceil(DRIFT_CHIPS_PER_S * t_sb + 2)`` (the +2 covers rem_code loop
    transients and floor rounding).
    """
    m = int(np.ceil(DRIFT_CHIPS_PER_S * t_sb_s + 2.0))
    return 2 * m + 2, m


def _intercept(cfg: TrackingConfig, st: ChannelState):
    """Code-phase intercept of the block's first consumed sample.

    Bit-identical to the former inline computation in :func:`block_geometry`
    (pass A's epoch-0 ``rem_code`` is ``st.rem_code`` and its ``delta`` is
    this same expression), so it can also be evaluated from the superblock's
    initial state alone by :func:`make_wordpack`.
    """
    spms = cfg.samples_per_ms
    fs = cfg.sampling_frequency
    L = GPS_L1CA_CODE_LENGTH
    doppler = st.carrier_freq - cfg.intermediate_frequency
    aiding = (
        doppler * (GPS_L1CA_CODE_FREQ / GPS_L1CA_CARRIER_FREQ)
        if cfg.carrier_aiding else 0.0
    )
    delta = st.code_freq_offset + aiding
    avail0 = (cfg.tail_ms + 1) * spms
    unread0 = jnp.minimum(st.unread + spms, avail0)
    base = avail0 - unread0                              # [n_ch] int32
    a_ms = base // spms
    b_rem = base % spms
    b1023 = (b_rem * jnp.int32(L)).astype(jnp.float32)   # exact in int32
    B = st.rem_code - base.astype(jnp.float32) * (delta / fs) - b1023 / spms
    B = jnp.mod(B, float(L))
    c_int = jnp.floor(B).astype(jnp.int32)               # [0, 1022]
    fb = B - c_int.astype(jnp.float32)                   # [0, 1)
    return base, a_ms, b_rem, c_int, fb


def _word_windex(cfg: TrackingConfig, n_rows: int = C0I_ROWS):
    """Static (numpy) bit-gather index table for packed-word building.

    Row ``j`` of the result packs chips starting at integer chip offset
    ``c + C0I_MIN + j`` of the roll origin ``c`` — for the per-block build
    ``n_rows = C0I_ROWS`` (the ``floor(frac + spacing)`` range); for the
    superblock-hoisted table the row axis is extended by the drift range.
    """
    spms = cfg.samples_per_ms
    gsize, local = _group_size(cfg.sampling_frequency)
    step0 = GPS_L1CA_CODE_FREQ / cfg.sampling_frequency
    # +2 slack groups: sample-quantised correlator taps shift the chip
    # stream forward by up to ~2 chips past the per-ms span.
    n_groups = (spms + gsize - 1) // gsize + 2
    cs0 = np.floor(np.arange(n_groups) * gsize * step0).astype(np.int32)
    windex = (
        8
        + (C0I_MIN + np.arange(n_rows))[:, None, None]
        - 2
        + cs0[None, :, None]
        + np.arange(local)[None, None, :]
    )                                                # [n_rows, G, local]
    return windex, local


def _build_words(cfg: TrackingConfig, bits3x, c_int,
                 n_rows: int = C0I_ROWS):
    """Packed chip words at integer chip offset ``c_int`` (per channel).

    Device-side packed words from rolled code bits:
    ``rolled[p] = chip (c_int - 8 + p) mod 1023 = bits3x[L + c_int - 8 + p]``;
    returns ``[n_ch, n_rows, G]``. Row ``j`` packs the chips for offset
    ``c_int + C0I_MIN + j`` — rows beyond ``C0I_ROWS`` extend the same
    sequence (the superblock-hoisted table), bit-identical to the leading
    rows of a fresh build at ``c_int + (j - v)`` for any split.
    """
    L = GPS_L1CA_CODE_LENGTH
    windex, local = _word_windex(cfg, n_rows)
    pow2 = jnp.asarray((2.0 ** np.arange(local)).astype(np.float32))
    roll_start = L + c_int - 8
    width = int(windex.max()) + 1           # no clamped (wrong-chip) reads
    # 4x tiling covers the worst case: start <= L + 1022 - 8 = 2037,
    # end <= 2037 + width <= bits3x width (tiled_code_bits).
    assert 2037 + width <= bits3x.shape[-1], (width, bits3x.shape)
    rolled = jax.vmap(
        lambda bt, s0: jax.lax.dynamic_slice(bt, (s0,), (width,))
    )(bits3x, roll_start)
    return jnp.sum(rolled[:, windex] * pow2, axis=-1)   # [n_ch, n_rows, G]


def make_wordpack(cfg: TrackingConfig, bits3x, st: ChannelState,
                  t_sb_s: float):
    """Hoisted word tables for every block of a superblock.

    Built once from the superblock's initial state. The word for (integer
    drift dc, C0I row v) depends only on ``dc + v``, so the per-offset
    tables collapse into ONE table whose C0I row axis is extended by the
    drift range: per block the kernel adds the per-channel integer drift
    ``d`` to its row selector (a scalar), and the XLA boundary recompute
    picks its C0I_ROWS-row slice ``[d, d + 4)`` with a tiny one-hot
    reduction. ``d`` stays in range because ``code_rail_hz`` (pass C) and
    the carrier-aiding bound cap the code-rate offset at
    ``DRIFT_CHIPS_PER_S`` chips/s (:func:`_wordpack_geometry`).
    """
    dc_n, lead = _wordpack_geometry(t_sb_s)
    *_, c_int0, _ = _intercept(cfg, st)
    c_roll = jnp.mod(c_int0 - lead, GPS_L1CA_CODE_LENGTH).astype(jnp.int32)
    wtab = _build_words(cfg, bits3x, c_roll,
                        n_rows=dc_n + C0I_ROWS - 1)    # [n_ch, J, G]
    # dc_n/lead are recovered from wtab.shape[1] downstream (the pack must
    # stay a pytree of arrays to cross jit boundaries).
    return {"c_roll": c_roll, "wtab": wtab}


def block_words(cfg: TrackingConfig, bits3x, st: ChannelState, c_int,
                wordpack=None):
    """Packed chip words ``[n_ch, C0I_ROWS, G]`` of the dense pass.

    Built per block from a cyclic roll of the code bits at ``c_int``, or
    picked from the superblock-hoisted table of :func:`make_wordpack`.
    """
    if wordpack is None:
        return _build_words(cfg, bits3x, c_int)
    wtab = wordpack["wtab"]                              # [n_ch, J, G]
    n_j = wtab.shape[1]
    dc_n = n_j - C0I_ROWS + 1
    lead = (dc_n - 2) // 2
    # Non-tracking channels' intercepts wander (their correlators are
    # masked out downstream) — pin them to the table centre. Tracking
    # channels' drift is bounded by code_rail_hz + carrier aiding
    # (DRIFT_CHIPS_PER_S), so the clip is unreachable for them.
    d = jnp.where(st.mode == MODE_TRACKING,
                  jnp.mod(c_int - wordpack["c_roll"], GPS_L1CA_CODE_LENGTH),
                  jnp.int32(lead))
    d = jnp.clip(d, 0, dc_n - 1)
    # Rows [d, d + C0I_ROWS) of the extended table (tiny one-hot
    # reduction, no dynamic slices).
    sel = (jnp.arange(n_j, dtype=jnp.int32)[None, :, None]
           == d[:, None, None]
           + jnp.arange(C0I_ROWS, dtype=jnp.int32)[None, None, :])
    return jnp.sum(
        jnp.where(sel[..., None], wtab[:, :, None, :], 0.0), axis=1)


def block_geometry(cfg: TrackingConfig, st: ChannelState, geo):
    """Per-block code/carrier phase anchors in window coordinates.

    Code phase at *window* sample m is ``B + m*step (mod 1023)``: the
    integer part ``c_int`` of B selects the code rotation, and
    per-millisecond anchor tables carry float32 precision for the
    fractional parts. Shared by the dense pass, the fused correlator and
    the time-sharded (sequence-parallel) variant.
    """
    spms = cfg.samples_per_ms
    fs = cfg.sampling_frequency
    n_q = cfg.tail_ms + cfg.block_ms
    delta = geo["delta"]
    omega = geo["omega"]

    # Window position of the first consumed sample (epoch-0 read pointer)
    # and the code phase intercept B = rem0 - base*step (mod 1023).
    base, a_ms, b_rem, c_int, fb = _intercept(cfg, st)

    qs = jnp.arange(n_q, dtype=jnp.float32)
    fb_q = fb[:, None] + qs[None, :] * (spms * delta / fs)[:, None]
    w_ms = jnp.mod(omega * spms, TWO_PI)
    phic0 = (
        geo["rem_carrier"][0]
        + a_ms.astype(jnp.float32) * w_ms
        + omega * b_rem.astype(jnp.float32)
    )
    phic_q = jnp.mod(phic0[:, None] - qs[None, :] * w_ms[:, None], TWO_PI)
    return {"base": base, "c_int": c_int, "fb_q": fb_q, "phic_q": phic_q}


def dense_streams(cfg: TrackingConfig, words, fb_q, phic_q, omega, code_step,
                  window_re, window_im, q_offset=0):
    """Correlation streams over a window slice aligned to ms boundaries.

    Args:
        window_re/im: ``[n_samples]`` slice; its first sample must lie at
            global per-ms grid index ``q_offset`` (``q_offset`` may be a
            traced integer — the time-sharded path passes the shard index).

    Returns ``[n_ch, n_streams, n_samples]`` float32.
    """
    from sydr_tpu.ops import profiles as prof

    spms = cfg.samples_per_ms
    fs = cfg.sampling_frequency
    gsize, local = _group_size(fs)
    step0 = GPS_L1CA_CODE_FREQ / fs
    n_ch = words.shape[0]
    n_samp = window_re.shape[-1]
    assert n_samp % spms == 0, "slice must be whole milliseconds"
    n_ms_l = n_samp // spms
    n_groups = words.shape[-1]

    q_offset = jnp.asarray(q_offset, jnp.int32)
    fb_l = jax.lax.dynamic_slice(
        fb_q, (jnp.int32(0), q_offset), (n_ch, n_ms_l))
    ph_l = jax.lax.dynamic_slice(
        phic_q, (jnp.int32(0), q_offset), (n_ch, n_ms_l))

    def expand_ms(x_q):
        return jnp.repeat(x_q, spms, axis=1)

    def expand_group(x_qg):
        x = jnp.repeat(x_qg, gsize, axis=2)[:, :, :spms]
        return x.reshape(n_ch, n_ms_l * spms)

    shifts = prof.spacing_shifts(cfg)
    EXT = 128 if shifts is not None else 0
    # Extended per-sample tables: the EXT lookahead samples are pinned to
    # the last local millisecond (its anchors stay linear past spms), so
    # sample-quantised taps can read ``base_chip[m + k]`` past the slice.
    lm = np.arange(n_samp, dtype=np.int64) % spms
    if EXT:
        lm = np.concatenate([lm, lm[-1] + 1 + np.arange(EXT, dtype=np.int64)])
    lm_f = jnp.asarray(lm.astype(np.float32))
    grp = lm // gsize
    cs0 = np.floor(np.arange(n_groups) * gsize * step0).astype(np.int32)
    cs0_m = jnp.asarray(cs0[np.minimum(grp, n_groups - 1)].astype(np.int32))

    step_parts = cg.code_step_parts(code_step, spms)
    phase = expand_ms(ph_l) - omega[:, None] * lm_f[None, :n_samp]
    cosv, sinv = jnp.cos(phase), jnp.sin(phase)
    mre = cosv * window_re[None, :] - sinv * window_im[None, :]
    mim = cosv * window_im[None, :] + sinv * window_re[None, :]

    def expand_ms_ext(x_q):
        x = expand_ms(x_q)
        if not EXT:
            return x
        return jnp.concatenate(
            [x, jnp.repeat(x_q[:, -1:], EXT, axis=1)], axis=1)

    def expand_group_ext(x_qg):
        x = expand_group(x_qg)
        if not EXT:
            return x
        tail_grp = jnp.asarray(
            np.minimum(grp[-EXT:], n_groups - 1).astype(np.int32))
        return jnp.concatenate([x, x_qg[:, -1, tail_grp]], axis=1)

    def chip_stream(sp):
        """0/1-masked chips at spacing ``sp``, ``[n_ch, n_samp + EXT]``."""
        r_q = fb_l + sp
        c0i_q = jnp.floor(r_q).astype(jnp.int32)
        row_q = jnp.clip(c0i_q - C0I_MIN, 0, C0I_ROWS - 1)
        w_qg = jnp.zeros((n_ch, n_ms_l, n_groups), jnp.float32)
        for v in range(C0I_ROWS):
            w_qg = w_qg + jnp.where(
                (row_q == v)[:, :, None], words[:, v, :][:, None, :], 0.0
            )
        w_rep = expand_group_ext(w_qg)
        r_m = expand_ms_ext(r_q)
        c0i_m = expand_ms_ext(c0i_q.astype(jnp.float32)).astype(jnp.int32)

        idx_frac = jnp.ceil(cg.chip_phase(
            r_m, lm_f[None, :], [p[:, None] for p in step_parts]
        )).astype(jnp.int32)
        l = idx_frac - c0i_m + 2 - cs0_m[None, :]
        l_clip = jnp.clip(l, 0, local - 1)
        p2 = jax.lax.bitcast_convert_type(
            ((127 - l_clip) << 23).astype(jnp.int32), jnp.float32
        )
        t = w_rep * p2
        bit = jnp.floor(t) - 2.0 * jnp.floor(t * 0.5)
        in_range = ((l >= 0) & (l < local)).astype(jnp.float32)
        return (2.0 * bit - 1.0) * in_range

    streams = []
    if shifts is not None:
        base_sp, ks = shifts
        base = chip_stream(base_sp)
        for k in ks:
            chips = base[:, k:k + n_samp]
            streams.append(chips * mre)
            streams.append(chips * mim)
    else:
        for sp in prof.spacings_for(cfg):
            chips = chip_stream(sp)
            streams.append(chips * mre)
            streams.append(chips * mim)
    return jnp.stack(streams, axis=1)


def epoch_bounds(cfg: TrackingConfig, geo, base):
    """``(b_start, b_end)`` ``[block_ms, n_ch]`` epoch sample bounds in
    window coordinates (inactive epochs are empty)."""
    n_win = cfg.window_samples
    req_eff = jnp.where(geo["active"], geo["required"], 0)
    b_start = geo["b_start"] + base[None, :]
    b_end = jnp.clip(b_start + req_eff, 0, n_win)
    return jnp.clip(b_start, 0, n_win), b_end


def correlator_taps(cfg: TrackingConfig) -> tuple:
    """``((spacing, sample_shift), ...)`` per correlator tap: quantised
    taps are shifts of the base stream, the others stand alone."""
    from sydr_tpu.ops import profiles as prof

    shifts = prof.spacing_shifts(cfg)
    if shifts is not None:
        base_sp, ks = shifts
        return tuple((base_sp, k) for k in ks)
    return tuple((sp, 0) for sp in prof.spacings_for(cfg))


def _pass_b(cfg: TrackingConfig, bits3x, st: ChannelState, geo,
            window_re, window_im, wordpack=None):
    """Correlators ``[block_ms, n_ch, n_streams]`` for the whole block."""
    return correlate(cfg, bits3x, st, geo, block_geometry(cfg, st, geo),
                     window_re, window_im, wordpack)


def correlate(cfg: TrackingConfig, bits3x, st: ChannelState, geo, bg,
              window_re, window_im, wordpack=None):
    """Per-epoch correlators ``[block_ms, n_ch, n_streams]`` of one block
    from its epoch geometry (``geo``, pass A) and phase anchors (``bg``,
    :func:`block_geometry`).

    Code/carrier phase are linear in the *window* sample index m:
    ``phi_code(m) = B + m*step (mod 1023)`` with ``B = rem0 - base*step``.
    ``cfg.use_pallas`` runs the fused per-epoch correlator
    (``ops.correlator_gpu``); otherwise the XLA dense pass materialises the
    per-sample streams, prefix-sums them and differences the prefix at the
    epoch bounds.
    """
    b_start, b_end = epoch_bounds(cfg, geo, bg["base"])

    if cfg.use_pallas:
        return cg.correlate_epochs(
            window_re, window_im, bits3x, bg["c_int"], geo["omega"],
            geo["code_step"], bg["fb_q"], bg["phic_q"], b_start, b_end,
            spms=cfg.samples_per_ms, taps=correlator_taps(cfg),
            code_offset=cfg.ablate_word_row,
            interpret=cfg.pallas_interpret)

    words = block_words(cfg, bits3x, st, bg["c_int"], wordpack)
    streams = dense_streams(
        cfg, words, bg["fb_q"], bg["phic_q"], geo["omega"],
        geo["code_step"], window_re, window_im, q_offset=0,
    )                                                     # [n_ch, S, n_win]
    n_ch, n_streams = streams.shape[:2]
    cs = jnp.cumsum(streams, axis=-1)
    cs = jnp.concatenate([jnp.zeros_like(cs[..., :1]), cs], axis=-1)

    idxs = jnp.stack([b_start, b_end], axis=0)            # [2, block_ms, n_ch]
    idxs = jnp.transpose(idxs, (2, 0, 1)).reshape(n_ch, 1, -1)
    picked = jnp.take_along_axis(
        cs, jnp.broadcast_to(idxs, (n_ch, n_streams, idxs.shape[-1])),
        axis=-1,
    ).reshape(n_ch, n_streams, 2, cfg.block_ms)
    corr = picked[:, :, 1, :] - picked[:, :, 0, :]
    return jnp.transpose(corr, (2, 0, 1))                 # [bm, n_ch, 2S]


# ---------------------------------------------------------------------------
# Pass C: scalar replay (loop filters, bit sync, indicators)
# ---------------------------------------------------------------------------

def _pass_c(cfg: TrackingConfig, st: ChannelState, geo, corr):
    import types

    from sydr_tpu.ops import profiles as prof

    frozen_carrier = st.carrier_freq
    frozen_code_off = st.code_freq_offset

    def step(carry, inp):
        (carrier_freq, code_off, dll_mem, pll_mem, fll_mem, fll_vel,
         fll_acc, lock_state, ip_prev, qp_prev,
         flags, code_counter, ms_counter, edge_hist, bit_edge, accum_count,
         ip_sum, qp_sum, ip_sq, qp_sq, ratio_sum, cn0, pll_lock, fll_lock,
         phi_virt, chip_virt, ipc_prev, qpc_prev) = carry
        c, active = inp["corr"], inp["active"]

        stv = types.SimpleNamespace(
            dll_memory=dll_mem, pll_memory=pll_mem, fll_vel=fll_vel,
            fll_acc=fll_acc,
            i_prompt_prev=ip_prev, q_prompt_prev=qp_prev,
            pll_lock=pll_lock, fll_lock=fll_lock, lock_state=lock_state,
            code_counter=code_counter,
        )
        # Virtual-NCO compensation: the within-block NCO is frozen, so the
        # raw discriminators measure the full error; subtract the phase /
        # frequency the already-applied corrections would have removed.
        comp = {
            "freq": carrier_freq - frozen_carrier,
            "phase": phi_virt - jnp.round(phi_virt),
            "code": chip_virt,
        }
        lu = prof.loop_update(cfg, c, stv, active, comp=comp)
        i_early, q_early = lu["i_early"], lu["q_early"]
        i_prompt, q_prompt = lu["i_prompt"], lu["q_prompt"]
        i_late, q_late = lu["i_late"], lu["q_late"]
        code_err = lu["code_err"]
        phase_err = lu["phase_err"]
        nco_code = lu["nco_code"]
        nco_carrier = lu["nco_carrier"]

        new_carrier = carrier_freq + nco_carrier
        if cfg.freq_rail_hz > 0:
            new_carrier = jnp.clip(
                new_carrier,
                st.freq_anchor - cfg.freq_rail_hz,
                st.freq_anchor + cfg.freq_rail_hz,
            )
        if cfg.max_block_freq_step > 0:
            new_carrier = jnp.clip(
                new_carrier,
                frozen_carrier - cfg.max_block_freq_step,
                frozen_carrier + cfg.max_block_freq_step,
            )
        new_code_off = code_off - nco_code
        if cfg.code_rail_hz > 0:
            new_code_off = jnp.clip(
                new_code_off, -cfg.code_rail_hz, cfg.code_rail_hz)

        # Virtual-phase-compensated prompts for the bit/C/N0 path: the raw
        # prompts live in the FROZEN-NCO frame, so the phase the virtual
        # NCO has already applied (comp["phase"], realised into the real
        # NCO only at the block boundary) rotates them out of the
        # corrected frame — in short pull-in blocks a 20 ms bit spans
        # several blocks and those per-boundary rotations corrupted the
        # NWPR coherent sum (healthy decoding channels read -120 dB-Hz;
        # round-4 soak forensics). Derotating by the same wrapped virtual
        # phase the discriminators are compensated with puts every epoch
        # of a bit in one frame; the squared sums and the Beaulieu ratio
        # are rotation-invariant and use the raw values unchanged. The
        # scanned runtime applies corrections physically each epoch, so
        # this also brings the batch C/N0 closer to its oracle.
        theta = TWO_PI * comp["phase"]
        cth, sth = jnp.cos(theta), jnp.sin(theta)
        ip_c = i_prompt * cth + q_prompt * sth
        qp_c = q_prompt * cth - i_prompt * sth

        # Bit-edge histogram sync (same semantics as the scanned runtime;
        # the flip detector compares consecutive prompts in the SAME
        # compensated frame — ``ipc_prev`` carries the previous epoch's
        # derotated prompt, re-seeded from the raw state value at block
        # start where the virtual phase is zero by construction).
        had_sync = (flags & FLAG_BIT_SYNC) != 0
        new_ms_counter = jnp.where(active, (ms_counter + 1) % 20, ms_counter)
        sign_flip = jnp.sign(ipc_prev) != jnp.sign(ip_c)
        counting = (
            active & ~had_sync & (code_counter > cfg.min_convergence_ms)
            & (pll_lock > 0.5)
        )
        flip_now = counting & sign_flip
        onehot = (
            jnp.arange(20, dtype=jnp.int32)[None, :]
            == new_ms_counter[:, None]
        ).astype(jnp.int32)
        new_hist = edge_hist + onehot * flip_now[:, None].astype(jnp.int32)
        declare = ~had_sync & runtime_mod._bit_sync_declare(cfg, new_hist)
        new_edge = jnp.where(
            declare, jnp.argmax(new_hist, -1).astype(jnp.int32), bit_edge
        )
        bit_sync = had_sync | declare
        phase_in_bit = jnp.mod(new_ms_counter - new_edge, 20)
        at_edge = active & bit_sync & (phase_in_bit == 0)
        bit_complete = at_edge & (accum_count >= 20)
        bit_ip_sum = ip_sum
        accum_reset = at_edge | declare
        new_accum = jnp.where(accum_reset, 0, accum_count) + (
            active & bit_sync
        ).astype(jnp.int32)

        acc = active & bit_sync
        n_ip = jnp.where(accum_reset, 0.0, ip_sum) + jnp.where(acc, ip_c, 0.0)
        n_qp = jnp.where(accum_reset, 0.0, qp_sum) + jnp.where(acc, qp_c, 0.0)
        n_ip2 = jnp.where(accum_reset, 0.0, ip_sq) + jnp.where(acc, i_prompt**2, 0.0)
        n_qp2 = jnp.where(accum_reset, 0.0, qp_sq) + jnp.where(acc, q_prompt**2, 0.0)
        n_ratio = jnp.where(accum_reset, 0.0, ratio_sum) + jnp.where(
            acc, trk.beaulieu_ratio_term(i_prompt, q_prompt,
                                         ip_prev, qp_prev), 0.0)
        new_cn0 = trk.cn0_update(cfg, bit_complete, ip_sum, qp_sum,
                                 ip_sq, qp_sq, ratio_sum, cn0)

        new_pll_lock = lu["pll_lock"]
        new_fll_lock = lu["fll_lock"]
        new_flags = jnp.where(
            active,
            flags | FLAG_CODE_LOCK | jnp.where(bit_sync, FLAG_BIT_SYNC, 0),
            flags)

        def upd(new, old):
            return jnp.where(active, new, old)

        out = {
            "active": active,
            "i_early": i_early, "q_early": q_early,
            "i_prompt": i_prompt, "q_prompt": q_prompt,
            "i_late": i_late, "q_late": q_late,
            "dll_error": code_err, "pll_error": phase_err,
            "fll_error": lu["freq_err"], "lock_state": lu["lock_state"],
            "nco_code": nco_code, "nco_carrier": nco_carrier,
            "carrier_freq": upd(new_carrier, carrier_freq),
            "code_freq": GPS_L1CA_CODE_FREQ + geo["delta"],
            "cn0": new_cn0, "pll_lock": new_pll_lock,
            "fll_lock": new_fll_lock,
            "flags": new_flags,
            "unread": inp["unread_after"],
            "required": inp["required"],
            "rem_code": inp["rem_code_next"],
            "bit_ready": bit_complete,
            "bit_ip_sum": bit_ip_sum,
        }
        new_carry = (
            upd(new_carrier, carrier_freq), upd(new_code_off, code_off),
            upd(code_err, dll_mem), upd(phase_err, pll_mem),
            upd(lu["freq_err"], fll_mem), lu["fll_vel"], lu["fll_acc"],
            lu["lock_state"],
            upd(i_prompt, ip_prev), upd(q_prompt, qp_prev),
            new_flags, upd(code_counter + 1, code_counter),
            new_ms_counter, new_hist, new_edge, new_accum,
            n_ip, n_qp, n_ip2, n_qp2, n_ratio,
            new_cn0, new_pll_lock, new_fll_lock,
            jnp.where(active,
                      phi_virt + (upd(new_carrier, carrier_freq)
                                  - frozen_carrier) * 1e-3,
                      phi_virt),
            jnp.where(active,
                      chip_virt + (upd(new_code_off, code_off)
                                   - frozen_code_off) * 1e-3,
                      chip_virt),
            upd(ip_c, ipc_prev), upd(qp_c, qpc_prev),
        )
        return new_carry, out

    rem_code_seq = jnp.concatenate(
        [geo["rem_code"][1:], geo["rem_code_end"][None]], axis=0
    )
    inputs = {
        "corr": corr,
        "active": geo["active"],
        "unread_after": geo["unread_after"],
        "required": geo["required"],
        "rem_code_next": rem_code_seq,
    }
    init = (
        st.carrier_freq, st.code_freq_offset, st.dll_memory, st.pll_memory,
        st.fll_memory, st.fll_vel, st.fll_acc, st.lock_state,
        st.i_prompt_prev, st.q_prompt_prev, st.flags, st.code_counter,
        st.ms_counter, st.edge_hist, st.bit_edge, st.accum_count,
        st.ip_sum, st.qp_sum, st.ip_sq_sum, st.qp_sq_sum, st.cn0_ratio_sum,
        st.cn0, st.pll_lock, st.fll_lock,
        jnp.zeros_like(st.carrier_freq), jnp.zeros_like(st.carrier_freq),
        st.i_prompt_prev, st.q_prompt_prev,
    )
    carry, outputs = jax.lax.scan(step, init, inputs, unroll=True)
    (carrier_freq, code_off, dll_mem, pll_mem, fll_mem, fll_vel, fll_acc,
     lock_state, ip_prev, qp_prev, flags,
     code_counter, ms_counter, edge_hist, bit_edge, accum_count, ip_sum,
     qp_sum, ip_sq, qp_sq, ratio_sum, cn0, pll_lock, fll_lock, phi_virt_end,
     chip_virt_end, _ipc_end, _qpc_end) = carry

    # End-of-block phase catch-up: realise the virtual-NCO phase the
    # within-block corrections assumed (higher carrier frequency advances
    # the wipe-off phase negatively; code-rate offsets add chips).
    rem_carrier_end = jnp.mod(
        geo["rem_carrier_end"] - TWO_PI * phi_virt_end, TWO_PI)
    rem_code_end = geo["rem_code_end"] + chip_virt_end
    new_state = ChannelState(
        mode=st.mode, flags=flags,
        carrier_freq=carrier_freq, freq_anchor=st.freq_anchor,
        code_freq_offset=code_off,
        rem_carrier=rem_carrier_end, rem_code=rem_code_end,
        dll_memory=dll_mem, pll_memory=pll_mem,
        fll_memory=fll_mem, fll_vel=fll_vel, fll_acc=fll_acc,
        i_prompt_prev=ip_prev, q_prompt_prev=qp_prev,
        unread=geo["unread_end"], code_counter=code_counter,
        ms_counter=ms_counter, edge_hist=edge_hist, bit_edge=bit_edge,
        accum_count=accum_count,
        ip_sum=ip_sum, qp_sum=qp_sum, cn0_ratio_sum=ratio_sum,
        ip_sq_sum=ip_sq, qp_sq_sum=qp_sq,
        cn0=cn0, pll_lock=pll_lock, fll_lock=fll_lock,
        lock_state=lock_state,
    )
    return new_state, outputs


@functools.partial(jax.jit, static_argnames=("cfg",))
def run_block_batched(cfg: TrackingConfig, bits3x, state: ChannelState,
                      window_re, window_im, wordpack=None):
    """Drop-in replacement for ``runtime.run_block`` (frozen-rate blocks).

    ``bits3x`` is the ``tiled_code_bits`` table (``[n_ch, 4160]``).
    ``wordpack`` (optional, from :func:`make_wordpack`) supplies hoisted
    packed-word tables so the per-block code roll is a one-hot pick.
    """
    from sydr_tpu.channels.runtime import _slew_anchor

    geo = _pass_a(cfg, state)
    corr = _pass_b(cfg, bits3x, state, geo, window_re, window_im,
                   wordpack=wordpack)
    new_state, outputs = _pass_c(cfg, state, geo, corr)
    return _slew_anchor(cfg, new_state), outputs


@functools.partial(jax.jit, static_argnames=("cfg", "k_blocks"))
def run_superblock(cfg: TrackingConfig, k_blocks: int, bits3x,
                   state: ChannelState, samples_re, samples_im):
    """Process ``k_blocks`` consecutive blocks in one device dispatch.

    ``samples_re/im`` hold ``tail_ms + k_blocks * block_ms`` milliseconds
    laid out contiguously; block k's window is the slice starting at
    ``k * block_ms`` (its tail is the previous block's last ``tail_ms``).
    One host round-trip then covers ``k_blocks * block_ms`` of signal — the
    superblock amortisation of the fetch latency.

    Returns (state, outputs) with outputs ``[k_blocks*block_ms, n_ch]``.
    """
    spms = cfg.samples_per_ms
    sb = cfg.block_ms * spms
    win_len = cfg.window_samples

    # Dense-pass word tables hoisted out of the block scan: the code-phase
    # intercept drifts at most DRIFT_CHIPS_PER_S * (wordpack duration)
    # chips from the group's initial state, so one drift-extended table
    # covers a GROUP of consecutive blocks (<= 0.2 s, 11 table rows at
    # 20 ms blocks) and the per-block roll + word gather drops out. The
    # fused correlator gathers chips directly and needs no table.
    max_group = max(1, int(round(0.2 / (cfg.block_ms * 1e-3))))
    group = max(g for g in range(1, k_blocks + 1)
                if k_blocks % g == 0 and g <= max_group)
    n_groups = k_blocks // group
    t_group_s = group * cfg.block_ms * 1e-3

    def inner(wordpack, st, start):
        wre = jax.lax.dynamic_slice(samples_re, (start,), (win_len,))
        wim = jax.lax.dynamic_slice(samples_im, (start,), (win_len,))
        return run_block_batched(cfg, bits3x, st, wre, wim,
                                 wordpack=wordpack)

    # Scan carries hold the state PACKED as two dense matrices: one carried
    # buffer per dtype instead of ~29 tiny [n_ch] leaves, each of which
    # costs a copy per iteration (channels/state.py pack_state).
    def outer(packed, kg):
        st = unpack_state(*packed)
        wordpack = (None if cfg.use_pallas else
                    make_wordpack(cfg, bits3x, st, t_sb_s=t_group_s))

        def body(packed2, j):
            st2, outs2 = inner(wordpack, unpack_state(*packed2),
                               kg * (group * sb) + j * sb)
            return pack_state(st2), outs2

        packed, outs = jax.lax.scan(
            body, packed, jnp.arange(group, dtype=jnp.int32))
        return packed, outs

    packed, outs = jax.lax.scan(
        outer, pack_state(state), jnp.arange(n_groups, dtype=jnp.int32))
    state = unpack_state(*packed)
    merged = jax.tree_util.tree_map(
        lambda x: x.reshape((k_blocks * cfg.block_ms,) + x.shape[3:]), outs)
    return state, merged
