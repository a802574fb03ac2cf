"""Lockstep multi-channel tracking runtime: one scanned SPMD program.

This replaces the reference's parallel runtime — one OS process per channel
with shared-memory ring buffer, per-ms Event barriers and a result queue
(``/root/reference/sydr/channel/channelManager.py:149-188``,
``channel/channel.py:121-160``) — with a single jitted function:

    state, outputs = run_block(config, codes, state, window_re, window_im)

``lax.scan`` advances time in 1-ms epochs over a block of samples resident in
device memory; a vmapped channel axis processes every satellite in lockstep.
The per-ms Event fan-out/fan-in barrier disappears: lockstep SPMD *is* the
barrier. The result queue becomes the fixed-shape ``outputs`` pytree
(``[block_ms, n_channels]`` per field), transferred to the host once per
block.

Variable-length epochs (the reference's ``track_requiredSamples``,
``channel_l1ca_borre.py:428-429``) are handled with fixed-shape windows plus
masking: each channel reads a static-size window at a dynamic offset and the
correlator masks samples beyond its dynamic ``required`` count.

The sliding window buffer is ``[tail_ms + block_ms]`` milliseconds of IQ; the
tail carries the last ``tail_ms`` ms of the previous block so channels whose
read cursor lags the write head (bounded by ~2 ms in steady state) stay in
range — the device-side equivalent of the reference's 100-ms shared-memory
circular buffer (``channelManager.py:54-61``).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp

from sydr_tpu.constants import (
    GPS_L1CA_CARRIER_FREQ,
    GPS_L1CA_CODE_FREQ,
    GPS_L1CA_CODE_LENGTH,
)
from sydr_tpu.channels.state import (
    FLAG_BIT_SYNC,
    FLAG_CODE_LOCK,
    MODE_TRACKING,
    ChannelState,
)
from sydr_tpu.ops import tracking as trk

TWO_PI = 2.0 * jnp.pi


@dataclasses.dataclass(frozen=True)
class TrackingConfig:
    """Static tracking configuration (hashable; closed over by jit)."""

    sampling_frequency: float = 10e6
    intermediate_frequency: float = 0.0
    block_ms: int = 20
    tail_ms: int = 4
    window_size: int = 10240       # >= samples_per_ms * (1 + margin)
    spacings: tuple = (-0.5, 0.0, 0.5)
    # Borre loop filters (reference channel_GPS_L1CA_borre.ini).
    dll_bandwidth: float = 1.0
    dll_damping: float = 0.7
    dll_gain: float = 1.0
    dll_pdi: float = 1e-3
    pll_bandwidth: float = 8.0
    pll_damping: float = 0.7
    pll_gain: float = 0.25
    pll_pdi: float = 1e-3
    # Carrier-aided code NCO (not in the reference; standard technique this
    # design enables by default — scales the code rate by the measured
    # carrier Doppler so the DLL only tracks residuals).
    carrier_aiding: bool = True
    min_convergence_ms: int = 100  # bit-sync arming delay (reference :30)
    bit_sync_flips: int = 10       # sign flips needed to declare bit sync
    # Early declaration: a UNANIMOUS histogram (every observed flip in one
    # bin) of at least this many flips is conclusive on its own — nav data
    # can go seconds without a transition (zero-heavy subframe-1 words),
    # so waiting for ``bit_sync_flips`` can stall a healthy channel.
    # 0 disables the early path.
    bit_sync_unanimous: int = 5
    # Dominance gate on the normal (>= bit_sync_flips) declaration: the
    # histogram mode must hold at least this fraction of all observed
    # flips, else counting continues. A diffuse histogram means the flips
    # are noise (false lock / unconverged PLL) and an argmax declaration
    # would mis-anchor the bit edge — exactly the reference's first-flip
    # failure mode (channel_l1ca_borre.py:399-407) this method replaces.
    bit_sync_dominance: float = 0.6
    # Channel profile: "borre" (DLL+Costas PLL, 3 correlators) or "kaplan"
    # (FLL-assisted PLL + lock-state machine, 5 correlators; reference
    # channel_l1ca_kaplan.py).
    profile: str = "borre"
    # Narrow-only kaplan (the CRUISE shape): 3 correlators
    # (narrow E, P, narrow L) instead of the 5-tap wide/narrow pairs —
    # the FLL assist and lock indicators read only the prompts, so the
    # delayed-feedback robustness that made kaplan the production cruise
    # profile (round 5, ops/profiles.py alias note) is retained at the
    # borre correlator cost (6 streams, not 10). The wide pair only matters for pull-in/wide-track, which the
    # 5-tap pull-in configuration still runs.
    kaplan_narrow_only: bool = False
    spacing_wide: float = 0.5
    spacing_narrow: float = 0.2
    fll_bandwidth_pullin: float = 100.0
    fll_bandwidth_wide: float = 50.0
    fll_bandwidth_narrow: float = 15.0
    pll_bandwidth_wide: float = 25.0
    pll_bandwidth_narrow: float = 15.0
    fll_threshold_wide: float = 0.5
    fll_threshold_narrow: float = 0.8
    pll_threshold_narrow: float = 0.8
    lock_indicator_alpha: float = 0.005
    # Kaplan carrier-loop DLF order: 2 (2nd-order PLL / 1st-order FLL) or
    # 3 (3rd-order PLL / 2nd-order FLL, reference dsp/tracking.py:283-325).
    dlf_order: int = 2
    # FLL discriminator: "atan" (single-arctan, half-cycle ambiguous) or
    # "atan2" (four-quadrant cross/dot, reference dsp/tracking.py:150-176).
    fll_discriminator: str = "atan"
    # C/N0 estimator fed by the 20-ms prompt accumulators: "nwpr"
    # (narrow/wide power ratio) or "beaulieu" (reference
    # channel_l1ca_kaplan.py:485-494, dsp/lockindicator.py:75-99).
    cn0_estimator: str = "nwpr"
    # Carrier NCO rail: clamp the tracked frequency within +-rail of the
    # acquisition anchor (acquisition error <= half a Doppler bin), killing
    # the FLL_ATAN +-500 Hz false-lock aliases. 0 disables.
    freq_rail_hz: float = 400.0
    # Rail re-anchoring: once a channel is bit-synced (genuinely locked, so
    # the alias-rejection purpose of the rail is served), slew the anchor
    # toward the tracked carrier at this rate so hours-long Doppler drift
    # (~0.5-1 Hz/s across a satellite pass) never pins the loop at the
    # rail. 0 disables (anchor stays at the acquisition value).
    anchor_slew_hz_per_s: float = 5.0
    # Batch runtime: bound the total carrier correction applied within one
    # block. The virtual-NCO compensation is linear while the atan
    # discriminators saturate at +-250 Hz; clamping the per-block step keeps
    # the compensation in the linear region during aggressive pull-in.
    max_block_freq_step: float = 125.0
    # Code-rate-offset rail (Hz of the 1.023 MHz code clock). Physical code
    # Doppler not already removed by carrier aiding is < ~1 Hz (satellite
    # dynamics enter via aiding; what remains is receiver clock drift,
    # <= ~2 Hz at 2 ppm TCXO), so +-6 Hz only engages on divergence. It also
    # bounds the code-phase drift per superblock, which sizes the hoisted
    # word tables (batch_runtime.DRIFT_CHIPS_PER_S). 0 disables (the batch
    # runtime's word-table row pick then clips, degrading a diverged — i.e.
    # already unlocked — channel's correlators).
    code_rail_hz: float = 6.0
    # "scan": per-ms feedback cadence (reference-exact); "batch": two-pass
    # frozen-rate blocks (dense, time-parallel; see channels/batch_runtime).
    runtime: str = "scan"
    # Batch runtime pass B: the fused per-epoch correlator
    # (ops/correlator_gpu.py, CUDA GPUs) instead of the XLA dense pass.
    use_pallas: bool = False
    # Run that kernel in the Pallas interpreter (CPU tests only; without it
    # use_pallas raises on a non-GPU backend).
    pallas_interpret: bool = False
    # Batch runtime: blocks per device dispatch (host fetch amortisation);
    # host-side decode/measurement cadence coarsens to the superblock.
    superblock: int = 1
    # Quantise sample uploads to int8 (4x less host->device traffic; the
    # scale is chosen per (super)block and undone on device). GNSS signals
    # are below the noise floor, so 8-bit front-end quantisation costs
    # <0.2 dB — recorded files are int8/int16 anyway.
    upload_int8: bool = True
    # Pre-correlation decimation: the session's input stream arrives at
    # ``sampling_frequency * input_decimate`` and is boxcar-summed by this
    # factor before any processing — the textbook SDR front-end reduction
    # (a chip spans many samples, so summing within a fraction of a chip
    # costs ~0.2-0.5 dB of correlation loss at the chip edges while cutting
    # per-channel device work and upload volume by the factor). All
    # configured rates/windows refer to the DECIMATED stream.
    input_decimate: int = 1
    # Quantise correlator spacings to whole samples (hardware-correlator
    # semantics: E/P/L taps are integer sample lags of one chip stream, so
    # the effective chip spacing is k * code_step, Doppler-scaled). Keeps
    # E/L symmetric about the prompt (zero pseudorange bias) and lets the
    # dense pass and the Pallas kernel derive E/L chips by shifting the
    # single base chip stream.
    quantize_spacing: bool = False
    epl_method: str = "bitpack"
    # Batch-runtime pass A (epoch geometry): "closed" (vectorised closed
    # form — no scan, no carry copies; all-or-nothing block activation,
    # f32-equivalent trajectories; production default) or "scan" (the
    # original per-epoch recurrence, kept as the oracle form; see
    # batch_runtime._pass_a_*).
    pass_a: str = "closed"
    # Fault injection (tests/parity gate only): offset the fused
    # correlator's code-table index by this many chips, emulating a broken
    # kernel whose chips are misaligned (the prompt correlators collapse).
    # Lets the parity gate be tested end-to-end:
    # production_parity(ablate=True) must fail and bench.py must exit
    # non-zero. Never set in production.
    ablate_word_row: int = 0

    @property
    def samples_per_ms(self) -> int:
        return round(self.sampling_frequency * 1e-3)

    @property
    def window_samples(self) -> int:
        return (self.tail_ms + self.block_ms) * self.samples_per_ms


def _bit_sync_declare(cfg: TrackingConfig, edge_hist):
    """Bit-edge declaration rule from a mod-20 flip histogram ``[ch, 20]``.

    Two paths: (a) unanimous — every observed flip in one bin and at least
    ``bit_sync_unanimous`` of them (conclusive even when the nav data then
    goes seconds without a transition); (b) volume — at least
    ``bit_sync_flips`` flips AND the mode bin holds ``bit_sync_dominance``
    of them (a diffuse histogram is noise; declaring on its argmax would
    mis-anchor the bit edge like the reference's first-flip method does,
    tools/reference_e2e.py "ref_bitsync_slips")."""
    total = jnp.sum(edge_hist, axis=-1)
    mode = jnp.max(edge_hist, axis=-1)
    unanimous = (
        (mode == total) & (total >= cfg.bit_sync_unanimous)
        if cfg.bit_sync_unanimous > 0 else jnp.zeros_like(total, bool)
    )
    dominant = (total >= cfg.bit_sync_flips) & (
        mode.astype(jnp.float32)
        >= cfg.bit_sync_dominance * total.astype(jnp.float32))
    return unanimous | dominant


def _epoch(cfg: TrackingConfig, codes, window_re, window_im, carry,
           epoch_idx):
    """One 1-ms lockstep epoch across all channels."""
    st: ChannelState = carry
    spms = cfg.samples_per_ms
    fs = cfg.sampling_frequency

    # One millisecond of samples "arrives" for every channel.
    avail = (cfg.tail_ms + epoch_idx + 1) * spms
    unread = jnp.minimum(st.unread + spms, avail)

    doppler = st.carrier_freq - cfg.intermediate_frequency
    aiding = (
        doppler * (GPS_L1CA_CODE_FREQ / GPS_L1CA_CARRIER_FREQ)
        if cfg.carrier_aiding
        else 0.0
    )
    # delta: code-rate offset from nominal [Hz]; kept separate from the
    # absolute rate so sub-mHz corrections survive float32 (the absolute sum
    # would quantise the rate to ~0.06 Hz and limit-cycle the DLL).
    delta = st.code_freq_offset + aiding
    code_freq = GPS_L1CA_CODE_FREQ + delta
    code_step = code_freq / fs
    required = jnp.ceil(
        (GPS_L1CA_CODE_LENGTH - st.rem_code) / code_step
    ).astype(jnp.int32)

    active = (st.mode == MODE_TRACKING) & (unread >= required)

    # Per-channel fixed-size window reads at dynamic offsets. The window is
    # padded (run_block) so the fixed-size slice never overruns: clamping the
    # start instead would silently misalign the last epoch of every block for
    # channels whose leftover unread is below window_size - samples_per_ms.
    read_ptr = jnp.maximum(avail - unread, 0)

    def one_channel(rp, code_row, req, cf, rem_ca, rem_co, cstep):
        wr = jax.lax.dynamic_slice(window_re, (rp,), (cfg.window_size,))
        wi = jax.lax.dynamic_slice(window_im, (rp,), (cfg.window_size,))
        from sydr_tpu.ops import profiles as prof

        return trk.epl_correlate(
            wr, wi, code_row, req, cf, rem_ca, rem_co, cstep,
            spacings=prof.spacings_for(cfg), sampling_frequency=fs,
            method=cfg.epl_method,
        )

    corr = jax.vmap(one_channel)(
        read_ptr, codes, required, st.carrier_freq, st.rem_carrier,
        st.rem_code, code_step,
    )  # [n_ch, 2 * n_spacings]

    # --- Discriminators + loop filters (profile-dependent) -----------------
    from sydr_tpu.ops import profiles as prof

    lu = prof.loop_update(cfg, corr, st, active)
    i_early, q_early = lu["i_early"], lu["q_early"]
    i_prompt, q_prompt = lu["i_prompt"], lu["q_prompt"]
    i_late, q_late = lu["i_late"], lu["q_late"]
    code_err = lu["code_err"]
    phase_err = lu["phase_err"]
    nco_code = lu["nco_code"]
    nco_carrier = lu["nco_carrier"]

    # --- NCO / phase bookkeeping (reference channel_l1ca_borre.py:364,422) -
    rem_carrier = jnp.mod(
        st.rem_carrier
        - TWO_PI * st.carrier_freq * required.astype(jnp.float32) / fs,
        TWO_PI,
    )
    # Exact-rational phase update: fc/fs == 1023/spms exactly, so
    # required*step - 1023 == 1023*(required - spms)/spms + required*delta/fs
    # with every term well inside float32 precision. This is the split that
    # keeps long-run code phase drift at the micro-chip level.
    rem_code = (
        st.rem_code
        + GPS_L1CA_CODE_LENGTH * (required - spms).astype(jnp.float32) / spms
        + required.astype(jnp.float32) * (delta / fs)
    )
    carrier_freq = st.carrier_freq + nco_carrier
    if cfg.freq_rail_hz > 0:
        carrier_freq = jnp.clip(
            carrier_freq,
            st.freq_anchor - cfg.freq_rail_hz,
            st.freq_anchor + cfg.freq_rail_hz,
        )
    code_freq_offset = st.code_freq_offset - nco_code
    if cfg.code_rail_hz > 0:
        code_freq_offset = jnp.clip(
            code_freq_offset, -cfg.code_rail_hz, cfg.code_rail_hz)

    # --- Bit-edge synchronisation (histogram method) -----------------------
    # The reference latches onto the FIRST prompt sign flip
    # (channel_l1ca_borre.py:399-407), which mis-anchors the bit boundary by
    # up to 10 ms when the PLL is still converging. Here sign-flip positions
    # are histogrammed modulo 20 epochs and the bit edge is declared at the
    # histogram mode once enough flips are observed — millisecond-exact bit
    # boundaries, which the pseudorange bookkeeping depends on.
    had_bit_sync = (st.flags & FLAG_BIT_SYNC) != 0
    ms_counter = jnp.where(active, (st.ms_counter + 1) % 20, st.ms_counter)
    sign_flip = jnp.sign(st.i_prompt_prev) != jnp.sign(i_prompt)
    counting = (
        active & ~had_bit_sync
        & (st.code_counter > cfg.min_convergence_ms)
        & (st.pll_lock > 0.5)
    )
    flip_now = counting & sign_flip
    onehot = (
        jnp.arange(20, dtype=jnp.int32)[None, :] == ms_counter[:, None]
    ).astype(jnp.int32)
    edge_hist = st.edge_hist + onehot * flip_now[:, None].astype(jnp.int32)
    declare = ~had_bit_sync & _bit_sync_declare(cfg, edge_hist)
    bit_edge = jnp.where(
        declare, jnp.argmax(edge_hist, axis=-1).astype(jnp.int32), st.bit_edge
    )
    bit_sync = had_bit_sync | declare
    phase_in_bit = jnp.mod(ms_counter - bit_edge, 20)
    at_edge = active & bit_sync & (phase_in_bit == 0)
    bit_complete = at_edge & (st.accum_count >= 20)
    # 20-ms prompt sum of the *finished* bit (valid where bit_complete).
    bit_ip_sum = st.ip_sum
    new_bit_sync = declare
    accum_reset = at_edge | declare
    accum_count = jnp.where(accum_reset, 0, st.accum_count) + (
        active & bit_sync
    ).astype(jnp.int32)

    # --- C/N0 + lock indicators over bit-aligned 20-ms intervals -----------
    acc = active & bit_sync
    ip_sum = jnp.where(accum_reset, 0.0, st.ip_sum) + \
        jnp.where(acc, i_prompt, 0.0)
    qp_sum = jnp.where(accum_reset, 0.0, st.qp_sum) + \
        jnp.where(acc, q_prompt, 0.0)
    ip_sq_sum = jnp.where(accum_reset, 0.0, st.ip_sq_sum) + \
        jnp.where(acc, i_prompt**2, 0.0)
    qp_sq_sum = jnp.where(accum_reset, 0.0, st.qp_sq_sum) + \
        jnp.where(acc, q_prompt**2, 0.0)
    ratio_sum = jnp.where(accum_reset, 0.0, st.cn0_ratio_sum) + \
        jnp.where(acc, trk.beaulieu_ratio_term(
            i_prompt, q_prompt, st.i_prompt_prev, st.q_prompt_prev), 0.0)
    cn0 = trk.cn0_update(cfg, bit_complete, st.ip_sum, st.qp_sum,
                         st.ip_sq_sum, st.qp_sq_sum, st.cn0_ratio_sum,
                         st.cn0)

    pll_lock = lu["pll_lock"]
    fll_lock = lu["fll_lock"]

    flags = jnp.where(
        active,
        st.flags | FLAG_CODE_LOCK | jnp.where(bit_sync, FLAG_BIT_SYNC, 0),
        st.flags,
    )

    def upd(new, old):
        return jnp.where(active, new, old)

    new_state = ChannelState(
        mode=st.mode,
        flags=flags,
        carrier_freq=upd(carrier_freq, st.carrier_freq),
        freq_anchor=st.freq_anchor,
        code_freq_offset=upd(code_freq_offset, st.code_freq_offset),
        rem_carrier=upd(rem_carrier, st.rem_carrier),
        rem_code=upd(rem_code, st.rem_code),
        dll_memory=upd(code_err, st.dll_memory),
        pll_memory=upd(phase_err, st.pll_memory),
        fll_memory=upd(lu["freq_err"], st.fll_memory),
        fll_vel=lu["fll_vel"],
        fll_acc=lu["fll_acc"],
        i_prompt_prev=upd(i_prompt, st.i_prompt_prev),
        q_prompt_prev=upd(q_prompt, st.q_prompt_prev),
        unread=jnp.where(active, unread - required, unread),
        code_counter=upd(st.code_counter + 1, st.code_counter),
        ms_counter=ms_counter,
        edge_hist=edge_hist,
        bit_edge=bit_edge,
        accum_count=accum_count,
        ip_sum=ip_sum,
        qp_sum=qp_sum,
        cn0_ratio_sum=ratio_sum,
        ip_sq_sum=ip_sq_sum,
        qp_sq_sum=qp_sq_sum,
        cn0=cn0,
        pll_lock=pll_lock,
        fll_lock=fll_lock,
        lock_state=lu["lock_state"],
    )

    outputs = {
        "active": active,
        "i_early": i_early, "q_early": q_early,
        "i_prompt": i_prompt, "q_prompt": q_prompt,
        "i_late": i_late, "q_late": q_late,
        "dll_error": code_err, "pll_error": phase_err,
        "fll_error": lu["freq_err"], "lock_state": lu["lock_state"],
        "nco_code": nco_code, "nco_carrier": nco_carrier,
        "carrier_freq": carrier_freq,
        "code_freq": code_freq,
        "cn0": cn0, "pll_lock": pll_lock, "fll_lock": fll_lock,
        "flags": flags,
        "unread": new_state.unread,
        "required": required,
        "rem_code": new_state.rem_code,
        "bit_ready": bit_complete,
        "bit_ip_sum": bit_ip_sum,
    }
    return new_state, outputs


@functools.partial(jax.jit, static_argnames=("cfg",))
def run_block(cfg: TrackingConfig, codes, state: ChannelState,
              window_re, window_im):
    """Process one block of IQ through all channels.

    Args:
        cfg: static TrackingConfig.
        codes: ``[n_ch, 1025]`` float32 padded code tables.
        state: ChannelState pytree (``[n_ch]`` arrays).
        window_re, window_im: ``[(tail_ms + block_ms) * samples_per_ms]``
            float32 sample planes; the first ``tail_ms`` ms are the tail of
            the previous block.

    Returns:
        (new_state, outputs) with outputs a dict of ``[block_ms, n_ch]``.
    """
    # Trailing zero pad so every fixed-size window_size slice fits without
    # start clamping (read_ptr <= window_samples - samples_per_ms; padded
    # samples are always beyond `required` and masked by the correlator).
    pad = max(cfg.window_size - cfg.samples_per_ms, 0)
    if pad:
        zeros = jnp.zeros((pad,), window_re.dtype)
        window_re = jnp.concatenate([window_re, zeros])
        window_im = jnp.concatenate([window_im, zeros])
    step = functools.partial(_epoch, cfg, codes, window_re, window_im)
    state, outputs = jax.lax.scan(
        step, state, jnp.arange(cfg.block_ms, dtype=jnp.int32)
    )
    state = _slew_anchor(cfg, state)
    return state, outputs


def _slew_anchor(cfg: TrackingConfig, st: ChannelState) -> ChannelState:
    """Per-block rail re-anchoring (see ``anchor_slew_hz_per_s``)."""
    if cfg.anchor_slew_hz_per_s <= 0 or cfg.freq_rail_hz <= 0:
        return st
    max_step = cfg.anchor_slew_hz_per_s * cfg.block_ms * 1e-3
    synced = (st.flags & FLAG_BIT_SYNC) != 0
    anchor = st.freq_anchor + jnp.clip(
        st.carrier_freq - st.freq_anchor, -max_step, max_step)
    import dataclasses as _dc

    return _dc.replace(
        st, freq_anchor=jnp.where(synced, anchor, st.freq_anchor))
