"""Tracking-loop DSP: EPL correlators, discriminators, loop filters.

Array-program re-derivation of the reference tracking kernels
(``/root/reference/sydr/dsp/tracking.py`` and ``c_functions/tracking.c``).
Key structural differences from the reference:

* Fixed-shape windows. The reference consumes a *variable* number of samples
  per code period (``track_requiredSamples``); XLA requires static shapes, so
  correlators here read a fixed ``window_size`` sample window and mask samples
  beyond the (dynamic) ``required`` length.
* Boundary-gather correlator. The naive formulation gathers one chip per
  sample (10k gathers/channel/ms). Since the chip index is non-decreasing in
  the sample index, the correlation is re-expressed as segment sums of the
  mixed signal between *chip boundaries*: one complex cumulative sum over the
  window plus ~1k boundary gathers per spacing, with all three spacings
  sharing the cumsum. This is the default device path; the direct gather
  version is kept as a reference oracle (``method="gather"``).

Indexing convention matches the reference exactly: chip lookups index a
1025-long padded code (one wraparound chip each side) with
``ceil(rem_code + spacing + n * code_step)`` (see ``EPL``, reference
``dsp/tracking.py:110-114``, and the padded code at
``channel_l1ca_borre.py:173``).

All functions are pure, jit-able and vmap-able over a channel axis.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

TWO_PI = 2.0 * jnp.pi
N_PADDED = 1025  # padded code length
# Correlator dot products keep full float32 operands (no TF32 rounding).
_HIGHEST = jax.lax.Precision.HIGHEST


# ---------------------------------------------------------------------------
# Carrier replica and mixing
# ---------------------------------------------------------------------------

def mix_carrier(
    window_re: jax.Array,
    window_im: jax.Array,
    carrier_freq,
    rem_carrier,
    sampling_frequency,
):
    """Wipe the carrier off an IQ window (complex-free: (re, im) pairs).

    Returns the mixed signal ``exp(j*(-2*pi*f*n/fs + rem)) * window`` as
    (re, im) float32 arrays.
    """
    n = jnp.arange(window_re.shape[-1], dtype=jnp.float32)
    phase = rem_carrier - (TWO_PI * carrier_freq / sampling_frequency) * n
    cos, sin = jnp.cos(phase), jnp.sin(phase)
    mixed_re = cos * window_re - sin * window_im
    mixed_im = cos * window_im + sin * window_re
    return mixed_re, mixed_im


def advance_carrier_phase(rem_carrier, carrier_freq, n_samples, sampling_frequency):
    """Carrier phase remainder after ``n_samples`` (reference
    ``channel_l1ca_borre.py:364-365``)."""
    rem = rem_carrier - TWO_PI * carrier_freq * (
        jnp.asarray(n_samples).astype(jnp.float32) / sampling_frequency
    )
    return jnp.mod(rem, TWO_PI)


# ---------------------------------------------------------------------------
# EPL correlators
# ---------------------------------------------------------------------------

def _epl_gather(mixed_re, mixed_im, code_padded, required, rem_code,
                code_step, spacings):
    """Oracle implementation: one chip gather per sample."""
    w = mixed_re.shape[-1]
    n = jnp.arange(w, dtype=jnp.float32)
    valid = (jnp.arange(w) < required).astype(jnp.float32)
    outs = []
    for sp in spacings:
        idx = jnp.ceil(rem_code + sp + n * code_step).astype(jnp.int32)
        chips = code_padded[jnp.clip(idx, 0, N_PADDED - 1)]
        weighted = chips * valid
        outs.append(jnp.sum(weighted * mixed_re))
        outs.append(jnp.sum(weighted * mixed_im))
    return jnp.stack(outs)


def _epl_cumsum(mixed_re, mixed_im, code_padded, required, rem_code,
                code_step, spacings):
    """Boundary-gather implementation (shared cumulative sums).

    For chip index ``c(n) = ceil(r + n*step)``, the first sample with
    ``c(n) >= k`` is ``floor((k - 1 - r) / step) + 1``; the correlation is the
    code-weighted sum of cumsum segments between consecutive boundaries. All
    three spacings share the two (re, im) cumulative sums.
    """
    w = mixed_re.shape[-1]
    valid = jnp.arange(w) < required
    cs_re = jnp.cumsum(jnp.where(valid, mixed_re, 0.0), axis=-1)
    cs_im = jnp.cumsum(jnp.where(valid, mixed_im, 0.0), axis=-1)
    zero = jnp.zeros_like(cs_re[..., :1])
    cs_re = jnp.concatenate([zero, cs_re], axis=-1)
    cs_im = jnp.concatenate([zero, cs_im], axis=-1)

    k = jnp.arange(N_PADDED + 1, dtype=jnp.float32)
    outs = []
    for sp in spacings:
        r = rem_code + sp
        bounds = jnp.floor((k - 1.0 - r) / code_step).astype(jnp.int32) + 1
        bounds = jnp.clip(bounds, 0, required)
        outs.append(jnp.sum(code_padded * (cs_re[bounds[1:]] - cs_re[bounds[:-1]])))
        outs.append(jnp.sum(code_padded * (cs_im[bounds[1:]] - cs_im[bounds[:-1]])))
    return jnp.stack(outs)


def _epl_local(mixed_re, mixed_im, code_padded, required, rem_code,
               code_step, spacings, sampling_frequency):
    """Gather-free correlator: shifted code + per-group local one-hot.

    Avoids the per-element gathers of the direct and the cumsum
    formulations by exploiting that the chip index is affine in the sample
    index: within a 128-sample group the chip index spans only
    ``ceil(127*step)+1`` values, and the group's base chip is *statically*
    known up to one dynamic integer shift ``floor(rem + spacing)``. So:

      1. one dynamic_slice aligns the padded code per (channel, spacing);
      2. a compile-time index matrix expands it to per-group chip slices;
      3. chips are reconstructed as a local one-hot multiply-sum
         (compare + FMA over ~15 values instead of a 1025-entry gather).

    Bit-identical chip indexing to ``_epl_gather`` (same ceil arithmetic).
    """
    import numpy as np

    w = mixed_re.shape[-1]
    g = 128
    pad = (-w) % g
    if pad:
        mixed_re = jnp.concatenate([mixed_re, jnp.zeros(pad, jnp.float32)])
        mixed_im = jnp.concatenate([mixed_im, jnp.zeros(pad, jnp.float32)])
        w += pad
    n_groups = w // g
    step0 = 1.023e6 / sampling_frequency
    local = int(np.ceil((g - 1) * step0)) + 5
    cs0 = np.floor(np.arange(n_groups) * g * step0).astype(np.int32)
    static_idx = np.minimum(
        cs0[:, None] + np.arange(local)[None, :], 1032
    )  # [n_groups, local]
    cs0_rep = jnp.asarray(np.repeat(cs0, g))          # [w]
    j_range = jnp.arange(local, dtype=jnp.int32)

    # code_ext[p] = code_padded[p - 4]; with base = c0i + 2 the shifted view
    # satisfies code_sh[m] = code_padded[c0i + m - 2], so that
    # code_groups[g, j] = code_padded[c0i + cs0[g] + j - 2] matches
    # l = idx - c0i - cs0[g] + 2 exactly (chips = code_padded[idx]).
    code_ext = jnp.concatenate(
        [jnp.zeros(4, jnp.float32), code_padded, jnp.zeros(8, jnp.float32)]
    )

    n = jnp.arange(w, dtype=jnp.float32)
    valid = (jnp.arange(w) < required).astype(jnp.float32)
    mre = mixed_re * valid
    mim = mixed_im * valid

    outs = []
    for sp in spacings:
        r = rem_code + sp
        c0i = jnp.floor(r).astype(jnp.int32)
        base = jnp.clip(c0i + 2, 0, code_ext.shape[0] - 1033)
        code_sh = jax.lax.dynamic_slice(code_ext, (base,), (1033,))
        code_groups = code_sh[static_idx]             # static gather
        idx = jnp.ceil(r + n * code_step).astype(jnp.int32)
        l = (idx - c0i + 2 - cs0_rep).reshape(n_groups, g)
        onehot = (l[:, :, None] == j_range[None, None, :]).astype(jnp.float32)
        chips = jnp.sum(
            onehot * code_groups[:, None, :], axis=-1
        ).reshape(w)
        outs.append(jnp.dot(chips, mre, precision=_HIGHEST))
        outs.append(jnp.dot(chips, mim, precision=_HIGHEST))
    return jnp.stack(outs)


def _epl_bitpack(mixed_re, mixed_im, code_padded, required, rem_code,
                 code_step, spacings, sampling_frequency):
    """Arithmetic chip lookup via per-group bit-packed code words.

    Like ``_epl_local`` but without materialising the one-hot tensor: each 128-sample group's ``local`` candidate chips are
    packed as bits of one float32 integer word ``w[g] = sum_j bit_j * 2^j``
    (exact for local <= 24), and the per-sample chip is extracted as

        bit = floor(w * 2^-l) - 2 * floor(w * 2^-l / 2)
        chip = 2 * bit - 1

    with ``2^-l`` built by exponent-field bitcast (integer ops only). All
    tensors stay ``[window]``-shaped elementwise — fully fusable by XLA.
    Chip indexing is identical to ``_epl_gather`` (same ceil arithmetic).
    """
    import numpy as np

    w_len = mixed_re.shape[-1]
    step0 = 1.023e6 / sampling_frequency
    # Largest power-of-two group whose chip span packs into an exact f32 int.
    g = 128
    while g > 8 and int(np.ceil((g - 1) * step0)) + 5 > 24:
        g //= 2
    local = int(np.ceil((g - 1) * step0)) + 5
    assert local <= 24, "bit-packed words need local <= 24 (float32 exact)"
    pad = (-w_len) % g
    if pad:
        mixed_re = jnp.concatenate([mixed_re, jnp.zeros(pad, jnp.float32)])
        mixed_im = jnp.concatenate([mixed_im, jnp.zeros(pad, jnp.float32)])
        w_len += pad
    n_groups = w_len // g
    cs0 = np.floor(np.arange(n_groups) * g * step0).astype(np.int32)
    static_idx = np.minimum(
        cs0[:, None] + np.arange(local)[None, :], 1032
    )
    cs0_rep = jnp.asarray(np.repeat(cs0, g))
    pow2j = jnp.asarray((2.0 ** np.arange(local)).astype(np.float32))

    code_ext = jnp.concatenate(
        [jnp.zeros(4, jnp.float32), code_padded, jnp.zeros(8, jnp.float32)]
    )

    n = jnp.arange(w_len, dtype=jnp.float32)
    valid = (jnp.arange(w_len) < required).astype(jnp.float32)
    mre = mixed_re * valid
    mim = mixed_im * valid

    outs = []
    for sp in spacings:
        r = rem_code + sp
        c0i = jnp.floor(r).astype(jnp.int32)
        base = jnp.clip(c0i + 2, 0, code_ext.shape[0] - 1033)
        code_sh = jax.lax.dynamic_slice(code_ext, (base,), (1033,))
        bits = (code_sh[static_idx] > 0).astype(jnp.float32)  # [n_groups, local]
        words = jnp.dot(bits, pow2j, precision=_HIGHEST)       # [n_groups]
        w_rep = jnp.repeat(words, g)                           # [w_len]

        idx = jnp.ceil(r + n * code_step).astype(jnp.int32)
        l = idx - c0i + 2 - cs0_rep                            # [w_len] int32
        l_clip = jnp.clip(l, 0, local - 1)
        # 2^-l via exponent-field construction (|l| < 126 guaranteed).
        p = jax.lax.bitcast_convert_type(
            ((127 - l_clip) << 23).astype(jnp.int32), jnp.float32
        )
        t = w_rep * p
        bit = jnp.floor(t) - 2.0 * jnp.floor(t * 0.5)
        in_range = ((l >= 0) & (l < local)).astype(jnp.float32)
        chips = (2.0 * bit - 1.0) * in_range
        outs.append(jnp.dot(chips, mre, precision=_HIGHEST))
        outs.append(jnp.dot(chips, mim, precision=_HIGHEST))
    return jnp.stack(outs)


def epl_correlate(
    window_re: jax.Array,
    window_im: jax.Array,
    code_padded: jax.Array,
    required,
    carrier_freq,
    rem_carrier,
    rem_code,
    code_step,
    spacings=(-0.5, 0.0, 0.5),
    sampling_frequency: float = 10e6,
    method: str = "cumsum",
):
    """Early/Prompt/Late correlation over a fixed window.

    Args:
        window_re, window_im: ``[window_size]`` float32 IQ planes starting at
            the code period boundary.
        code_padded: ``[1025]`` float32 padded +/-1 chips.
        required: dynamic int32 number of valid samples (<= window_size).
        spacings: static correlator spacings in chips.

    Returns:
        ``[2 * len(spacings)]`` float32: (i, q) per spacing in order.
    """
    mixed_re, mixed_im = mix_carrier(
        window_re, window_im, carrier_freq, rem_carrier, sampling_frequency
    )
    if method == "local":
        return _epl_local(mixed_re, mixed_im, code_padded, required,
                          rem_code, code_step, spacings, sampling_frequency)
    if method == "bitpack":
        return _epl_bitpack(mixed_re, mixed_im, code_padded, required,
                            rem_code, code_step, spacings, sampling_frequency)
    impl = _epl_cumsum if method == "cumsum" else _epl_gather
    return impl(mixed_re, mixed_im, code_padded, required, rem_code,
                code_step, spacings)


# ---------------------------------------------------------------------------
# Discriminators (reference dsp/tracking.py:120-176)
# ---------------------------------------------------------------------------

def dll_nneml(i_early, q_early, i_late, q_late):
    """Normalised non-coherent early-minus-late power discriminator [chips]."""
    e = jnp.sqrt(i_early**2 + q_early**2)
    l = jnp.sqrt(i_late**2 + q_late**2)
    return jnp.where(e + l > 0.0, (e - l) / (e + l), 0.0)


def pll_costas(i_prompt, q_prompt):
    """Costas-loop phase discriminator [cycles]."""
    i_prompt = jnp.asarray(i_prompt)
    ratio = jnp.where(i_prompt != 0.0, q_prompt / jnp.where(i_prompt != 0.0, i_prompt, 1.0), 0.0)
    return jnp.arctan(ratio) / TWO_PI


def _half_cycle_unwrap(x):
    x = jnp.where(x >= jnp.pi / 2.0, x - jnp.pi, x)
    return jnp.where(x <= -jnp.pi / 2.0, x + jnp.pi, x)


def fll_atan(i_prompt, q_prompt, i_prompt_prev, q_prompt_prev, delta_t):
    """Single-arctangent frequency discriminator [Hz]."""
    i_prompt = jnp.asarray(i_prompt)
    i_prompt_prev = jnp.asarray(i_prompt_prev)
    safe = jnp.where(i_prompt != 0.0, i_prompt, 1.0)
    safe_prev = jnp.where(i_prompt_prev != 0.0, i_prompt_prev, 1.0)
    a = jnp.where(i_prompt != 0.0, q_prompt / safe, 0.0)
    b = jnp.where(i_prompt_prev != 0.0, q_prompt_prev / safe_prev, 0.0)
    diff = jnp.arctan(a) - jnp.arctan(b)
    diff = jnp.where(jnp.isnan(diff), 0.0, diff)
    return _half_cycle_unwrap(diff) / delta_t / TWO_PI


def fll_atan2(i_prompt, q_prompt, i_prompt_prev, q_prompt_prev, delta_t):
    """Four-quadrant cross/dot frequency discriminator [Hz].

    ``theta = atan2(cross, dot)`` is the inter-epoch phase advance
    (``P0* x P1 = A^2 e^{i theta}``); the decision-directed form
    ``atan2(cross * sign(dot), |dot|)`` folds the 180-degree rotations that
    nav-data bit flips cause into the half-cycle range, so the estimate
    stays unbiased across bit boundaries. NOTE: deviates deliberately from
    the reference's ``FLL_ATAN2`` (``dsp/tracking.py:146-152``), which
    swaps the atan2 arguments and therefore reads ``pi/2 - theta`` — a
    constant +250 Hz bias at 1 ms epochs that makes the loop settle a
    quarter-cycle off (same policy as the repo's other spec-sign fixes).
    """
    cross = i_prompt_prev * q_prompt - q_prompt_prev * i_prompt
    dot = i_prompt_prev * i_prompt + q_prompt_prev * q_prompt
    return jnp.arctan2(cross * jnp.sign(dot), jnp.abs(dot)) \
        / delta_t / TWO_PI


# ---------------------------------------------------------------------------
# Loop filters
# ---------------------------------------------------------------------------

def loop_filter_taus(noise_bandwidth: float, damping: float, gain: float):
    """Borre-style 2nd-order loop filter time constants (tau1, tau2)."""
    wn = noise_bandwidth * 8.0 * damping / (4.0 * damping**2 + 1.0)
    return gain / wn**2, 2.0 * damping / wn


def borre_loop_filter(value, memory, tau1, tau2, pdi):
    """PI loop filter used by the Borre channel profile."""
    return (tau2 / tau1) * (value - memory) + (pdi / tau1) * value


def fll_assisted_pll_2nd(phase_err, freq_err, w0f, w0p, a2, t_int, vel_memory):
    """2nd-order PLL assisted by a 1st-order FLL (Kaplan 2006 DLF).

    Returns (output, new_vel_memory).
    """
    update = (phase_err * w0p**2 + freq_err * w0f) * t_int
    out = update + vel_memory + phase_err * a2 * w0p
    return out, update


def fll_assisted_pll_3rd(
    phase_err, freq_err, w0f, w0p, a2, a3, b3, t_int, vel_memory, acc_memory
):
    """3rd-order PLL assisted by a 2nd-order FLL (Kaplan 2006 DLF).

    Returns (output, new_vel_memory, new_acc_memory).
    """
    acc_update = (phase_err * w0p**3 + freq_err * w0f**2) * t_int
    first = acc_update + acc_memory
    vel_update = (first + phase_err * a3 * w0p**2 + freq_err * a2 * w0f) * t_int
    out = vel_update + vel_memory + phase_err * b3 * w0p
    return out, vel_update, acc_update


# ---------------------------------------------------------------------------
# Lock indicators and C/N0 estimators (reference dsp/lockindicator.py)
# ---------------------------------------------------------------------------

def low_pass(new, old, alpha):
    return (1.0 - alpha) * old + alpha * new


def pll_lock_indicator(i_prompt, q_prompt, previous, alpha=0.01):
    """Narrow-band-difference over narrow-band-power, low-pass filtered."""
    nbd = i_prompt**2 - q_prompt**2
    nbp = i_prompt**2 + q_prompt**2
    value = jnp.where(nbp > 0.0, nbd / nbp, 0.0)
    return low_pass(value, previous, alpha)


def fll_lock_indicator(
    i_prompt, q_prompt, i_prompt_prev, q_prompt_prev, previous, alpha=0.01
):
    dot = i_prompt * i_prompt_prev - q_prompt * q_prompt_prev
    cross_sign = jnp.sign(i_prompt * i_prompt_prev + q_prompt * q_prompt_prev)
    power = i_prompt**2 + q_prompt**2
    value = jnp.where(power > 0.0, jnp.abs(dot * cross_sign / power), 0.0)
    return low_pass(value, previous, alpha)


def cn0_nwpr(i_sum, q_sum, i_sq_sum, q_sq_sum, n_accum=20, t_int=1e-3):
    """Narrow-band / wide-band power-ratio C/N0 estimate [dB-Hz]."""
    nbp = i_sum**2 + q_sum**2
    wbp = i_sq_sum + q_sq_sum
    np_ratio = jnp.where(wbp > 0.0, nbp / wbp, 1.0)
    arg = (np_ratio - 1.0) / (n_accum - np_ratio) / t_int
    return 10.0 * jnp.log10(jnp.maximum(arg, 1e-12))


def cn0_beaulieu(ratio, n, t_int, previous, alpha=0.1):
    """Beaulieu-method C/N0 estimate, low-pass filtered [linear Hz]."""
    value = jnp.where(ratio > 0.0, n / ratio, 0.0) / t_int
    return low_pass(value, previous, alpha)


def beaulieu_ratio_term(i_prompt, q_prompt, i_prompt_prev, q_prompt_prev):
    """Per-epoch Beaulieu Pn/Pd ratio term accumulated over one data bit.

    Falletti 2011: ``Pn = (|x_k| - |x_{k-1}|)^2 / 2`` (magnitude jitter
    between consecutive prompts — data-bit insensitive) over
    ``Pd = (|x_k|^2 + |x_{k-1}|^2) / 2``. NOTE: deviates deliberately from
    the reference (``channel_l1ca_kaplan.py:485``), which accumulates
    ``(iP^2+qP^2)/(|iP|-|qP|)^2`` — total power over a *signal*-power-like
    denominator — into the Pn/Pd slot of ``CN0_Beaulieu``, so its estimate
    saturates near 1/T (~17 dB-Hz) for any strong signal.
    """
    m1_sq = i_prompt**2 + q_prompt**2
    m0_sq = i_prompt_prev**2 + q_prompt_prev**2
    pn = (jnp.sqrt(m1_sq) - jnp.sqrt(m0_sq)) ** 2
    pd = m1_sq + m0_sq
    return jnp.where(pd > 0.0, pn / pd, 0.0)


def cn0_update(cfg, bit_complete, ip_sum, qp_sum, ip_sq_sum, qp_sq_sum,
               ratio_sum, prev_cn0, n_accum=20):
    """Estimator-selected C/N0 [dB-Hz] refresh at bit completion.

    ``cfg.cn0_estimator``: "nwpr" (default) or "beaulieu". The Beaulieu
    low-pass runs in the linear domain (previous dB-Hz converted back), so
    one state field serves both estimators.
    """
    if getattr(cfg, "cn0_estimator", "nwpr") == "beaulieu":
        prev_lin = jnp.power(10.0, prev_cn0 / 10.0)
        # lambda = n / sum(Pn/Pd) estimates the per-epoch SNR; C/N0 =
        # SNR / T_coherent with T = 1 ms code periods.
        lin = cn0_beaulieu(ratio_sum, float(n_accum), 1e-3, prev_lin)
        new = 10.0 * jnp.log10(jnp.maximum(lin, 1e-12))
    else:
        new = cn0_nwpr(ip_sum, qp_sum, ip_sq_sum, qp_sq_sum)
    return jnp.where(bit_complete, new, prev_cn0)
