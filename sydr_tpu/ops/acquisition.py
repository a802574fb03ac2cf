"""PCPS (Parallel Code Phase Search) acquisition as batched matmul DFTs.

Reformulation of the reference acquisition stage
(``/root/reference/sydr/dsp/acquisition.py:9-115`` and the C variant
``c_functions/acquisition.c:109-172``): instead of a per-channel Python loop
over Doppler bins, the whole (channel x Doppler x non-coherent x coherent)
grid is evaluated inside one jitted function. The circular correlations run
on the matmul four-step DFT (``sydr_tpu.ops.fft``) with signals carried as
(re, im) float32 pairs.

Sign conventions are direct (unlike the reference, which negates the bin at
readout, ``channel_l1ca_borre.py:302``): bin ``d`` wipes a carrier at
``f_if + d`` and the returned Doppler is the bin value itself.
"""

from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np

from sydr_tpu.constants import GPS_L1CA_CODE_FREQ
from sydr_tpu.constants import GPS_L1CA_CODE_LENGTH as GPS_L1CA_CODE_LENGTH_I
from sydr_tpu.ops import fft as mmfft
from sydr_tpu.signal import cacode


def doppler_bins(doppler_range: float, doppler_step: float) -> np.ndarray:
    """Doppler search bins: -range .. +range inclusive."""
    return np.arange(-doppler_range, doppler_range + 1, doppler_step).astype(
        np.float32
    )


def code_fft_conj(prn: int, sampling_frequency: float) -> np.ndarray:
    """conj(FFT(upsampled C/A code)) as a complex128 host array."""
    code = cacode.upsample_code(cacode.ca_code(prn), sampling_frequency)
    return np.conj(np.fft.fft(code.astype(np.float64)))


def split_reim(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Split a host complex array into float32 (re, im) planes."""
    x = np.asarray(x)
    return (
        np.ascontiguousarray(x.real, dtype=np.float32),
        np.ascontiguousarray(x.imag, dtype=np.float32),
    )


@functools.partial(
    jax.jit,
    static_argnames=(
        "sampling_frequency",
        "intermediate_frequency",
        "coherent",
        "non_coherent",
        "doppler_chunk",
    ),
)
def pcps_map(
    iq_re: jax.Array,
    iq_im: jax.Array,
    code_k_re: jax.Array,
    code_k_im: jax.Array,
    bins: jax.Array,
    fwd_plan: mmfft.DFTPlan,
    inv_plan: mmfft.DFTPlan,
    *,
    sampling_frequency: float,
    intermediate_frequency: float = 0.0,
    coherent: int = 5,
    non_coherent: int = 10,
    doppler_chunk: int = 4,
) -> jax.Array:
    """Correlation maps for a batch of channels.

    Args:
        iq_re, iq_im: ``[n_ch, non_coherent * coherent * n]`` float32 samples.
        code_k_re, code_k_im: ``[n_ch, n]`` float32, conj(DFT(code replica)).
        bins: ``[n_dop]`` float32 Doppler bins (length must be a multiple of
            ``doppler_chunk``).

    Returns:
        ``[n_ch, n_dop, n]`` float32 correlation map.
    """
    n_ch, n = code_k_re.shape
    n_dop = bins.shape[0]
    assert n_dop % doppler_chunk == 0, "pad bins to a multiple of doppler_chunk"

    blocks_re = iq_re.reshape(n_ch, non_coherent, coherent, n)
    blocks_im = iq_im.reshape(n_ch, non_coherent, coherent, n)

    # Carrier phase restarts at each non-coherent block (reference semantics:
    # one carrier vector of length coherent*n reused per block,
    # dsp/acquisition.py:33,45-53).
    t = (jnp.arange(coherent * n, dtype=jnp.float32) / sampling_frequency).reshape(
        coherent, n
    )

    def one_chunk(chunk_bins):
        # chunk_bins: [doppler_chunk]
        freqs = intermediate_frequency + chunk_bins  # [dc]
        phase = -2.0 * jnp.pi * freqs[:, None, None] * t[None]  # [dc, coh, n]
        cos, sin = jnp.cos(phase), jnp.sin(phase)
        # (cos + j sin) * (i + j q) expanded in reals.
        mixed_re = blocks_re[None] * cos[:, None, None] - blocks_im[None] * sin[:, None, None]
        mixed_im = blocks_re[None] * sin[:, None, None] + blocks_im[None] * cos[:, None, None]
        corr_re, corr_im = mmfft.circular_correlate(
            mixed_re, mixed_im, code_k_re[None, :, None, None],
            code_k_im[None, :, None, None], fwd_plan, inv_plan,
        )
        coh_re = jnp.sum(corr_re, axis=3)  # [dc, ch, nc, n]
        coh_im = jnp.sum(corr_im, axis=3)
        noncoh = jnp.sum(jnp.sqrt(coh_re**2 + coh_im**2), axis=2)  # [dc, ch, n]
        return noncoh

    chunked = bins.reshape(n_dop // doppler_chunk, doppler_chunk)
    maps = jax.lax.map(one_chunk, chunked)  # [n_chunks, dc, ch, n]
    return maps.reshape(n_dop, n_ch, n).transpose(1, 0, 2)


@functools.partial(
    jax.jit,
    static_argnames=(
        "sampling_frequency",
        "intermediate_frequency",
        "coherent",
        "non_coherent",
        "phases",
        "bin_shifts",
    ),
)
def pcps_shift_map(
    iq_re: jax.Array,
    iq_im: jax.Array,
    code_k_re: jax.Array,
    code_k_im: jax.Array,
    fwd_plan: mmfft.DFTPlan,
    inv_plan: mmfft.DFTPlan,
    *,
    sampling_frequency: float,
    intermediate_frequency: float = 0.0,
    coherent: int = 5,
    non_coherent: int = 10,
    phases: tuple = (0.0,),
    bin_shifts: tuple = ((0, 0),),
) -> jax.Array:
    """PCPS via the DFT shift theorem: one mix+forward DFT per *phase*.

    When the Doppler step divides the DFT bin spacing ``fs / n`` (the usual
    case: 500 Hz step vs 1 kHz bins), every Doppler bin is an integer DFT
    bin shift ``k`` away from one of ``n_phases = (fs/n) / step`` fractional
    offsets. Mixing and the forward DFT then run once per phase instead of
    once per bin (~10x fewer mixes and forward transforms than
    :func:`pcps_map`), and each bin costs one spectrum product with a
    statically rolled code spectrum plus one inverse DFT. The residual
    output modulation ``exp(2j pi k tau / n)`` of the shifted product has
    unit magnitude, so the non-coherent sum is bit-for-math identical.

    Args:
        phases: distinct fractional Doppler offsets [Hz], ascending.
        bin_shifts: per output bin ``(k, phase_index)`` with
            ``bin_hz = k * fs/n + phases[phase_index]``.

    Returns ``[n_ch, n_bins, n]`` float32 correlation map (same contract as
    :func:`pcps_map`).
    """
    n_ch, n = code_k_re.shape
    n_bins = len(bin_shifts)
    blocks_re = iq_re.reshape(n_ch, non_coherent, coherent, n)
    blocks_im = iq_im.reshape(n_ch, non_coherent, coherent, n)
    t = (jnp.arange(coherent * n, dtype=jnp.float32)
         / sampling_frequency).reshape(coherent, n)

    spectra_re, spectra_im = [], []
    for f_p in phases:
        ph = -2.0 * jnp.pi * (intermediate_frequency + f_p) * t  # [coh, n]
        cos, sin = jnp.cos(ph), jnp.sin(ph)
        mre = blocks_re * cos[None, None] - blocks_im * sin[None, None]
        mim = blocks_re * sin[None, None] + blocks_im * cos[None, None]
        fre, fim = mmfft.dft(mre, mim, fwd_plan)
        # coherent sum commutes with the (linear) inverse DFT
        spectra_re.append(jnp.sum(fre, axis=2))            # [ch, nc, n]
        spectra_im.append(jnp.sum(fim, axis=2))

    # All bins in one batch, one inverse DFT per non-coherent block:
    #   * every bin's rolled code spectrum is a static roll (two slices and
    #     a concat), built once and reused by all non-coherent blocks;
    #   * each bin's phase spectrum is picked statically too, so the
    #     per-block spectrum product is a single [n_bins, ch, n]
    #     elementwise op feeding one batched idft;
    #   * magnitudes accumulate in place, so peak working set stays at a
    #     few [n_bins, ch, n] f32 buffers regardless of non_coherent.
    kre_all = jnp.stack(
        [jnp.roll(code_k_re, k, axis=-1) for k, _ in bin_shifts])
    kim_all = jnp.stack(
        [jnp.roll(code_k_im, k, axis=-1) for k, _ in bin_shifts])

    acc = jnp.zeros((n_bins, n_ch, inv_plan.n2, inv_plan.n1), jnp.float32)
    for b in range(non_coherent):
        sre = jnp.stack([spectra_re[p][:, b, :] for _, p in bin_shifts])
        sim = jnp.stack([spectra_im[p][:, b, :] for _, p in bin_shifts])
        pre = sre * kre_all - sim * kim_all
        pim = sre * kim_all + sim * kre_all
        # Magnitudes are layout-invariant: accumulate in the four-step's
        # natural [k2, k1] layout and unpermute ONCE after the loop (saves
        # a full-map transpose relayout per non-coherent block).
        cre, cim = mmfft.idft(pre, pim, inv_plan, permuted_out=True)
        acc = acc + jnp.sqrt(cre**2 + cim**2)
    return jnp.transpose(mmfft.unpermute(acc, inv_plan), (1, 0, 2))


# PCPS formulation: "auto" selects the shift-theorem map at every
# decomposable grid with >= 3x phase reuse (each mix + forward DFT then
# serves several Doppler bins) and falls back to the direct map otherwise.
# Override per run with SYDR_ACQ_MODE=shift|direct|auto.
ACQ_MODE_DEFAULT = "auto"


def shift_plan(bins: np.ndarray, sampling_frequency: float, n: int,
               mode: str | None = None):
    """(phases, bin_shifts) for :func:`pcps_shift_map`, or None if the bins
    do not decompose onto integer DFT-bin shifts (or the mode selects the
    direct map, see ``ACQ_MODE_DEFAULT``). ``mode``
    overrides the SYDR_ACQ_MODE env / default ("shift" forces the plan
    when decomposable, "auto" applies the reuse heuristic)."""
    if mode is None:
        mode = os.environ.get("SYDR_ACQ_MODE", ACQ_MODE_DEFAULT)
    if mode == "direct":
        return None
    f_bin = sampling_frequency / n
    phases: list[float] = []
    shifts: list[tuple[int, int]] = []
    for d in np.asarray(bins, dtype=np.float64):
        k = int(np.floor(d / f_bin + 1e-9))
        rem = float(d - k * f_bin)
        if rem < 0 or rem >= f_bin - 1e-6:
            return None
        match = None
        for i, p in enumerate(phases):
            if abs(p - rem) < 1e-6:
                match = i
                break
        if match is None:
            phases.append(rem)
            match = len(phases) - 1
        shifts.append((k, match))
    if mode != "shift" and len(phases) > max(4, len(shifts) // 3):
        return None  # not enough reuse to be worth it
    return tuple(phases), tuple(shifts)


@functools.partial(jax.jit, static_argnames=("samples_per_chip",))
def peak_metric(corr_map: jax.Array, bins: jax.Array, *, samples_per_chip: int):
    """Two-peak comparison metric per channel.

    Mirrors ``TwoCorrelationPeakComparison`` (reference
    ``dsp/acquisition.py:78-115``): highest peak over the (Doppler x code)
    map, second peak taken on the same Doppler row with +/-1 chip of code
    phases around the main peak excluded (non-circular exclusion, matching
    the reference).

    Returns (doppler_hz [n_ch], code_index [n_ch] int32, metric [n_ch]).
    """
    n_ch, n_dop, n = corr_map.shape
    flat_idx = jnp.argmax(corr_map.reshape(n_ch, -1), axis=-1)
    fi = flat_idx // n
    ci = flat_idx % n
    peak1 = jnp.max(corr_map.reshape(n_ch, -1), axis=-1)

    rows = jnp.take_along_axis(corr_map, fi[:, None, None], axis=1)[:, 0, :]
    idx = jnp.arange(n)[None, :]
    excluded = (idx > ci[:, None] - samples_per_chip) & (
        idx < ci[:, None] + samples_per_chip
    )
    peak2 = jnp.max(jnp.where(excluded, -jnp.inf, rows), axis=-1)

    doppler = bins[fi]
    metric = peak1 / peak2
    return doppler, ci.astype(jnp.int32), metric


def acquire(
    iq,
    code_ffts,
    bins,
    *,
    sampling_frequency: float,
    intermediate_frequency: float = 0.0,
    coherent: int = 5,
    non_coherent: int = 10,
    doppler_chunk: int = 4,
    plans: tuple[mmfft.DFTPlan, mmfft.DFTPlan] | None = None,
    matmul_dtype=None,
):
    """Full PCPS acquisition: map + peak metric.

    Args:
        iq: host complex array ``[n_ch, non_coherent*coherent*n]`` (or a
            (re, im) float32 tuple).
        code_ffts: host complex ``[n_ch, n]`` conj code DFTs (or (re, im)).
        bins: any length; padded internally to a multiple of
            ``doppler_chunk`` with duplicates of the last bin (padded rows are
            dropped before peak-finding).

    Returns (doppler [n_ch], code_index [n_ch], metric [n_ch], map
    [n_ch, n_dop, n]).
    """
    if isinstance(iq, tuple):
        iq_re, iq_im = iq
    else:
        iq_re, iq_im = split_reim(iq)
    if isinstance(code_ffts, tuple):
        k_re, k_im = code_ffts
    else:
        k_re, k_im = split_reim(code_ffts)

    n = k_re.shape[-1]
    if plans is None:
        plans = (
            mmfft.make_plan(n, matmul_dtype=matmul_dtype),
            mmfft.make_plan(n, inverse=True, matmul_dtype=matmul_dtype),
        )
    fwd, inv = plans

    bins = np.asarray(bins, dtype=np.float32)
    n_dop = len(bins)
    sp = shift_plan(bins, sampling_frequency, n)
    if sp is not None:
        phases, bin_shifts = sp
        corr = pcps_shift_map(
            jnp.asarray(iq_re),
            jnp.asarray(iq_im),
            jnp.asarray(k_re),
            jnp.asarray(k_im),
            fwd,
            inv,
            sampling_frequency=sampling_frequency,
            intermediate_frequency=intermediate_frequency,
            coherent=coherent,
            non_coherent=non_coherent,
            phases=phases,
            bin_shifts=bin_shifts,
        )
    else:
        pad = (-n_dop) % doppler_chunk
        bins_padded = np.concatenate([bins, np.repeat(bins[-1:], pad)])
        corr = pcps_map(
            jnp.asarray(iq_re),
            jnp.asarray(iq_im),
            jnp.asarray(k_re),
            jnp.asarray(k_im),
            jnp.asarray(bins_padded),
            fwd,
            inv,
            sampling_frequency=sampling_frequency,
            intermediate_frequency=intermediate_frequency,
            coherent=coherent,
            non_coherent=non_coherent,
            doppler_chunk=doppler_chunk,
        )[:, :n_dop, :]
    samples_per_chip = round(sampling_frequency / GPS_L1CA_CODE_FREQ)
    doppler, code_idx, metric = peak_metric(
        corr, jnp.asarray(bins), samples_per_chip=samples_per_chip
    )
    return doppler, code_idx, metric, corr


# ---------------------------------------------------------------------------
# Serial search (time-domain) acquisition
# ---------------------------------------------------------------------------

def code_shift_matrix(prn: int, sampling_frequency: float) -> np.ndarray:
    """``[samples_per_code, 1023]`` float32: column k = code shifted k chips.

    Host-precomputed operand of the matmul serial search (one per PRN;
    ~40 MB at 10 Msps, bf16-castable).
    """
    code = cacode.ca_code(prn)
    cols = [
        cacode.upsample_code(np.roll(code, k), sampling_frequency)
        for k in range(GPS_L1CA_CODE_LENGTH_I)
    ]
    return np.stack(cols, axis=1).astype(np.float32)


@functools.partial(
    jax.jit,
    static_argnames=("sampling_frequency", "intermediate_frequency",
                     "doppler_chunk"),
)
def serial_search(
    iq_re: jax.Array,
    iq_im: jax.Array,
    shift_matrix: jax.Array,
    bins: jax.Array,
    *,
    sampling_frequency: float,
    intermediate_frequency: float = 0.0,
    doppler_chunk: int = 8,
):
    """Time-domain acquisition: carrier wipe-off then code-shift matmul.

    The reference's ``SerialSearch`` (``dsp/acquisition.py:119-155``) loops
    over every (Doppler, code shift) pair in Python; here the code-shift axis
    is one matmul per Doppler chunk:

        map[f, k] = |mixed_f . C[:, k]|^2

    Args:
        iq_re/iq_im: ``[n]`` float32 (one code period).
        shift_matrix: ``[n, 1023]`` from :func:`code_shift_matrix`.
        bins: ``[n_dop]`` float32 (pad to a multiple of doppler_chunk).

    Returns ``[n_dop, 1023]`` float32 correlation map.
    """
    n = iq_re.shape[-1]
    n_dop = bins.shape[0]
    assert n_dop % doppler_chunk == 0
    t = jnp.arange(n, dtype=jnp.float32) / sampling_frequency

    def one_chunk(chunk_bins):
        phase = -2.0 * jnp.pi * (
            intermediate_frequency + chunk_bins[:, None]) * t[None]
        cos, sin = jnp.cos(phase), jnp.sin(phase)
        mre = iq_re[None] * cos - iq_im[None] * sin
        mim = iq_re[None] * sin + iq_im[None] * cos
        i_corr = jnp.dot(mre, shift_matrix,
                         preferred_element_type=jnp.float32,
                         precision=jax.lax.Precision.HIGHEST)
        q_corr = jnp.dot(mim, shift_matrix,
                         preferred_element_type=jnp.float32,
                         precision=jax.lax.Precision.HIGHEST)
        return i_corr**2 + q_corr**2

    chunks = bins.reshape(n_dop // doppler_chunk, doppler_chunk)
    maps = jax.lax.map(one_chunk, chunks)
    return maps.reshape(n_dop, GPS_L1CA_CODE_LENGTH_I)


def peak_metric_ss(corr_map: jax.Array):
    """Two-peak metric with a 3x3 exclusion box (reference
    ``TwoCorrelationPeakComparison_SS``, dsp/acquisition.py:159-193).

    Returns ((freq_idx, code_idx), metric).
    """
    corr_map = jnp.asarray(corr_map)
    n_dop, n_code = corr_map.shape
    flat = jnp.argmax(corr_map)
    fi, ci = flat // n_code, flat % n_code
    peak1 = corr_map[fi, ci]
    fgrid = jnp.arange(n_dop)[:, None]
    cgrid = jnp.arange(n_code)[None, :]
    excl = (jnp.abs(fgrid - fi) <= 1) & (jnp.abs(cgrid - ci) <= 1)
    peak2 = jnp.max(jnp.where(excl, -jnp.inf, corr_map))
    return (fi, ci), peak1 / peak2
