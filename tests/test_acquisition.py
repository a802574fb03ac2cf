"""PCPS acquisition tests on synthetic signals."""

import numpy as np
import pytest

from sydr_tpu.ops import acquisition
from sydr_tpu.signal.synthetic import IQGenerator

FS = 4e6  # smaller fs keeps CPU test runtime low
N = 4000  # samples per code at FS


def _acquire_single(prn, doppler, code_phase, cn0=None, noise=False, seed=1):
    gen = IQGenerator(FS, noise=noise, seed=seed)
    gen.add_satellite(
        prn, doppler_hz=doppler, code_phase_chips=code_phase, cn0_dbhz=cn0
    )
    iq = gen.generate_ms(50)[None, :]  # [1, 50ms]
    code_fft = acquisition.code_fft_conj(prn, FS)[None, :]
    bins = acquisition.doppler_bins(5000, 100)
    return acquisition.acquire(
        iq, code_fft, bins, sampling_frequency=FS, coherent=5, non_coherent=10
    )


def test_acquire_noiseless_doppler_and_code():
    true_doppler = 1500.0
    code_phase = 300.25
    dop, ci, metric, _ = _acquire_single(5, true_doppler, code_phase)
    assert abs(float(dop[0]) - true_doppler) <= 50.0  # within half a bin
    expected_ci = (N - code_phase * FS / 1.023e6) % N
    assert abs(float(ci[0]) - expected_ci) <= 2.0
    assert float(metric[0]) > 3.0


def test_acquire_negative_doppler():
    dop, ci, metric, _ = _acquire_single(17, -3200.0, 812.0)
    assert abs(float(dop[0]) + 3200.0) <= 50.0
    assert float(metric[0]) > 3.0


def test_acquire_with_noise():
    dop, ci, metric, _ = _acquire_single(9, 2100.0, 100.0, cn0=45.0, noise=True)
    assert abs(float(dop[0]) - 2100.0) <= 50.0
    assert float(metric[0]) > 1.5


def test_acquire_absent_satellite_low_metric():
    gen = IQGenerator(FS, noise=True, seed=3)
    gen.add_satellite(1, doppler_hz=500.0, code_phase_chips=0.0, cn0_dbhz=45.0)
    iq = gen.generate_ms(50)[None, :]
    # Search for a PRN that is not present.
    code_fft = acquisition.code_fft_conj(21, FS)[None, :]
    bins = acquisition.doppler_bins(5000, 100)
    _, _, metric, _ = acquisition.acquire(
        iq, code_fft, bins, sampling_frequency=FS
    )
    assert float(metric[0]) < 1.5


def test_acquire_batched_channels():
    gen = IQGenerator(FS, noise=True, seed=7)
    sats = [(2, 1000.0, 50.0), (3, -2500.0, 700.5), (4, 4200.0, 10.0)]
    for prn, dop, cp in sats:
        gen.add_satellite(prn, doppler_hz=dop, code_phase_chips=cp, cn0_dbhz=47.0)
    iq_once = gen.generate_ms(50)
    iq = np.stack([iq_once] * len(sats))
    code_ffts = np.stack(
        [acquisition.code_fft_conj(prn, FS) for prn, _, _ in sats]
    )
    bins = acquisition.doppler_bins(5000, 100)
    dop, ci, metric, corr = acquisition.acquire(
        iq, code_ffts, bins, sampling_frequency=FS
    )
    assert corr.shape == (3, len(bins), N)
    for k, (prn, true_dop, cp) in enumerate(sats):
        assert abs(float(dop[k]) - true_dop) <= 50.0, prn
        assert float(metric[k]) > 1.5


def test_doppler_bins_match_reference_grid():
    bins = acquisition.doppler_bins(5000, 100)
    assert len(bins) == 101
    assert bins[0] == -5000.0 and bins[-1] == 5000.0


def test_shift_theorem_path_matches_direct():
    """pcps_shift_map (one mix/DFT per phase) equals pcps_map per bin."""
    import jax.numpy as jnp

    from sydr_tpu.ops import acquisition as acq
    from sydr_tpu.ops import fft as mmfft

    fs = 2e6
    gen = IQGenerator(fs, noise=True, seed=11)
    gen.add_satellite(9, doppler_hz=-1250.0, code_phase_chips=500.0,
                      cn0_dbhz=45.0)
    iq = gen.generate_ms(50)
    iq_re = np.float32(iq.real)[None]
    iq_im = np.float32(iq.imag)[None]
    k = acq.split_reim(acq.code_fft_conj(9, fs))
    k_re, k_im = k[0][None], k[1][None]
    bins = acq.doppler_bins(5000, 250)
    n = k_re.shape[-1]
    plans = (mmfft.make_plan(n), mmfft.make_plan(n, inverse=True))

    sp = acq.shift_plan(bins, fs, n, mode="auto")
    assert sp is not None and len(sp[0]) == 4  # 250 Hz step vs 1 kHz bins

    pad = (-len(bins)) % 4
    bp = np.concatenate([bins, np.repeat(bins[-1:], pad)])
    direct = np.asarray(acq.pcps_map(
        jnp.asarray(iq_re), jnp.asarray(iq_im),
        jnp.asarray(k_re), jnp.asarray(k_im),
        jnp.asarray(bp), plans[0], plans[1],
        sampling_frequency=fs, coherent=5, non_coherent=10,
    ))[:, :len(bins)]
    shifted = np.asarray(acq.pcps_shift_map(
        jnp.asarray(iq_re), jnp.asarray(iq_im),
        jnp.asarray(k_re), jnp.asarray(k_im),
        plans[0], plans[1],
        sampling_frequency=fs, coherent=5, non_coherent=10,
        phases=sp[0], bin_shifts=sp[1],
    ))
    np.testing.assert_allclose(shifted, direct, rtol=1e-3, atol=1e-2)

    # Bin sets without phase reuse (step not dividing the bin spacing)
    # fall back to the direct path.
    assert acq.shift_plan(np.arange(-5000, 5001, 333.3), fs, n,
                          mode="auto") is None


def test_bf16_matmul_plans_find_same_peak():
    """bf16 DFT-matrix plans keep acquisition decisions.

    The bf16 rounding (~2^-9 relative per product, f32 accumulation) is far
    below the noise floor; the peak bin/code index must match the f32 path
    and the correlation map must agree to ~1%.
    """
    import jax.numpy as jnp

    gen = IQGenerator(FS, noise=True, seed=5)
    gen.add_satellite(7, doppler_hz=-2750.0, code_phase_chips=412.5,
                      cn0_dbhz=45.0)
    iq = gen.generate_ms(50)[None, :]
    code_fft = acquisition.code_fft_conj(7, FS)[None, :]
    bins = acquisition.doppler_bins(5000, 100)

    dop32, ci32, m32, map32 = acquisition.acquire(
        iq, code_fft, bins, sampling_frequency=FS)
    dop16, ci16, m16, map16 = acquisition.acquire(
        iq, code_fft, bins, sampling_frequency=FS,
        matmul_dtype=jnp.bfloat16)

    assert float(dop16[0]) == float(dop32[0])
    assert int(ci16[0]) == int(ci32[0])
    assert abs(float(m16[0]) - float(m32[0])) < 0.05 * float(m32[0])
    scale = float(np.max(np.asarray(map32)))
    np.testing.assert_allclose(
        np.asarray(map16) / scale, np.asarray(map32) / scale, atol=0.02)
