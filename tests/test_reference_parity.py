"""Side-by-side parity against the reference implementation.

Runs the reference's OWN numpy DSP (``/root/reference/sydr``: PCPS
acquisition, and the Borre channel's per-ms EPL/DLL/PLL update sequence of
``channel_l1ca_borre.py:333-433``) and sydr_tpu on the SAME synthetic
samples from the SAME handoff state, then compares:

  * acquisition: detected Doppler (same bin) and code index (+-2 samples);
  * tracking: per-ms E/P/L correlators bit-for-bit-close over the early
    deterministic window, and converged carrier/code trajectories;
  * the reference's measured CPU rate (its vectorised ``EPL``) — the
    honest ``vs_baseline`` denominator.

Skipped when ``/root/reference`` is unavailable (the repo stays
standalone).
"""

import os
import sys
import time

import numpy as np
import pytest

REF = "/root/reference"
pytestmark = pytest.mark.skipif(
    not os.path.isdir(os.path.join(REF, "sydr")),
    reason="reference checkout not available")
if os.path.isdir(os.path.join(REF, "sydr")) and REF not in sys.path:
    sys.path.insert(0, REF)

FS = 4e6
DOP = 1300.0
CODE_PHASE = 234.5
CHIP_RATE = 1.023e6
SPACINGS = (-0.5, 0.0, 0.5)


def _signal(n_ms, seed=3):
    from sydr_tpu.signal.synthetic import IQGenerator

    bits = np.random.default_rng(1).integers(0, 2, n_ms // 20 + 2)
    gen = IQGenerator(FS, noise=True, seed=seed)
    gen.add_satellite(7, doppler_hz=DOP, code_phase_chips=CODE_PHASE,
                      cn0_dbhz=48.0, nav_bits=bits)
    iq = gen.generate_ms(n_ms)
    return np.asarray(iq, dtype=np.complex128)


def test_acquisition_parity():
    from sydr.dsp.acquisition import PCPS, TwoCorrelationPeakComparison
    from sydr.signal.gnsssignal import GenerateGPSGoldCode, UpsampleCode

    from sydr_tpu.ops import acquisition as acq

    coher, noncoh = 5, 10
    iq = _signal(coher * noncoh)

    # --- reference (channel_l1ca_borre.py:280-305) -------------------------
    code = GenerateGPSGoldCode(7)
    up = UpsampleCode(code, FS)
    code_fft = np.conj(np.fft.fft(up))
    spc = round(FS * 1023 / CHIP_RATE)
    spchip = round(FS / CHIP_RATE)
    cmap = PCPS(rfData=iq, interFrequency=0.0, samplingFrequency=FS,
                codeFFT=code_fft, dopplerRange=5000, dopplerStep=100,
                samplesPerCode=spc, coherentIntegration=coher,
                nonCoherentIntegration=noncoh)
    (fi, ci), peak_ratio = TwoCorrelationPeakComparison(
        correlationMap=cmap, samplesPerCode=spc, samplesPerCodeChip=spchip)
    ref_dop = -(-5000 + 100 * fi)
    ref_code_idx = int(np.round(ci))

    # --- sydr_tpu ----------------------------------------------------------
    bins = acq.doppler_bins(5000, 100)
    k_re, k_im = acq.split_reim(acq.code_fft_conj(7, FS))
    dop, code_idx, metric, _ = acq.acquire(
        (np.float32(iq.real)[None], np.float32(iq.imag)[None]),
        (k_re[None], k_im[None]), bins,
        sampling_frequency=FS, coherent=coher, non_coherent=noncoh)

    assert float(dop[0]) == pytest.approx(ref_dop, abs=1e-6)
    assert abs(int(code_idx[0]) - ref_code_idx) <= 2
    assert peak_ratio > 1.5 and float(metric[0]) > 1.5


def _ref_track(iq, code1025, n_ms, s0):
    """The reference per-ms loop, exactly channel_l1ca_borre.py:333-433."""
    from sydr.dsp.tracking import (
        DLL_NNEML, EPL, PLL_costa, BorreLoopFilter, LoopFiltersCoefficients)

    d_t1, d_t2 = LoopFiltersCoefficients(1.0, 0.7, 1.0)
    p_t1, p_t2 = LoopFiltersCoefficients(8.0, 0.7, 0.25)
    carrier, rem_c, rem_code = DOP, 0.0, 0.0
    code_freq = CHIP_RATE
    code_step = code_freq / FS
    nco_code_err = nco_carr_err = 0.0
    cur = s0
    req = int(np.ceil((1023 - rem_code) / code_step))
    out = []
    for _ in range(n_ms):
        corr = EPL(rfData=iq[cur:cur + req], code=code1025,
                   samplingFrequency=FS, carrierFrequency=carrier,
                   remainingCarrier=rem_c, remainingCode=rem_code,
                   codeStep=code_step, correlatorsSpacing=SPACINGS)
        rem_c = (rem_c - carrier * 2.0 * np.pi * req / FS) % (2 * np.pi)
        code_err = DLL_NNEML(iEarly=corr[0], qEarly=corr[1],
                             iLate=corr[4], qLate=corr[5])
        nco_code = BorreLoopFilter(code_err, nco_code_err, d_t1, d_t2, 1e-3)
        nco_code_err = code_err
        phase_err = PLL_costa(iPrompt=corr[2], qPrompt=corr[3])
        nco_carr = BorreLoopFilter(phase_err, nco_carr_err, p_t1, p_t2, 1e-3)
        nco_carr_err = phase_err
        code_freq -= nco_code
        carrier += nco_carr
        rem_code += req * code_step - 1023
        code_step = code_freq / FS
        cur += req
        req = int(np.ceil((1023 - rem_code) / code_step))
        out.append((list(corr), carrier, rem_code))
    return out


def _sydr_track(iq, n_ms, s0):
    """The same loop through sydr_tpu's ops (scan-runtime DSP layer)."""
    import jax.numpy as jnp

    from sydr_tpu.channels.state import code_table
    from sydr_tpu.ops import tracking as trk

    code1025 = jnp.asarray(code_table([7])[0])
    d_t1, d_t2 = trk.loop_filter_taus(1.0, 0.7, 1.0)
    p_t1, p_t2 = trk.loop_filter_taus(8.0, 0.7, 0.25)
    carrier, rem_c, rem_code = DOP, 0.0, 0.0
    code_freq = CHIP_RATE
    code_step = code_freq / FS
    nco_code_err = nco_carr_err = 0.0
    cur = s0
    spms = int(round(FS * 1e-3))
    win = spms + 64
    req = int(np.ceil((1023 - rem_code) / code_step))
    out = []
    re = np.float32(iq.real)
    im = np.float32(iq.imag)
    for _ in range(n_ms):
        corr = np.asarray(trk.epl_correlate(
            jnp.asarray(re[cur:cur + win]), jnp.asarray(im[cur:cur + win]),
            code1025, req, carrier, rem_c, rem_code, code_step,
            spacings=SPACINGS, sampling_frequency=FS))
        rem_c = (rem_c - carrier * 2.0 * np.pi * req / FS) % (2 * np.pi)
        code_err = float(trk.dll_nneml(corr[0], corr[1], corr[4], corr[5]))
        nco_code = float(trk.borre_loop_filter(
            code_err, nco_code_err, d_t1, d_t2, 1e-3))
        nco_code_err = code_err
        phase_err = float(trk.pll_costas(corr[2], corr[3]))
        nco_carr = float(trk.borre_loop_filter(
            phase_err, nco_carr_err, p_t1, p_t2, 1e-3))
        nco_carr_err = phase_err
        code_freq -= nco_code
        carrier += nco_carr
        rem_code += req * code_step - 1023
        code_step = code_freq / FS
        cur += req
        req = int(np.ceil((1023 - rem_code) / code_step))
        out.append((corr, carrier, rem_code))
    return out


def test_tracking_dsp_parity():
    from sydr.signal.gnsssignal import GenerateGPSGoldCode

    n_ms = 400
    iq = _signal(n_ms + 40)
    # Handoff: the first code-period boundary after signal start, true
    # Doppler as the acquisition estimate, zero phase remainders — the
    # identical state both loops start from.
    s0 = int(round((1023 - CODE_PHASE) * FS / CHIP_RATE))
    code = GenerateGPSGoldCode(7)
    code1025 = np.r_[code[-1], code, code[0]].astype(np.float64)

    ref = _ref_track(iq, code1025, n_ms, s0)
    ours = _sydr_track(iq, n_ms, s0)

    # Early window: float32 vs float64 round-off has not yet fed back
    # through the loops, so the correlators must agree tightly.
    for e in range(40):
        rc = np.asarray(ref[e][0], dtype=np.float64)
        tc = np.asarray(ours[e][0], dtype=np.float64)
        np.testing.assert_allclose(tc, rc, rtol=5e-3, atol=2.0,
                                   err_msg=f"epoch {e}")

    # After convergence both loops track the same truth: trajectories agree.
    ref_cf = np.array([r[1] for r in ref])
    our_cf = np.array([r[1] for r in ours])
    assert abs(ref_cf[-100:].mean() - DOP) < 2.0
    assert abs(our_cf[-100:].mean() - DOP) < 2.0
    assert abs(ref_cf[-100:].mean() - our_cf[-100:].mean()) < 1.0
    # Code phase trajectories stay sample-aligned.
    ref_rc = np.array([r[2] for r in ref])
    our_rc = np.array([r[2] for r in ours])
    assert np.abs(ref_rc[-100:] - our_rc[-100:]).mean() < 0.05


def test_reference_cpu_rate_measured():
    """Record the reference's measured per-channel-ms EPL rate (the
    ``vs_baseline`` denominator is this, not an asserted constant)."""
    from sydr.dsp.tracking import EPL
    from sydr.signal.gnsssignal import GenerateGPSGoldCode

    iq = _signal(20)
    code = GenerateGPSGoldCode(7)
    code1025 = np.r_[code[-1], code, code[0]].astype(np.float64)
    spms = int(round(FS * 1e-3))

    def one_ms():
        return EPL(rfData=iq[:spms], code=code1025, samplingFrequency=FS,
                   carrierFrequency=DOP, remainingCarrier=0.1,
                   remainingCode=0.2, codeStep=CHIP_RATE / FS,
                   correlatorsSpacing=SPACINGS)

    one_ms()
    t0 = time.time()
    reps = 100
    for _ in range(reps):
        one_ms()
    per_ms = (time.time() - t0) / reps
    rtf = 1e-3 / per_ms
    print(f"\nreference EPL: {per_ms*1e3:.3f} ms per channel-ms "
          f"(RTF {rtf:.2f} per channel at {FS/1e6:.0f} Msps)")
    assert per_ms > 0
