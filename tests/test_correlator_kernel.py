"""Fused per-epoch correlator (ops/correlator_gpu.py) in interpret mode.

The kernel is compared with the XLA dense pass it replaces, over every tap
shape and every sampling rate the dense pass takes, and with a numpy
evaluation of its definition on epochs of odd lengths. On the card it runs
compiled in ``chip_smoke.py`` (and the ``gpu``-marked test below).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sydr_tpu.channels import batch_runtime
from sydr_tpu.channels.runtime import TrackingConfig
from sydr_tpu.channels.state import MODE_TRACKING, init_state
from sydr_tpu.ops import correlator_gpu
from sydr_tpu.signal.synthetic import IQGenerator

KEYS = ("i_early", "q_early", "i_prompt", "q_prompt", "i_late", "q_late")
SHAPES = {
    "borre": dict(profile="borre"),
    "kaplan": dict(profile="kaplan"),
    "kaplan_narrow": dict(profile="kaplan", kaplan_narrow_only=True),
}


def _setup(n_ch=3, block_ms=4, fs=10e6):
    prns = [5, 12, 21][:n_ch]
    dops = [1200.0, -2600.0, 3900.0][:n_ch]
    gen = IQGenerator(fs, noise=True, seed=4)
    for prn, dop in zip(prns, dops):
        gen.add_satellite(prn, doppler_hz=dop, code_phase_chips=100.0,
                          cn0_dbhz=48.0)
    cfg = dict(sampling_frequency=fs, block_ms=block_ms, tail_ms=4,
               window_size=round(fs * 1e-3) + 240, runtime="batch")
    iq = gen.generate_ms(4 + block_ms)
    wre = jnp.asarray(np.float32(iq.real))
    wim = jnp.asarray(np.float32(iq.imag))

    spms = round(fs * 1e-3)
    state = init_state(n_ch)
    state = dataclasses.replace(
        state,
        mode=jnp.full((n_ch,), MODE_TRACKING, jnp.int32),
        carrier_freq=jnp.asarray(np.float32(dops)),
        rem_code=jnp.asarray(np.float32([0.02, 0.7, 0.4][:n_ch])),
        rem_carrier=jnp.asarray(np.float32([0.3, 2.1, 5.0][:n_ch])),
        code_freq_offset=jnp.asarray(np.float32([0.5, -1.2, 2.0][:n_ch])),
        unread=jnp.asarray(np.int32(
            [int(1.1 * spms), int(1.4 * spms), int(1.2345 * spms)][:n_ch])),
    )
    bits3x = jnp.asarray(batch_runtime.tiled_code_bits(prns))
    return cfg, bits3x, state, wre, wim


@jax.jit(static_argnums=0)
def _geometry(cfg, state):
    geo = batch_runtime._pass_a(cfg, state)
    return geo, batch_runtime.block_geometry(cfg, state, geo)


@jax.jit(static_argnums=0)
def _correlate(cfg, bits3x, state, geo, bg, wre, wim):
    return batch_runtime.correlate(cfg, bits3x, state, geo, bg, wre, wim)


@pytest.mark.parametrize("fs", [10e6, 5e6, 2.5e6, 1.25e6])
@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_fused_correlator_matches_dense_pass(shape, quantize, fs):
    """Same correlators as the dense pass, to f32 summation order.

    Both are fed one block geometry: computed inside two programs, its f32
    values can differ in the last bit (fusion-dependent multiply-add
    contraction), which moves a ceil() tie — one sample's chip — now and
    then."""
    cfg_args, bits3x, state, wre, wim = _setup(fs=fs)
    cfg_args.update(SHAPES[shape], quantize_spacing=quantize)
    dense = TrackingConfig(**cfg_args)
    geo, bg = _geometry(dense, state)

    ref = np.asarray(_correlate(dense, bits3x, state, geo, bg, wre, wim))
    got = np.asarray(_correlate(
        TrackingConfig(**cfg_args, use_pallas=True, pallas_interpret=True),
        bits3x, state, geo, bg, wre, wim))

    n_taps = len(batch_runtime.correlator_taps(dense))
    assert got.shape == ref.shape == (dense.block_ms, 3, 2 * n_taps)
    rms = np.sqrt(np.mean(ref ** 2))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4 * rms)


def test_fused_correlator_needs_gpu_or_interpret():
    """Off a GPU the kernel raises instead of switching path."""
    cfg_args, bits3x, state, wre, wim = _setup(n_ch=1, block_ms=2, fs=2e6)
    assert jax.default_backend() != "gpu"
    with pytest.raises(ValueError, match="pallas_interpret"):
        batch_runtime.run_block_batched(
            TrackingConfig(**cfg_args, use_pallas=True), bits3x, state,
            wre, wim)


def _numpy_epochs(wre, wim, bits, c_int, omega, cstep, fb_q, ph_q, bounds,
                  spms, taps):
    """The kernel's definition, evaluated sample by sample in numpy."""
    n_q = fb_q.shape[1]
    block_ms, n_ch = bounds[0].shape
    parts = [np.asarray(p) for p in
             correlator_gpu.code_step_parts(jnp.asarray(cstep), spms)]
    out = np.zeros((block_ms, n_ch, 2 * len(taps)), np.float64)
    for c in range(n_ch):
        for e in range(block_ms):
            m = np.arange(bounds[0][e, c], bounds[1][e, c])
            q = np.minimum(m // spms, n_q - 1)
            lm = (m - q * spms).astype(np.float32)
            phase = ph_q[c, q] - omega[c] * lm
            x = (wre[m] + 1j * wim[m]) * np.exp(1j * phase.astype(np.float64))
            for t, (sp, k) in enumerate(taps):
                n = m + k
                qk = np.minimum(n // spms, n_q - 1)
                lk = (n - qk * spms).astype(np.float32)
                r = (fb_q[c, qk] + np.float32(sp)).astype(np.float32)
                hi, mid, lo = (p[c] for p in parts)
                idx = np.ceil(((r + lk * hi) + lk * mid)
                              + lk * lo).astype(np.int64)
                chip = 2.0 * bits[c, correlator_gpu.CODE_ORIGIN
                                  + c_int[c] + idx] - 1.0
                out[e, c, 2 * t] = np.sum(chip * x.real)
                out[e, c, 2 * t + 1] = np.sum(chip * x.imag)
    return out


def test_code_step_split_is_exact():
    """The three-term split sums back to code_step, and each term times
    any sample index of a millisecond (+ lookahead) is exact in float32."""
    rng = np.random.default_rng(0)
    for spms in (1250, 2500, 5000, 10000):
        cstep = np.float32(1.023e6 / (spms * 1e3)
                           * (1 + rng.uniform(-1e-5, 1e-5, 64)))
        parts = [np.asarray(p) for p in
                 correlator_gpu.code_step_parts(jnp.asarray(cstep), spms)]
        np.testing.assert_array_equal(
            (parts[0] + parts[1]) + parts[2], cstep)
        lm = np.arange(spms + 256, dtype=np.float64)
        for p in parts:
            prod = lm[:, None] * p.astype(np.float64)[None, :]
            np.testing.assert_array_equal(prod.astype(np.float32), prod)


@pytest.mark.parametrize("spms,bounds", [
    # odd lengths, none a multiple of the tile
    (2500, [(0, 2501), (2501, 4999), (4999, 7503)]),
    # empty epochs and one crossing two millisecond boundaries
    (1250, [(100, 100), (100, 2901), (2901, 2901)]),
    # the last epoch ends at the window end: taps read past it
    (5000, [(9000, 14001), (14001, 19997), (19997, 20000)]),
])
def test_fused_correlator_odd_epoch_lengths(spms, bounds):
    """Masked tails and lookahead: any epoch bounds, numpy reference."""
    rng = np.random.default_rng(3)
    n_q, n_ch = 4, 2
    n_win = n_q * spms
    wre = np.float32(rng.standard_normal(n_win))
    wim = np.float32(rng.standard_normal(n_win))
    bits = batch_runtime.tiled_code_bits([3, 30])
    c_int = np.int32([17, 1010])
    cstep = np.float32(1.023e6 / (spms * 1e3) * np.array([1.0, 1.000001]))
    omega = np.float32([0.011, -0.004])
    fb_q = np.float32(rng.uniform(0, 1, (n_ch, n_q)))
    ph_q = np.float32(rng.uniform(0, 6.28, (n_ch, n_q)))
    b = np.asarray(bounds, np.int32)
    b_start = np.stack([b[:, 0], np.minimum(b[:, 0] + 7, b[:, 1])], axis=1)
    b_end = np.stack([b[:, 1], b[:, 1]], axis=1)
    step0 = cstep[0]
    taps = ((-2 * step0, 0), (-2 * step0, 2), (-2 * step0, 4))

    got = np.asarray(correlator_gpu.correlate_epochs(
        jnp.asarray(wre), jnp.asarray(wim), jnp.asarray(bits),
        jnp.asarray(c_int), jnp.asarray(omega), jnp.asarray(cstep),
        jnp.asarray(fb_q), jnp.asarray(ph_q), jnp.asarray(b_start),
        jnp.asarray(b_end), spms=spms, taps=taps, interpret=True))
    ref = _numpy_epochs(wre, wim, bits, c_int, omega, cstep, fb_q, ph_q,
                        (b_start, b_end), spms, taps)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-3)


@pytest.mark.gpu
def test_fused_correlator_compiled_on_gpu():
    """The compiled kernel against the dense pass on the same card."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a CUDA GPU: on the card run "
                    "JAX_PLATFORMS=cuda pytest -m gpu -n 0")
    cfg_args, bits3x, state, wre, wim = _setup()
    cfg_args.update(SHAPES["kaplan_narrow"], quantize_spacing=True)
    dense = TrackingConfig(**cfg_args)
    geo, bg = _geometry(dense, state)
    ref = np.asarray(_correlate(dense, bits3x, state, geo, bg, wre, wim))
    got = np.asarray(_correlate(TrackingConfig(**cfg_args, use_pallas=True),
                                bits3x, state, geo, bg, wre, wim))
    rms = np.sqrt(np.mean(ref ** 2))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4 * rms)
