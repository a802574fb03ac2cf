"""Superblock device loop equals sequential block processing."""

import numpy as np

from sydr_tpu.channels.runtime import TrackingConfig
from sydr_tpu.receiver.session import TrackingSession
from sydr_tpu.signal.synthetic import IQGenerator

FS = 4e6


def _run(superblock, n_ms=1440, seed=13):
    gen = IQGenerator(FS, noise=True, seed=seed)
    gen.add_satellite(5, doppler_hz=1200.0, code_phase_chips=10.0,
                      cn0_dbhz=47.0)
    cfg = TrackingConfig(sampling_frequency=FS, block_ms=20, tail_ms=4,
                         window_size=4224, runtime="batch",
                         superblock=superblock)
    session = TrackingSession(cfg, [5])
    outs = []
    chunk = superblock * 20
    for _ in range(n_ms // chunk):
        iq = gen.generate_ms(chunk)
        outs.append(session.process_block(np.float32(iq.real),
                                          np.float32(iq.imag)))
    return session, {
        k: np.concatenate([o[k] for o in outs], 0) for k in outs[0]
    }


def test_superblock_matches_sequential():
    s1, out1 = _run(1)
    s4, out4 = _run(4)
    # Acquisition happens at slightly different times (history fills at
    # superblock granularity); compare steady-state tracking.
    # Acquisition triggers at superblock granularity (20 ms later here), so
    # transients differ; both must converge to the same steady state.
    assert s1.acq_results[0]["code_index"] == s4.acq_results[0]["code_index"]
    cf1 = out1["carrier_freq"][-200:, 0].mean()
    cf4 = out4["carrier_freq"][-200:, 0].mean()
    assert abs(cf1 - 1200.0) < 2 and abs(cf4 - 1200.0) < 2
    ip1 = np.abs(out1["i_prompt"][-200:, 0]).mean()
    ip4 = np.abs(out4["i_prompt"][-200:, 0]).mean()
    assert abs(ip1 - ip4) < 0.05 * ip1


import pytest


@pytest.mark.slow
@pytest.mark.parametrize("pallas", [False, True])
def test_superblock_exact_same_signal_alignment(pallas):
    """With acquisition forced at the same sample, outputs are identical.

    The superblock path hoists the dense pass's packed-word tables out of
    the block scan (``make_wordpack``'s drift-extended row axis); this
    asserts it stays consistent with the per-block roll of standalone
    ``run_block_batched`` — for the XLA dense pass and for the fused
    correlator (interpret mode, quantised taps), which reads chips from
    the code table directly."""
    import dataclasses

    import jax.numpy as jnp

    from sydr_tpu.channels import batch_runtime as br
    from sydr_tpu.channels.state import MODE_TRACKING, init_state

    gen = IQGenerator(FS, noise=True, seed=3)
    gen.add_satellite(7, doppler_hz=-900.0, code_phase_chips=0.0,
                      cn0_dbhz=47.0)
    iq = gen.generate_ms(4 + 80)  # tail + 4 blocks of 20
    re, im = np.float32(iq.real), np.float32(iq.imag)

    cfg = TrackingConfig(sampling_frequency=FS, block_ms=20, tail_ms=4,
                         window_size=4224, runtime="batch",
                         use_pallas=pallas, pallas_interpret=pallas,
                         quantize_spacing=pallas)
    state = init_state(1)
    state = dataclasses.replace(
        state,
        mode=jnp.full((1,), MODE_TRACKING, jnp.int32),
        carrier_freq=jnp.asarray([-900.0], jnp.float32),
        unread=jnp.asarray([4000], jnp.int32),
    )
    bits3x = jnp.asarray(br.tiled_code_bits([7]))

    # Sequential: 4 windows.
    st = state
    seq = []
    spms, sb, tail = 4000, 80000, 16000
    for k in range(4):
        wre = jnp.asarray(re[k * sb:k * sb + tail + sb])
        wim = jnp.asarray(im[k * sb:k * sb + tail + sb])
        st, out = br.run_block_batched(cfg, bits3x, st, wre, wim)
        seq.append(out)
    st_sb, out_sb = br.run_superblock(
        cfg, 4, bits3x, state, jnp.asarray(re), jnp.asarray(im))

    ip_seq = np.concatenate([np.asarray(o["i_prompt"]) for o in seq], 0)
    # The hoisted-wordpack GEOMETRY (drift d, picked words, read base) is
    # bit-identical inside the scan — verified by the wordpack identity
    # test in test_batch_runtime.py. The correlator VALUES may differ at
    # f32-rounding level: the scan-body compile and the standalone compile
    # round the f32 phase-anchor tables (phic_q) differently (FMA
    # reassociation, ~1e-6 rad).
    tol = dict(rtol=1e-5, atol=1e-2)
    np.testing.assert_allclose(np.asarray(out_sb["i_prompt"]), ip_seq,
                               **tol)
    np.testing.assert_allclose(np.asarray(st_sb.carrier_freq),
                               np.asarray(st.carrier_freq), atol=1e-4)
    np.testing.assert_array_equal(np.asarray(st_sb.unread),
                                  np.asarray(st.unread))
