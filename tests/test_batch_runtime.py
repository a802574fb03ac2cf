"""Batched (two-pass) runtime vs scanned runtime equivalence tests."""

import dataclasses

import numpy as np
import pytest

from sydr_tpu.channels.runtime import TrackingConfig
from sydr_tpu.channels.state import FLAG_BIT_SYNC
from sydr_tpu.receiver.session import TrackingSession
from sydr_tpu.signal.synthetic import IQGenerator

FS = 4e6


def _run(runtime, n_ms=2400, seed=11):
    rng = np.random.default_rng(seed)
    sats = [
        dict(prn=5, doppler=1200.0, code_phase=321.4),
        dict(prn=12, doppler=-2600.0, code_phase=811.9),
    ]
    bits = rng.integers(0, 2, 200)
    gen = IQGenerator(FS, noise=True, seed=seed)
    for s in sats:
        gen.add_satellite(s["prn"], doppler_hz=s["doppler"],
                          code_phase_chips=s["code_phase"], cn0_dbhz=46.0,
                          nav_bits=bits)
    cfg = TrackingConfig(sampling_frequency=FS, block_ms=20, tail_ms=4,
                         window_size=4224, runtime=runtime)
    session = TrackingSession(cfg, [s["prn"] for s in sats])
    outs = []
    for _ in range(n_ms // cfg.block_ms):
        iq = gen.generate_ms(cfg.block_ms)
        outs.append(session.process_block(np.float32(iq.real),
                                          np.float32(iq.imag)))
    merged = {k: np.concatenate([o[k] for o in outs], 0) for k in outs[0]}
    return session, merged, sats, bits


@pytest.fixture(scope="module")
def both_runs():
    return {rt: _run(rt) for rt in ("scan", "batch")}


def test_batch_tracks_and_locks(both_runs):
    _, out, sats, _ = both_runs["batch"]
    for i, s in enumerate(sats):
        cf = out["carrier_freq"][-200:, i]
        assert abs(cf.mean() - s["doppler"]) < 5.0, (i, cf.mean())
        assert abs(out["pll_error"][-300:, i].mean()) < 5e-3
        assert abs(out["dll_error"][-400:, i].mean()) < 0.03
        assert out["flags"][-1, i] & FLAG_BIT_SYNC


def test_batch_matches_scan_steady_state(both_runs):
    _, scan_out, sats, _ = both_runs["scan"]
    _, batch_out, _, _ = both_runs["batch"]
    for i in range(len(sats)):
        cf_s = scan_out["carrier_freq"][-200:, i].mean()
        cf_b = batch_out["carrier_freq"][-200:, i].mean()
        assert abs(cf_s - cf_b) < 2.0, (i, cf_s, cf_b)
        cn0_s = scan_out["cn0"][-100:, i].mean()
        cn0_b = batch_out["cn0"][-100:, i].mean()
        assert abs(cn0_s - cn0_b) < 2.5, (i, cn0_s, cn0_b)
        # Prompt amplitude (signal power recovered) must agree within a few %.
        ip_s = np.abs(scan_out["i_prompt"][-300:, i]).mean()
        ip_b = np.abs(batch_out["i_prompt"][-300:, i]).mean()
        assert abs(ip_s - ip_b) < 0.05 * ip_s, (ip_s, ip_b)


def test_batch_decodes_same_bits(both_runs):
    _, scan_out, sats, bits = both_runs["scan"]
    _, batch_out, _, _ = both_runs["batch"]
    tiled = np.tile(bits * 2 - 1, 20)
    ref = "".join("1" if b > 0 else "0" for b in tiled)
    ref_inv = "".join("0" if b > 0 else "1" for b in tiled)
    for out in (scan_out, batch_out):
        for i in range(len(sats)):
            ready = out["bit_ready"][:, i]
            sums = out["bit_ip_sum"][ready, i]
            assert len(sums) > 20
            s = "".join("1" if b > 0 else "0" for b in np.sign(sums[5:]))
            assert s in ref or s in ref_inv


def test_batch_bit_cadence(both_runs):
    _, out, sats, _ = both_runs["batch"]
    for i in range(len(sats)):
        idx = np.flatnonzero(out["bit_ready"][:, i])
        gaps = np.diff(idx)
        assert (np.abs(gaps - 20) <= 1).all()


def test_scan_last_epoch_not_clamped():
    """Regression: read_ptr clamping corrupted the last epoch of a block.

    With leftover unread below window_size - samples_per_ms, the old
    ``clip(avail - unread, 0, window_samples - window_size)`` shifted the
    window slice back by up to 240 samples on the final epoch while
    rem_code still described the true read position — decorrelating that
    epoch's correlators. The window is now padded instead.
    """
    import jax.numpy as jnp

    from sydr_tpu.channels import runtime as rt
    from sydr_tpu.channels.state import MODE_TRACKING, code_table, init_state

    fs = 10e6
    cfg = TrackingConfig(sampling_frequency=fs, block_ms=20, tail_ms=4,
                         window_size=10240, runtime="scan")
    spms = cfg.samples_per_ms
    step = 1023.0 / spms
    rem_code = 0.5
    unread0 = 100                      # leftover < window_size - spms = 240

    # First consumed sample (epoch 0) sits at avail0 - (unread0 + spms).
    a0 = (cfg.tail_ms + 1) * spms - (unread0 + spms)
    code_phase = (rem_code - a0 * step) % 1023.0

    gen = IQGenerator(fs, noise=False)
    gen.add_satellite(1, doppler_hz=0.0, code_phase_chips=code_phase,
                      cn0_dbhz=None, code_doppler=False)
    iq = gen.generate_ms(cfg.tail_ms + cfg.block_ms)

    st = init_state(1)
    st.mode = jnp.full((1,), MODE_TRACKING, jnp.int32)
    st.rem_code = jnp.full((1,), rem_code, jnp.float32)
    st.unread = jnp.full((1,), unread0, jnp.int32)
    codes = code_table([1])

    _, out = rt.run_block(cfg, codes, st,
                          np.float32(iq.real), np.float32(iq.imag))
    ip = np.asarray(out["i_prompt"])[:, 0]
    assert np.asarray(out["active"]).all()
    # Every epoch, including the last, must be fully correlated.
    assert ip.min() > 0.9 * ip.max(), ip
    assert ip[-1] > 0.9 * spms


def test_wordpack_identity_across_drift_range():
    """Hoisted word table rows equal fresh per-offset builds, all drifts.

    The superblock optimisation relies on: the packed word for (integer
    chip drift ``d``, C0I row ``v``) depends only on ``d + v``, so rows
    ``[d, d + C0I_ROWS)`` of the drift-extended table built at the roll
    origin must be bit-identical to a fresh :func:`_build_words` at
    ``c_roll + d`` — for EVERY drift the superblock can encounter.
    """
    import jax.numpy as jnp

    from sydr_tpu.channels import batch_runtime as br

    cfg = TrackingConfig(sampling_frequency=FS, block_ms=20, tail_ms=4,
                         window_size=4224, runtime="batch")
    bits3x = jnp.asarray(br.tiled_code_bits([7, 23]))
    dc_n, lead = br._wordpack_geometry(4 * cfg.block_ms * 1e-3)
    L = 1023
    for c_int0 in (0, 511, 1013, 1022):   # include wrap-around origins
        c_roll = np.mod(np.int32(c_int0) - lead, L)
        wtab = np.asarray(br._build_words(
            cfg, bits3x, jnp.full((2,), c_roll, jnp.int32),
            n_rows=dc_n + br.C0I_ROWS - 1))
        for d in range(dc_n):
            fresh = np.asarray(br._build_words(
                cfg, bits3x,
                jnp.full((2,), (c_roll + d) % L, jnp.int32)))
            np.testing.assert_array_equal(wtab[:, d:d + br.C0I_ROWS], fresh)
