"""Sequence-parallel (time-sharded) block correlation vs single-device."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sydr_tpu.channels import batch_runtime as br
from sydr_tpu.channels.runtime import TrackingConfig
from sydr_tpu.channels.state import MODE_TRACKING, init_state
from sydr_tpu.parallel.timeshard import (
    make_sp_mesh,
    run_block_batched_timesharded,
)
from sydr_tpu.signal.synthetic import IQGenerator

FS = 4e6


def _setup(n_ch=2, block_ms=20):
    prns = [5, 12][:n_ch]
    dops = [1200.0, -2600.0][:n_ch]
    gen = IQGenerator(FS, noise=True, seed=7)
    for prn, dop in zip(prns, dops):
        gen.add_satellite(prn, doppler_hz=dop, code_phase_chips=77.0,
                          cn0_dbhz=48.0)
    cfg = TrackingConfig(sampling_frequency=FS, block_ms=block_ms, tail_ms=4,
                         window_size=4224, runtime="batch")
    iq = gen.generate_ms(4 + block_ms)
    wre = jnp.asarray(np.float32(iq.real))
    wim = jnp.asarray(np.float32(iq.imag))
    state = init_state(n_ch)
    state = dataclasses.replace(
        state,
        mode=jnp.full((n_ch,), MODE_TRACKING, jnp.int32),
        carrier_freq=jnp.asarray(np.float32(dops)),
        rem_code=jnp.asarray(np.float32([0.05, 0.6][:n_ch])),
        rem_carrier=jnp.asarray(np.float32([0.4, 2.2][:n_ch])),
        unread=jnp.asarray(np.int32([5000, 6500][:n_ch])),
    )
    bits3x = jnp.asarray(br.tiled_code_bits(prns))
    return cfg, bits3x, state, wre, wim


def test_timesharded_matches_single_device():
    assert len(jax.devices()) >= 8
    mesh = make_sp_mesh(8)
    cfg, bits3x, state, wre, wim = _setup()

    st_ref, out_ref = br.run_block_batched(cfg, bits3x, state, wre, wim)
    st_sp, out_sp = run_block_batched_timesharded(
        cfg, mesh, bits3x, state, wre, wim)

    for key in ("i_prompt", "q_prompt", "i_early", "i_late"):
        np.testing.assert_allclose(
            np.asarray(out_sp[key]), np.asarray(out_ref[key]),
            rtol=1e-3, atol=1.0,
        ), key
    np.testing.assert_allclose(
        np.asarray(st_sp.carrier_freq), np.asarray(st_ref.carrier_freq),
        atol=0.05)
    np.testing.assert_array_equal(np.asarray(st_sp.unread),
                                  np.asarray(st_ref.unread))


def test_timeshard_requires_divisible_ms():
    mesh = make_sp_mesh(8)
    cfg, bits3x, state, wre, wim = _setup(block_ms=21)  # 25 ms !% 8
    with pytest.raises(AssertionError):
        run_block_batched_timesharded(cfg, mesh, bits3x, state, wre, wim)
