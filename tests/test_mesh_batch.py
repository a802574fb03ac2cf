"""Channel-sharded batched (production) runtime vs single-device.

The batch runtime is elementwise over the channel axis, so sharding it over
the ``ch`` mesh axis (``parallel.mesh.make_sharded_batch_step``) must be
bit-identical to the single-device run — the multi-chip story of the *fast*
path (the reference's analog is one OS process per channel,
``/root/reference/sydr/channel/channelManager.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sydr_tpu.channels import batch_runtime as br
from sydr_tpu.channels.runtime import TrackingConfig
from sydr_tpu.parallel import mesh as pmesh

FS = 1.023e6  # 1023 samples per code period: tiny, structurally identical


def _cfg(**kw):
    base = dict(sampling_frequency=FS, block_ms=4, tail_ms=2,
                window_size=1152, runtime="batch")
    base.update(kw)
    return TrackingConfig(**base)


def _inputs(cfg, n_channels, n_ms=None, seed=0):
    import __graft_entry__ as g

    _, state, _, _ = g._tracking_inputs(cfg, n_channels, seed=seed)
    prns = [(k % 32) + 1 for k in range(n_channels)]
    bits3x = jnp.asarray(br.tiled_code_bits(prns))
    rng = np.random.default_rng(seed + 1)
    n = (n_ms or (cfg.tail_ms + cfg.block_ms)) * cfg.samples_per_ms
    wre = jnp.asarray(rng.standard_normal(n).astype(np.float32))
    wim = jnp.asarray(rng.standard_normal(n).astype(np.float32))
    return bits3x, state, wre, wim


def test_sharded_batch_step_matches_single_device():
    cfg = _cfg()
    n_ch = 8
    bits3x, state, wre, wim = _inputs(cfg, n_ch)

    st_ref, out_ref = br.run_block_batched(cfg, bits3x, state, wre, wim)

    mesh = pmesh.make_mesh(n_ch_shards=4, n_dop_shards=1,
                           devices=jax.devices()[:4])
    shard_ch, repl = pmesh.batch_shardings(mesh)
    step = pmesh.make_sharded_batch_step(cfg, mesh)
    st_sh, out_sh = step(
        jax.device_put(bits3x, shard_ch),
        jax.tree_util.tree_map(lambda x: jax.device_put(x, shard_ch), state),
        jax.device_put(wre, repl), jax.device_put(wim, repl),
    )
    for k in out_ref:
        np.testing.assert_array_equal(
            np.asarray(out_ref[k]), np.asarray(out_sh[k]), err_msg=k)
    for leaf_r, leaf_s in zip(jax.tree_util.tree_leaves(st_ref),
                              jax.tree_util.tree_leaves(st_sh)):
        np.testing.assert_array_equal(np.asarray(leaf_r), np.asarray(leaf_s))


def test_sharded_superblock_matches_single_device():
    cfg = _cfg(superblock=3)
    n_ch = 8
    bits3x, state, wre, wim = _inputs(
        cfg, n_ch, n_ms=cfg.tail_ms + 3 * cfg.block_ms)

    st_ref, out_ref = br.run_superblock(cfg, 3, bits3x, state, wre, wim)

    mesh = pmesh.make_mesh(n_ch_shards=2, n_dop_shards=1,
                           devices=jax.devices()[:2])
    shard_ch, repl = pmesh.batch_shardings(mesh)
    step = pmesh.make_sharded_batch_step(cfg, mesh, k_blocks=3)
    st_sh, out_sh = step(
        jax.device_put(bits3x, shard_ch),
        jax.tree_util.tree_map(lambda x: jax.device_put(x, shard_ch), state),
        jax.device_put(wre, repl), jax.device_put(wim, repl),
    )
    for k in out_ref:
        np.testing.assert_array_equal(
            np.asarray(out_ref[k]), np.asarray(out_sh[k]), err_msg=k)


def test_sharded_batch_step_rowsum_pallas_matches_single_device():
    """The fused correlator (grid over channels x epochs) is per-channel
    elementwise, so channel-sharding it must stay bit-identical."""
    cfg = TrackingConfig(sampling_frequency=10e6, block_ms=2, tail_ms=2,
                         window_size=10240, runtime="batch", use_pallas=True,
                         pallas_interpret=True, quantize_spacing=True)
    n_ch = 4
    bits3x, state, wre, wim = _inputs(cfg, n_ch)

    st_ref, out_ref = br.run_block_batched(cfg, bits3x, state, wre, wim)

    mesh = pmesh.make_mesh(n_ch_shards=2, n_dop_shards=1,
                           devices=jax.devices()[:2])
    shard_ch, repl = pmesh.batch_shardings(mesh)
    step = pmesh.make_sharded_batch_step(cfg, mesh)
    st_sh, out_sh = step(
        jax.device_put(bits3x, shard_ch),
        jax.tree_util.tree_map(lambda x: jax.device_put(x, shard_ch), state),
        jax.device_put(wre, repl), jax.device_put(wim, repl),
    )
    for k in out_ref:
        np.testing.assert_array_equal(
            np.asarray(out_ref[k]), np.asarray(out_sh[k]), err_msg=k)


@pytest.mark.slow
def test_session_with_mesh_closed_loop():
    """Full session (acquisition handoff + batch tracking) on a mesh tracks
    a synthetic satellite identically to the single-device session."""
    from sydr_tpu.receiver.session import AcquisitionConfig, TrackingSession
    from sydr_tpu.signal.synthetic import IQGenerator

    fs = 4e6
    cfg = TrackingConfig(sampling_frequency=fs, block_ms=20, tail_ms=4,
                         window_size=4224, runtime="batch", superblock=2)
    acq_cfg = AcquisitionConfig(coherent=2, non_coherent=3)
    prns = [5, 12, 0, 0]  # padded to divide over the ch axis

    bits = np.random.default_rng(3).integers(0, 2, 200)

    def drive(mesh):
        gen = IQGenerator(fs, noise=True, seed=7)
        gen.add_satellite(5, doppler_hz=1200.0, code_phase_chips=321.4,
                          cn0_dbhz=46.0, nav_bits=bits)
        gen.add_satellite(12, doppler_hz=-2600.0, code_phase_chips=811.9,
                          cn0_dbhz=46.0, nav_bits=bits)
        session = TrackingSession(cfg, prns, acq_cfg, mesh=mesh)
        outs = []
        for _ in range(30):  # 2.4 s: enough for histogram bit sync
            iq = gen.generate_ms(cfg.superblock * cfg.block_ms)
            outs.append(session.process_block(
                np.float32(iq.real), np.float32(iq.imag)))
        return session, {
            k: np.concatenate([o[k] for o in outs], 0) for k in outs[0]}

    mesh = pmesh.make_mesh(n_ch_shards=4, n_dop_shards=1,
                           devices=jax.devices()[:4])
    _, out_sh = drive(mesh)
    _, out_ref = drive(None)

    # The sharded executable's float rounding differs at ~1e-6 per block and
    # the closed loop amplifies it, so compare tracking behaviour, not bits
    # (bit-identity of one step is covered above).
    assert out_sh["active"][-100:, :2].all()
    from sydr_tpu.channels.state import FLAG_BIT_SYNC

    for i, dop in enumerate((1200.0, -2600.0)):
        cf_sh = out_sh["carrier_freq"][-100:, i].mean()
        cf_ref = out_ref["carrier_freq"][-100:, i].mean()
        assert abs(cf_sh - dop) < 5.0, (i, cf_sh)
        assert abs(cf_sh - cf_ref) < 1.0, (i, cf_sh, cf_ref)
        assert out_sh["flags"][-1, i] & FLAG_BIT_SYNC
    np.testing.assert_allclose(
        out_ref["cn0"][-1, :2], out_sh["cn0"][-1, :2], rtol=0.05)
