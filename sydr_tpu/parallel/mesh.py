"""Device-mesh sharding of the receiver's parallel axes.

The reference's only parallelism is one OS process per channel on one host
(``/root/reference/sydr/channel/channelManager.py``). This design
shards array axes over a ``jax.sharding.Mesh``:

* ``ch`` — the channel axis (per-satellite state, the DP-like axis): the
  tracking runtime is embarrassingly parallel across channels, so sharding
  the ``[n_channels]`` state pytree partitions the whole scanned program with
  no collectives until outputs are gathered to host.
* ``dop`` — the Doppler axis of acquisition (model-parallel-like): the PCPS
  search grid shards over (channel x Doppler); each device computes its bin
  slab and only the per-channel peak reduction crosses devices.
* time-block (SP-like) sharding of the correlation window with boundary
  state exchange is provided by ``sydr_tpu.parallel.timeshard``.

Multi-host: the same shardings apply over a multi-host mesh initialised with
``jax.distributed.initialize`` — data feeding then uses
``jax.make_array_from_process_local_data`` per host (see
``sydr_tpu/parallel/distributed.py``).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from sydr_tpu.channels import runtime
from sydr_tpu.channels.state import ChannelState


def make_mesh(n_ch_shards: int | None = None, n_dop_shards: int = 1,
              devices=None) -> Mesh:
    """Build a (ch, dop) mesh over the available devices."""
    devices = devices if devices is not None else jax.devices()
    n = len(devices)
    if n_ch_shards is None:
        n_ch_shards = n // n_dop_shards
    assert n_ch_shards * n_dop_shards == n, (n_ch_shards, n_dop_shards, n)
    dev_array = np.asarray(devices).reshape(n_ch_shards, n_dop_shards)
    return Mesh(dev_array, axis_names=("ch", "dop"))


def channel_sharding(mesh: Mesh, state: ChannelState):
    """Per-leaf NamedShardings partitioning the channel axis."""
    def leaf_sharding(leaf):
        spec = [None] * leaf.ndim
        spec[0] = "ch"
        return NamedSharding(mesh, P(*spec))
    return jax.tree_util.tree_map(leaf_sharding, state)


def shard_session_state(mesh: Mesh, state: ChannelState, codes):
    """Place state + code tables with the channel axis sharded."""
    shardings = channel_sharding(mesh, state)
    state = jax.tree_util.tree_map(jax.device_put, state, shardings)
    codes = jax.device_put(codes, NamedSharding(mesh, P("ch", None)))
    return state, codes


def make_sharded_run_block(cfg: runtime.TrackingConfig, mesh: Mesh):
    """jit run_block with channel-sharded state and replicated windows.

    Returns a callable (codes, state, window_re, window_im) -> (state, out).
    """
    repl = NamedSharding(mesh, P())
    code_sh = NamedSharding(mesh, P("ch", None))

    def state_shardings(n_ch_proto: ChannelState):
        return channel_sharding(mesh, n_ch_proto)

    @functools.partial(jax.jit, static_argnames=("cfg",))
    def _run(cfg, codes, state, window_re, window_im):
        return runtime.run_block(cfg, codes, state, window_re, window_im)

    def run(codes, state, window_re, window_im):
        st_sh = state_shardings(state)
        codes = jax.device_put(codes, code_sh)
        state = jax.tree_util.tree_map(jax.device_put, state, st_sh)
        window_re = jax.device_put(jnp.asarray(window_re), repl)
        window_im = jax.device_put(jnp.asarray(window_im), repl)
        return _run(cfg, codes, state, window_re, window_im)

    return run


def make_sharded_batch_step(cfg: runtime.TrackingConfig, mesh: Mesh,
                            k_blocks: int = 1):
    """Channel-shard the batched (production) runtime over ``mesh``.

    Every op in ``batch_runtime`` — pass A/C scalar scans, the dense pass,
    and the fused correlator (grid ``(n_ch, block_ms)``) — is elementwise
    over the channel axis, so the sharding is collective-free: each device
    runs the full runtime on its channel shard with the sample window
    replicated (the window upload rides the host link once; the
    interconnect never carries samples).
    This is the multi-chip path of the *production* runtime; the scanned
    runtime's equivalent is :func:`make_sharded_run_block`.

    Returns a jitted ``(bits3x, state, window_re, window_im) -> (state, out)``
    with channel-sharded ``state``/``bits3x`` and replicated windows; the
    channel count must divide over ``mesh.shape['ch']``.

    Reference analog: one OS process per channel on one host
    (``/root/reference/sydr/channel/channelManager.py``).
    """
    from sydr_tpu.channels import batch_runtime as br

    def _step(tables, state, wre, wim):
        """``tables``: bits3x (batch runtime) or code table (scan)."""
        if cfg.runtime != "batch":
            return runtime.run_block(cfg, tables, state, wre, wim)
        if k_blocks > 1:
            return br.run_superblock(cfg, k_blocks, tables, state, wre, wim)
        return br.run_block_batched(cfg, tables, state, wre, wim)

    sharded = jax.shard_map(
        _step, mesh=mesh,
        in_specs=(P("ch"), P("ch"), P(), P()),
        out_specs=(P("ch"), P(None, "ch")),
        check_vma=False,
    )
    return jax.jit(sharded)


def batch_shardings(mesh: Mesh):
    """(state/bits3x sharding, replicated sharding) for the batch step."""
    return NamedSharding(mesh, P("ch")), NamedSharding(mesh, P())


def sharded_pcps(
    mesh: Mesh,
    iq_re, iq_im, code_k_re, code_k_im, bins,
    fwd_plan, inv_plan,
    *,
    sampling_frequency: float,
    intermediate_frequency: float = 0.0,
    coherent: int = 5,
    non_coherent: int = 10,
):
    """PCPS with the (channel x Doppler) grid sharded over the mesh.

    The Doppler bin axis is padded to the ``dop`` mesh size and the full
    batch is evaluated in one sharded call (no sequential chunking): each
    device owns an (n_ch/ch_shards) x (n_dop/dop_shards) slab.
    """
    from sydr_tpu.ops import acquisition as acq

    n_dop = len(bins)
    dop_size = mesh.shape["dop"]
    pad = (-n_dop) % dop_size
    bins_p = np.concatenate(
        [np.asarray(bins, np.float32), np.repeat(bins[-1:], pad)]
    )

    in_sh = NamedSharding(mesh, P("ch", None))
    bins_sh = NamedSharding(mesh, P("dop"))

    corr = acq.pcps_map(
        jax.device_put(jnp.asarray(iq_re), in_sh),
        jax.device_put(jnp.asarray(iq_im), in_sh),
        jax.device_put(jnp.asarray(code_k_re), in_sh),
        jax.device_put(jnp.asarray(code_k_im), in_sh),
        jax.device_put(jnp.asarray(bins_p), bins_sh),
        fwd_plan,
        inv_plan,
        sampling_frequency=sampling_frequency,
        intermediate_frequency=intermediate_frequency,
        coherent=coherent,
        non_coherent=non_coherent,
        doppler_chunk=len(bins_p),
    )[:, :n_dop, :]
    samples_per_chip = round(sampling_frequency / 1.023e6)
    return acq.peak_metric(
        corr, jnp.asarray(np.asarray(bins, np.float32)),
        samples_per_chip=samples_per_chip,
    )
