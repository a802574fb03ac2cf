"""Sequence-parallel (time-axis) sharding of the block correlation.

The reference's analog of long-sequence scaling is streaming time-blocking
with boundary-state carry (SURVEY §5); on a device mesh, this module shards
the *sample axis* of one block across an ``sp`` mesh axis: each device
computes the dense correlation streams and a local running prefix for its
contiguous sub-window, and the per-epoch correlators are assembled with two
collectives —

  * ``all_gather`` of per-shard stream totals -> exclusive cross-shard
    prefix (the "boundary state exchange"),
  * ``psum`` of each shard's contribution to the epoch-boundary anchors it
    owns.

Combined with the channel axis this gives the 2-D (ch x sp) scaling story:
channels when there are many satellites, time when there are few channels
but high sample rates. Requires ``(tail_ms + block_ms) % n_shards == 0``.
Each shard runs the XLA dense pass; the fused correlator has no
sequence-parallel form yet.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from sydr_tpu.channels import batch_runtime as br
from sydr_tpu.channels.runtime import TrackingConfig
from sydr_tpu.channels.state import ChannelState


def make_sp_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    import numpy as np

    devices = devices if devices is not None else jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), axis_names=("sp",))


@functools.partial(jax.jit, static_argnames=("cfg", "mesh"))
def run_block_batched_timesharded(
    cfg: TrackingConfig, mesh: Mesh, bits3x, state: ChannelState,
    window_re, window_im,
):
    """Drop-in run_block with the dense pass sharded over the ``sp`` axis."""
    n_sp = mesh.shape["sp"]
    n_ms = cfg.tail_ms + cfg.block_ms
    assert n_ms % n_sp == 0, (
        f"tail_ms + block_ms = {n_ms} must divide over {n_sp} shards")
    spms = cfg.samples_per_ms
    n_ms_l = n_ms // n_sp
    shard_len = n_ms_l * spms
    n_win = cfg.window_samples

    geo = br._pass_a(cfg, state)
    bg = br.block_geometry(cfg, state, geo)
    base, fb_q, phic_q = bg["base"], bg["fb_q"], bg["phic_q"]
    words = br.block_words(cfg, bits3x, state, bg["c_int"])
    omega = geo["omega"]
    code_step = geo["code_step"]
    n_ch = words.shape[0]

    # Epoch boundaries as window-sample positions; anchors at b - 1.
    req_eff = jnp.where(geo["active"], geo["required"], 0)
    b_start = jnp.clip(geo["b_start"] + base[None, :], 0, n_win)
    b_end = jnp.clip(b_start + req_eff, 0, n_win)
    bounds = jnp.concatenate([b_start, b_end], axis=0)    # [2*bm, n_ch]
    pvals = bounds.T - 1                                  # [n_ch, 2*bm]
    valid_b = pvals >= 0

    def shard_fn(win_re_l, win_im_l):
        d = jax.lax.axis_index("sp")
        streams = br.dense_streams(
            cfg, words, fb_q, phic_q, omega, code_step,
            win_re_l[0], win_im_l[0], q_offset=d * n_ms_l,
        )                                                  # [n_ch, S, L]
        cs_l = jnp.cumsum(streams, axis=-1)
        totals = cs_l[..., -1]                             # [n_ch, S]
        all_tot = jax.lax.all_gather(totals, "sp")         # [n_sp, n_ch, S]
        shard_ids = jnp.arange(n_sp)
        below = jnp.sum(
            jnp.where((shard_ids < d)[:, None, None], all_tot, 0.0), axis=0
        )                                                  # [n_ch, S]

        m0 = d * shard_len
        owner = valid_b & (pvals >= m0) & (pvals < m0 + shard_len)
        li = jnp.clip(pvals - m0, 0, shard_len - 1)        # [n_ch, 2bm]
        vals = jnp.take_along_axis(
            cs_l, li[:, None, :].repeat(cs_l.shape[1], axis=1), axis=-1
        )                                                  # [n_ch, S, 2bm]
        contrib = jnp.where(
            owner[:, None, :], vals + below[..., None], 0.0)
        anchors = jax.lax.psum(contrib, "sp")              # replicated
        return anchors

    anchors = jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P(None, "sp"), P(None, "sp")),
        out_specs=P(),
        check_vma=False,
    )(window_re.reshape(1, n_win), window_im.reshape(1, n_win))

    n_streams = anchors.shape[1]
    bm = cfg.block_ms
    picked = anchors * valid_b[:, None, :]
    a_start = picked[:, :, :bm]
    a_end = picked[:, :, bm:]
    corr = jnp.transpose(a_end - a_start, (2, 0, 1))       # [bm, n_ch, S]
    return br._pass_c(cfg, state, geo, corr)
