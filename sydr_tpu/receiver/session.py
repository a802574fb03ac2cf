"""Host-side orchestration of the device tracking runtime.

``TrackingSession`` owns the device channel state, assembles the sliding
sample window per block, and performs the acquisition→tracking handoff.
It is the host half of the reference's ``ChannelManager`` + ``Receiver.run``
loop (``/root/reference/sydr/receiver/receiver.py:101-144``,
``channel/channelManager.py``), with the per-ms multiprocessing barrier
replaced by a per-block jitted device call.

Sample accounting: the session counts the absolute number of samples fed
(``total_samples``); each channel's absolute read position is
``total_samples - unread`` (the reference keeps the equivalent quantity via
``getNbUnreadSamples``). The acquisition handoff replicates the reference's
alignment: tracking starts at the last code boundary inside the acquisition
window, ``unread = samples_per_code - code_index - 1``
(``channel_l1ca_borre.py:309-311``).
"""

from __future__ import annotations

import dataclasses
import logging

import jax
import jax.numpy as jnp
import numpy as np

from sydr_tpu.channels import batch_runtime, runtime
from sydr_tpu.channels.state import (
    MODE_ACQUIRING,
    MODE_IDLE,
    MODE_TRACKING,
    ChannelState,
    code_table,
    init_state,
)
from sydr_tpu.constants import (
    GPS_L1CA_CARRIER_FREQ,
    GPS_L1CA_CODE_FREQ,
    GPS_L1CA_CODE_LENGTH,
)
from sydr_tpu.ops import acquisition as acq

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class CruisePolicy:
    """When to promote from the pull-in step to the cruise step.

    The batch runtime's delayed-feedback stability rule forces pull-in to
    run the Kaplan FLL-assisted profile at short blocks
    (``loop_bandwidth * block_length < ~0.15``, ``batch_runtime`` module
    docstring), while the throughput-optimal cruise shape is 20 ms
    blocks / long superblocks (kaplan loops since round 5: the borre
    Costas loop under 20 ms delayed feedback holds ~k*25 Hz alias locks
    on ~15% of cold-start code phases, tools/track_benchmark.py; the
    borre cruise remains available per config). This policy decides when
    every channel is
    stable enough to migrate — the channel state pytree is
    runtime-independent, so promotion is a config swap + re-jit at a block
    boundary. (The reference's per-ms loop never faces this; this design
    owes the handoff to make its headline configuration the actual
    production path.)
    """

    # consecutive qualifying process_block calls before promoting
    stable_blocks: int = 2
    # every TRACKING channel must hold at least this PLL lock indicator.
    # NOT C/N0: the NWPR estimate is unreliable in the pull-in shape —
    # a 20 ms bit spans four 5 ms blocks, and the frozen-NCO phase step
    # at each block boundary corrupts the coherent sum (channels decoding
    # subframes read -120..20 dB-Hz; round-4 soak forensics). pll_lock is
    # computed from raw epoch pairs and is partially degraded by the same
    # boundary steps, so the bar is deliberately low — it only needs to
    # exclude clearly-unlocked channels; bit sync (dominance-gated
    # histogram) is the real convergence signal.
    min_pll_lock: float = 0.3
    # ... and have declared bit sync (20 ms epoch grid pinned)
    require_bit_sync: bool = True


@dataclasses.dataclass
class AcquisitionConfig:
    doppler_range: float = 5000.0
    doppler_step: float = 100.0
    coherent: int = 5
    non_coherent: int = 10
    threshold: float = 1.5
    # "pcps" (FFT circular correlation) or "serial" (time-domain matmul
    # search, the reference's SerialSearch channel variant).
    method: str = "pcps"
    # A below-threshold search re-arms after this much fresh signal
    # (0 disables retry: one noisy window would otherwise permanently
    # disable the satellite; the reference never retries either,
    # channel_l1ca_borre.py:263-278 only guards on sample count).
    retry_backoff_ms: int = 200

    @property
    def required_ms(self) -> int:
        if self.method == "serial":
            return 1
        return self.coherent * self.non_coherent


class TrackingSession:
    """Drives the vmapped channel runtime over a streamed IQ signal."""

    def __init__(
        self,
        cfg: runtime.TrackingConfig,
        prns: list[int],
        acq_cfg: AcquisitionConfig | None = None,
        mesh=None,
        cruise: "runtime.TrackingConfig | None" = None,
        cruise_policy: CruisePolicy | None = None,
    ):
        """``mesh``: optional ``jax.sharding.Mesh`` with a ``ch`` axis — the
        tracking runtime then runs channel-sharded over the mesh devices
        (``parallel.mesh.make_sharded_batch_step``); the channel count must
        divide over ``mesh.shape['ch']`` (pad ``prns`` with 0 if needed).

        ``cruise``: optional throughput-optimal TrackingConfig to promote
        to once every channel is stable (:class:`CruisePolicy`); ``cfg``
        is then the pull-in configuration. Both must share sampling rate,
        decimation and tail length — only the loop profile, block length
        and superblock may differ.
        """
        self.cfg = cfg
        self._pullin_cfg = cfg
        self.prns = list(prns)
        self.acq_cfg = acq_cfg or AcquisitionConfig()
        self.cruise_cfg = cruise
        self.cruise_policy = cruise_policy or CruisePolicy()
        self.promoted = False
        self._stable_blocks = 0
        if cruise is not None:
            assert cruise.tail_ms == cfg.tail_ms
            assert cruise.samples_per_ms == cfg.samples_per_ms
            assert cruise.input_decimate == cfg.input_decimate
            assert cruise.intermediate_frequency == cfg.intermediate_frequency
        self.n_channels = len(prns)
        self.mesh = mesh
        self._shard_ch = None
        if mesh is not None:
            from sydr_tpu.parallel import mesh as pmesh

            assert self.n_channels % mesh.shape["ch"] == 0, (
                f"{self.n_channels} channels do not divide over "
                f"{mesh.shape['ch']} 'ch' shards; pad prns with 0")
            self._shard_ch, self._shard_repl = pmesh.batch_shardings(mesh)
        self.codes = self._place(jnp.asarray(code_table(prns)))
        self.bits3x = self._place(
            jnp.asarray(batch_runtime.tiled_code_bits(prns)))
        self.state: ChannelState = init_state(self.n_channels)
        self.mode_host = np.where(
            np.asarray([p > 0 for p in self.prns]), MODE_ACQUIRING, MODE_IDLE
        ).astype(np.int32)
        self.state = self._place_state(dataclasses.replace(
            self.state, mode=jnp.asarray(self.mode_host)
        ))
        spms = cfg.samples_per_ms
        self.total_samples = 0
        # Host history for acquisition (keeps the last required_ms of IQ).
        hist = self.acq_cfg.required_ms * spms
        self._hist_re = np.zeros(hist, dtype=np.float32)
        self._hist_im = np.zeros(hist, dtype=np.float32)
        # Device-resident acquisition ring: the PCPS search reads the last
        # required_ms of samples straight from device memory (maintained by
        # the packed block step from the samples already uploaded for
        # tracking), so cold start re-uploads nothing.
        self._ring_re = jnp.zeros(hist, dtype=jnp.float32)
        self._ring_im = jnp.zeros(hist, dtype=jnp.float32)
        # Device window tail (previous block's last tail_ms milliseconds).
        tail = cfg.tail_ms * spms
        self._tail_re = np.zeros(tail, dtype=np.float32)
        self._tail_im = np.zeros(tail, dtype=np.float32)
        self._code_ffts = None
        self._plans = None
        self._packed_run = None
        self.acq_results: dict[int, dict] = {}
        # Earliest total_samples at which a failed channel may retry.
        self._acq_retry_at: dict[int, int] = {}

    # ------------------------------------------------------------------
    def _place(self, arr):
        """Channel-shard an array over the mesh (no-op without one)."""
        if self._shard_ch is None:
            return arr
        return jax.device_put(arr, self._shard_ch)

    def _place_state(self, state: ChannelState) -> ChannelState:
        """Channel-shard every state leaf over the mesh (no-op without)."""
        if self._shard_ch is None:
            return state
        return jax.tree_util.tree_map(
            lambda x: jax.device_put(x, self._shard_ch), state)

    # ------------------------------------------------------------------
    def _update_hist(self, block_re, block_im):
        h = len(self._hist_re)
        n = len(block_re)
        if n >= h:
            self._hist_re[:] = block_re[-h:]
            self._hist_im[:] = block_im[-h:]
        else:
            self._hist_re = np.roll(self._hist_re, -n)
            self._hist_im = np.roll(self._hist_im, -n)
            self._hist_re[-n:] = block_re
            self._hist_im[-n:] = block_im

    # ------------------------------------------------------------------
    def _maybe_acquire(self):
        """Run PCPS for channels in ACQUIRING mode once enough history."""
        pending = [
            i for i in range(self.n_channels)
            if self.mode_host[i] == MODE_ACQUIRING
            and self.total_samples >= self._acq_retry_at.get(i, 0)
        ]
        need = self.acq_cfg.required_ms * self.cfg.samples_per_ms
        if not pending or self.total_samples < need:
            return

        if self.acq_cfg.method == "serial":
            self._acquire_serial(pending)
            return
        if self._code_ffts is None:
            self._code_ffts = {
                i: acq.split_reim(
                    acq.code_fft_conj(self.prns[i], self.cfg.sampling_frequency)
                )
                for i in range(self.n_channels)
                if self.prns[i] > 0
            }
        k_re = np.stack([self._code_ffts[i][0] for i in pending])
        k_im = np.stack([self._code_ffts[i][1] for i in pending])
        bins = acq.doppler_bins(self.acq_cfg.doppler_range,
                                self.acq_cfg.doppler_step)
        # Device-resident search: the sample history is already on device
        # (maintained by the block step from the tracking upload); the
        # zero-copy broadcast avoids a 50-ms float32 re-upload.
        iq_re = jnp.broadcast_to(self._ring_re[None, :], (len(pending), need))
        iq_im = jnp.broadcast_to(self._ring_im[None, :], (len(pending), need))
        doppler, code_idx, metric, cmap = acq.acquire(
            (iq_re, iq_im),
            (k_re, k_im),
            bins,
            sampling_frequency=self.cfg.sampling_frequency,
            intermediate_frequency=self.cfg.intermediate_frequency,
            coherent=self.acq_cfg.coherent,
            non_coherent=self.acq_cfg.non_coherent,
        )
        doppler = np.asarray(doppler)
        code_idx = np.asarray(code_idx)
        metric = np.asarray(metric)
        # Chip-resolution correlation map for diagnostics/report (the
        # reference renders this surface with utils/surface3d.py).
        cmap = np.asarray(cmap)
        spc = max(1, round(self.cfg.sampling_frequency / GPS_L1CA_CODE_FREQ))
        n_chip = cmap.shape[-1] // spc
        cmap_dec = cmap[:, :, :n_chip * spc].reshape(
            cmap.shape[0], cmap.shape[1], n_chip, spc).max(axis=-1)

        samples_per_code = round(
            self.cfg.sampling_frequency
            * GPS_L1CA_CODE_LENGTH
            / GPS_L1CA_CODE_FREQ
        )
        mode = np.array(self.mode_host)
        carrier = np.array(self.state.carrier_freq)
        anchor = np.array(self.state.freq_anchor)
        code_off = np.array(self.state.code_freq_offset)
        unread = np.array(self.state.unread)
        for j, i in enumerate(pending):
            self.acq_results[i] = {
                "prn": self.prns[i],
                "doppler": float(doppler[j]),
                "code_index": int(code_idx[j]),
                "metric": float(metric[j]),
                "corr_map": cmap_dec[j].astype(np.float32),
                "corr_dopplers": np.asarray(bins, np.float32),
            }
            if metric[j] < self.acq_cfg.threshold:
                mode[i] = self._acq_fail_mode(i)
                continue
            self._acq_retry_at.pop(i, None)
            mode[i] = MODE_TRACKING
            carrier[i] = self.cfg.intermediate_frequency + doppler[j]
            anchor[i] = carrier[i]
            if not self.cfg.carrier_aiding:
                code_off[i] = doppler[j] * (
                    GPS_L1CA_CODE_FREQ / GPS_L1CA_CARRIER_FREQ
                )
            # Start at the last code boundary of the acquisition window
            # (reference channel_l1ca_borre.py:309-311).
            unread[i] = samples_per_code - int(code_idx[j]) - 1
        self.mode_host = mode
        self.state = self._place_state(dataclasses.replace(
            self.state,
            mode=jnp.asarray(mode),
            carrier_freq=jnp.asarray(carrier),
            freq_anchor=jnp.asarray(anchor),
            code_freq_offset=jnp.asarray(code_off),
            unread=jnp.asarray(unread),
        ))

    # ------------------------------------------------------------------
    @property
    def block_input_samples(self) -> int:
        """Raw input samples one ``process_block`` call consumes (callers
        must re-read this every block: promotion changes the block shape)."""
        return (self.cfg.superblock * self.cfg.block_ms
                * self.cfg.samples_per_ms * self.cfg.input_decimate)

    def _maybe_promote(self, out) -> None:
        """Pull-in -> cruise handoff (see :class:`CruisePolicy`)."""
        if self.cruise_cfg is None or self.promoted:
            return
        from sydr_tpu.channels.state import FLAG_BIT_SYNC

        tracking = self.mode_host == MODE_TRACKING
        if not tracking.any():
            return
        # Channels still on their FIRST acquisition attempt hold promotion;
        # channels in retry backoff (already searched once) do not — a
        # persistently weak satellite must not keep the receiver in the
        # pull-in shape forever.
        for i in range(self.n_channels):
            if (self.mode_host[i] == MODE_ACQUIRING
                    and i not in self.acq_results):
                return
        flags = np.asarray(out["flags"][-1])
        pll = np.asarray(out["pll_lock"][-1])
        pol = self.cruise_policy
        ok = True
        for i in np.nonzero(tracking)[0]:
            if pol.require_bit_sync and not (int(flags[i]) & FLAG_BIT_SYNC):
                ok = False
                break
            if not (pll[i] >= pol.min_pll_lock):
                ok = False
                break
        self._stable_blocks = self._stable_blocks + 1 if ok else 0
        if self._stable_blocks >= pol.stable_blocks:
            self._promote()

    def _promote(self) -> None:
        """Swap to the cruise configuration at this block boundary.

        The state pytree is runtime-independent: NCO frequencies, phase
        remainders, sample accounting, bit-sync grid, C/N0 and counters all
        carry over. Only the loop-filter memories are zeroed — the pull-in
        (Kaplan) and cruise (Borre) filters hold differently-scaled
        internal states, and a zeroed filter memory costs one bounded
        transient epoch under the frequency/code rails.
        """
        old = (f"{self.cfg.profile}/{self.cfg.block_ms}ms"
               f"/sb{self.cfg.superblock}")
        z = jnp.zeros_like(self.state.dll_memory)
        self.state = self._place_state(dataclasses.replace(
            self.state, dll_memory=z, pll_memory=z, fll_memory=z,
            fll_vel=z, fll_acc=z))
        self.cfg = self.cruise_cfg
        self._packed_run = None        # re-jit lazily with the cruise cfg
        self.promoted = True
        logger.info(
            "promoted %s -> %s/%dms/sb%d (all channels stable)", old,
            self.cfg.profile, self.cfg.block_ms, self.cfg.superblock)

    # ------------------------------------------------------------------
    def _acq_fail_mode(self, i: int) -> int:
        """Mode after a below-threshold search: re-arm with backoff."""
        if self.acq_cfg.retry_backoff_ms <= 0:
            return MODE_IDLE
        self._acq_retry_at[i] = self.total_samples + (
            self.acq_cfg.retry_backoff_ms * self.cfg.samples_per_ms
        )
        return MODE_ACQUIRING

    # ------------------------------------------------------------------
    def process_block(self, block_re: np.ndarray, block_im: np.ndarray):
        """Process ``superblock * block_ms`` milliseconds of IQ.

        Returns host outputs ``[superblock * block_ms, n_ch]``.
        """
        cfg = self.cfg
        expect = cfg.superblock * cfg.block_ms * cfg.samples_per_ms
        dec = cfg.input_decimate
        assert len(block_re) == expect * dec, (len(block_re), expect, dec)
        if dec > 1:
            # Boxcar pre-correlation decimation (cfg.input_decimate): done
            # host-side so the upload also shrinks by the factor.
            block_re = np.float32(block_re).reshape(-1, dec).sum(axis=1)
            block_im = np.float32(block_im).reshape(-1, dec).sum(axis=1)

        window_re = np.concatenate([self._tail_re, block_re])
        window_im = np.concatenate([self._tail_im, block_im])
        if self._packed_run is None:
            self._packed_run = self._make_packed_run()
        if cfg.upload_int8:
            peak = max(
                float(np.max(np.abs(window_re))),
                float(np.max(np.abs(window_im))), 1e-12,
            )
            scale = 120.0 / peak
            up_re = np.clip(np.rint(window_re * scale), -127, 127
                            ).astype(np.int8)
            up_im = np.clip(np.rint(window_im * scale), -127, 127
                            ).astype(np.int8)
            inv_scale = np.float32(1.0 / scale)
        else:
            up_re, up_im = window_re, window_im
            inv_scale = np.float32(1.0)
        (self.state, packed_f, packed_i, self._ring_re, self._ring_im,
         keys_f, keys_i) = self._packed_run(
            self.state, jnp.asarray(up_re), jnp.asarray(up_im), inv_scale,
            self._ring_re, self._ring_im)
        self.total_samples += expect
        tail = cfg.tail_ms * cfg.samples_per_ms
        self._tail_re = window_re[-tail:]
        self._tail_im = window_im[-tail:]
        self._update_hist(block_re, block_im)
        self._maybe_acquire()
        # Two bulk transfers instead of one per output key: each host fetch
        # pays the full device round-trip on this backend.
        host_f = np.asarray(packed_f)
        host_i = np.asarray(packed_i)
        out = {k: host_f[..., j] for j, k in enumerate(keys_f)}
        for j, k in enumerate(keys_i):
            col = host_i[..., j]
            out[k] = col.astype(bool) if k in self._BOOL_KEYS else col
        self._maybe_promote(out)
        return out

    _BOOL_KEYS = frozenset({"active", "bit_ready"})

    def _make_packed_run(self):
        """Jitted block step returning outputs packed into two arrays.

        Key order is resolved abstractly (jax.eval_shape) before any device
        work; packing makes the per-block host fetch two bulk transfers
        instead of ~24 round-trips.
        """
        cfg = self.cfg
        codes = self.codes
        bits3x = self.bits3x
        keys: dict[str, tuple] = {}
        if cfg.runtime != "batch":
            assert cfg.superblock == 1, "superblock requires the batch runtime"
        sharded_step = None
        if self.mesh is not None:
            from sydr_tpu.parallel import mesh as pmesh

            sharded_step = pmesh.make_sharded_batch_step(
                cfg, self.mesh,
                k_blocks=cfg.superblock if cfg.runtime == "batch" else 1)

        hist_n = self.acq_cfg.required_ms * cfg.samples_per_ms
        tail_n = cfg.tail_ms * cfg.samples_per_ms

        def roll_ring(ring, fresh):
            if fresh.shape[0] >= hist_n:
                return jax.lax.slice_in_dim(
                    fresh, fresh.shape[0] - hist_n, fresh.shape[0])
            return jnp.concatenate([ring[fresh.shape[0]:], fresh])

        def inner(state, wre, wim, inv_scale, ring_re, ring_im):
            wre = wre.astype(jnp.float32) * inv_scale
            wim = wim.astype(jnp.float32) * inv_scale
            # Acquisition ring: append the fresh (non-tail) samples.
            ring_re = roll_ring(ring_re, wre[tail_n:])
            ring_im = roll_ring(ring_im, wim[tail_n:])
            tables = bits3x if cfg.runtime == "batch" else codes
            if sharded_step is not None:
                state, outputs = sharded_step(tables, state, wre, wim)
            elif cfg.runtime == "batch" and cfg.superblock > 1:
                state, outputs = batch_runtime.run_superblock(
                    cfg, cfg.superblock, bits3x, state, wre, wim)
            elif cfg.runtime == "batch":
                state, outputs = batch_runtime.run_block_batched(
                    cfg, bits3x, state, wre, wim)
            else:
                state, outputs = runtime.run_block(
                    cfg, codes, state, wre, wim)
            keys["f"] = tuple(sorted(
                k for k, v in outputs.items() if v.dtype == jnp.float32))
            keys["i"] = tuple(sorted(
                k for k, v in outputs.items() if v.dtype != jnp.float32))
            packed_f = jnp.stack([outputs[k] for k in keys["f"]], axis=-1)
            packed_i = jnp.stack(
                [outputs[k].astype(jnp.int32) for k in keys["i"]], axis=-1)
            return state, packed_f, packed_i, ring_re, ring_im

        n_in = (cfg.tail_ms + cfg.superblock * cfg.block_ms) \
            * cfg.samples_per_ms if cfg.superblock > 1 \
            else cfg.window_samples
        in_dtype = jnp.int8 if cfg.upload_int8 else jnp.float32
        ring_s = jax.ShapeDtypeStruct((hist_n,), jnp.float32)
        jax.eval_shape(
            inner, self.state,
            jax.ShapeDtypeStruct((n_in,), in_dtype),
            jax.ShapeDtypeStruct((n_in,), in_dtype),
            jax.ShapeDtypeStruct((), jnp.float32),
            ring_s, ring_s,
        )
        jitted = jax.jit(inner)
        keys_f, keys_i = keys["f"], keys["i"]

        def run(state, wre, wim, inv_scale, ring_re, ring_im):
            state2, pf, pi, ring_re, ring_im = jitted(
                state, wre, wim, inv_scale, ring_re, ring_im)
            return state2, pf, pi, ring_re, ring_im, keys_f, keys_i

        return run

    # ------------------------------------------------------------------
    def or_flags(self, i: int, mask: int) -> None:
        """OR decode-progress bits (SUBFRAME_SYNC/TOW_DECODED/EPH_DECODED)
        into channel ``i``'s device flags. Decoding happens on the host, so
        the receiver pushes these at block boundaries; the per-epoch
        ``flags`` output/DB column then shows the reference's per-channel
        progression (channel.py:205-228, enumerations.py:120-138)."""
        import dataclasses as dc

        st = self.state
        self.state = dc.replace(
            st, flags=st.flags.at[i].set(st.flags[i] | jnp.int32(mask)))

    # ------------------------------------------------------------------
    def reset_channel(self, i: int) -> None:
        """Reset channel ``i`` to ACQUIRING (lock-loss reacquisition).

        If the session has been promoted to the cruise shape, it DEMOTES
        back to the pull-in configuration first: a freshly-acquired
        channel carries up to half the acquisition Doppler step
        (+-50 Hz) of carrier error, far outside the cruise Costas loop's
        pull range — handing it straight to cruise is how the round-4
        soak's PRN 6 parked in a ~19 Hz half-bit-rate alias
        (tools/false_lock_probe.py). The pull-in (FLL-assisted) shape
        re-converges it, then :meth:`_maybe_promote` restores cruise once
        every channel is stable again.
        """
        import dataclasses as dc

        from sydr_tpu.channels.state import MODE_ACQUIRING, init_state

        self._demote()
        fresh = init_state(self.n_channels)

        def reset_leaf(cur, init):
            return cur.at[i].set(init[i])

        self.state = self._place_state(jax.tree_util.tree_map(
            reset_leaf, self.state,
            dc.replace(fresh, mode=jnp.full_like(fresh.mode, MODE_ACQUIRING)),
        ))
        self.mode_host[i] = MODE_ACQUIRING
        self.acq_results.pop(i, None)
        self._acq_retry_at.pop(i, None)

    def _demote(self) -> None:
        """Swap back from cruise to the pull-in configuration."""
        if not self.promoted:
            return
        old = (f"{self.cfg.profile}/{self.cfg.block_ms}ms"
               f"/sb{self.cfg.superblock}")
        z = jnp.zeros_like(self.state.dll_memory)
        self.state = self._place_state(dataclasses.replace(
            self.state, dll_memory=z, pll_memory=z, fll_memory=z,
            fll_vel=z, fll_acc=z))
        self.cfg = self._pullin_cfg
        self._packed_run = None        # re-jit lazily with the pull-in cfg
        self.promoted = False
        self._stable_blocks = 0
        logger.info(
            "demoted %s -> %s/%dms/sb%d (channel reacquisition)", old,
            self.cfg.profile, self.cfg.block_ms, self.cfg.superblock)

    # ------------------------------------------------------------------
    def _acquire_serial(self, pending) -> None:
        """Time-domain serial-search acquisition (one code period)."""
        spms = self.cfg.samples_per_ms
        bins = acq.doppler_bins(self.acq_cfg.doppler_range,
                                self.acq_cfg.doppler_step)
        pad = (-len(bins)) % 8
        bins_p = np.concatenate([bins, np.repeat(bins[-1:], pad)])
        iq_re = self._hist_re[-spms:]
        iq_im = self._hist_im[-spms:]
        samples_per_chip = self.cfg.sampling_frequency / GPS_L1CA_CODE_FREQ
        mode = np.array(self.mode_host)
        carrier = np.array(self.state.carrier_freq)
        anchor = np.array(self.state.freq_anchor)
        code_off = np.array(self.state.code_freq_offset)
        unread = np.array(self.state.unread)
        samples_per_code = round(spms)
        for i in pending:
            shift = acq.code_shift_matrix(self.prns[i],
                                          self.cfg.sampling_frequency)
            cmap = acq.serial_search(
                iq_re, iq_im, jnp.asarray(shift), jnp.asarray(bins_p),
                sampling_frequency=self.cfg.sampling_frequency,
                intermediate_frequency=self.cfg.intermediate_frequency,
            )[: len(bins)]
            (fi, ci_chips), metric = acq.peak_metric_ss(cmap)
            # Chip-shift k peaks when the stream phase is 1023 - k chips;
            # convert to the PCPS sample-index convention.
            code_idx = int(
                round(float(ci_chips) * samples_per_chip)
            ) % samples_per_code
            self.acq_results[i] = {
                "prn": self.prns[i],
                "doppler": float(bins[int(fi)]),
                "code_index": code_idx,
                "metric": float(metric),
            }
            if float(metric) < self.acq_cfg.threshold:
                mode[i] = self._acq_fail_mode(i)
                continue
            self._acq_retry_at.pop(i, None)
            mode[i] = MODE_TRACKING
            carrier[i] = self.cfg.intermediate_frequency + float(bins[int(fi)])
            anchor[i] = carrier[i]
            if not self.cfg.carrier_aiding:
                code_off[i] = float(bins[int(fi)]) * (
                    GPS_L1CA_CODE_FREQ / GPS_L1CA_CARRIER_FREQ
                )
            unread[i] = samples_per_code - code_idx - 1
        self.mode_host = mode
        self.state = self._place_state(dataclasses.replace(
            self.state,
            mode=jnp.asarray(mode),
            carrier_freq=jnp.asarray(carrier),
            freq_anchor=jnp.asarray(anchor),
            code_freq_offset=jnp.asarray(code_off),
            unread=jnp.asarray(unread),
        ))
