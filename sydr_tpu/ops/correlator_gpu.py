"""Fused per-epoch correlator for the batched tracking runtime (Pallas, Triton).

One program owns one (channel, epoch) pair of a block. It walks the epoch's
samples ``[b_start, b_end)`` of the block window in power-of-two tiles with a
masked tail and, per sample, regenerates the carrier with sin/cos, wipes it
off, takes each correlator tap's chip from a ``+-1`` code table by a plain
gather, and accumulates the E/P/L x I/Q products in float32 registers. Only
the per-epoch correlators ``[block_ms, n_ch, n_streams]`` reach device
memory; the window is read once per channel and stays L2-resident.

The arithmetic reproduces ``batch_runtime.dense_streams`` (the XLA dense
pass, which is the reference this kernel is tested against):

* carrier phase at window sample ``m`` is ``phic_q[q] - omega * lm`` with
  ``q = m // spms`` and ``lm = m % spms`` (per-millisecond anchors);
* the chip of a tap at spacing ``sp`` is code chip
  ``c_int + ceil(fb_q[q] + sp + lm * code_step)`` (mod 1023), with the
  product taken over the exact three-term split of ``code_step``
  (:func:`chip_phase`), so that the index is the same float32 computation
  on every backend;
* sample-quantised taps are whole-sample shifts ``k`` of the base stream:
  tap ``k`` at sample ``m`` reads the base chip of sample ``m + k``, whose
  anchors stay those of the window's last millisecond past its end.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

# Index of chip 0 in a ``batch_runtime.tiled_code_bits`` row: entry
# ``CODE_ORIGIN + u`` holds chip ``u mod 1023`` for u in [-1023, 3069).
CODE_ORIGIN = 1023
NUM_WARPS = 4


def tile_size(spms: int) -> int:
    """Samples per loop step: a power of two near half an epoch, <= 1024."""
    t = 128
    while t < 1024 and 2 * t < spms:
        t *= 2
    return t


def code_step_parts(code_step, spms: int):
    """``code_step`` as three float32 terms whose products with any sample
    index below ``spms + 256`` are exact.

    Each term keeps at most ``24 - bits(spms + 256)`` significant bits
    (masked off the float32 mantissa; the differences are exact), so
    :func:`chip_phase` rounds only in its additions and gives the same
    float32 — hence the same ``ceil`` chip index — whether or not a
    compiler fuses a multiply into the following add.
    """
    drop = (spms + 256).bit_length()          # low mantissa bits dropped
    if 3 * (24 - drop) < 24:
        raise ValueError(f"{spms} samples per ms is too many to split")
    mask = jnp.int32(-(1 << drop))

    def head(x):
        bits = lax.bitcast_convert_type(x, jnp.int32)
        return lax.bitcast_convert_type(bits & mask, jnp.float32)

    hi = head(code_step)
    mid = head(code_step - hi)
    return hi, mid, (code_step - hi) - mid


def chip_phase(r, lm, parts):
    """Code phase ``r + lm * code_step`` in chips from the
    :func:`code_step_parts` split: every product is exact, and the sums run
    in this fixed order."""
    hi, mid, lo = parts
    return ((r + lm * hi) + lm * mid) + lm * lo


def _kernel(wre_ref, wim_ref, bits_ref, cint_ref, omega_ref, cstep_ref,
            fb_ref, ph_ref, bs_ref, be_ref, o_ref, *, spms, n_q, taps,
            tile, s_pad, code_offset):
    ch = pl.program_id(0)
    e = pl.program_id(1)
    start = bs_ref[ch, e]
    end = be_ref[ch, e]
    c_base = cint_ref[ch] + (CODE_ORIGIN + code_offset)
    omega = omega_ref[ch]
    step_parts = [cstep_ref[ch, i] for i in range(3)]
    code_max = bits_ref.shape[1] - 1
    lane = lax.broadcasted_iota(jnp.int32, (tile,), 0)
    n_tiles = (jnp.maximum(end - start, 0) + (tile - 1)) // tile

    def anchor(n):
        """(ms index, sample-in-ms) of window sample ``n``, pinned to the
        last millisecond past the window's end."""
        q = jnp.minimum(lax.div(n, spms), n_q - 1)
        return q, n - q * spms

    def body(t, accs):
        off = start + t * tile
        m = off + lane
        valid = m < end
        re = plgpu.load(wre_ref.at[pl.ds(off, tile)], mask=valid, other=0.0)
        im = plgpu.load(wim_ref.at[pl.ds(off, tile)], mask=valid, other=0.0)
        q, lm = anchor(m)
        phase = ph_ref[ch, q] - omega * lm.astype(jnp.float32)
        cosv, sinv = jnp.cos(phase), jnp.sin(phase)
        mre = cosv * re - sinv * im
        mim = cosv * im + sinv * re
        out = []
        for (sp, k), acc_i, acc_q in zip(taps, accs[0::2], accs[1::2]):
            qk, lk = anchor(m + k)
            r = fb_ref[ch, qk] + sp
            idx = jnp.ceil(chip_phase(
                r, lk.astype(jnp.float32), step_parts)).astype(jnp.int32)
            bit = bits_ref[ch, jnp.clip(c_base + idx, 0, code_max)]
            chip = 2.0 * bit - 1.0
            out += [acc_i + chip * mre, acc_q + chip * mim]
        return tuple(out)

    zero = jnp.zeros((tile,), jnp.float32)
    accs = lax.fori_loop(0, n_tiles, body, (zero,) * (2 * len(taps)))
    s_idx = lax.broadcasted_iota(jnp.int32, (s_pad,), 0)
    res = jnp.zeros((s_pad,), jnp.float32)
    for s, acc in enumerate(accs):
        res = jnp.where(s_idx == s, jnp.sum(acc), res)
    o_ref[...] = res


def correlate_epochs(window_re, window_im, bits, c_int, omega, code_step,
                     fb_q, phic_q, b_start, b_end, *, spms: int,
                     taps: tuple, code_offset: int = 0,
                     interpret: bool = False):
    """Per-epoch E/P/L correlators of one block window.

    Args:
        window_re, window_im: ``[n_win]`` float32 block window.
        bits: ``[n_ch, W]`` 0/1 float32 tiled code (``tiled_code_bits``).
        c_int: ``[n_ch]`` int32 integer code-phase intercept.
        omega, code_step: ``[n_ch]`` float32 frozen carrier rate [rad per
            sample] and code rate [chips per sample].
        fb_q, phic_q: ``[n_ch, n_q]`` per-millisecond code-fraction and
            carrier-phase anchors (``batch_runtime.block_geometry``).
        b_start, b_end: ``[block_ms, n_ch]`` int32 epoch sample bounds in
            window coordinates.
        taps: ``((spacing, shift), ...)``: chips of tap ``i`` are those of
            the stream at ``spacing`` read ``shift`` samples ahead.
        code_offset: chips added to every code-table index (fault injection
            only; see ``TrackingConfig.ablate_word_row``).
        interpret: run the Pallas interpreter (the CPU test path).

    Returns ``[block_ms, n_ch, 2 * len(taps)]`` float32 correlators, streams
    ordered (I, Q) per tap.
    """
    if not interpret and jax.default_backend() != "gpu":
        raise ValueError(
            "the fused correlator compiles for CUDA GPUs only; on "
            f"{jax.default_backend()!r} set TrackingConfig.pallas_interpret "
            "(tests) or use_pallas=False (the XLA dense pass)")
    block_ms, n_ch = b_start.shape
    n_q = fb_q.shape[1]
    n_streams = 2 * len(taps)
    s_pad = max(2, pl.next_power_of_2(n_streams))
    tile = tile_size(spms)
    kernel = functools.partial(
        _kernel, spms=spms, n_q=n_q, taps=tuple(taps), tile=tile,
        s_pad=s_pad, code_offset=code_offset)
    step_parts = jnp.stack(code_step_parts(code_step, spms), axis=1)
    out = pl.pallas_call(
        kernel,
        grid=(n_ch, block_ms),
        out_specs=pl.BlockSpec((None, None, s_pad), lambda c, e: (e, c, 0)),
        out_shape=jax.ShapeDtypeStruct((block_ms, n_ch, s_pad), jnp.float32),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        interpret=interpret,
        name="epoch_correlator",
    )(window_re, window_im, bits, c_int.astype(jnp.int32), omega,
      step_parts, fb_q, phic_q, jnp.transpose(b_start), jnp.transpose(b_end))
    return out[..., :n_streams]
