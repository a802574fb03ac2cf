"""Benchmark: 32-channel GPS L1 C/A tracking real-time factor on one device.

Prints ONE JSON line:
    {"metric": ..., "value": ..., "unit": ..., "vs_baseline": ...,
     "platform": ..., "device_kind": ..., "device_count": ...}

Primary metric: real-time factor (seconds of 10 Msps IQ signal processed per
wall second) for 32 tracking channels. ``vs_baseline`` compares against the
reference design's per-sample numpy EPL correlator (same operation count as
``sydr/dsp/tracking.py:92-116``) timed on this host's CPU for the same
32-channel workload.

Extra context fields (acquisition grid points/s, samples/s) are included in
the same JSON object.

Budget discipline: every stage runs under one global wall-clock deadline
(``BENCH_DEADLINE`` seconds, default 540); a stage is skipped when the time
remaining is below its worst-case estimate, and a watchdog thread
force-emits the JSON line with whatever has finished near the deadline.
Stage order is by importance: parity gate -> decimated RTF (headline) ->
reference CPU -> acquisition -> full-rate RTF.

The parity gate GATES: on ``parity_ok == False`` the headline value is
nulled and the process exits non-zero; so does any stage that raised.
"""

import json
import os
import sys
import threading
import time

_here = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, _here)

import numpy as np

N_CHANNELS = int(os.environ.get("BENCH_CHANNELS", "32"))
FS = float(os.environ.get("BENCH_FS", "10e6"))
# Product-realistic loop shape: 20 ms feedback blocks, scanned into 1 s
# device dispatches.
BLOCK_MS = int(os.environ.get("BENCH_BLOCK_MS", "20"))
# Measurement window: N_BLOCKS superblocks of signal per timed round.
N_BLOCKS = int(os.environ.get("BENCH_BLOCKS", "10"))
RUNTIME = os.environ.get("BENCH_RUNTIME", "batch")  # "batch" | "scan"
# Pass B: the fused correlator on a GPU, the XLA dense pass elsewhere
# (BENCH_PALLAS=0/1 overrides).
_PALLAS_ENV = os.environ.get("BENCH_PALLAS")
SUPERBLOCK = int(os.environ.get("BENCH_SUPERBLOCK", "50"))
# Sample-quantised correlator taps (hardware-correlator semantics): E/L
# chips are whole-sample shifts of one base chip stream.
QUANTIZE = os.environ.get("BENCH_QUANT", "1") == "1"
# Pre-correlation boxcar decimation (production receiver front-end): the
# full 10 Msps input stream is consumed on DEVICE inside the timed step
# (the boxcar sum is part of the measurement); tracking then runs at
# FS / BENCH_DECIMATE with a documented ~0.2-0.5 dB correlation-loss
# budget (tests/test_decimate.py). The undecimated RTF is also measured
# and reported alongside.
DECIMATE = int(os.environ.get("BENCH_DECIMATE", "4"))
# Pass-A epoch geometry: "scan" (recurrence) or "closed" (vectorised
# closed form; see channels/batch_runtime._pass_a_closed).
PASS_A = os.environ.get("BENCH_PASS_A", "closed")
# Loop profile of the measured cruise configuration. Production switched
# to kaplan in round 5: the borre Costas loop under 20 ms delayed block
# feedback holds metastable alias lock points at ~k*25 Hz on ~15% of
# cold-start code phases (tools/track_benchmark.py finding); the
# FLL-assisted kaplan loop at the same block shape never does, at
# negligible pass-C cost.
PROFILE = os.environ.get("BENCH_PROFILE", "kaplan")


def use_pallas_default() -> bool:
    """The fused correlator where it compiles (CUDA GPUs)."""
    if _PALLAS_ENV is not None:
        return _PALLAS_ENV == "1"
    import jax

    return jax.devices()[0].platform == "gpu"


# --------------------------------------------------------------------------
# budget framework
# --------------------------------------------------------------------------
DEADLINE_S = float(os.environ.get("BENCH_DEADLINE", "540"))
_T0 = time.time()
_DONE = threading.Event()
RESULT: dict = {}
_BASE_FIELDS = (
    "value", "vs_baseline", "samples_per_s", "acq_grid_points_per_s",
    "reference_cpu_rtf_per_channel", "rtf_fullrate", "parity_ok",
)


def _remaining() -> float:
    return DEADLINE_S - (time.time() - _T0)


def _device_fields() -> dict:
    import jax

    devs = jax.devices()
    return {"platform": devs[0].platform, "device_kind": devs[0].device_kind,
            "device_count": len(devs)}


def _emit_json() -> None:
    out = {
        "metric": f"rtf_{N_CHANNELS}ch_{FS/1e6:.0f}msps",
        "unit": "x_realtime",
        "decimate": DECIMATE,
        "n_channels": N_CHANNELS,
    }
    for k in _BASE_FIELDS:
        out.setdefault(k, None)
    out.update(RESULT)
    # The parity gate gates: a broken kernel must never ship a plausible
    # RTF as the headline.
    if out.get("parity_ok") is False:
        out["value"] = None
    print(json.dumps(out), flush=True)


def _exit_code() -> int:
    if RESULT.get("parity_ok") is False:
        return 4
    return 5 if RESULT.get("errors") else 0


def _watchdog() -> None:
    slack = _remaining() - 5.0
    if slack > 0:
        _DONE.wait(slack)
    if not _DONE.is_set():
        RESULT["partial"] = True
        RESULT.setdefault("skipped", []).append("deadline")
        _emit_json()
        os._exit(_exit_code())


def _run_stage(name: str, est_s: float, fn) -> bool:
    """Run ``fn`` if the remaining budget covers ``est_s``; else skip.

    A stage that raises is recorded under ``errors`` and makes the process
    exit non-zero after the JSON line."""
    if _remaining() < est_s:
        RESULT.setdefault("skipped", []).append(name)
        return False
    t0 = time.time()
    try:
        fn()
        return True
    except Exception as e:
        RESULT.setdefault("errors", {})[name] = (
            f"{type(e).__name__}: {str(e)[:200]}")
        return False
    finally:
        RESULT.setdefault("stage_s", {})[name] = round(time.time() - t0, 1)


def cruise_config(decimate: int = 1, use_pallas: bool | None = None,
                  n_channels: int = N_CHANNELS):
    """The measured cruise TrackingConfig at ``FS / decimate``."""
    from sydr_tpu.channels.runtime import TrackingConfig

    if use_pallas is None:
        use_pallas = use_pallas_default()
    fs_trk = FS / decimate
    return TrackingConfig(
        sampling_frequency=fs_trk,
        block_ms=BLOCK_MS,
        tail_ms=4,
        window_size=int(round(fs_trk * 1e-3)) + 256,
        runtime=RUNTIME,
        use_pallas=use_pallas,
        superblock=SUPERBLOCK if RUNTIME == "batch" else 1,
        quantize_spacing=QUANTIZE,
        input_decimate=decimate,
        pass_a=PASS_A,
        profile=PROFILE,
        # the production cruise runs the narrow-only kaplan shape
        # (3 taps / 6 streams; see channels/runtime.py)
        kaplan_narrow_only=(PROFILE == "kaplan"),
    )


def cruise_step(cfg, n_channels: int = N_CHANNELS, seed: int = 0):
    """``(step, state, signal_s)``: one device dispatch of the cruise shape.

    ``step(state) -> (state, outputs)`` consumes ``signal_s`` seconds of
    random full-rate IQ already resident on the device (boxcar-decimated by
    ``cfg.input_decimate`` inside the step).
    """
    import jax
    import jax.numpy as jnp

    from sydr_tpu.channels.runtime import run_block
    from sydr_tpu.channels import batch_runtime as br
    import __graft_entry__ as g

    decimate = cfg.input_decimate
    codes, state, _, _ = g._tracking_inputs(cfg, n_channels)
    rng = np.random.default_rng(seed)
    spms = cfg.samples_per_ms
    signal_s = cfg.block_ms * 1e-3 * cfg.superblock
    if cfg.runtime != "batch":
        n_win = cfg.window_samples
        wre = jnp.asarray(rng.standard_normal(n_win).astype(np.float32))
        wim = jnp.asarray(rng.standard_normal(n_win).astype(np.float32))
        return (lambda st: run_block(cfg, codes, st, wre, wim)), state, \
            signal_s

    prns = [(k % 32) + 1 for k in range(n_channels)]
    bits3x = jnp.asarray(br.tiled_code_bits(prns))
    n_in = (cfg.tail_ms + cfg.superblock * cfg.block_ms) * spms
    wre_raw = jnp.asarray(
        rng.standard_normal(n_in * decimate).astype(np.float32))
    wim_raw = jnp.asarray(
        rng.standard_normal(n_in * decimate).astype(np.float32))

    # Boxcar decimation as ONE natural matmul against a [128*D, 128] 0/1
    # block-sum matrix: the stream is read once and the output reshape is
    # layout-free. Single-pass bf16 on purpose: the 0/1 matrix is exact
    # and production samples are int8-quantised (integers <= 127 are
    # exact in bf16); for f32 test noise the 2^-9 rounding is ~-48 dB.
    dsum = jnp.asarray(
        (np.arange(128 * decimate)[:, None] // decimate
         == np.arange(128)[None, :]).astype(np.float32)
    ).astype(jnp.bfloat16)

    def _boxcar(x):
        padn = (-x.shape[0]) % (128 * decimate)
        if padn:
            x = jnp.concatenate([x, jnp.zeros(padn, x.dtype)])
        out = jnp.dot(
            x.reshape(-1, 128 * decimate).astype(jnp.bfloat16), dsum,
            preferred_element_type=jnp.float32).reshape(-1)
        return out[:n_in]

    @jax.jit
    def _sb(st, wre_r, wim_r):
        if decimate > 1:
            wre, wim = _boxcar(wre_r), _boxcar(wim_r)
        else:
            wre, wim = wre_r, wim_r
        return br.run_superblock(cfg, cfg.superblock, bits3x, st, wre, wim)

    if cfg.superblock > 1:
        return (lambda st: _sb(st, wre_raw, wim_raw)), state, signal_s
    return (lambda st: br.run_block_batched(
        cfg, bits3x, st, wre_raw, wim_raw)), state, signal_s


def time_rtf(step, state, signal_s: float, n_steps: int) -> float:
    """Real-time factor of ``n_steps`` steps after a compile + warm-up."""
    import jax

    st, out = step(state)
    jax.block_until_ready((st, out))
    st, out = step(st)
    jax.block_until_ready((st, out))
    t0 = time.perf_counter()
    for _ in range(n_steps):
        st, out = step(st)
    jax.block_until_ready((st, out))
    return n_steps * signal_s / (time.perf_counter() - t0)


def bench_tracking(decimate=1):
    cfg = cruise_config(decimate)
    step, state, signal_s = cruise_step(cfg)
    rtf = time_rtf(step, state, signal_s, N_BLOCKS)
    return rtf, rtf * FS * N_CHANNELS


def bench_acquisition():
    import jax

    from sydr_tpu.ops import acquisition as acq
    from sydr_tpu.ops import fft as mmfft

    n = int(round(FS * 1e-3))
    rng = np.random.default_rng(0)
    coher, noncoh = 5, 10
    n_ch = min(N_CHANNELS, 12)
    iq_re = rng.standard_normal((n_ch, coher * noncoh * n)).astype(np.float32)
    iq_im = rng.standard_normal((n_ch, coher * noncoh * n)).astype(np.float32)
    k = np.stack([acq.code_fft_conj(i + 1, FS) for i in range(n_ch)])
    bins = acq.doppler_bins(5000, 100)
    plans = (mmfft.make_plan(n), mmfft.make_plan(n, inverse=True))

    # Device-resident inputs, matching bench_tracking: this times grid
    # compute, not the host link (in the receiver the samples are already
    # on device for tracking).
    iq_re, iq_im = jax.device_put(iq_re), jax.device_put(iq_im)
    k_re = jax.device_put(np.float32(k.real))
    k_im = jax.device_put(np.float32(k.imag))

    def run():
        d, ci, m, corr = acq.acquire(
            (iq_re, iq_im), (k_re, k_im), bins,
            sampling_frequency=FS, coherent=coher, non_coherent=noncoh,
            plans=plans,
        )
        return jax.block_until_ready(m)

    run()  # compile
    t0 = time.perf_counter()
    reps = 3
    for _ in range(reps):
        run()
    wall = (time.perf_counter() - t0) / reps
    grid_points = n_ch * len(bins) * n
    return grid_points / wall


def bench_reference_cpu():
    """Reference per-channel-ms EPL rate on this host's CPU.

    Uses the ACTUAL reference implementation (``/root/reference``'s
    vectorised ``sydr.dsp.tracking.EPL``) when that checkout is present;
    otherwise a faithful numpy re-implementation of the same operation
    (``sydr/dsp/tracking.py:92-116``).
    """
    try:
        import sys as _sys

        if "/root/reference" not in _sys.path:
            _sys.path.insert(0, "/root/reference")
        from sydr.dsp.tracking import EPL as _ref_epl
        from sydr.signal.gnsssignal import GenerateGPSGoldCode

        n = int(round(FS * 1e-3))
        rng = np.random.default_rng(0)
        iq = (rng.standard_normal(n) + 1j * rng.standard_normal(n))
        code = GenerateGPSGoldCode(1)
        code1025 = np.r_[code[-1], code, code[0]].astype(np.float64)

        def epl_ms():
            return _ref_epl(
                rfData=iq, code=code1025, samplingFrequency=FS,
                carrierFrequency=1500.0, remainingCarrier=0.5,
                remainingCode=0.2, codeStep=1.023e6 / FS,
                correlatorsSpacing=(-0.5, 0.0, 0.5))

        epl_ms()
        t0 = time.time()
        reps = 50
        for _ in range(reps):
            epl_ms()
        return 1e-3 / ((time.time() - t0) / reps)
    except Exception:
        pass
    from sydr_tpu.signal import cacode

    n = int(round(FS * 1e-3))
    rng = np.random.default_rng(0)
    sig_re = rng.standard_normal(n)
    sig_im = rng.standard_normal(n)
    code_padded = cacode.padded_code(1).astype(np.float64)
    code_step = 1.023e6 / FS
    t = np.arange(n) / FS

    def epl_ms():
        phase = -2.0 * np.pi * 1500.0 * t + 0.5
        replica = np.exp(1j * phase)
        mixed = replica * (sig_re + 1j * sig_im)
        out = []
        for sp in (-0.5, 0.0, 0.5):
            idx = np.ceil(sp + np.arange(n) * code_step).astype(np.int64)
            chips = code_padded[np.clip(idx, 0, 1024)]
            out.append(np.sum(chips * mixed.real))
            out.append(np.sum(chips * mixed.imag))
        return out

    epl_ms()
    t0 = time.time()
    reps = 50
    for _ in range(reps):
        epl_ms()
    per_ms = (time.time() - t0) / reps
    # Reference RTF for N_CHANNELS channels, one process per channel would be
    # core-parallel; charge it the single-core rate per channel as the
    # reference does per process (optimistic for the reference: assumes
    # N_CHANNELS idle cores).
    ref_rtf = 1e-3 / per_ms
    return ref_rtf


def bench_parity():
    """Pre-measurement numeric gate: production-path parity.

    Runs the 4-block closed-loop superblock parity case
    (tools/chip_parity.production_parity) on the measured pass-B path and
    reports parity_metric / parity_ok in the JSON line, so a miscompiled
    kernel can never publish a plausible-but-corrupt RTF.
    """
    if os.environ.get("BENCH_PARITY", "1") != "1":
        return {"parity_ok": None}
    try:
        from tools.chip_parity import production_parity

        return production_parity(use_pallas=use_pallas_default())
    except Exception as e:  # parity infra failure is itself a red flag
        return {"parity_ok": False,
                "parity_error": f"{type(e).__name__}: {str(e)[:200]}"}


def main():
    from sydr_tpu.utils import compile_cache

    compile_cache.enable()
    threading.Thread(target=_watchdog, daemon=True).start()
    RESULT.update(_device_fields())
    RESULT["pallas"] = use_pallas_default()

    def st_parity():
        RESULT.update(bench_parity())

    def st_decimated():
        rtf, sps = bench_tracking(decimate=DECIMATE)
        # headline value: front-end boxcar decimation (the device consumes
        # the full FS stream inside the timed step; accuracy budget in
        # tests/test_decimate.py).
        RESULT["value"] = round(rtf, 3)
        RESULT["samples_per_s"] = round(sps, 1)

    def st_ref_cpu():
        RESULT["reference_cpu_rtf_per_channel"] = round(
            bench_reference_cpu(), 3)
        if RESULT.get("value"):
            RESULT["vs_baseline"] = round(
                RESULT["value"] / RESULT["reference_cpu_rtf_per_channel"], 3)

    def st_acq():
        RESULT["acq_grid_points_per_s"] = round(bench_acquisition(), 1)

    def st_fullrate():
        if DECIMATE > 1:
            RESULT["rtf_fullrate"] = round(bench_tracking(decimate=1)[0], 3)
        else:
            RESULT["rtf_fullrate"] = RESULT.get("value")

    # Worst-case stage estimates assume COLD compiles; with the persistent
    # compile cache warm they finish far faster.
    _run_stage("parity", 30.0, st_parity)
    if RESULT.get("parity_ok") is False:
        _DONE.set()
        _emit_json()
        raise SystemExit(4)
    _run_stage("tracking_decimated", 60.0, st_decimated)
    _run_stage("reference_cpu", 12.0, st_ref_cpu)
    _run_stage("acquisition", 45.0, st_acq)
    _run_stage("tracking_fullrate", 45.0, st_fullrate)
    _DONE.set()
    _emit_json()
    raise SystemExit(_exit_code())


if __name__ == "__main__":
    main()
