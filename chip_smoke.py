"""Smoke test of the receiver on one CUDA GPU, through its user entry points.

    python chip_smoke.py                 # phases 1-5 on one card
    python chip_smoke.py --four-cards    # phase 6 only, on four cards

Phases (every one must pass; nothing is caught):

1. device      — JAX must see GPUs; prints the card's name and power limit.
2. parity      — one open-loop block at 32 channels, 10 and 2.5 Msps, in the
                 quantised narrow kaplan and the borre tap shapes: the fused
                 correlator on the card against the XLA dense pass on the
                 host CPU, max|err| <= 1e-3 * rms(prompt); then the 4-block
                 closed-loop production gate (tools/chip_parity.py).
3. acquisition — 12 channels x 101 Doppler bins x 10,000 code phases, 5x10
                 integration, synthetic satellites at 45 dB-Hz: peak bin and
                 code index equal a float64 numpy FFT reference, two-peak
                 metric within 1%; grid points/s of the matmul-DFT shift map
                 and of the same map on jnp.fft.
4. tracking    — the bench's cruise step (32 ch, 10 Msps, decimate 4, narrow
                 kaplan, 20 ms blocks, superblock 50): real-time factor of
                 1 s of signal for the fused correlator and the dense pass,
                 at decimate 4 and at full rate.
5. end to end  — ``python -m sydr_tpu --demo`` for 20 s of 10 Msps signal:
                 position fixes within 10 m of the reference position.
6. four cards  — the channel-sharded cruise step with 128 channels over a
                 4-card mesh must equal the same channels on one card bit for
                 bit.

The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
``--only a,b`` runs a subset of phases 1-5 (development).
"""

import argparse
import contextlib
import dataclasses
import io
import json
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import numpy as np  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from sydr_tpu.channels import batch_runtime as br  # noqa: E402
from sydr_tpu.channels.runtime import TrackingConfig  # noqa: E402
from sydr_tpu.channels.state import MODE_TRACKING, init_state  # noqa: E402
from sydr_tpu.utils import compile_cache  # noqa: E402

N_CH = 32
PARITY_BOUND = 1e-3          # max|err| / rms(prompt)
ACQ_METRIC_RTOL = 0.01
FIX_ERROR_M = 10.0


def log(msg: str) -> None:
    print(msg, flush=True)


# --------------------------------------------------------------------------
# 1. device
# --------------------------------------------------------------------------
def phase_device(n_cards: int = 1):
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"no GPU: JAX sees {devs}")
    if len(devs) < n_cards:
        raise SystemExit(f"need {n_cards} GPUs, JAX sees {len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    log(f"card: {smi}")
    log(f"jax devices: {len(devs)} x {devs[0].device_kind}")


# --------------------------------------------------------------------------
# 2. correlator parity
# --------------------------------------------------------------------------
def _parity_block(fs: float, seed: int = 11):
    """32-channel tracking state + 24 ms window with 32 satellites."""
    from sydr_tpu.signal.synthetic import IQGenerator

    rng = np.random.default_rng(seed)
    prns = list(range(1, N_CH + 1))
    dops = rng.uniform(-4500.0, 4500.0, N_CH)
    gen = IQGenerator(fs, noise=True, seed=seed)
    for prn, dop in zip(prns, dops):
        gen.add_satellite(prn, doppler_hz=dop,
                          code_phase_chips=rng.uniform(0, 1023),
                          cn0_dbhz=45.0)
    spms = round(fs * 1e-3)
    iq = gen.generate_ms(24)
    state = dataclasses.replace(
        init_state(N_CH),
        mode=jnp.full((N_CH,), MODE_TRACKING, jnp.int32),
        carrier_freq=jnp.asarray(np.float32(dops)),
        rem_code=jnp.asarray(np.float32(rng.uniform(-0.5, 0.9, N_CH))),
        rem_carrier=jnp.asarray(np.float32(rng.uniform(0, 6.28, N_CH))),
        code_freq_offset=jnp.asarray(np.float32(rng.uniform(-2, 2, N_CH))),
        unread=jnp.asarray(np.int32(rng.integers(spms, 3 * spms, N_CH))),
    )
    return (br.tiled_code_bits(prns), state,
            np.float32(iq.real), np.float32(iq.imag))


@jax.jit(static_argnums=0)
def _geometry(cfg, state):
    """Pass A epoch geometry + pass-B phase anchors of one block."""
    geo = br._pass_a(cfg, state)
    return geo, br.block_geometry(cfg, state, geo)


@jax.jit(static_argnums=0)
def _correlate(cfg, bits, state, geo, bg, wre, wim):
    """Pass-B correlators ``[block_ms, n_ch, n_streams]`` of one block."""
    return br.correlate(cfg, bits, state, geo, bg, wre, wim)


def parity_case(fs: float, shape: str) -> float:
    """Fused correlator on the card vs the dense pass on the host CPU.

    Both are fed the card's epoch geometry and anchors: computed on two
    backends, those differ in the last f32 bits, which moves a ceil() tie
    (one sample's epoch or one chip) now and then — printed apart as the
    whole-path difference. The gate is on the correlator alone.
    """
    base = dict(sampling_frequency=fs, block_ms=20, tail_ms=4,
                window_size=round(fs * 1e-3) + 256, runtime="batch")
    if shape == "kaplan":
        base.update(profile="kaplan", kaplan_narrow_only=True,
                    quantize_spacing=True)
    else:
        base.update(profile="borre")
    dense, fused = TrackingConfig(**base), TrackingConfig(
        **base, use_pallas=True)
    bits, state, wre, wim = _parity_block(fs)
    gpu, cpu = jax.devices()[0], jax.devices("cpu")[0]
    g_args = jax.device_put((bits, state, wre, wim), gpu)
    geo, bg = _geometry(dense, g_args[1])
    got = np.asarray(_correlate(fused, g_args[0], g_args[1], geo, bg,
                                *g_args[2:]))
    c_args = jax.device_put((bits, state, wre, wim), cpu)
    ref = np.asarray(_correlate(dense, c_args[0], c_args[1],
                                *jax.device_put((geo, bg), cpu),
                                *c_args[2:]))
    ref_cpu_geo = np.asarray(_correlate(
        dense, c_args[0], c_args[1], *_geometry(dense, c_args[1]),
        *c_args[2:]))
    rms_p = float(np.sqrt(np.mean(ref[..., 2] ** 2 + ref[..., 3] ** 2)))
    err = float(np.max(np.abs(got - ref))) / rms_p
    err_path = float(np.max(np.abs(got - ref_cpu_geo))) / rms_p
    log(f"parity {shape} {fs / 1e6:g} Msps: fused max|err|/rms(prompt) = "
        f"{err:.3e} (bound {PARITY_BOUND:g}; rms prompt {rms_p:.1f}); "
        f"with the CPU's own geometry {err_path:.3e}")
    if not err <= PARITY_BOUND:
        raise SystemExit(f"correlator parity failed: {err:.3e}")
    return err


def phase_parity():
    from tools.chip_parity import PARITY_BOUNDS, production_parity

    for fs in (10e6, 2.5e6):
        for shape in ("kaplan", "borre"):
            parity_case(fs, shape)
    res = production_parity(use_pallas=True)
    log(f"production gate: metric={res['parity_metric']:.4g} "
        f"(<= {PARITY_BOUNDS['parity_metric']}) "
        f"scaled={res['parity_scaled']:.4g} "
        f"(<= {PARITY_BOUNDS['parity_scaled']}) "
        f"prompt_ratio={res['prompt_ratio']:.6f} "
        f"(in {PARITY_BOUNDS['prompt_ratio']})")
    if not res["parity_ok"]:
        raise SystemExit("production parity gate failed")


# --------------------------------------------------------------------------
# 3. acquisition
# --------------------------------------------------------------------------
ACQ_FS = 10e6
ACQ_COH, ACQ_NONCOH = 5, 10


def _acq_signal(n_ch: int, seed: int = 5):
    from sydr_tpu.signal.synthetic import IQGenerator

    rng = np.random.default_rng(seed)
    n_ms = ACQ_COH * ACQ_NONCOH
    iq = []
    for ch in range(n_ch):
        gen = IQGenerator(ACQ_FS, noise=True, seed=seed + ch)
        gen.add_satellite(ch + 1, doppler_hz=rng.uniform(-4800, 4800),
                          code_phase_chips=rng.uniform(0, 1023),
                          cn0_dbhz=45.0)
        iq.append(gen.generate_ms(n_ms))
    return np.stack(iq)


def _acq_reference(iq, prns, bins):
    """Float64 numpy PCPS map, straight from the definition."""
    n = round(ACQ_FS * 1e-3)
    t = np.arange(ACQ_COH * n) / ACQ_FS
    out = np.empty((len(prns), len(bins), n))
    from sydr_tpu.ops import acquisition as acq

    for c, prn in enumerate(prns):
        k = acq.code_fft_conj(prn, ACQ_FS)
        blocks = iq[c].astype(np.complex128).reshape(ACQ_NONCOH, ACQ_COH * n)
        for b, f in enumerate(bins):
            mixed = (blocks * np.exp(-2j * np.pi * f * t)).reshape(
                ACQ_NONCOH, ACQ_COH, n)
            spec = np.fft.fft(mixed, axis=-1).sum(axis=1)
            out[c, b] = np.abs(np.fft.ifft(spec * k, axis=-1)).sum(axis=0)
    return out


def _shift_map_fft(iq, code_k, *, phases, bin_shifts):
    """``acquisition.pcps_shift_map`` with jnp.fft on complex64."""
    n_ch, n = code_k.shape
    blocks = iq.reshape(n_ch, ACQ_NONCOH, ACQ_COH, n)
    t = (jnp.arange(ACQ_COH * n, dtype=jnp.float32) / ACQ_FS).reshape(
        ACQ_COH, n)
    spectra = [jnp.sum(jnp.fft.fft(
        blocks * jnp.exp(-2j * jnp.pi * f_p * t).astype(jnp.complex64),
        axis=-1), axis=2) for f_p in phases]               # [ch, nc, n]
    k_all = jnp.stack([jnp.roll(code_k, k, axis=-1) for k, _ in bin_shifts])
    s_all = jnp.stack([spectra[p] for _, p in bin_shifts])  # [bins, ch, nc, n]
    corr = jnp.fft.ifft(s_all * k_all[:, :, None, :], axis=-1)
    return jnp.transpose(jnp.sum(jnp.abs(corr), axis=2), (1, 0, 2))


def _rate(fn, points: int, reps: int = 3) -> float:
    jax.block_until_ready(fn())
    t0 = time.perf_counter()
    for _ in range(reps):
        jax.block_until_ready(fn())
    return points * reps / (time.perf_counter() - t0)


def phase_acquisition(n_ch: int = 12):
    from sydr_tpu.ops import acquisition as acq
    from sydr_tpu.ops import fft as mmfft

    n = round(ACQ_FS * 1e-3)
    prns = list(range(1, n_ch + 1))
    bins = acq.doppler_bins(5000, 100)
    iq = _acq_signal(n_ch)
    k = np.stack([acq.code_fft_conj(p, ACQ_FS) for p in prns])
    plans = (mmfft.make_plan(n), mmfft.make_plan(n, inverse=True))
    iq_re, iq_im, k_re, k_im = jax.device_put(
        (np.float32(iq.real), np.float32(iq.imag),
         np.float32(k.real), np.float32(k.imag)))

    def run():
        return acq.acquire((iq_re, iq_im), (k_re, k_im), bins,
                           sampling_frequency=ACQ_FS, coherent=ACQ_COH,
                           non_coherent=ACQ_NONCOH, plans=plans)

    dop, ci, metric, _ = run()
    ref_map = _acq_reference(iq, prns, bins)
    spc = round(ACQ_FS / 1.023e6)
    r_dop, r_ci, r_metric = acq.peak_metric(
        jnp.asarray(ref_map, jnp.float32), jnp.asarray(bins),
        samples_per_chip=spc)
    dop, ci, metric = map(np.asarray, (dop, ci, metric))
    r_dop, r_ci, r_metric = map(np.asarray, (r_dop, r_ci, r_metric))
    rel = np.abs(metric / r_metric - 1.0)
    log(f"acquisition: doppler {dop.tolist()} code index {ci.tolist()}")
    log(f"acquisition vs float64 reference: doppler equal "
        f"{int(np.sum(dop == r_dop))}/{n_ch}, code index equal "
        f"{int(np.sum(ci == r_ci))}/{n_ch}, max metric deviation "
        f"{float(rel.max()):.2e} (bound {ACQ_METRIC_RTOL})")
    if not (np.array_equal(dop, r_dop) and np.array_equal(ci, r_ci)
            and rel.max() <= ACQ_METRIC_RTOL):
        raise SystemExit("acquisition disagrees with the float64 reference")

    phases, bin_shifts = acq.shift_plan(bins, ACQ_FS, n)
    points = n_ch * len(bins) * n
    mm_rate = _rate(lambda: run()[2], points)
    iq_c = jax.device_put(iq.astype(np.complex64))
    k_c = jax.device_put(k.astype(np.complex64))
    fft_map = jax.jit(lambda x, kk: _shift_map_fft(
        x, kk, phases=phases, bin_shifts=bin_shifts))
    f_dop, f_ci, _ = acq.peak_metric(fft_map(iq_c, k_c), jnp.asarray(bins),
                                     samples_per_chip=spc)
    fft_rate = _rate(lambda: fft_map(iq_c, k_c), points)
    log(f"acquisition grid points/s: matmul-DFT shift map {mm_rate:.4g}, "
        f"jnp.fft shift map {fft_rate:.4g} (peaks equal: "
        f"{bool(np.array_equal(np.asarray(f_dop), r_dop) and np.array_equal(np.asarray(f_ci), r_ci))})")


# --------------------------------------------------------------------------
# 4. tracking at full width
# --------------------------------------------------------------------------
def phase_tracking():
    import bench

    for decimate in (4, 1):
        for use_pallas in (True, False):
            cfg = bench.cruise_config(decimate, use_pallas=use_pallas,
                                      n_channels=N_CH)
            step, state, signal_s = bench.cruise_step(cfg, N_CH)
            rtf = bench.time_rtf(step, state, signal_s, n_steps=1)
            log(f"tracking RTF, {N_CH} ch at {bench.FS / 1e6:g} Msps, "
                f"decimate {decimate}, "
                f"{'fused correlator' if use_pallas else 'dense pass'}: "
                f"{rtf:.2f}")


# --------------------------------------------------------------------------
# 5. end to end
# --------------------------------------------------------------------------
def phase_end_to_end():
    from sydr_tpu import main as cli

    out = os.path.join(HERE, ".results", "chip_smoke_demo")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["--demo", "--ms", "20000", "--fs", "10e6",
                       "--decimate", "4", "--pallas", "--superblock", "20",
                       "--no-dashboard", "--out", out])
    text = buf.getvalue()
    for line in text.splitlines():
        if line.startswith(("processed", "final fix", "error vs",
                            "no position fix")):
            log(f"demo: {line}")
    m = re.search(r"error vs reference position: ([0-9.]+) m", text)
    if rc != 0 or m is None or not float(m.group(1)) < FIX_ERROR_M:
        raise SystemExit(f"end-to-end demo failed (rc={rc})")


# --------------------------------------------------------------------------
# 6. four cards
# --------------------------------------------------------------------------
def phase_four_cards(n_ch: int = 128):
    import bench
    from sydr_tpu.parallel import mesh as pmesh

    cfg = bench.cruise_config(4, use_pallas=True, n_channels=n_ch)
    cfg = dataclasses.replace(cfg, superblock=10)
    _, state, _ = bench.cruise_step(cfg, n_ch)
    rng = np.random.default_rng(7)
    n_in = (cfg.tail_ms + cfg.superblock * cfg.block_ms) * cfg.samples_per_ms
    wre = np.float32(rng.standard_normal(n_in))
    wim = np.float32(rng.standard_normal(n_in))
    bits = br.tiled_code_bits([(k % 32) + 1 for k in range(n_ch)])
    results = []
    for devices in (jax.devices()[:1], jax.devices()[:4]):
        mesh = pmesh.make_mesh(n_ch_shards=len(devices), devices=devices)
        shard_ch, repl = pmesh.batch_shardings(mesh)
        step = pmesh.make_sharded_batch_step(cfg, mesh,
                                             k_blocks=cfg.superblock)
        st = jax.tree_util.tree_map(
            lambda x: jax.device_put(x, shard_ch), state)
        args = (jax.device_put(bits, shard_ch), st,
                jax.device_put(wre, repl), jax.device_put(wim, repl))
        out = step(*args)
        jax.block_until_ready(out)
        t0 = time.perf_counter()
        out = step(*args)
        jax.block_until_ready(out)
        dt = time.perf_counter() - t0
        log(f"{n_ch} ch sharded over {len(devices)} card(s): "
            f"{dt * 1e3:.1f} ms per {cfg.superblock * cfg.block_ms} ms "
            f"of signal")
        results.append(jax.tree_util.tree_map(np.asarray, out))
    leaves = zip(jax.tree_util.tree_leaves(results[0]),
                 jax.tree_util.tree_leaves(results[1]))
    n_diff = sum(int(np.sum(a != b)) for a, b in leaves)
    log(f"4-card vs 1-card outputs: {n_diff} differing values")
    if n_diff:
        raise SystemExit("channel-sharded outputs differ from one card")


PHASES = {"device": phase_device, "parity": phase_parity,
          "acquisition": phase_acquisition, "tracking": phase_tracking,
          "end_to_end": phase_end_to_end}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-card channel-sharded comparison")
    ap.add_argument("--only", default=",".join(PHASES),
                    help="comma-separated subset of phases 1-5")
    args = ap.parse_args()
    compile_cache.enable()
    t0 = time.time()
    if args.four_cards:
        phase_device(n_cards=4)
        phase_four_cards()
    else:
        phase_device()
        for name in args.only.split(","):
            if name != "device":
                t = time.time()
                PHASES[name]()
                log(f"[{name}: {time.time() - t:.1f} s]")
    log(f"[total {time.time() - t0:.1f} s]")
    devs = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)


if __name__ == "__main__":
    main()
