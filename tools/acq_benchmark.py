"""Monte-Carlo acquisition benchmarking: Pd / Pfa / estimate errors vs C/N0.

The reference advertises itself as "a controlled environment for testing new
processing algorithms, for benchmarking purposes" and its legacy analysis
module rendered per-satellite acquisition metric tables
(``/root/reference/sydr/old/analysis.py:21-110``). This tool is the
benchmark-grade version of that capability: for a grid of C/N0 values and
integration settings it runs repeated randomized trials of the production
PCPS pipeline (``sydr_tpu.ops.acquisition.acquire``) against the synthetic
signal generator, and reports

  * detection probability Pd  (metric above threshold AND the peak within
    tolerance of the injected Doppler / code phase),
  * false-alarm probability Pfa on signal-absent trials at the same
    threshold,
  * mean / p10 of the two-peak metric,
  * RMS Doppler and code-phase estimation error on detected trials.

Trials are batched on the channel axis so one ``acquire`` call evaluates a
whole batch — the same batching the receiver uses for parallel cold starts.

Usage:
  python tools/acq_benchmark.py                       # default sweep, JSON+table
  python tools/acq_benchmark.py --cn0 33 36 39 42 \
      --trials 32 --coherent 5 --non-coherent 10 --fs 10e6
  python tools/acq_benchmark.py --out docs/acq_benchmark.md
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

sys.path.insert(0, ".")

GPS_L1CA_CODE_FREQ = 1.023e6
CODE_CHIPS = 1023


def run_config(
    *,
    prn: int,
    cn0_dbhz: float | None,
    trials: int,
    sampling_frequency: float,
    coherent: int,
    non_coherent: int,
    doppler_range: float,
    doppler_step: float,
    seed: int,
    threshold: float,
    plans=None,
    nav_bits: bool = False,
) -> dict:
    """One (C/N0, settings) cell. ``cn0_dbhz=None`` = signal-absent (Pfa).

    ``nav_bits=True`` modulates each trial's satellite with random LNAV data
    bits at a random bit phase (a random integer number of code periods is
    added to the code phase, which shifts the 20-ms bit grid without moving
    the correlation peak), so coherent integration straddles real data-bit
    transitions — the realistic (slightly harder) condition near threshold.
    The default (no bits) measures the bit-transition-free upper bound.
    """
    from sydr_tpu.ops import acquisition as acq
    from sydr_tpu.signal.synthetic import IQGenerator

    rng = np.random.default_rng(seed)
    n_ms = coherent * non_coherent
    spc = round(sampling_frequency * 1e-3)

    true_dop = rng.uniform(-doppler_range * 0.9, doppler_range * 0.9, trials)
    true_chips = rng.uniform(0.0, CODE_CHIPS, trials)

    iq = np.empty((trials, n_ms * spc), dtype=np.complex64)
    for k in range(trials):
        gen = IQGenerator(sampling_frequency, noise=True,
                          seed=int(rng.integers(1 << 31)))
        if cn0_dbhz is not None:
            bits = None
            phase = float(true_chips[k])
            if nav_bits:
                bits = rng.integers(0, 2, 64)
                # whole code periods shift the bit grid, not the peak
                phase += CODE_CHIPS * int(rng.integers(0, 20))
            gen.add_satellite(prn, doppler_hz=float(true_dop[k]),
                              code_phase_chips=phase,
                              cn0_dbhz=float(cn0_dbhz), nav_bits=bits)
        iq[k] = gen.generate_ms(n_ms)

    kf = acq.code_fft_conj(prn, sampling_frequency)
    code_ffts = np.broadcast_to(kf, (trials, kf.shape[-1]))
    bins = acq.doppler_bins(doppler_range, doppler_step)

    t0 = time.perf_counter()
    doppler, code_idx, metric, _ = acq.acquire(
        iq, code_ffts, bins,
        sampling_frequency=sampling_frequency,
        coherent=coherent, non_coherent=non_coherent, plans=plans)
    doppler = np.asarray(doppler, dtype=np.float64)
    code_idx = np.asarray(code_idx, dtype=np.float64)
    metric = np.asarray(metric, dtype=np.float64)
    wall = time.perf_counter() - t0

    out = {
        "cn0_dbhz": cn0_dbhz,
        "trials": trials,
        "coherent": coherent,
        "non_coherent": non_coherent,
        "metric_mean": float(metric.mean()),
        "metric_p10": float(np.percentile(metric, 10)),
        "wall_s": round(wall, 3),
    }
    if cn0_dbhz is None:
        out["pfa"] = float((metric >= threshold).mean())
        return out

    # The injected code phase is where the code stream starts at sample 0,
    # so the correlation peak sits at the sample index of the NEXT code
    # start. samples/chip is fractional in general — use the true ratio
    # (tests/test_acquisition.py:31 pins the same convention).
    n = kf.shape[-1]
    spchip = sampling_frequency / GPS_L1CA_CODE_FREQ
    exp_idx = (n - true_chips * spchip) % n
    didx = np.abs((code_idx - exp_idx + n / 2) % n - n / 2)
    ddop = np.abs(doppler - true_dop)
    correct = (didx <= 1.5 * spchip) & (ddop <= doppler_step)
    detected = (metric >= threshold) & correct
    out["pd"] = float(detected.mean())
    out["p_correct_peak"] = float(correct.mean())
    if detected.any():
        out["doppler_rms_hz"] = float(
            np.sqrt(np.mean((doppler - true_dop)[detected] ** 2)))
        out["code_rms_chips"] = float(np.sqrt(np.mean(
            (didx[detected] / spchip) ** 2)))
    return out


def render_table(rows: list[dict], threshold: float) -> str:
    lines = [
        f"| C/N0 [dB-Hz] | coh x noncoh | Pd | metric mean | metric p10 |"
        f" Doppler RMS [Hz] | code RMS [chips] |",
        "|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        if r["cn0_dbhz"] is None:
            continue
        lines.append(
            f"| {r['cn0_dbhz']:.0f} | {r['coherent']}x{r['non_coherent']} "
            f"| {r['pd']:.2f} | {r['metric_mean']:.2f} "
            f"| {r['metric_p10']:.2f} "
            f"| {r.get('doppler_rms_hz', float('nan')):.1f} "
            f"| {r.get('code_rms_chips', float('nan')):.3f} |")
    absent = [r for r in rows if r["cn0_dbhz"] is None]
    if absent:
        nt = absent[0]["trials"]
        hits = int(round(absent[0]["pfa"] * nt))
        lines.append(
            f"\nSignal-absent: Pfa = {hits}/{nt} trials at threshold "
            f"{threshold} (rule-of-three 95% upper bound ≈ "
            f"{3.0 / nt:.3f} when 0 observed).")
    return "\n".join(lines)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--prn", type=int, default=7)
    p.add_argument("--cn0", type=float, nargs="+",
                   default=[33.0, 36.0, 39.0, 42.0, 45.0])
    p.add_argument("--trials", type=int, default=32)
    p.add_argument("--fs", type=float, default=4e6)
    p.add_argument("--coherent", type=int, default=5)
    p.add_argument("--non-coherent", type=int, default=10)
    p.add_argument("--doppler-range", type=float, default=5000.0)
    p.add_argument("--doppler-step", type=float, default=100.0)
    p.add_argument("--threshold", type=float, default=1.5)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--no-pfa", action="store_true")
    p.add_argument("--nav-bits", action="store_true",
                   help="modulate trials with random data bits at random "
                        "bit phase (realistic near-threshold condition)")
    p.add_argument("--cpu", action="store_true",
                   help="force the CPU backend")
    p.add_argument("--out", help="also write the markdown table here")
    args = p.parse_args(argv)
    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")

    from sydr_tpu.utils import compile_cache

    compile_cache.enable()

    n = round(args.fs * 1e-3)
    from sydr_tpu.ops import fft as mmfft
    plans = (mmfft.make_plan(n), mmfft.make_plan(n, inverse=True))

    def cell(cn0, seed):
        return run_config(
            prn=args.prn, cn0_dbhz=cn0, trials=args.trials,
            sampling_frequency=args.fs, coherent=args.coherent,
            non_coherent=args.non_coherent,
            doppler_range=args.doppler_range,
            doppler_step=args.doppler_step,
            seed=seed, threshold=args.threshold, plans=plans,
            nav_bits=args.nav_bits)

    # Warm-up at the sweep shape so no row's wall_s pays JIT compile
    # (advisor round-4: the first row's timing was compile-dominated).
    cell(None, args.seed + 10_000_000)

    rows = []
    for cn0 in args.cn0:
        # Per-point seed derives from the C/N0 VALUE (not list position):
        # re-running any documented subset reproduces the recorded numbers.
        r = cell(float(cn0), args.seed + int(round(cn0 * 10)))
        rows.append(r)
        print(json.dumps(r), flush=True)
    if not args.no_pfa:
        r = cell(None, args.seed + 1000)
        rows.append(r)
        print(json.dumps(r), flush=True)

    table = render_table(rows, args.threshold)
    print("\n" + table)
    if args.out:
        cmd = "python tools/acq_benchmark.py " + " ".join(
            a for a in (argv if argv is not None else sys.argv[1:])
            if a != "--out" and a != args.out
            and not a.startswith("--out="))
        with open(args.out, "w") as fh:
            fh.write("# Acquisition benchmark\n\n"
                     f"PRN {args.prn}, fs {args.fs/1e6:g} Msps, grid "
                     f"±{args.doppler_range:.0f} Hz @ {args.doppler_step:.0f} "
                     f"Hz, {args.trials} trials/point"
                     + (", random nav bits at random bit phase"
                        if args.nav_bits else
                        ", no nav-bit modulation (transition-free bound)")
                     + f".\n\nExact command: `{cmd}`\n\n" + table + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
