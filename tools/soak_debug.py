"""Per-fix forensics for a failed soak: error time series + channel events.

Runs the same receiver configuration as tools/soak.py but prints every
fix (time, ENU error split, bias) and WARNING-level channel events with
timestamps, so a bound violation can be attributed to a channel event
(reacquisition re-entry, smoothing reset) rather than guessed at.

Usage: python tools/soak_debug.py --seconds 90 [--cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import sys
import time

_here = os.path.dirname(os.path.abspath(__file__))
_repo = os.path.dirname(_here)
if _repo not in sys.path:
    sys.path.insert(0, _repo)

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seconds", type=int, default=90)
    ap.add_argument("--fs", type=float, default=10e6)
    ap.add_argument("--decimate", type=int, default=4)
    ap.add_argument("--pallas", action="store_true")
    ap.add_argument("--superblock", type=int, default=25)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--no-smoothing", action="store_true")
    ap.add_argument("--seed", type=int, default=3)
    args = ap.parse_args(argv)
    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")

    from sydr_tpu.utils import compile_cache

    compile_cache.enable()
    logging.basicConfig(
        level=logging.INFO,
        format="%(relativeCreated)8.0fms %(levelname)s %(message)s")

    from sydr_tpu.channels.runtime import TrackingConfig
    from sydr_tpu.receiver.receiver import Receiver, ReceiverConfig
    from sydr_tpu.signal.scenario import (
        DEMO_RX_TRUTH, Scenario, demo_ephemerides)

    rx_truth = np.asarray(DEMO_RX_TRUTH)
    t0, week = 302400.0, 2190
    sats = demo_ephemerides(t0, week)
    scn = Scenario(rx_truth, sats, t0, args.fs, cn0_dbhz=47.0,
                   seed=args.seed)

    fs_trk = args.fs / args.decimate
    pull_in = TrackingConfig(
        sampling_frequency=fs_trk, input_decimate=args.decimate,
        window_size=round(fs_trk * 1e-3) + 256,
        runtime="batch", use_pallas=args.pallas,
        profile="kaplan", block_ms=5, superblock=1,
        quantize_spacing=True,
    )
    cruise_cfg = dataclasses.replace(
        pull_in, profile="kaplan", kaplan_narrow_only=True, block_ms=20, superblock=args.superblock)
    rcfg = ReceiverConfig(
        prns=tuple(e.prn for e in sats),
        tracking=pull_in, cruise_tracking=cruise_cfg,
        approx_position=tuple(rx_truth + 1000.0),
        assisted_ephemerides={e.prn: e for e in sats},
        tropo_enabled=False,
    )
    if args.no_smoothing:
        rcfg = dataclasses.replace(rcfg, smoothing_time_s=0.0)
    receiver = Receiver(rcfg)

    total_ms = args.seconds * 1000
    done = 0
    n_seen = 0
    while done < total_ms:
        n = min(1000, total_ms - done)
        iq = scn.generate_ms(n)
        receiver.process_ms(iq)
        done += n
        if done % 10000 == 0:
            out = receiver.last_outputs
            rows = []
            for i, ch in enumerate(receiver.channels):
                cn0 = (float(np.asarray(out["cn0"])[-1, i])
                       if out is not None else None)
                pll = (float(np.asarray(out["pll_lock"])[-1, i])
                       if out is not None else None)
                rows.append({
                    "prn": ch.prn,
                    "cn0": round(cn0, 1) if cn0 else cn0,
                    "pll": round(pll, 2) if pll is not None else None,
                    "n_codes": ch.n_codes,
                    "bits": ch.bits_pushed,
                    "tow": ch.tow_ref is not None,
                    "sf": sorted(ch.subframes_seen),
                })
            print(json.dumps({"ms": done, "channels": rows}), flush=True)
        for f in receiver.fixes[n_seen:]:
            err = f.solution.position - rx_truth
            print(json.dumps({
                "t": round(f.tow, 3), "ms": done,
                "err_m": round(float(np.linalg.norm(err)), 3),
                "err_xyz": [round(float(v), 2) for v in err],
                "bias_m": round(float(f.solution.clock_bias_m), 1),
                "nsat": int(f.n_satellites),
                "prns": list(map(int, f.prns)),
                "resid_rms_m": round(float(np.sqrt(np.mean(
                    np.square(f.solution.residuals)))), 3),
            }), flush=True)
        n_seen = len(receiver.fixes)

    errs = np.array([
        np.linalg.norm(f.solution.position - rx_truth)
        for f in receiver.fixes])
    conv = errs[3:] if len(errs) > 6 else errs
    print(json.dumps({
        "n_fixes": len(errs),
        "mean": round(float(conv.mean()), 3),
        "max": round(float(conv.max()), 3),
    }), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
