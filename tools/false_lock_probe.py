"""Attribute a stuck channel: tracked code/carrier vs scenario truth.

Runs the soak configuration for a few seconds, then for every channel
computes the stream position of its latest code boundary (the
``_transmit_time_at`` geometry) and evaluates the TRUTH code phase of its
own satellite at that instant — a healthy lock reads ~0 (mod 1023)
chips; a code-offset false lock reads the offset directly; a cross-PRN
lock shows a large offset plus a tracked Doppler matching a different
satellite.

Usage: python tools/false_lock_probe.py [--seconds 8] [--cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

_here = os.path.dirname(os.path.abspath(__file__))
_repo = os.path.dirname(_here)
if _repo not in sys.path:
    sys.path.insert(0, _repo)

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seconds", type=int, default=8)
    ap.add_argument("--fs", type=float, default=10e6)
    ap.add_argument("--decimate", type=int, default=4)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--seed", type=int, default=3)
    args = ap.parse_args(argv)
    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")

    from sydr_tpu.utils import compile_cache

    compile_cache.enable()

    from sydr_tpu.channels.runtime import TrackingConfig
    from sydr_tpu.constants import (
        GPS_L1CA_CARRIER_FREQ, GPS_L1CA_CODE_FREQ)
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
        runtime="batch", profile="kaplan", block_ms=5, superblock=1,
        quantize_spacing=True,
    )
    cruise_cfg = dataclasses.replace(
        pull_in, profile="kaplan", kaplan_narrow_only=True, block_ms=20, superblock=25)
    rcfg = ReceiverConfig(
        prns=tuple(e.prn for e in sats),
        tracking=pull_in, cruise_tracking=cruise_cfg,
        approx_position=tuple(rx_truth + 1000.0),
        assisted_ephemerides={e.prn: e for e in sats},
        tropo_enabled=False,
    )
    receiver = Receiver(rcfg)

    done = 0
    while done < args.seconds * 1000:
        receiver.process_ms(scn.generate_ms(1000))
        done += 1000

    snapshot = receiver._state_snapshot()
    out = receiver.last_outputs
    truth = scn.truth_state(t0 + done * 1e-3)
    tmap = {s["prn"]: s for s in truth}
    total = receiver.session.total_samples
    for i, ch in enumerate(receiver.channels):
        unread = int(snapshot["unread"][i])
        rem_code = float(snapshot["rem_code"][i])
        carrier = float(snapshot["carrier_freq"][i])
        delta = float(snapshot["code_freq_offset"][i]) + carrier * (
            GPS_L1CA_CODE_FREQ / GPS_L1CA_CARRIER_FREQ)
        step = (GPS_L1CA_CODE_FREQ + delta) / fs_trk
        p = (total - unread) - rem_code / step
        t_p = t0 + p / fs_trk
        sat = next(s for s in scn.sats if s.eph.prn == ch.prn)
        code_phase, _ = scn._phase_at(sat, t_p)
        off = float(np.mod(code_phase, 1023.0))
        off = off if off < 511.5 else off - 1023.0
        cn0 = float(np.asarray(out["cn0"])[-1, i]) if out is not None else 0
        print(json.dumps({
            "prn": ch.prn,
            "cn0": round(cn0, 1),
            "tracked_doppler": round(carrier, 1),
            "truth_doppler": round(tmap[ch.prn]["doppler"], 1),
            "code_offset_chips": round(off, 3),
            "nearest_other_doppler": round(min(
                (s["doppler"] for s in truth if s["prn"] != ch.prn),
                key=lambda d: abs(d - carrier)), 1),
        }), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
