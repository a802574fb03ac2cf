"""Per-op device-time profile of the cruise tracking step.

Runs the bench's cruise superblock step (``bench.cruise_step``) under
``jax.profiler`` and aggregates per-op device durations from the trace,
normalised to milliseconds per second of processed signal, plus the
device's busy share of the traced step's wall time (union of the leaf-op
intervals on the device planes).

Usage: python tools/trace_profile.py [fused|dense ...]
       (BENCH_DECIMATE, BENCH_CHANNELS, ... as for bench.py)
"""
import glob
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

PATHS = sys.argv[1:] or ["fused", "dense"]
_WRAPPERS = ("%while", "jit_", "jit(", "%call", "%conditional")


def device_ops(trace_dir):
    """(per-op totals, control-flow wrapper totals, busy ns) of a trace.

    Control-flow WRAPPER events (``%while...``, ``jit_...``, ``%call``,
    ``%conditional``) span their whole body, whose leaf ops are emitted as
    separate events — counting both double-counts every op inside a scan,
    so wrappers are excluded from the totals and returned separately. Set
    TRACE_DUMP=1 to print the plane / line structure.
    """
    import jax

    paths = glob.glob(os.path.join(
        trace_dir, "plugins/profile/*/*.xplane.pb"))
    assert paths, trace_dir
    data = jax.profiler.ProfileData.from_file(paths[-1])
    totals, wrappers, spans = {}, {}, []
    for plane in data.planes:
        if "/device:" not in plane.name:
            continue
        if os.environ.get("TRACE_DUMP") == "1":
            print(f"plane: {plane.name}")
            for line in plane.lines:
                print(f"  line: {line.name} "
                      f"({sum(1 for _ in line.events)} events)")
        for line in plane.lines:
            for ev in line.events:
                ns = ev.duration_ns
                if ns <= 0:
                    continue
                wrapper = ev.name.startswith(_WRAPPERS)
                d = wrappers if wrapper else totals
                d[ev.name] = d.get(ev.name, 0.0) + ns * 1e-6
                if not wrapper:
                    spans.append((ev.start_ns, ev.start_ns + ns))
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return (sorted(totals.items(), key=lambda kv: -kv[1]),
            sorted(wrappers.items(), key=lambda kv: -kv[1]), busy)


def main():
    import jax

    import bench
    from sydr_tpu.utils import compile_cache

    compile_cache.enable()
    print("devices:", jax.devices(), flush=True)
    for path in PATHS:
        cfg = bench.cruise_config(bench.DECIMATE,
                                  use_pallas=(path == "fused"))
        step, state, sig_s = bench.cruise_step(cfg)
        st, out = step(state)            # compile + warm
        st, out = step(st)
        jax.block_until_ready((st, out))
        with tempfile.TemporaryDirectory() as td:
            jax.profiler.start_trace(td)
            t0 = time.perf_counter()
            st, out = step(st)
            jax.block_until_ready((st, out))
            wall = time.perf_counter() - t0
            jax.profiler.stop_trace()
            ops, wrappers, busy_ns = device_ops(td)
        total = sum(ms for _, ms in ops)
        print(f"\n=== {path}, decimate {bench.DECIMATE} "
              f"({sig_s:.1f} s of signal; traced wall {wall:.3f} s, "
              f"device busy {busy_ns * 1e-9 / wall:.3f} of it) ===")
        print(f"device op total: {total / sig_s:8.2f} ms/s "
              f"(RTF-limit {1000 * sig_s / total:6.1f})")
        for name, ms in ops[:int(os.environ.get("TRACE_TOP", "14"))]:
            print(f"  {ms / sig_s:8.2f} ms/s  {name[:90]}")
        if wrappers:
            print("  -- control-flow wrappers (span their bodies; "
                  "excluded from the total) --")
            for name, ms in wrappers[:4]:
                print(f"  {ms / sig_s:8.2f} ms/s  {name[:90]}")
        jax.clear_caches()


if __name__ == "__main__":
    main()
