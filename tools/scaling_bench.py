"""Multi-device scaling checks on a virtual 8-device CPU mesh.

The production tracking runtime shards channel-wise over a ``ch`` mesh axis
with NO collectives (``parallel/mesh.make_sharded_batch_step``): every
device runs the complete runtime on its channel shard with the sample
window replicated. On such a program the n-device step time IS the
1-device step time at ``n_ch / n`` channels — there is no cross-device
edge that could break that equality. This tool checks the argument on the
compiler's output and records host-side overheads:

  1. **Collective census** — compile the ch-sharded production step for
     8 devices and count communication ops in the optimized HLO
     (all-gather / all-reduce / collective-permute / all-to-all).
     Expected 0: linear-by-construction, verified at the compiler level.
     The sp (time-axis) path is compiled too and must show exactly its
     designed collectives (1 all-gather + 1 psum→all-reduce per block).
  2. **Sharding overhead** — wall time of the 1-shard sharded step vs the
     plain unsharded step (same device count): the cost of the shard_map
     machinery itself. Expected ~1.0x.
  3. **Wall curves** over 1..8 shards, strong (32 ch total) and weak
     (8 ch/shard). These run 8 virtual devices on the host's cores — the
     wall ceiling is the host's, not the sharding's; the curves are
     recorded for overhead inspection, not as an efficiency claim.

The 4-card comparison on real GPUs is ``chip_smoke.py --four-cards``.

Usage:
  python tools/scaling_bench.py [--json-out FILE]
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
import time

_here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _here)

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=8")

import numpy as np  # noqa: E402

def _count_collectives(hlo_text: str) -> dict:
    """Occurrences of communication ops in optimized HLO, by kind.

    Only *instruction definitions* count (lines like ``%all-gather.3 =``
    or ``all-gather-start``), not metadata mentions.
    """
    out: dict[str, int] = {}
    # instruction form: `%name = type KIND(...)` — the KIND (not the JAX-
    # derived instruction name) identifies the communication op
    op_re = re.compile(
        r"= \S+ (all-gather|all-reduce|collective-permute|all-to-all|"
        r"reduce-scatter)(?:-start)?\(")
    for line in hlo_text.splitlines():
        m = op_re.search(line)
        if m:
            out[m.group(1)] = out.get(m.group(1), 0) + 1
    return out


def _tracking_setup(fs, n_channels, superblock, *, use_pallas=False,
                    quantize=True, block_ms=20, decimate=1, seed=0):
    import jax.numpy as jnp

    from sydr_tpu.channels import batch_runtime as br
    from sydr_tpu.channels.runtime import TrackingConfig
    import __graft_entry__ as g

    fs_trk = fs / decimate
    cfg = TrackingConfig(
        sampling_frequency=fs_trk, block_ms=block_ms, tail_ms=4,
        window_size=int(round(fs_trk * 1e-3)) + 256, runtime="batch",
        use_pallas=use_pallas, superblock=superblock,
        quantize_spacing=quantize,
        input_decimate=decimate, pass_a="closed",
        profile="kaplan",   # the production cruise profile (round 5)
        kaplan_narrow_only=True,
    )
    _, state, _, _ = g._tracking_inputs(cfg, n_channels, seed=seed)
    prns = [(k % 32) + 1 for k in range(n_channels)]
    bits3x = jnp.asarray(br.tiled_code_bits(prns))
    rng = np.random.default_rng(seed + 1)
    n_in = (cfg.tail_ms + superblock * cfg.block_ms) * cfg.samples_per_ms
    wre = jnp.asarray(rng.standard_normal(n_in * decimate).astype(np.float32))
    wim = jnp.asarray(rng.standard_normal(n_in * decimate).astype(np.float32))
    return cfg, bits3x, state, wre, wim


# --------------------------------------------------------------------------
# CPU-mesh sections
# --------------------------------------------------------------------------
def cpu_mesh_sections(fs=2.046e6, n_channels=32, superblock=5,
                      reps=5) -> dict:
    import jax

    jax.config.update("jax_platforms", "cpu")
    import functools

    import jax.numpy as jnp

    from sydr_tpu.channels import batch_runtime as br
    from sydr_tpu.parallel import mesh as pmesh

    assert len(jax.devices()) >= 8, jax.devices()
    out: dict = {"fs": fs, "n_channels": n_channels,
                 "superblock": superblock,
                 "host_physical_cores": os.cpu_count()}

    cfg, bits3x, state, wre, wim = _tracking_setup(
        fs, n_channels, superblock)

    @functools.partial(jax.jit)
    def plain(st, wre, wim):
        return br.run_superblock(cfg, superblock, bits3x, st, wre, wim)

    def timeit(fn, st, *args):
        st2, _ = fn(st, *args)
        jax.block_until_ready(st2)
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            st2, _ = fn(st, *args)
            jax.block_until_ready(st2)
            ts.append(time.perf_counter() - t0)
        return min(ts)

    signal_s = superblock * cfg.block_ms * 1e-3

    # ---- strong scaling + 1-shard overhead -------------------------------
    strong = {}
    census = None
    steps = {}
    for n in (1, 2, 4, 8):
        mesh = pmesh.make_mesh(n_ch_shards=n, n_dop_shards=1,
                               devices=jax.devices()[:n])
        shard_ch, repl = pmesh.batch_shardings(mesh)
        step = pmesh.make_sharded_batch_step(cfg, mesh, k_blocks=superblock)
        stp = jax.tree_util.tree_map(
            lambda x: jax.device_put(x, shard_ch), state)
        b = jax.device_put(bits3x, shard_ch)
        wr = jax.device_put(wre, repl)
        wi = jax.device_put(wim, repl)
        if n == 8 and census is None:
            hlo = step.lower(b, stp, wr, wi).compile().as_text()
            census = _count_collectives(hlo)
        steps[n] = (step, b, stp, wr, wi)
        tn = timeit(lambda st, wr, wi: step(b, st, wr, wi), stp, wr, wi)
        strong[n] = {"step_s": round(tn, 4),
                     "rtf": round(signal_s / tn, 2)}
    # 1-shard overhead: INTERLEAVE plain and sharded-1 dispatches (wall
    # noise on this shared host runs ~±20%, so back-to-back loops lie;
    # alternating pairs see the same host state)
    step1, b1, st1, wr1, wi1 = steps[1]
    t_pl, t_s1 = [], []
    for _ in range(max(5, reps)):
        t0 = time.perf_counter()
        s2, _ = plain(state, wre, wim)
        jax.block_until_ready(s2)
        t_pl.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        s2, _ = step1(b1, st1, wr1, wi1)
        jax.block_until_ready(s2)
        t_s1.append(time.perf_counter() - t0)
    t_plain = min(t_pl)
    out["unsharded_step_s"] = round(t_plain, 4)
    out["sharding_overhead_1shard"] = round(min(t_s1) / t_plain, 3)
    out["strong_scaling_wall"] = strong
    out["ch_collectives_in_hlo_8dev"] = census or {}
    out["ch_collectives_total"] = int(sum((census or {}).values()))

    # ---- weak scaling (8 ch / shard) -------------------------------------
    weak = {}
    for n in (1, 2, 4, 8):
        n_ch = 8 * n
        cfg_w, b3, st_w, wre_w, wim_w = _tracking_setup(
            fs, n_ch, superblock)
        mesh = pmesh.make_mesh(n_ch_shards=n, n_dop_shards=1,
                               devices=jax.devices()[:n])
        shard_ch, repl = pmesh.batch_shardings(mesh)
        step = pmesh.make_sharded_batch_step(cfg_w, mesh,
                                             k_blocks=superblock)
        stp = jax.tree_util.tree_map(
            lambda x: jax.device_put(x, shard_ch), st_w)
        b = jax.device_put(b3, shard_ch)
        wr = jax.device_put(wre_w, repl)
        wi = jax.device_put(wim_w, repl)
        tn = timeit(lambda st, wr, wi: step(b, st, wr, wi), stp, wr, wi)
        weak[n] = {"n_channels": n_ch, "step_s": round(tn, 4),
                   "channel_s_per_s": round(n_ch * signal_s / tn, 2)}
    out["weak_scaling_wall"] = weak

    # ---- sp (time-axis) path: designed collectives census ---------------
    from sydr_tpu.parallel import timeshard

    sp_mesh = timeshard.make_sp_mesh(8)
    n_ms = cfg.tail_ms + cfg.block_ms  # 24 ms / 8 shards = 3 ms each
    cfg_sp, b3, st_sp, wre_sp, wim_sp = _tracking_setup(
        fs, 8, 1, block_ms=n_ms - cfg.tail_ms)
    lowered = timeshard.run_block_batched_timesharded.lower(
        cfg_sp, sp_mesh, b3, st_sp,
        wre_sp[: n_ms * cfg_sp.samples_per_ms],
        wim_sp[: n_ms * cfg_sp.samples_per_ms])
    sp_census = _count_collectives(lowered.compile().as_text())
    out["sp_collectives_in_hlo_8dev"] = sp_census
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--json-out", default=None,
                   help="merge results into this JSON file")
    p.add_argument("--fs", type=float, default=None)
    p.add_argument("--superblock", type=int, default=None)
    args = p.parse_args(argv)
    from sydr_tpu.utils import compile_cache

    compile_cache.enable()

    kw = {}
    if args.fs:
        kw["fs"] = args.fs
    if args.superblock:
        kw["superblock"] = args.superblock
    res = {"cpu_mesh": cpu_mesh_sections(**kw)}

    print(json.dumps(res, indent=1))
    if args.json_out:
        merged = {}
        if os.path.exists(args.json_out):
            with open(args.json_out) as fh:
                merged = json.load(fh)
        merged.update(res)
        with open(args.json_out, "w") as fh:
            json.dump(merged, fh, indent=1)
            fh.write("\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
