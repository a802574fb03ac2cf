"""Receiver infrastructure tests: config, checkpoint/resume, reacquisition,
report generation, atmosphere models."""

import dataclasses
import os

import numpy as np
import pytest

from sydr_tpu.channels.runtime import TrackingConfig
from sydr_tpu.receiver.checkpoint import load_checkpoint, save_checkpoint
from sydr_tpu.receiver.receiver import Receiver, ReceiverConfig
from sydr_tpu.signal.synthetic import IQGenerator

FS = 4e6


def _cfg(**kw):
    return ReceiverConfig(
        prns=(5, 12),
        tracking=TrackingConfig(sampling_frequency=FS, block_ms=20,
                                tail_ms=4, window_size=4224),
        tropo_enabled=False,
        **kw,
    )


def _gen(seed=11, cn0=46.0):
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, 200)
    gen = IQGenerator(FS, noise=True, seed=seed)
    gen.add_satellite(5, doppler_hz=1200.0, code_phase_chips=321.4,
                      cn0_dbhz=cn0, nav_bits=bits)
    gen.add_satellite(12, doppler_hz=-2600.0, code_phase_chips=811.9,
                      cn0_dbhz=cn0, nav_bits=bits)
    return gen


def test_config_ini_reference_format(tmp_path):
    chan = tmp_path / "chan.ini"
    chan.write_text(
        "[ACQUISITION]\ndoppler_range = 4000\ndoppler_steps = 200\n"
        "coherent_integration = 4\nnon_coherent_integration = 8\n"
        "threshold = 1.8\n"
        "[TRACKING]\ncorrelator_early = -0.4\ncorrelator_prompt = 0\n"
        "correlator_late = 0.4\ndll_noise_bandwidth = 2.0\n"
        "pll_noise_bandwidth = 12.0\n"
    )
    ini = tmp_path / "receiver.ini"
    ini.write_text(
        "[DEFAULT]\nname = TEST\nms_to_process = 5000\n"
        "outfolder = /tmp/x\napprox_position_x = 1.0\n"
        "approx_position_y = 2.0\napprox_position_z = 3.0\n"
        "reference_position_x = 10.0\nreference_position_y = 20.0\n"
        "reference_position_z = 30.0\n"
        "[RFSIGNAL]\nfilepath = /data/iq.bin\nsampling_frequency = 5e6\n"
        "intermediate_frequency = 0.0\ndata_size = 16\nis_complex = true\n"
        "[SATELLITES]\ninclude_prn = 2,3,4\n"
        "[MEASUREMENTS]\nfrequency = 2\npseudorange = True\ndoppler = True\n"
        f"[CHANNELS]\ngps_l1ca = {chan}\n"
    )
    from sydr_tpu import config as cfgmod

    rc = cfgmod.load(str(ini))
    assert rc.name == "TEST"
    assert rc.ms_to_process == 5000
    assert rc.rf_filepath == "/data/iq.bin"
    assert rc.rf_data_size == 16
    assert rc.receiver.prns == (2, 3, 4)
    assert rc.receiver.tracking.sampling_frequency == 5e6
    assert rc.receiver.tracking.spacings == (-0.4, 0.0, 0.4)
    assert rc.receiver.tracking.dll_bandwidth == 2.0
    assert rc.receiver.tracking.pll_bandwidth == 12.0
    assert rc.receiver.acquisition.doppler_step == 200
    assert rc.receiver.acquisition.threshold == 1.8
    assert rc.receiver.measurement_period_ms == 500
    assert rc.reference_position == (10.0, 20.0, 30.0)
    assert rc.measurements_enabled["doppler"]


def test_config_yaml(tmp_path):
    y = tmp_path / "rx.yaml"
    y.write_text(
        "sampling_frequency: 4e6\n"
        "prns: [5, 12]\n"
        "tracking:\n  block_ms: 10\n  profile: kaplan\n"
        "acquisition:\n  doppler_range: 6000\n"
        "receiver:\n  measurement_period_ms: 2000\n"
        "run:\n  name: yamltest\n  ms_to_process: 1234\n"
    )
    from sydr_tpu import config as cfgmod

    rc = cfgmod.load(str(y))
    assert rc.receiver.tracking.block_ms == 10
    assert rc.receiver.tracking.profile == "kaplan"
    assert rc.receiver.acquisition.doppler_range == 6000
    assert rc.receiver.measurement_period_ms == 2000
    assert rc.ms_to_process == 1234
    assert rc.name == "yamltest"


def test_checkpoint_resume_bit_identical(tmp_path):
    """Resumed receiver must produce identical downstream outputs."""
    gen_a = _gen()
    rx_a = Receiver(_cfg())
    for _ in range(60):  # 1200 ms
        rx_a.process_ms(gen_a.generate_ms(20))
    ckpt = str(tmp_path / "state.npz")
    save_checkpoint(rx_a, ckpt)

    # Continue original.
    tail_a = []
    for _ in range(30):
        rx_a.process_ms(gen_a.generate_ms(20))
        tail_a.append(rx_a.last_outputs)

    # Fresh receiver + restore; feed identical signal continuation.
    gen_b = _gen()
    _ = gen_b.generate_ms(1200)  # advance generator to the checkpoint
    rx_b = Receiver(_cfg())
    load_checkpoint(rx_b, ckpt)
    tail_b = []
    for _ in range(30):
        rx_b.process_ms(gen_b.generate_ms(20))
        tail_b.append(rx_b.last_outputs)

    for oa, ob in zip(tail_a, tail_b):
        np.testing.assert_array_equal(oa["i_prompt"], ob["i_prompt"])
        np.testing.assert_array_equal(oa["flags"], ob["flags"])
        np.testing.assert_array_equal(oa["carrier_freq"], ob["carrier_freq"])
    for ca, cb in zip(rx_a.channels, rx_b.channels):
        assert ca.n_codes == cb.n_codes
        assert ca.bits_pushed == cb.bits_pushed
        assert ca.tow_ref == cb.tow_ref


def test_reacquisition_on_lock_loss():
    """Signal vanishes -> C/N0 collapses -> channel resets to ACQUIRING."""
    from sydr_tpu.channels.state import MODE_ACQUIRING

    cfg = _cfg(reacq_cn0_threshold=30.0, reacq_low_cn0_s=0.5,
               reacq_dead_s=0.5, reacq_warmup_codes=1000)
    rx = Receiver(cfg)
    gen = _gen()
    for _ in range(100):  # 2 s with signal
        rx.process_ms(gen.generate_ms(20))
    assert all(m == 2 for m in rx.session.mode_host)  # tracking

    # Replace the signal with pure noise.
    rng = np.random.default_rng(0)
    spms = rx.cfg.tracking.samples_per_ms
    for _ in range(100):
        noise = (rng.standard_normal(20 * spms)
                 + 1j * rng.standard_normal(20 * spms)) * np.sqrt(0.5)
        rx.process_ms(noise.astype(np.complex64))
        if any(m == MODE_ACQUIRING for m in rx.session.mode_host):
            break
    assert any(m == MODE_ACQUIRING for m in rx.session.mode_host), \
        "no channel was reset after losing the signal"


def test_report_generation(tmp_path):
    cfg = _cfg(database_path=str(tmp_path / "run.db"))
    rx = Receiver(cfg)
    gen = _gen()
    for _ in range(40):
        rx.process_ms(gen.generate_ms(20))
    rx.db.add("position", {"tow": 1.0, "sample": 1, "x": 2795125.0,
                           "y": 1236112.0, "z": 5579646.0,
                           "clock_bias": 10.0, "n_satellites": 5,
                           "gdop": 2.0})
    rx.db.add("position", {"tow": 2.0, "sample": 2, "x": 2795126.0,
                           "y": 1236113.0, "z": 5579645.0,
                           "clock_bias": 11.0, "n_satellites": 5,
                           "gdop": 2.1,
                           "vx": 0.1, "vy": -0.2, "vz": 0.05,
                           "clock_drift": 0.4})
    rx.timers.store(rx.db)
    from sydr_tpu.io.report import generate_report

    out = generate_report(rx.db, str(tmp_path / "report.html"),
                          reference_position=(2795125.165, 1236112.5,
                                              5579646.0))
    text = open(out).read()
    assert "Acquisition" in text
    assert "Tracking" in text
    assert "Position" in text
    assert "base64" in text
    # Map tab (geodetic track + OSM link) and per-stage timing table
    # (reference visualisation.py:643-879).
    assert "openstreetmap.org" in text
    assert "<h3>Map</h3>" in text
    assert "Processing time" in text and "track_block" in text
    # round-5 panels: 3-D correlation surface, solved velocity/drift
    assert "Correlation surface" in text
    assert "<h3>Velocity</h3>" in text and "clock drift" in text
    assert os.path.getsize(out) > 50_000  # embedded figures
    rx.db.close()


def test_layered_logging(tmp_path):
    """Reference-style layered logging (logger.py:22-30): DEBUG file +
    INFO console; fileConfig ini applies verbatim."""
    import logging

    from sydr_tpu.utils.logconfig import configure_logging

    logfile = configure_logging(out_folder=str(tmp_path), color=False)
    log = logging.getLogger("sydr_tpu.test.layered")
    log.debug("file-only detail")
    log.info("console+file info")
    for h in logging.getLogger().handlers:
        h.flush()
    text = open(logfile).read()
    assert "file-only detail" in text          # DEBUG reaches the file
    assert "console+file info" in text
    assert "| sydr_tpu.test.layered" in text   # reference-format columns

    ini = tmp_path / "logging.ini"
    ini.write_text(f"""[loggers]
keys=root

[handlers]
keys=fileHandler

[formatters]
keys=mformatter

[logger_root]
level=DEBUG
handlers=fileHandler

[handler_fileHandler]
class=FileHandler
level=DEBUG
formatter=mformatter
args=('{tmp_path}/custom.log', 'w')

[formatter_mformatter]
format=%(levelname)s :: %(message)s
""")
    configure_logging(config_path=str(ini))
    logging.getLogger("x").debug("via fileconfig")
    for h in logging.getLogger().handlers:
        h.flush()
    assert "DEBUG :: via fileconfig" in open(tmp_path / "custom.log").read()
    # restore a sane default for the rest of the suite
    configure_logging(color=False)


def test_atmosphere_models():
    from sydr_tpu.nav import atmosphere

    # Zenith tropo ~2.3-2.5 m at sea level; grows at low elevation.
    z = atmosphere.tropo_delay_collins(np.deg2rad(90), np.deg2rad(45), 0.0)
    assert 2.0 < z < 3.0
    low = atmosphere.tropo_delay_collins(np.deg2rad(5), np.deg2rad(45), 0.0)
    assert low > 5 * z
    # Height reduces the delay.
    high = atmosphere.tropo_delay_collins(np.deg2rad(90), np.deg2rad(45),
                                          3000.0)
    assert high < z

    # Klobuchar with typical broadcast coefficients: metres-level, positive.
    alpha = (1.1176e-8, 7.4506e-9, -5.9605e-8, -5.9605e-8)
    beta = (90112.0, 0.0, -196610.0, -65536.0)
    d = atmosphere.iono_delay_klobuchar(
        np.deg2rad(40), np.deg2rad(210), np.deg2rad(40), np.deg2rad(260),
        50700.0, alpha, beta)
    assert 1.0 < d < 40.0


def test_agnss_rinex_config_wiring(tmp_path):
    """INI -> RINEX assisted ephemerides -> receiver, through the real CLI."""
    import sydr_tpu.config as config_mod
    from sydr_tpu.io import rinex
    from sydr_tpu.main import main as cli_main
    from sydr_tpu.signal.synthetic import IQGenerator
    from tests.test_lnav import make_eph

    fs = 2e6
    eph = make_eph()
    nav_path = str(tmp_path / "brdc.rnx")
    rinex.write_nav(nav_path, [eph])

    gen = IQGenerator(fs, noise=True, seed=9)
    gen.add_satellite(eph.prn, doppler_hz=800.0, cn0_dbhz=48.0)
    rf_path = str(tmp_path / "iq.bin")
    gen.write_file(rf_path, 400, dtype="int8")

    ini = tmp_path / "receiver.ini"
    ini.write_text(f"""
[DEFAULT]
name = agnss_test
ms_to_process = 400
outfolder = {tmp_path}/out
approx_position_x = 2795100.0
approx_position_y = 1236100.0
approx_position_z = 5579600.0

[RFSIGNAL]
filepath = {rf_path}
sampling_frequency = 2e6
intermediate_frequency = 0.0
data_size = 8
is_complex = true

[SATELLITES]
include_prn = {eph.prn}

[AGNSS]
agnss_enabled = True
clock = 2021-11-30 08:39:06
broadcast_ephemeris_path = {nav_path}
""")

    run_cfg = config_mod.load(str(ini))
    assert run_cfg.agnss_enabled
    assert run_cfg.agnss_ephemeris_path == nav_path

    rc = cli_main(["--config", str(ini), "--cpu", "--no-dashboard",
                   "--no-report"])
    assert rc == 0
    db_file = tmp_path / "out" / "agnss_test.db"
    assert db_file.exists()

    # The CLI path replaces assisted_ephemerides from the RINEX file;
    # verify the same wiring yields a usable ephemeris for the channel.
    from sydr_tpu.io.rinex import load_assisted_ephemerides
    from sydr_tpu.receiver.receiver import Receiver

    assisted = load_assisted_ephemerides(nav_path)
    cfg2 = dataclasses.replace(run_cfg.receiver,
                               assisted_ephemerides=assisted)
    rx = Receiver(cfg2)
    got = rx.ephemeris_for(0)
    assert got is not None and got.prn == eph.prn and got.complete


def test_failed_acquisition_retries_with_backoff():
    """Noise-only start: below-threshold searches re-arm and eventually
    succeed once the satellite signal appears (regression: one noisy
    window used to disable the channel permanently)."""
    from sydr_tpu.channels.state import MODE_ACQUIRING, MODE_TRACKING

    rng = np.random.default_rng(3)
    cfg = _cfg()
    rx = Receiver(cfg)
    spms = rx.cfg.tracking.samples_per_ms

    # 120 ms of pure noise: enough history for a (failing) first search.
    for _ in range(6):
        noise = (rng.standard_normal(20 * spms)
                 + 1j * rng.standard_normal(20 * spms)) * np.sqrt(0.5)
        rx.process_ms(noise.astype(np.complex64))
    assert all(m == MODE_ACQUIRING for m in rx.session.mode_host)
    assert rx.session._acq_retry_at, "failed search did not arm a retry"

    gen = _gen()
    for _ in range(40):  # signal appears; retries should lock both PRNs
        rx.process_ms(gen.generate_ms(20))
        if all(m == MODE_TRACKING for m in rx.session.mode_host):
            break
    assert all(m == MODE_TRACKING for m in rx.session.mode_host)


def test_agnss_header_iono_clock_and_measurements(tmp_path):
    """RINEX header GPSA/GPSB -> Klobuchar auto-enable; AGNSS clock seeds
    the receiver clock; MEASUREMENTS doppler toggle maps to enable_doppler
    (reference RINEXNav.py:47-59, receiver_gps_l1ca.py:68-71)."""
    import sydr_tpu.config as config_mod
    from sydr_tpu.io import rinex
    from sydr_tpu.nav.gpstime import GpsTime
    from tests.test_lnav import make_eph

    alpha = (1.1176e-08, -7.4506e-09, -5.9605e-08, 1.1921e-07)
    beta = (116480.0, -16384.0, -327680.0, 65536.0)
    nav_path = str(tmp_path / "brdc.rnx")
    rinex.write_nav(nav_path, [make_eph()],
                    header=rinex.NavHeader(iono_alpha=alpha, iono_beta=beta))

    hdr = rinex.read_header(nav_path)
    assert hdr.has_klobuchar
    np.testing.assert_allclose(hdr.iono_alpha, alpha, rtol=1e-3)
    np.testing.assert_allclose(hdr.iono_beta, beta, rtol=1e-3)

    clock_str = "2021-11-30 08:39:06"
    run_cfg = config_mod.RunConfig(
        receiver=_cfg(),
        agnss_enabled=True,
        agnss_clock=clock_str,
        agnss_ephemeris_path=nav_path,
        measurements_enabled={"pseudorange": True, "doppler": False},
    )
    run_cfg = config_mod.apply_agnss(run_cfg)
    rcfg = run_cfg.receiver
    assert rcfg.iono_enabled
    np.testing.assert_allclose(rcfg.iono_alpha, alpha, rtol=1e-3)
    np.testing.assert_allclose(rcfg.iono_beta, beta, rtol=1e-3)
    assert rcfg.assisted_ephemerides and 7 in rcfg.assisted_ephemerides
    assert not rcfg.enable_doppler
    expect_tow = GpsTime.from_string(clock_str).seconds
    assert rcfg.assisted_clock_tow == pytest.approx(expect_tow)

    # The receiver consumes the assisted clock as its time at sample 0.
    rx = Receiver(rcfg)
    assert rx.clock_tow == pytest.approx(expect_tow)


def test_rinex_mixed_constellation_read(tmp_path):
    """Galileo records are readable (tagged system='E'); GPS-only loaders
    skip them (reference RINEXNav.py:85-136 parses both)."""
    from sydr_tpu.io import rinex
    from tests.test_lnav import make_eph

    nav_path = str(tmp_path / "mixed.rnx")
    rinex.write_nav(nav_path, [make_eph()])
    # Append a Galileo record with the same Keplerian block shape.
    with open(nav_path) as fh:
        lines = fh.read().splitlines()
    rec = [ln for ln in lines if ln.startswith("G07")][0]
    body_at = lines.index(rec)
    gal = ["E11" + rec[3:]] + lines[body_at + 1: body_at + 8]
    with open(nav_path, "a") as fh:
        fh.write("\n".join(gal) + "\n")

    gps_only = rinex.read_nav(nav_path)
    assert [e.prn for e in gps_only] == [7]
    both = rinex.read_nav(nav_path, systems=("G", "E"))
    assert {(e.system, e.prn) for e in both} == {("G", 7), ("E", 11)}
    gal_eph = [e for e in both if e.system == "E"][0]
    assert gal_eph.iodc == 0 and gal_eph.sqrt_a == pytest.approx(5153.672)


def test_device_acquisition_ring_mirrors_host_history():
    """The device-resident acquisition ring must hold the same samples the
    host history does (modulo the int8 upload quantisation), since PCPS
    cold start reads the ring instead of re-uploading the history."""
    from sydr_tpu.channels.runtime import TrackingConfig
    from sydr_tpu.receiver.session import AcquisitionConfig, TrackingSession

    fs = 4e6
    cfg = TrackingConfig(sampling_frequency=fs, block_ms=20, tail_ms=4,
                         window_size=4224, runtime="batch", superblock=2)
    acq_cfg = AcquisitionConfig(coherent=2, non_coherent=3,
                                threshold=1e9)  # never hand off
    session = TrackingSession(cfg, [5], acq_cfg)
    rng = np.random.default_rng(0)
    chunk = cfg.superblock * cfg.block_ms * cfg.samples_per_ms
    for _ in range(3):
        re = rng.standard_normal(chunk).astype(np.float32)
        im = rng.standard_normal(chunk).astype(np.float32)
        session.process_block(re, im)
    ring = np.asarray(session._ring_re)
    hist = session._hist_re
    assert ring.shape == hist.shape
    # Sample-exact alignment (any offset would decorrelate noise samples).
    assert np.corrcoef(ring, hist)[0, 1] > 0.999
    # Values differ only by the int8 upload quantisation; the scale is
    # per-block over the whole window, so bound with 2x the history LSB.
    lsb = np.max(np.abs(hist)) / 120.0
    np.testing.assert_allclose(ring, hist, atol=2.0 * lsb)


def test_reset_channel_demotes_to_pullin():
    """A reacquisition while promoted must drop the session back to the
    pull-in shape: a fresh acquisition carries up to +-(doppler_step/2)
    of carrier error, outside the cruise Costas loop's pull range (the
    round-4 soak's PRN 6 parked in a ~19 Hz half-bit-rate alias when
    handed straight to cruise; tools/false_lock_probe.py)."""
    import dataclasses

    pull_in = TrackingConfig(sampling_frequency=FS, block_ms=5, tail_ms=4,
                             window_size=4224, runtime="batch",
                             profile="kaplan")
    cruise = dataclasses.replace(pull_in, profile="borre", block_ms=20,
                                 superblock=5)
    cfg = ReceiverConfig(prns=(5, 12), tracking=pull_in,
                         cruise_tracking=cruise, tropo_enabled=False)
    rx = Receiver(cfg)
    sess = rx.session
    sess._promote()
    assert sess.promoted and sess.cfg.profile == "borre"

    sess.reset_channel(0)
    assert not sess.promoted
    assert sess.cfg.profile == "kaplan" and sess.cfg.block_ms == 5
    assert sess._stable_blocks == 0
    assert sess.mode_host[0] == 1  # MODE_ACQUIRING


def test_rinex_obs_export_cli_path(tmp_path):
    """DB measurement rows -> RINEX 3.04 obs file -> read_obs round trip
    (the main.py --rinex-obs export path)."""
    from sydr_tpu.io.database import ResultDatabase
    from sydr_tpu.io.rinex_obs import export_from_database, read_obs

    db = ResultDatabase(str(tmp_path / "m.db"))
    for tow, prn, pr, dop in ((100.0, 5, 21000123.4, 1200.5),
                              (100.0, 12, 22000456.7, -2600.25),
                              (101.0, 5, 21000321.9, 1201.0)):
        db.add("measurement", {"tow": tow, "channel_id": 0, "prn": prn,
                               "mtype": "pseudorange", "value": pr,
                               "raw_value": pr, "residual": 0.0})
        db.add("measurement", {"tow": tow, "channel_id": 0, "prn": prn,
                               "mtype": "doppler", "value": dop,
                               "raw_value": dop, "residual": 0.0})
    db.commit()
    path = str(tmp_path / "run.obs")
    n = export_from_database(db, path)
    assert n == 2
    back = read_obs(path)
    assert len(back) == 2
    first = back[0]
    assert abs(first["obs"][5]["C1C"] - 21000123.4) < 1e-3
    assert abs(first["obs"][12]["D1C"] + 2600.25) < 1e-3
    db.close()


def test_carrier_phase_observable_continuity():
    """L1C (cycles): anchored to pr/lambda at arc start, advanced by
    -integrated-Doppler (RINEX sign: dL/dt = -D1C), re-anchored on a
    Hatch-filter restart (cycle slip)."""
    from sydr_tpu.constants import GPS_L1CA_CARRIER_FREQ, SPEED_OF_LIGHT

    rx = Receiver(_cfg())
    lam = SPEED_OF_LIGHT / GPS_L1CA_CARRIER_FREQ

    rx._phase_cycles[0] = 1000.0
    pr1 = 21_000_000.0
    s1 = rx._smooth_pseudorange(0, pr1)
    l1 = rx._carrier_phase_obs(0, s1)
    assert l1 == pytest.approx(s1 / lam)

    # range decreases by exactly the carrier advance (+ 0.8 m code noise):
    # the phase observable must fall by exactly the cycle count, with the
    # code noise absent from the delta (cycle-count continuity).
    rx._phase_cycles[0] += 1500.25
    pr2 = pr1 - 1500.25 * lam + 0.8
    s2 = rx._smooth_pseudorange(0, pr2)
    l2 = rx._carrier_phase_obs(0, s2)
    assert l2 - l1 == pytest.approx(-1500.25, abs=1e-9)

    # a >30 m raw-vs-predicted gap restarts the Hatch filter AND the arc
    rx._phase_cycles[0] += 10.0
    pr3 = pr2 - 10.0 * lam + 100.0
    s3 = rx._smooth_pseudorange(0, pr3)
    l3 = rx._carrier_phase_obs(0, s3)
    assert rx._smooth[0][2] == 1  # filter restarted
    assert l3 == pytest.approx(s3 / lam)

    # channel reset drops the anchor entirely
    rx._l1c_anchor and rx._l1c_anchor.pop(0)
    assert 0 not in rx._l1c_anchor


def test_dashboard_rich_render():
    """Per-channel colored live display (reference enlightengui.py:67-155):
    state badge, C/N0 meter, TOW badge, subframe 1-5 cells."""
    import io

    from sydr_tpu.receiver.dashboard import Dashboard

    rx = Receiver(_cfg())
    buf = io.StringIO()
    dash = Dashboard(rx, stream=buf, force=True)
    n_bl = rx.cfg.tracking.block_ms
    out = {
        "cn0": np.full((n_bl, 2), 43.0),
        "carrier_freq": np.full((n_bl, 2), 1200.0),
        "flags": np.zeros((n_bl, 2), dtype=np.int64),
    }
    rx.channels[0].subframes_seen.update({1, 2})
    rx.channels[0].tow_ref = 302406.0
    dash.update(out)
    text = buf.getvalue()
    assert "\x1b[" in text                      # ANSI styling present
    assert "G05" in text and "G12" in text      # both channels
    assert "TOW 302406" in text                 # decoded TOW badge
    assert "dB-Hz" in text
    # five subframe cells rendered per channel
    assert text.count("\x1b[97;42m1\x1b[0m") == 1   # sf1 green on ch0 only
    assert text.count("\x1b[97;41m4\x1b[0m") == 2   # sf4 red on both
    dash.close()


def test_report_without_matplotlib(tmp_path, monkeypatch):
    """Without matplotlib the report keeps its tables and statistics."""
    import sys

    from sydr_tpu.io.database import ResultDatabase
    from sydr_tpu.io.report import generate_report

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    db = ResultDatabase(str(tmp_path / "r.db"))
    db.add("acquisition", {"prn": 5, "doppler": 1200.0, "code_index": 77,
                           "metric": 3.2})
    for k in range(3):
        db.add("position", {"tow": 1.0 + k, "sample": k,
                            "x": 2795125.0 + k, "y": 1236112.0,
                            "z": 5579646.0, "clock_bias": 10.0,
                            "n_satellites": 5, "gdop": 2.0,
                            "vx": 0.1, "vy": 0.0, "vz": 0.0,
                            "clock_drift": 0.0})
    db.add("timing", {"stage": "track_block", "count": 1, "mean_ms": 1.0,
                      "max_ms": 1.0, "total_s": 0.001})
    db.commit()
    out = generate_report(db, str(tmp_path / "report.html"),
                          reference_position=(2795125.0, 1236112.0,
                                              5579646.0))
    text = open(out).read()
    assert "matplotlib is not installed" in text
    assert "base64" not in text
    assert "<td>G05</td>" in text and "<td>3D</td>" in text
    assert "<h3>Velocity</h3>" in text
    db.close()


def test_config_yaml_without_pyyaml(tmp_path, monkeypatch):
    """A YAML config without PyYAML names the .ini alternative."""
    import sys

    from sydr_tpu import config as cfgmod

    y = tmp_path / "rx.yaml"
    y.write_text("sampling_frequency: 4e6\n")
    monkeypatch.setitem(sys.modules, "yaml", None)
    with pytest.raises(ImportError, match=r"\.ini"):
        cfgmod.load(str(y))
