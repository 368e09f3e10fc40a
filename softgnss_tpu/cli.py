"""Command-line driver: ``python -m softgnss_tpu.cli``.

Mirrors the reference's main.py behavior (banner, probe, full processing)
with real flags instead of edit-the-source configuration
(reference README.md:18-19): every ReceiverConfig field is overridable via
``--set key=value``, and a ``--synthetic`` mode runs the built-in golden
scenario since the reference's textbook recordings are not shipped.
"""

from __future__ import annotations

import argparse
import logging
import sys

import numpy as np

import softgnss_tpu
from softgnss_tpu.compile_cache import enable_compile_cache
from softgnss_tpu.config import ReceiverConfig, default_config, fast_config

BANNER = rf"""
softgnss_tpu v{softgnss_tpu.__version__} — GPS L1 C/A software receiver
  JAX/XLA implementation: batched FFT acquisition, scan-based
  multi-channel DLL/PLL tracking, nav decode, least-squares PVT.
"""


def _parse_value(raw: str):
    if "," in raw:
        return tuple(_parse_value(v) for v in raw.split(",") if v != "")
    for cast in (int, float):
        try:
            return cast(raw)
        except ValueError:
            pass
    if raw.lower() in ("true", "false"):
        return raw.lower() == "true"
    return raw


def build_config(args) -> ReceiverConfig:
    cfg = fast_config() if args.fast else default_config()
    overrides = {}
    for item in args.set or []:
        if "=" not in item:
            raise SystemExit(f"--set expects key=value, got {item!r}")
        key, raw = item.split("=", 1)
        if key not in ReceiverConfig.__dataclass_fields__:
            raise SystemExit(f"unknown config field {key!r}")
        overrides[key] = _parse_value(raw)
    if args.file:
        overrides["file_name"] = args.file
    if args.ms is not None:
        overrides["ms_to_process"] = args.ms
    return cfg.with_options(**overrides)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="softgnss_tpu", description="GPS L1 C/A software receiver (JAX)")
    parser.add_argument("--file", help="raw IF capture file")
    parser.add_argument("--synthetic", action="store_true",
                        help="run the built-in synthetic golden scenario")
    parser.add_argument("--fast", action="store_true",
                        help="start from the small fast_config instead of the "
                             "reference-parity default_config")
    parser.add_argument("--ms", type=int, help="milliseconds to process")
    parser.add_argument("--set", action="append", metavar="KEY=VALUE",
                        help="override any ReceiverConfig field")
    parser.add_argument("--probe", action="store_true", help="run the data-quality probe")
    parser.add_argument("--probe-only", action="store_true",
                        help="probe the capture and exit")
    parser.add_argument("--no-nav", action="store_true", help="skip the navigation stage")
    parser.add_argument("--plot", action="store_true",
                        help="render acquisition/tracking/navigation dashboards")
    parser.add_argument("--plot-dir", default=".", help="directory for saved plots")
    parser.add_argument("--checkpoint", help="tracking checkpoint .npz path")
    parser.add_argument("--mesh", metavar="TIMExCHANNEL",
                        help="distribute over a device mesh, e.g. '1x8' or '2x4'")
    parser.add_argument("--shard", choices=["channel", "time", "time-exact"],
                        default="channel",
                        help="tracking sharding strategy when --mesh is set")
    parser.add_argument("--stream", action="store_true",
                        help="software-pipeline tracking over time chunks "
                             "(overlap capture upload / compute / readback)")
    parser.add_argument("--ephemerides", metavar="NPZ",
                        help="warm start: per-PRN ephemeris set from a "
                             "previous run (--save-ephemerides); navigation "
                             "then needs ~8-15 s of capture (preamble-phase "
                             "dependent) instead of 36 s")
    parser.add_argument("--save-ephemerides", metavar="NPZ",
                        help="write the decoded per-PRN ephemeris set after "
                             "a successful navigation run")
    parser.add_argument("--cpu", action="store_true", help="force the CPU backend")
    parser.add_argument("-v", "--verbose", action="store_true")
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.DEBUG if args.verbose else logging.INFO,
                        format="%(levelname)s %(name)s: %(message)s")
    print(BANNER)

    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")
    enable_compile_cache()

    config = build_config(args)
    from softgnss_tpu import io as sio
    from softgnss_tpu.pipeline import run_receiver

    signal = None
    if args.synthetic:
        from softgnss_tpu.scenario import build_scenario, synthesize_scenario
        n_ms = config.ms_to_process + config.acquisition_ms + 2
        print(f"Synthesizing golden scenario ({n_ms} ms at "
              f"{config.sampling_freq / 1e6:.3f} Msps)...")
        scenario = build_scenario(config)
        signal = synthesize_scenario(scenario, n_ms)
        truth = scenario.receiver_ecef
        print(f"  injected receiver ECEF: {truth[0]:.1f} {truth[1]:.1f} {truth[2]:.1f}")
    elif not (args.file or config.file_name):
        parser.error("provide --file, --synthetic, or --set file_name=...")

    if args.probe_only:
        if signal is None:
            signal, config = sio.load_capture(
                args.file or config.file_name, config)
        stats = sio.probe_data(config, signal[config.skip_samples:])
        print(f"Probed {stats['n_samples']} samples: mean {stats['mean']:.3f}, "
              f"std {stats['std']:.2f}, clipped {100 * stats['clipped_fraction']:.2f}%")
        if args.plot:
            from softgnss_tpu import plots
            path = plots.plot_probe(config, stats, out_dir=args.plot_dir)
            print(f"Probe plot saved to {path}")
        return 0

    if args.stream and args.mesh:
        parser.error("--stream is single-device (exclusive with --mesh)")
    mesh = None
    if args.mesh:
        from softgnss_tpu.parallel import make_mesh
        try:
            n_t, n_c = (int(v) for v in args.mesh.lower().split("x"))
        except ValueError:
            parser.error(f"--mesh expects TIMExCHANNEL (e.g. 2x4), got {args.mesh!r}")
        try:
            mesh = make_mesh({config.time_axis: n_t, config.channel_axis: n_c})
        except ValueError as exc:
            parser.error(f"{exc} (hint: XLA_FLAGS="
                         "--xla_force_host_platform_device_count=N adds virtual "
                         "CPU devices)")

    ephemerides = iono = utc = None
    if args.ephemerides:
        from softgnss_tpu.nav.message import (load_ephemerides, load_iono,
                                              load_utc)
        ephemerides = load_ephemerides(args.ephemerides)
        iono = load_iono(args.ephemerides)
        utc = load_utc(args.ephemerides)

    results = run_receiver(config, signal=signal, file_name=args.file or None,
                           probe=args.probe, navigate=not args.no_nav,
                           checkpoint=args.checkpoint, mesh=mesh,
                           shard=args.shard, stream=args.stream,
                           ephemerides=ephemerides, iono=iono, utc=utc)
    print(results.summary())

    if args.save_ephemerides and any(e is not None for e in results.ephemerides):
        from softgnss_tpu.nav.message import save_ephemerides
        save_ephemerides(args.save_ephemerides, results.ephemerides,
                         iono=getattr(results.solutions, "iono", None),
                         utc=getattr(results.solutions, "utc_params", None))
        print(f"Ephemerides saved to {args.save_ephemerides}")

    if args.synthetic and results.has_fix:
        sol = results.solutions
        err = np.sqrt((sol.x - truth[0]) ** 2 + (sol.y - truth[1]) ** 2
                      + (sol.z - truth[2]) ** 2)
        print(f"3D error vs injected truth: mean {np.nanmean(err):.1f} m, "
              f"max {np.nanmax(err):.1f} m")

    if args.plot:
        from softgnss_tpu import plots
        for path in plots.plot_all(config, results, out_dir=args.plot_dir):
            print(f"Plot saved to {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
