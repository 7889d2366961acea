"""foveax_torch CLI: the port's counterpart of ``foveax/cli/main.py``,
with its subcommands, argument tables and printed output.

Subcommands mirror the reference's three executables:
  serve                 <- driver.x (reference: src/driver.cc)
  client                <- client_driver.x (reference: src/client_driver.cc)
  single_frame, interpolate_sampled, encode_bitrate, decode,
  foveate_no_encoding   <- run_satlogrectilinear.x subcommands
                           (reference: src/run_satlogrectilinear.cc:55-69)

Everything runs on the card unless ``--device cpu`` is given (the global
option that takes the place of foveax's ``--platform``); without a GPU the
default exits non-zero with :func:`~foveax_torch.device.resolve_device`'s
message.  The kernels run where the tensors are: on the card the CUDA
kernels, on the CPU their plain versions (the ``direct`` sampler is plain
PyTorch on both).
"""

from __future__ import annotations

import argparse
import asyncio
import dataclasses
import logging
import sys
import time
from pathlib import Path

import numpy as np
import torch

from foveax_torch.device import resolve_device
from foveax_torch.pipeline.runner import upload

def _center(arg: str):
    x, y = arg.split(",")
    return float(x), float(y)


def _add_io_args(p: argparse.ArgumentParser) -> None:
    p.add_argument(
        "--gaze-trace",
        help="360_em-format gaze trace file, or 'synthetic[:seed]' for a "
        "generated pursuit+saccade trace",
    )
    p.add_argument(
        "--gaze", type=_center, default=(0.5, 0.5), help="fixed gaze 'x,y' in [0,1]"
    )


def _gaze_fn(args):
    trace = getattr(args, "gaze_trace", None)
    if trace:
        from foveax_torch.io.gaze import GazeViewPoints, synthetic_trace

        if trace == "synthetic" or trace.startswith("synthetic:"):
            # Reproducible recorded-style moving gaze (smooth pursuit +
            # saccades) without needing a dataset file on disk —
            # "synthetic" or "synthetic:<seed>".
            try:
                seed = int(trace.split(":", 1)[1]) if ":" in trace else 0
            except ValueError:
                raise SystemExit(
                    f"invalid --gaze-trace {trace!r}: expected "
                    "'synthetic' or 'synthetic:<integer seed>'"
                )
            gvp = GazeViewPoints.from_text(
                synthetic_trace(3600, seed=seed, saccades=True)
            )
        else:
            gvp = GazeViewPoints(trace)
        return lambda i: gvp.gaze_for_frame(i)
    fixed = args.gaze
    return lambda i: fixed


def _gaze_tensor(gaze, device) -> torch.Tensor:
    return torch.tensor(gaze, dtype=torch.float32, device=device)


def cmd_serve(args) -> int:
    from foveax_torch.config import FoveaxConfig
    from foveax_torch.serve.server import FoveaxServer

    logging.basicConfig(level=logging.INFO)
    cfg = FoveaxConfig(fps=args.fps)
    mesh = None
    if args.mesh:
        if not args.broadcast:
            # server.mesh is consumed only by BroadcastChannel — silently
            # serving unsharded would defeat the flag's whole point.
            print("--mesh requires --broadcast", file=sys.stderr)
            return 1
        try:
            data, space = (int(v) for v in args.mesh.split("x"))
            if data < 1 or space < 1:
                raise ValueError
        except ValueError:
            print(
                f"bad --mesh {args.mesh!r}: expected DATAxSPACE, e.g. 2x4",
                file=sys.stderr,
            )
            return 1
        from foveax_torch.parallel import make_mesh

        # On the card the mesh takes the visible CUDA devices; under
        # --device cpu every entry is the CPU (the same decomposition on
        # one device, as the tests run it).
        devices = None
        if args.device.type == "cuda":
            n_devices = torch.cuda.device_count()
            if n_devices < data * space:
                print(
                    f"--mesh {args.mesh} needs {data * space} devices, have "
                    f"{n_devices}",
                    file=sys.stderr,
                )
                return 1
        else:
            devices = [args.device] * (data * space)
        mesh = make_mesh(space, data, devices=devices)
    server = FoveaxServer(
        cfg,
        video_dir=args.video_dir,
        jpeg_quality=args.quality,
        broadcast=args.broadcast,
        loop_videos=args.loop,
        predict_gaze=args.predict_gaze,
        allow_paths=args.allow_paths,
        wire_codec=args.wire_codec,
        wire_bitrate=args.wire_bitrate,
        wire_crf=args.wire_crf,
        wire_preset=args.wire_preset,
        sat_compression=args.sat_compression,
        svd_wire_compress=args.svd_wire_compress,
        mesh=mesh,
        adapt_rate=args.adapt_rate,
        place_videos=args.place_videos,
        batch_sampler=args.batch_sampler,
        readback_deadline_s=args.readback_deadline,
        device=args.device,
    )
    logging.getLogger("foveax_torch.serve").info(
        "wire codec: %s", server.wire_codec
    )
    if args.http_port:
        _start_web_server(args.http_port, args.port)
    try:
        asyncio.run(server.run(args.port))
    except KeyboardInterrupt:
        pass
    return 0


def _start_web_server(http_port: int, ws_port: int):
    """Serve the browser viewer (foveax_torch/web) on a daemon thread;
    returns the ThreadingHTTPServer (callers use its bound port and
    shutdown()).

    The viewer is static files; the websocket protocol itself stays on
    the main server port (the reference's client is a native SDL binary,
    src/client_driver.cc — the browser viewer is its analog)."""
    import functools
    import http.server
    import threading

    web_dir = Path(__file__).resolve().parent.parent / "web"
    handler = functools.partial(
        http.server.SimpleHTTPRequestHandler, directory=str(web_dir)
    )
    httpd = http.server.ThreadingHTTPServer(("0.0.0.0", http_port), handler)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    logging.getLogger("foveax_torch.serve").info(
        "browser viewer: http://localhost:%d/viewer.html"
        "?ws=ws%%3A%%2F%%2Flocalhost%%3A%d&video=<name>",
        httpd.server_address[1],
        ws_port,
    )
    return httpd


def cmd_client(args) -> int:
    from foveax_torch.config import FoveaxConfig
    from foveax_torch.io.png import save_png
    from foveax_torch.serve.client import FoveaxClient

    logging.basicConfig(level=logging.INFO)
    cfg = FoveaxConfig()
    if args.source_size:
        w, h = (int(v) for v in args.source_size.split("x"))
        cfg = cfg.with_source(w, h)

    sink = None
    if getattr(args, "display", False):
        import cv2

        def sink(frame, meta):
            cv2.imshow("foveax", frame[:, :, ::-1])
            cv2.waitKey(1)

    elif args.out_dir:
        out_dir = Path(args.out_dir)
        out_dir.mkdir(parents=True, exist_ok=True)

        def sink(frame, meta):
            save_png(out_dir / f"frame_{meta.frameNum:03d}.png", frame)

    client = FoveaxClient(
        args.uri,
        video=args.video,
        config=cfg,
        gaze_source=_gaze_fn(args),
        frame_sink=sink,
        max_frames=args.max_frames,
        device=args.device,
    )
    stats = asyncio.run(client.run())
    print(stats.report())
    return 0


def cmd_gaze_eval(args) -> int:
    """Compare gaze predictors on a recorded or synthetic trace (the
    dataset's pred_* fields are the zero-order baseline, reference:
    src/gaze_view_points.cc:25-31)."""
    from foveax_torch.io.gaze import GazeViewPoints, synthetic_trace
    from foveax_torch.serve.gazepred import evaluate_predictors

    if args.trace:
        gvp = GazeViewPoints(args.trace)
        label = args.trace
    else:
        kind = "saccades" if args.saccades else "smooth"
        gvp = GazeViewPoints.from_text(
            synthetic_trace(args.frames, saccades=args.saccades)
        )
        label = f"synthetic {kind}, {len(gvp)} frames"
    gazes = gvp.gaze_array()
    if len(gazes) < 3:
        print("trace too short", file=sys.stderr)
        return 1
    res = evaluate_predictors(gazes)
    print(f"trace: {label}")
    for mode, err in res.items():
        print(f"  {mode:<7} mean one-tick prediction error: {err:.5f}")
    print(f"  best: {min(res, key=res.get)}")
    return 0


def _open_reader(source: str):
    from foveax_torch.io.video import open_video

    return open_video(source)


def _skip_to(reader, frame_idx: int):
    """Frame at ``frame_idx`` or None if the clip is shorter (silently
    clamping to the last frame would foveate the wrong frame)."""
    frame = reader.read()
    for _ in range(frame_idx):
        frame = reader.read()
        if frame is None:
            return None
    return frame


def cmd_single_frame(args) -> int:
    """Foveate one frame with a chosen technique, save source + reduced
    PNGs (reference: src/run_satlogrectilinear.cc:173-242; the log-polar
    and point-sample baselines come from the reference's ImageSampler,
    src/image_sampler.cc)."""
    from foveax_torch.config import FoveaxConfig
    from foveax_torch.io.png import save_png
    from foveax_torch.pipeline.frames import FoveationPipeline

    dev = args.device
    with _open_reader(args.video) as r:
        frame = _skip_to(r, args.frame)
        if frame is None:
            print("no such frame", file=sys.stderr)
            return 1
        cfg = FoveaxConfig().with_source(r.width, r.height)

    fj = upload(frame, dev)
    c = _gaze_tensor(args.gaze, dev)
    tech = args.technique
    if tech == "logrect":
        p = FoveationPipeline(cfg, device=dev)
        reduced = p.foveate(fj, c)
    elif tech == "logrect_point":
        from foveax_torch.core.logrect import make_point_grid
        from foveax_torch.core.sample import sample_rect_point

        g = make_point_grid(
            cfg.reduced_width, cfg.reduced_height, r.width, r.height, dev
        )
        reduced = sample_rect_point(fj, g, c)
    elif tech in ("logpolar", "logpolar_pyramid"):
        from foveax_torch.core.logpolar import (
            build_pyramid,
            logpolar_gaussian_blur,
            make_logpolar_grid,
            sample_logpolar,
            sample_logpolar_pyramid,
        )

        g = make_logpolar_grid(
            cfg.reduced_width, cfg.reduced_height, r.width, r.height,
            device=dev,
        )
        if tech == "logpolar":
            sampled = sample_logpolar(fj, g, c)
        else:
            pyr = build_pyramid(fj, args.pyramid_levels)
            sampled = sample_logpolar_pyramid(pyr, g, c, args.pyramid_levels)
        reduced = logpolar_gaussian_blur(sampled)
    else:
        print(f"unknown technique {tech}", file=sys.stderr)
        return 1

    save_png(f"{args.out_prefix}_source.png", np.asarray(frame))
    save_png(f"{args.out_prefix}_foveated.png", reduced.cpu().numpy())
    print(f"wrote {args.out_prefix}_source.png and _foveated.png ({tech})")
    return 0


def cmd_viewport(args) -> int:
    """Gnomonic rectilinear viewport from an equirect frame (reference:
    src/projections.cc:51-86 — a standalone capability never wired into a
    reference program)."""
    from foveax_torch.core.gnomonic import gnomonic_project
    from foveax_torch.io.png import save_png

    with _open_reader(args.video) as r:
        frame = _skip_to(r, args.frame)
        if frame is None:
            print("no such frame", file=sys.stderr)
            return 1
    out = gnomonic_project(
        upload(frame, args.device),
        args.width,
        args.height,
        _gaze_tensor(args.gaze, args.device),
    )
    save_png(args.output, out.cpu().numpy())
    print(f"wrote {args.output}")
    return 0


def _doctor_kernels(dev: torch.device) -> str:
    """Build and launch the SAT build K5 on a small frame and hold it to
    its plain version; raises if either fails.  On the CPU the plain
    versions run and nothing is built."""
    if dev.type != "cuda":
        return "plain versions (cpu)"
    from foveax_torch.kernels import build as kbuild
    from foveax_torch.kernels.scan2d import sat_scan, sat_scan_plain

    t0 = time.perf_counter()
    kbuild.load("scan2d")
    built_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    frame = torch.from_numpy(rng.integers(0, 256, (3, 16, 128), np.uint8))
    got = sat_scan(frame.to(dev), in_layout="chw").view(torch.int32).cpu()
    want = sat_scan_plain(frame).view(torch.int32)
    if not torch.equal(got, want):
        raise RuntimeError("K5 on the card differs from its plain version")
    return f"OK (K5 built in {built_s:.1f} s, launched, equal to its plain version)"


def cmd_doctor(args) -> int:
    """Environment diagnostic: torch and the device, the CUDA kernels'
    build, native library, codec support."""
    dev = args.device
    print(f"torch {torch.__version__}")
    if dev.type == "cuda":
        name = torch.cuda.get_device_name(dev)
        print(f"device: {dev} ({name}; {torch.cuda.device_count()} visible, "
              f"CUDA {torch.version.cuda})")
    else:
        print(f"device: {dev}")

    try:
        x = torch.arange(8, dtype=torch.float32, device=dev)
        print(f"compute: sum(arange(8)) = {float(x.sum()):.0f} (expect 28)")
    except Exception as e:
        print(f"compute: FAILED ({str(e)[:120]})")
        return 1

    # A kernel that does not build or launch fails the diagnostic: the
    # port never carries on with the plain version on the card.
    try:
        print(f"kernels: {_doctor_kernels(dev)}")
    except Exception as e:
        print(f"kernels: FAILED ({str(e)[:200]})")
        return 1

    try:
        from foveax_torch import native

        print(f"native muxer: {'OK' if native.available() else 'unavailable'}")
    except Exception as e:
        print(f"native muxer: FAILED ({e})")

    try:
        import cv2

        print(f"opencv {cv2.__version__}: decode/encode available")
        from foveax_torch.io.video import encode_jpeg

        encode_jpeg(np.zeros((8, 8, 3), np.uint8))
        print("jpeg codec: OK")
    except Exception as e:
        print(f"opencv: FAILED ({e})")

    try:
        import websockets

        print(f"websockets {websockets.__version__}")
    except Exception as e:
        print(f"websockets: FAILED ({e})")

    if getattr(args, "probe_transfers", False):
        # Host<->device transfer health.  Each probe runs in a daemon
        # thread with a deadline so a stalled transfer reports WEDGED
        # instead of hanging the diagnostic.
        import threading

        def timed(label, fn, deadline_s=20.0):
            out = {}

            def run():
                t0 = time.perf_counter()
                try:
                    fn()
                    out["ms"] = (time.perf_counter() - t0) * 1e3
                except Exception as e:  # pragma: no cover
                    out["err"] = str(e)[:120]

            t = threading.Thread(target=run, daemon=True)
            t.start()
            t.join(deadline_s)
            if t.is_alive():
                print(f"{label}: WEDGED (no completion in {deadline_s:.0f}s)")
                return False
            if "err" in out:
                print(f"{label}: FAILED ({out['err']})")
                return False
            print(f"{label}: {out['ms']:.1f} ms")
            return True

        buf = np.zeros((608, 1072, 3), np.uint8)
        held = {}

        def upload_probe():
            # Fenced by a dependent scalar readback.
            held["x"] = torch.from_numpy(buf).to(dev)
            float(held["x"][:1, :1].to(torch.int64).sum())

        ok = timed("upload 2MB (+scalar fence)", upload_probe)
        ok = ok and timed(
            "scalar readback",
            lambda: float(held["x"].to(torch.int64).sum()),
        )
        ok = ok and timed("2MB readback", lambda: held["x"].cpu().numpy())
        if not ok:
            print(
                "transfer path unhealthy: device compute may still work, "
                "but serving/readback will stall"
            )
            return 1
    return 0


def cmd_montage(args) -> int:
    """Four-panel comparison image: source (gaze marked) | transmitted |
    log-rectilinear restoration | log-polar baseline restoration."""
    import cv2

    from foveax_torch.config import FoveaxConfig
    from foveax_torch.core.logpolar import (
        logpolar_gaussian_blur,
        make_logpolar_grid,
        sample_logpolar,
        unwarp_logpolar,
    )
    from foveax_torch.pipeline.frames import FoveationPipeline

    dev = args.device
    with _open_reader(args.video) as r:
        frame = _skip_to(r, args.frame)
        if frame is None:
            print("no such frame", file=sys.stderr)
            return 1
        cfg = FoveaxConfig().with_source(r.width, r.height)

    p = FoveationPipeline(cfg, device=dev)
    c = p.center(*args.gaze)
    fj = upload(frame, dev)
    reduced, restored = p.roundtrip(fj, c)
    g = make_logpolar_grid(
        cfg.reduced_width, cfg.reduced_height, r.width, r.height, device=dev
    )
    lp = logpolar_gaussian_blur(sample_logpolar(fj, g, c))
    lp_restored = unwarp_logpolar(lp, r.width, r.height, c)

    pw, ph = r.width // 2, r.height // 2

    def panel(img, text, interp=cv2.INTER_AREA):
        if isinstance(img, torch.Tensor):
            img = img.cpu().numpy()
        im = cv2.resize(np.asarray(img), (pw, ph), interpolation=interp)
        im = np.ascontiguousarray(im[:, :, ::-1])
        cv2.putText(im, text, (12, 34), cv2.FONT_HERSHEY_SIMPLEX, 1.0, (0, 0, 0), 5)
        cv2.putText(im, text, (12, 34), cv2.FONT_HERSHEY_SIMPLEX, 1.0, (255, 255, 255), 2)
        return im

    src = np.ascontiguousarray(np.asarray(frame)[:, :, ::-1])
    gx, gy = int(args.gaze[0] * r.width), int(args.gaze[1] * r.height)
    cv2.circle(src, (gx, gy), max(12, r.height // 45), (0, 255, 0), 3)
    top = np.concatenate(
        [
            panel(src[:, :, ::-1], "source (gaze circled)"),
            panel(reduced, "transmitted (log-rect)", cv2.INTER_NEAREST),
        ],
        axis=1,
    )
    bottom = np.concatenate(
        [
            panel(restored, "restored (log-rect)"),
            panel(lp_restored, "restored (log-polar baseline)"),
        ],
        axis=1,
    )
    out = np.concatenate([top, bottom], axis=0)
    cv2.imwrite(args.output, out, [cv2.IMWRITE_JPEG_QUALITY, 88])
    print(f"wrote {args.output}")
    return 0


def cmd_svd_bench(args) -> int:
    """SVD-compressed SAT benchmark: factorize, reconstruct, time it
    (reference: src/eigen_sat_generate.cc — the Eigen CPU benchmark)."""
    from foveax_torch.core.sat import build_sat
    from foveax_torch.core.svd_sat import compress_sat, reconstruct_sat
    from foveax_torch.kernels.scan2d import as_int64

    dev = args.device
    with _open_reader(args.video) as r:
        frame = _skip_to(r, args.frame)
        if frame is None:
            print("no such frame", file=sys.stderr)
            return 1
    sat = build_sat(upload(frame, dev))
    t0 = time.perf_counter()
    svd = compress_sat(sat, args.rank)
    t_compress = time.perf_counter() - t0

    def rec_loop(iters):
        # A chain of reconstructions, each input depending on the last
        # result (acc * 0 keeps the dependency: NaN/Inf semantics), ending
        # in one scalar readback.
        acc = torch.zeros((), dtype=torch.float32, device=dev)
        for _ in range(iters):
            s = svd.s + acc * 0.0
            out = reconstruct_sat(dataclasses.replace(svd, s=s))
            acc = acc + out[0, 0, 0]
        return float(acc)

    rec_loop(2)  # warm
    t0 = time.perf_counter()
    rec_loop(args.iters)
    t_rec = (time.perf_counter() - t0) / args.iters
    out = reconstruct_sat(svd)

    sat_f = as_int64(sat).to(torch.float32)
    err = float(
        (out - sat_f).abs().mean() / torch.clamp_min(sat_f.mean(), 1.0)
    )
    print(
        f"rank={args.rank} compress={t_compress * 1000:.1f}ms "
        f"reconstruct={t_rec * 1000:.2f}ms rel_err={err:.2e}"
    )
    return 0


def cmd_quality(args) -> int:
    """Foveate+unwarp quality study over a clip: full-frame, foveal, and
    eccentricity-weighted PSNR per gaze trace (the paper's evaluation axis;
    the repo itself stores no numbers — SURVEY.md section 6)."""
    from foveax_torch.config import FoveaxConfig
    from foveax_torch.core.metrics import (
        eccentricity_weighted_psnr,
        foveal_psnr,
        foveal_ssim,
        psnr,
        ssim,
        ws_psnr,
    )
    from foveax_torch.pipeline.frames import FoveationPipeline

    dev = args.device
    gaze = _gaze_fn(args)
    techniques = args.techniques or ["logrect"]
    with _open_reader(args.video) as r:
        cfg = FoveaxConfig().with_source(r.width, r.height)
        p = FoveationPipeline(cfg, device=dev)
        frames = []
        for i, frame in enumerate(r):
            frames.append(frame)
            if args.max_frames and len(frames) >= args.max_frames:
                break

    # Optional codec-in-the-loop mode: foveate the whole clip, push the
    # reduced stream through the real file codec, then unwarp what a
    # client would actually decode (the paper's end-to-end experiment;
    # reference offline chain: encode_bitrate then decode,
    # src/run_satlogrectilinear.cc:660-855).
    def codec_roundtrip_reduced(reduced_frames):
        import tempfile

        from foveax_torch.io.video import VideoReader, VideoWriter

        with tempfile.TemporaryDirectory() as td:
            path = f"{td}/reduced.mp4"
            with VideoWriter(
                path,
                cfg.reduced_width,
                cfg.reduced_height,
                fps=30.0,
                quality=args.codec_quality,
            ) as w:
                for rf in reduced_frames:
                    w.write(rf)
            with VideoReader(path) as rr:
                return [f for f in rr]

    for tech in techniques:
        full, fov, ecc, ws, ssims, fov_ssims = [], [], [], [], [], []
        decoded = None
        if args.through_codec and tech != "logrect":
            print(
                f"note: --through-codec applies to logrect only; {tech} "
                "runs the in-memory roundtrip",
                file=sys.stderr,
            )
        if args.through_codec and tech == "logrect":
            reduced_all = [
                p.foveate(upload(f, dev), p.center(*gaze(i))).cpu().numpy()
                for i, f in enumerate(frames)
            ]
            decoded = codec_roundtrip_reduced(reduced_all)
            if len(decoded) < len(frames):
                # Some codec backends drop trailing frames on flush.
                print(
                    f"note: codec returned {len(decoded)}/{len(frames)} "
                    "frames; truncating",
                    file=sys.stderr,
                )
                frames = frames[: len(decoded)]
        for i, frame in enumerate(frames):
            c = p.center(*gaze(i))
            fj = upload(frame, dev)
            if tech == "logrect" and decoded is not None:
                restored = p.unwarp(upload(decoded[i], dev), c)
            elif tech == "logrect":
                _, restored = p.roundtrip(fj, c)
            elif tech == "logpolar":
                from foveax_torch.core.logpolar import (
                    logpolar_gaussian_blur,
                    make_logpolar_grid,
                    sample_logpolar,
                    unwarp_logpolar,
                )

                g = make_logpolar_grid(
                    cfg.reduced_width, cfg.reduced_height, r.width, r.height,
                    device=dev,
                )
                red = logpolar_gaussian_blur(sample_logpolar(fj, g, c))
                restored = unwarp_logpolar(red, r.width, r.height, c)
            else:
                print(f"unknown technique {tech}", file=sys.stderr)
                return 1
            full.append(float(psnr(restored, fj)))
            ws.append(float(ws_psnr(restored, fj)))
            fov.append(float(foveal_psnr(restored, fj, c)))
            ecc.append(float(eccentricity_weighted_psnr(restored, fj, c)))
            # SSIM columns (structural twin of the PSNR set): PSNR
            # flatters the box-filtered periphery's blur, SSIM's local
            # contrast terms do not — foveal-advantage readings need both.
            ssims.append(float(ssim(restored, fj)))
            fov_ssims.append(float(foveal_ssim(restored, fj, c)))
        n = len(full)
        mode = " (through codec)" if decoded is not None else ""
        print(
            f"{tech}{mode}: frames={n} psnr={sum(full) / n:.2f}dB "
            f"ws-psnr={sum(ws) / n:.2f}dB "
            f"foveal={sum(fov) / n:.2f}dB ecc-weighted={sum(ecc) / n:.2f}dB "
            f"ssim={sum(ssims) / n:.4f} foveal-ssim={sum(fov_ssims) / n:.4f}"
        )
    return 0


def cmd_ladder(args) -> int:
    """Bitrate ladder: bandwidth-vs-quality per technique through a real
    rate-controlled encode (the paper's headline comparison; reference
    chain: src/run_satlogrectilinear.cc:660-763 + src/video_encoder.cc:
    210-342).  Prints a markdown table."""
    from foveax_torch.cli.ladder import format_table, run_ladder
    from foveax_torch.config import FoveaxConfig
    from foveax_torch.io.wirecodec import available_wire_codecs

    if args.codec not in available_wire_codecs():
        print(
            f"codec {args.codec!r} unavailable (native shim not built)",
            file=sys.stderr,
        )
        return 1
    gaze = _gaze_fn(args)
    with _open_reader(args.video) as r:
        cfg = FoveaxConfig().with_source(r.width, r.height)
        fps = r.fps
        frames = []
        for frame in r:
            frames.append(frame)
            if args.max_frames and len(frames) >= args.max_frames:
                break
    rungs = run_ladder(
        frames,
        gaze,
        cfg,
        bitrates_kbps=args.bitrates,
        techniques=args.techniques,
        fps=fps,
        codec=args.codec,
        device=args.device,
    )
    print(format_table(rungs))
    return 0


def cmd_interpolate_sampled(args) -> int:
    """Foveate + unwarp one frame, save all three stages (reference:
    src/run_satlogrectilinear.cc:330-417)."""
    from foveax_torch.config import FoveaxConfig
    from foveax_torch.io.png import save_png
    from foveax_torch.pipeline.frames import FoveationPipeline

    with _open_reader(args.video) as r:
        frame = _skip_to(r, args.frame)
        if frame is None:
            print("no such frame", file=sys.stderr)
            return 1
        cfg = FoveaxConfig().with_source(r.width, r.height)
    p = FoveationPipeline(cfg, device=args.device)
    c = p.center(*args.gaze)
    reduced, restored = p.roundtrip(upload(frame, args.device), c)
    save_png(f"{args.out_prefix}_source.png", np.asarray(frame))
    save_png(f"{args.out_prefix}_foveated.png", reduced.cpu().numpy())
    save_png(f"{args.out_prefix}_restored.png", restored.cpu().numpy())
    print(f"wrote {args.out_prefix}_{{source,foveated,restored}}.png")
    return 0


def _transcode(args, mode: str) -> int:
    """Shared offline transcode loop (reference:
    src/run_satlogrectilinear.cc:660-763 encode_bitrate, :765-855 decode,
    :857-959 foveate_no_encoding)."""
    from foveax_torch.config import FoveaxConfig
    from foveax_torch.io.video import open_video_writer
    from foveax_torch.pipeline.frames import FoveationPipeline

    gaze = _gaze_fn(args)
    t0 = time.perf_counter()
    with _open_reader(args.video) as r:
        cfg = FoveaxConfig().with_source(r.width, r.height)
        if mode == "decode":
            # Input is already foveated at reduced size; unwarp to full.
            out_w = args.width or cfg.source_width
            out_h = args.height or cfg.source_height
            cfg = FoveaxConfig().with_source(out_w, out_h)
            if (r.width, r.height) != (cfg.reduced_width, cfg.reduced_height):
                print(
                    f"note: input {r.width}x{r.height} != reduced "
                    f"{cfg.reduced_width}x{cfg.reduced_height} for "
                    f"{out_w}x{out_h}",
                    file=sys.stderr,
                )
            out_size = (out_w, out_h)
        elif mode == "encode":
            out_size = (cfg.reduced_width, cfg.reduced_height)
        else:  # foveate_no_encoding: roundtrip at full size
            out_size = (cfg.source_width, cfg.source_height)

        p = FoveationPipeline(cfg, device=args.device)
        if mode == "encode":
            process = p.foveate
        elif mode == "decode":
            process = p.unwarp
        else:
            process = lambda f, c: p.roundtrip(f, c)[1]

        from foveax_torch.pipeline.profiling import StageTimer
        from foveax_torch.pipeline.runner import run_transcode

        # --bitrate selects the native rate-controlled encoder (the
        # reference's encode_bitrate takes an explicit bits/s argument,
        # src/run_satlogrectilinear.cc:669-676); --quality keeps the
        # OpenCV writer.
        with open_video_writer(
            args.output,
            out_size[0],
            out_size[1],
            fps=r.fps,
            bitrate=getattr(args, "bitrate", None),
            quality=args.quality,
            codec=getattr(args, "codec", None),
        ) as w:
            timer = run_transcode(
                r,
                process,
                gaze,
                lambda frame, i: w.write(frame),
                max_frames=args.max_frames,
                timer=StageTimer(),
                device=args.device,
            )
            n = w.n_written
    dt = time.perf_counter() - t0
    print(f"{mode}: {n} frames -> {args.output} in {dt:.1f}s ({n / dt:.1f} fps)")
    if getattr(w, "bytes_written", 0) and n:
        kbps = w.bytes_written * 8 * r.fps / n / 1e3
        print(f"achieved rate: {kbps:.0f} kbit/s at {r.fps:.0f} fps")
    if getattr(args, "profile", False):
        print(timer.report(), file=sys.stderr)
    return 0


def cmd_encode_bitrate(args) -> int:
    return _transcode(args, "encode")


def cmd_decode(args) -> int:
    return _transcode(args, "decode")


def cmd_foveate_no_encoding(args) -> int:
    return _transcode(args, "roundtrip")


def cmd_encode_ladder(args) -> int:
    """Encode-cost ladder: per-frame ms, wire kbit/s, and PSNR for every
    (codec, preset, size, rate mode) on THIS host — the encode half of
    the composed serving-capacity model (BENCHMARKS.md).  The reference
    offloads encode to NVENC silicon (src/video_encoder.cc:3-78) so it
    never needs this table; software encode makes the preset the
    members-per-core lever.  members/core = floor(tick / encode_ms),
    the count one core sustains at the tick without decimation."""
    from foveax_torch.io.wirecodec import (
        available_wire_codecs,
        make_wire_decoder,
        make_wire_encoder,
        probe_frame,
    )

    avail = available_wire_codecs()
    tick_ms = 1e3 / args.fps
    sizes = []
    for s in args.sizes:
        w, h = (int(v) for v in s.split("x"))
        sizes.append((w, h))

    def run_point(codec, preset, w, h, bitrate, crf):
        enc = make_wire_encoder(
            codec, w, h, args.fps, bitrate=bitrate, crf=crf, preset=preset,
            jpeg_quality=args.jpeg_quality,
        )
        dec = make_wire_decoder(
            getattr(enc, "sample_format", None),
            getattr(enc, "codec_config", None),
            size_hint=(w, h),
        )
        try:
            times, nbytes, sq, n_px = [], 0, 0.0, 0
            for i in range(args.frames + 1):
                frame = probe_frame(w, h, i)
                t0 = time.perf_counter()
                sample, _ = enc.encode(frame)
                if not i:
                    dec.decode(sample)
                    continue  # keyframe + lazy init excluded from median
                times.append(time.perf_counter() - t0)
                nbytes += len(sample)
                out = dec.decode(sample)
                if out is not None:
                    d = out.astype(np.float64) - frame.astype(np.float64)
                    sq += float(np.sum(d * d))
                    n_px += d.size
            ms = sorted(times)[len(times) // 2] * 1e3
            kbitps = nbytes * 8 / args.frames * args.fps / 1e3
            mse = sq / n_px if n_px else float("inf")
            psnr = 10 * np.log10(255.0**2 / mse) if mse > 0 else float("inf")
            return ms, kbitps, psnr
        finally:
            enc.close()
            dec.close()

    modes = [("crf", 0, args.crf)]
    if args.bitrate > 0:
        modes.append(("abr", args.bitrate, args.crf))
    points = []
    for codec in args.codecs:
        if codec not in avail:
            print(f"# {codec}: unavailable on this host, skipped")
            continue
        presets = [""] if codec == "jpeg" else list(args.presets)
        for w, h in sizes:
            for mode_name, bitrate, crf in modes if codec != "jpeg" else [modes[0]]:
                for preset in presets:
                    ms, kbitps, psnr = run_point(codec, preset, w, h, bitrate, crf)
                    members = int(tick_ms // ms) if ms > 0 else 0
                    points.append((codec, preset or "-", f"{w}x{h}", mode_name,
                                   ms, kbitps, psnr, members))

    print(f"# {args.frames} frames of moving probe content, fps={args.fps:g} "
          f"(tick {tick_ms:.1f} ms), crf={args.crf}"
          + (f", abr={args.bitrate}" if args.bitrate > 0 else ""))
    print(f"{'codec':7s} {'preset':10s} {'size':10s} {'mode':5s} "
          f"{'ms/frame':>9s} {'kbit/s':>9s} {'PSNR':>6s} {'members/core':>12s}")
    for codec, preset, size, mode, ms, kbitps, psnr, members in points:
        print(f"{codec:7s} {preset:10s} {size:10s} {mode:5s} "
              f"{ms:9.2f} {kbitps:9.0f} {psnr:6.2f} {members:12d}")
    if points:
        import os

        cores = os.cpu_count() or 1
        best = max(points, key=lambda p: p[7])
        print(f"# composed capacity at {sizes[0][0]}x{sizes[0][1]}: "
              f"min(240/chip device knee, {best[7]}/core x {cores} cores "
              f"encode half [{best[0]} {best[1]}]) — see BENCHMARKS.md "
              f"'Composed serving capacity'")
    return 0


def cmd_encode_capacity(args) -> int:
    """Members one host sustains at the tick, encode half only: replays
    the serve loop's exact encode structure (asyncio.gather of
    per-member encodes into a bounded executor, one inter-frame encoder
    per member — serve/server.py broadcast tick) against real encoders
    at the production reduced size, and reports the largest N whose p90
    per-tick encode batch fits 90% of the tick — the same threshold at
    which the channel's saturation decimation engages.  The composed
    serving capacity is min(device knee, this x cores): BENCHMARKS.md
    'Composed serving capacity'."""
    import os
    from concurrent.futures import ThreadPoolExecutor

    from foveax_torch.io.wirecodec import make_wire_encoder, probe_frame

    tick_ms = 1e3 / args.fps
    budget = 0.9 * tick_ms
    w, h = (int(v) for v in args.size.split("x"))
    if args.workers is None:  # the serve loop's executor sizing
        args.workers = min(32, (os.cpu_count() or 1) + 4)

    async def run_n(n):
        encs = [
            make_wire_encoder(
                args.codec, w, h, args.fps,
                bitrate=args.bitrate, crf=args.crf, preset=args.preset,
            )
            for _ in range(n)
        ]
        ex = ThreadPoolExecutor(max_workers=args.workers)
        loop = asyncio.get_running_loop()
        try:
            ticks = []
            for i in range(args.ticks + 2):
                frame = probe_frame(w, h, i)
                t0 = time.perf_counter()
                await asyncio.gather(*(
                    loop.run_in_executor(ex, e.encode, frame) for e in encs
                ))
                if i >= 2:  # keyframe + warmup ticks excluded
                    ticks.append((time.perf_counter() - t0) * 1e3)
            return float(np.percentile(ticks, 90))
        finally:
            ex.shutdown(wait=True)
            for e in encs:
                e.close()

    print(f"# {args.codec} preset={args.preset or '(default)'} {w}x{h} "
          f"fps={args.fps:g} (budget {budget:.1f} ms = 90% tick), "
          f"workers={args.workers}, {args.ticks} ticks")
    best = 0
    for n in range(1, args.max_members + 1):
        p90 = asyncio.run(run_n(n))
        fits = p90 <= budget
        print(f"members={n:3d}  p90 tick encode {p90:7.2f} ms  "
              f"{'OK' if fits else 'DECIMATES'}")
        if fits:
            best = n
        elif n > best + 1:
            break
    cores = os.cpu_count() or 1
    print(f"# sustained: {best} members/host at the {args.fps:g} fps tick "
          f"({cores} core(s)); composed capacity = min(240/chip device "
          f"knee, {best} encode half)")
    return 0


RESOLUTIONS = {
    "1080p": (1920, 1080),
    "4k": (3840, 2160),
    "8k": (7680, 4320),
    # 16K equirect: the resolution-scaling stress point.  The SAT's
    # mod-2^32 wrap engages (total pixel sum 3.4e10 > 2^32) and stays
    # correct for 4-tap boxes.
    "16k": (15360, 8640),
}


def _fence(y: torch.Tensor) -> None:
    """The chains' end: one scalar readback that depends on the last
    result."""
    float(y.to(torch.int64).sum())


def cmd_perf(args) -> int:
    """Device-path throughput across resolutions (1080p/4K/8K): a chain of
    frames, each restored frame the next input, timed as the difference
    of a long and a short chain that each end in a scalar readback.  With
    --clients N, also measures the batched multi-gaze serve step (N
    sampled gaze streams from one frame)."""
    from foveax_torch.config import reduced_dim
    from foveax_torch.core.direct import (
        sample_rect_direct,
        sample_rect_direct_batch,
    )
    from foveax_torch.core.logrect import make_grid
    from foveax_torch.core.sample import sample_rect_from_sat
    from foveax_torch.core.sat import build_sat
    from foveax_torch.core.unwarp import unwarp_rect
    from foveax_torch.kernels.segreduce import (
        fused_eligible,
        sample_rect_fused,
        sample_rect_fused_batch,
    )

    dev = args.device
    # The JAX package's gather workarounds "fast" and "mm" are the port's
    # "auto": the fused unwarp kernel where its contract holds.
    precision = "auto" if args.precision in ("fast", "mm") else args.precision
    names = args.resolutions or ["1080p", "4k"]
    rng = np.random.default_rng(0)
    for name in names:
        w, h = RESOLUTIONS[name]
        rw, rh = reduced_dim(w), reduced_dim(h)
        grid = make_grid(rw, rh, w, h, dev)

        # Single-gaze sampler: the fused segment-reduce kernel where the
        # shape is inside its contract ("auto"), else the SAT pair (K5,
        # then the 4-tap sampler); "direct" the SAT-free banded sampler.
        use_direct = args.sampler == "direct"
        eligible = fused_eligible(grid)
        use_fused = args.sampler == "fused" or (
            args.sampler == "auto" and eligible
        )
        if use_fused and not eligible:
            print(
                f"{name}: {w}x{h} -> {rw}x{rh} is outside the fused "
                "sampler's contract (use --sampler sat or auto)",
                file=sys.stderr,
            )
            return 1

        def step(f, c, grid=grid, w=w, h=h, use_fused=use_fused,
                 use_direct=use_direct):
            if use_fused:
                red = sample_rect_fused(f, grid, c, out_layout="chw")
            elif use_direct:
                red = sample_rect_direct(f, grid, c, out_layout="chw")
            else:
                red = sample_rect_from_sat(
                    build_sat(f, in_layout="chw"), grid, c, out_layout="chw"
                )
            return unwarp_rect(
                red, w, h, c, in_layout="chw", out_layout="chw",
                precision=precision,
            )

        frame = torch.from_numpy(rng.integers(0, 256, (3, h, w), np.uint8)).to(dev)
        centers = [
            torch.tensor([0.3 + 0.01 * i, 0.5], dtype=torch.float32, device=dev)
            for i in range(args.frames + 4)
        ]

        def chain(n):
            y = frame
            t0 = time.perf_counter()
            for i in range(n):
                y = step(y, centers[i])
            _fence(y)
            return time.perf_counter() - t0

        chain(2)
        base = chain(2)
        total = chain(args.frames + 2)
        per = (total - base) / args.frames * 1000
        if per <= 0:
            print(
                f"{name}: timing noise exceeded the measured span — "
                "increase --frames",
                file=sys.stderr,
            )
        else:
            print(
                f"{name}: {w}x{h} -> {rw}x{rh}  {per:.2f} ms/frame  "
                f"{1000 / per:.1f} fps"
            )

        # The batch path as FoveationPipeline.batch_pair("auto") picks it:
        # fused where the shape is eligible, one SAT otherwise.
        batch_kind = args.batch_sampler
        if batch_kind == "auto":
            batch_kind = "fused" if eligible else "sat"
        for n_c in args.clients or []:
            if n_c <= 0:  # "--clients 0" stays a documented no-op
                continue

            if batch_kind == "direct":

                def batch_step(f, cs, grid=grid):
                    return sample_rect_direct_batch(
                        f, grid, cs, in_layout="chw", out_layout="chw"
                    )

            elif batch_kind == "fused":

                def batch_step(f, cs, grid=grid):
                    return sample_rect_fused_batch(
                        f, grid, cs, in_layout="chw", out_layout="chw"
                    )

            else:

                def batch_step(f, cs, grid=grid):
                    sat = build_sat(f, in_layout="chw")
                    return sample_rect_from_sat(sat, grid, cs, out_layout="chw")

            cs0 = torch.from_numpy(
                rng.uniform(0.1, 0.9, (n_c, 2)).astype(np.float32)
            ).to(dev)

            def chain_b(n, cs0=cs0, batch_step=batch_step):
                y, cs = frame, cs0
                t0 = time.perf_counter()
                for i in range(n):
                    reds = batch_step(y, cs)
                    y = y ^ reds[0, :, :1, :1]
                    cs = torch.remainder(cs + 0.003, 1.0)
                _fence(y)
                return time.perf_counter() - t0

            chain_b(2)
            base = chain_b(2)
            total = chain_b(args.frames + 2)
            per = (total - base) / args.frames * 1000
            if per <= 0:
                print(
                    f"{name} x{n_c} clients: timing noise exceeded the "
                    "measured span — increase --frames",
                    file=sys.stderr,
                )
                continue
            label = (
                "one SAT, batched sample"
                if batch_kind == "sat"
                else f"SAT-free {batch_kind}, batched"
            )
            print(
                f"{name} x{n_c} clients ({label}): "
                f"{per:.2f} ms/frame  {1000 / per * n_c:.1f} client-fps"
            )
    return 0


def cmd_stages(args) -> int:
    from foveax_torch.cli.stages import run_all

    return run_all(args.device)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="foveax_torch")
    from foveax_torch import __version__

    ap.add_argument(
        "--version", action="version", version=f"foveax_torch {__version__}"
    )
    ap.add_argument(
        "--device",
        default="cuda",
        help="torch device to run on (default cuda, which exits with an "
        "error when no GPU is present; cpu runs the kernels' plain "
        "versions, e.g. for a client co-located with a server that holds "
        "the card)",
    )
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("serve", help="run the streaming server")
    p.add_argument("--port", type=int, default=9562)
    p.add_argument("--video-dir", default="1080p_videos")
    p.add_argument("--fps", type=float, default=30.0)
    p.add_argument("--quality", type=int, default=90)
    p.add_argument(
        "--loop", action="store_true", help="loop videos when they end"
    )
    p.add_argument(
        "--allow-paths", action="store_true",
        help="allow videoRequest names to be filesystem paths (trusted "
        "deployments only; default confines requests to --video-dir)",
    )
    p.add_argument(
        "--predict-gaze", nargs="?", const="linear", default="off",
        choices=["off", "linear", "kalman"],
        help="extrapolate the gaze one tick ahead to hide latency "
        "(bare flag = linear; kalman adds pursuit filtering with "
        "saccade-aware reset, see foveax_torch/serve/gazepred.py)",
    )
    p.add_argument(
        "--broadcast",
        action="store_true",
        help="viewers of one video share a frame clock; gazes sample as "
        "one batched launch",
    )
    p.add_argument(
        "--wire-codec",
        default="auto",
        choices=["auto", "jpeg", "h264", "vp9", "mpeg4"],
        help="streaming sample codec (auto = h264 when the native shim is "
        "built, else jpeg)",
    )
    p.add_argument(
        "--wire-bitrate", type=int, default=0,
        help="rate-targeted encode, bits/s (0 = quality-targeted via --wire-crf)",
    )
    p.add_argument(
        "--wire-crf", type=int, default=25,
        help="quality target for the wire codec (reference runs cq 25, "
        "src/video_encoder.cc:43)",
    )
    p.add_argument(
        "--wire-preset", default="auto",
        help="software-encoder speed preset (x264 names, ultrafast..medium; "
        "vp9 maps onto cpu-used): auto = slowest preset whose measured "
        "per-frame cost on this host fits 40%% of the tick — the serving "
        "capacity lever, see `encode_ladder` and BENCHMARKS.md "
        "'Composed serving capacity'; '' = codec default (veryfast)",
    )
    p.add_argument(
        "--adapt-rate", action="store_true",
        help="AIMD the per-session wire bitrate on backlog drops "
        "(requires --wire-bitrate > 0; re-negotiates the encoder and "
        "re-sends the stream header live)",
    )
    p.add_argument(
        "--sat-compression", default="none", choices=["none", "svd"],
        help="svd: stream rank-r SAT factors + residual; clients foveate "
        "locally with their own gaze (zero gaze latency, one stream "
        "serves all gazes)",
    )
    p.add_argument(
        "--svd-wire-compress", default="rle",
        choices=["rle", "deflate", "none"],
        help="SVD-wire residual coding: rle = zlib Z_RLE + inter-frame "
        "delta (default), deflate = zlib level-1 + delta, none = raw "
        "(see BENCHMARKS.md 'SVD wire v2')",
    )
    p.add_argument(
        "--mesh", default="",
        help="shard broadcast serving over a DATAxSPACE device mesh, e.g. "
        "2x4 (requires --broadcast; the visible CUDA devices, or as many "
        "CPU entries under --device cpu)",
    )
    p.add_argument(
        "--place-videos", default="default",
        choices=["default", "round_robin"],
        help="round_robin: place each video's pipeline on its own local "
        "device (the visible CUDA devices in turn; one device serves all)",
    )
    p.add_argument(
        "--batch-sampler", default="auto",
        choices=["auto", "sat", "direct", "fused"],
        help="broadcast-tick sampling strategy: sat = amortize one SAT "
        "across the member batch; fused = SAT-free per-gaze sampling, one "
        "launch for the batch; direct = SAT-free banded sampling in plain "
        "PyTorch, no kernel (bit-identical; auto = fused where the shape "
        "is inside the fused sampler's contract, sat otherwise)",
    )
    p.add_argument(
        "--readback-deadline", type=float, default=120.0,
        help="deadline (s) on per-tick device->host readbacks: a wedged "
        "transport degrades to skipped frames instead of a hung channel, "
        "and cadence recovers when the transfer completes (must exceed a "
        "first tick's kernel build; <= 0 disables)",
    )
    p.add_argument(
        "--http-port", type=int, default=0,
        help="also serve the browser viewer (foveax_torch/web) over HTTP on "
        "this port (0 = off); open /viewer.html?video=NAME",
    )
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser(
        "gaze_eval",
        help="compare gaze predictors (zero/linear/kalman) on a trace",
    )
    p.add_argument("--trace", help="360_em-format gaze trace file")
    p.add_argument("--frames", type=int, default=600)
    p.add_argument(
        "--saccades", action="store_true",
        help="synthetic trace with ballistic saccades every 2 s",
    )
    p.set_defaults(fn=cmd_gaze_eval, host_only=True)

    p = sub.add_parser("client", help="run the headless streaming client")
    p.add_argument("--uri", default="ws://localhost:9562")
    p.add_argument("--video", default="03_drone_d5d4gnuAJLo")
    p.add_argument("--max-frames", type=int)
    p.add_argument("--out-dir", help="dump received frames as PNGs")
    p.add_argument(
        "--display", action="store_true",
        help="show frames in an OpenCV window (needs a display)",
    )
    p.add_argument("--source-size", help="e.g. 1920x1080")
    _add_io_args(p)
    p.set_defaults(fn=cmd_client)

    p = sub.add_parser("single_frame", help="foveate one frame to PNG")
    p.add_argument("video")
    p.add_argument("frame", type=int)
    p.add_argument("out_prefix")
    p.add_argument(
        "--technique",
        choices=["logrect", "logrect_point", "logpolar", "logpolar_pyramid"],
        default="logrect",
    )
    p.add_argument("--pyramid-levels", type=int, default=4)
    _add_io_args(p)
    p.set_defaults(fn=cmd_single_frame)

    p = sub.add_parser("viewport", help="gnomonic viewport from equirect")
    p.add_argument("video")
    p.add_argument("frame", type=int)
    p.add_argument("output")
    p.add_argument("--width", type=int, default=960)
    p.add_argument("--height", type=int, default=540)
    _add_io_args(p)
    p.set_defaults(fn=cmd_viewport)

    p = sub.add_parser(
        "stages", help="run the five staged validation configs (BASELINE.md)"
    )
    p.set_defaults(fn=cmd_stages)

    p = sub.add_parser("quality", help="PSNR quality study over a clip")
    p.add_argument("video")
    p.add_argument("--max-frames", type=int, default=30)
    p.add_argument(
        "--techniques", nargs="*", choices=["logrect", "logpolar"], default=None
    )
    p.add_argument(
        "--through-codec", action="store_true",
        help="push the reduced stream through the real file codec before "
        "unwarping (the paper's end-to-end chain)",
    )
    p.add_argument("--codec-quality", type=float, default=None)
    _add_io_args(p)
    p.set_defaults(fn=cmd_quality)

    p = sub.add_parser(
        "ladder", help="bitrate-vs-PSNR ladder through a real encoder"
    )
    p.add_argument("video")
    p.add_argument("--max-frames", type=int, default=30)
    p.add_argument(
        "--bitrates", nargs="*", type=float,
        default=[500, 1000, 2000, 4000, 8000], help="ladder rungs, kbit/s",
    )
    p.add_argument(
        "--techniques", nargs="*",
        choices=["logrect", "logpolar", "downsample"],
        default=["logrect", "logpolar", "downsample"],
    )
    p.add_argument(
        "--codec", default="h264", choices=["h264", "vp9", "mpeg4"]
    )
    _add_io_args(p)
    p.set_defaults(fn=cmd_ladder)

    p = sub.add_parser(
        "encode_ladder",
        help="encode cost/bitrate/PSNR per (codec, preset, size, mode) on "
        "this host — the encode half of serving capacity",
    )
    p.add_argument("--codecs", nargs="*", default=["h264", "vp9", "jpeg"])
    p.add_argument(
        "--presets", nargs="*",
        default=["ultrafast", "superfast", "veryfast", "faster", "fast"],
    )
    p.add_argument("--sizes", nargs="*", default=["1072x608", "2144x1200"])
    p.add_argument("--frames", type=int, default=12)
    p.add_argument("--fps", type=float, default=30.0)
    p.add_argument("--crf", type=int, default=25)
    p.add_argument(
        "--bitrate", type=int, default=2_000_000,
        help="also measure rate-targeted (ABR) mode at this target "
        "(0 = crf only)",
    )
    p.add_argument("--jpeg-quality", type=int, default=90)
    p.set_defaults(fn=cmd_encode_ladder, host_only=True)

    p = sub.add_parser(
        "encode_capacity",
        help="members/host sustained at the tick through the serve "
        "loop's encode structure (real encoders, bounded executor)",
    )
    p.add_argument("--codec", default="h264")
    p.add_argument("--preset", default="ultrafast")
    p.add_argument("--size", default="1072x608")
    p.add_argument("--fps", type=float, default=30.0)
    p.add_argument("--crf", type=int, default=25)
    p.add_argument("--bitrate", type=int, default=2_000_000)
    p.add_argument("--ticks", type=int, default=60)
    p.add_argument("--max-members", type=int, default=16)
    p.add_argument(
        "--workers", type=int, default=None,
        help="executor threads (default: the serve loop's sizing)",
    )
    p.set_defaults(fn=cmd_encode_capacity, host_only=True)

    p = sub.add_parser("perf", help="device-path fps across resolutions")
    p.add_argument(
        "--sampler",
        choices=["auto", "sat", "direct", "fused"],
        default="auto",
        help="single-gaze downsampler: SAT 4-tap (K5, then the 4-tap "
        "sampler), the SAT-free banded direct sampler (plain PyTorch) or "
        "the fused segment-reduce kernel (auto = fused where the shape is "
        "inside its contract, sat otherwise)",
    )
    p.add_argument(
        "--resolutions", nargs="*", choices=["1080p", "4k", "8k", "16k"], default=None
    )
    p.add_argument("--frames", type=int, default=20)
    p.add_argument(
        "--clients", type=int, nargs="*", default=None,
        help="also bench the batched N-gaze serve step; pass several "
        "values (e.g. --clients 8 32 128) to sweep for the marginal-cost "
        "knee",
    )
    p.add_argument(
        "--precision",
        choices=["exact", "fast", "mm", "fused", "auto"], default="auto",
        help="unwarp path: exact = the plain float blend; fused = the "
        "unwarp kernel (raises outside its contract); auto = the kernel "
        "where its contract holds, exact elsewhere (fast and mm, the JAX "
        "package's TPU gather workarounds, mean auto here; all <= 1 LSB "
        "of exact)",
    )
    p.add_argument(
        "--batch-sampler", choices=["auto", "sat", "direct", "fused"],
        default="auto",
        help="--clients batch path: sat = one SAT amortized across the "
        "batch; fused = SAT-free sampling of the whole batch in one launch; "
        "direct = SAT-free banded sampling, no kernel (bit-identical "
        "outputs); auto = fused where the shape is inside the fused "
        "sampler's contract, sat otherwise",
    )
    p.set_defaults(fn=cmd_perf)

    p = sub.add_parser("doctor", help="environment diagnostic")
    p.add_argument(
        "--probe-transfers", action="store_true",
        help="time host<->device transfers with a deadline (detects a "
        "stalled readback path without hanging)",
    )
    p.set_defaults(fn=cmd_doctor)

    p = sub.add_parser("montage", help="4-panel comparison image")
    p.add_argument("video")
    p.add_argument("frame", type=int)
    p.add_argument("output")
    _add_io_args(p)
    p.set_defaults(fn=cmd_montage)

    p = sub.add_parser("svd_bench", help="SVD-compressed SAT benchmark")
    p.add_argument("video")
    p.add_argument("--frame", type=int, default=0)
    p.add_argument("--rank", type=int, default=30)
    p.add_argument("--iters", type=int, default=5)
    p.set_defaults(fn=cmd_svd_bench)

    p = sub.add_parser(
        "interpolate_sampled", help="foveate+unwarp one frame to PNGs"
    )
    p.add_argument("video")
    p.add_argument("frame", type=int)
    p.add_argument("out_prefix")
    _add_io_args(p)
    p.set_defaults(fn=cmd_interpolate_sampled)

    for name, fn, hlp in [
        ("encode_bitrate", cmd_encode_bitrate, "offline foveated transcode"),
        ("decode", cmd_decode, "unwarp an already-foveated video"),
        (
            "foveate_no_encoding",
            cmd_foveate_no_encoding,
            "foveate+unwarp transcode without intermediate codec",
        ),
    ]:
        p = sub.add_parser(name, help=hlp)
        p.add_argument("video")
        p.add_argument("output")
        p.add_argument("--quality", type=float, default=None)
        p.add_argument(
            "--bitrate", type=int, default=None,
            help="explicit bits/s via the native rate-controlled encoder "
            "(reference: src/run_satlogrectilinear.cc:669-676)",
        )
        p.add_argument(
            "--codec", default=None,
            choices=["mp4v", "h264", "vp9", "mpeg4"],
            help="output codec (non-mp4v selects the native writer)",
        )
        p.add_argument("--max-frames", type=int)
        p.add_argument("--width", type=int)
        p.add_argument("--height", type=int)
        p.add_argument("--profile", action="store_true", help="print stage timings")
        _add_io_args(p)
        p.set_defaults(fn=fn)

    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if not getattr(args, "host_only", False):
        # Every subcommand that touches a device resolves it first: the
        # default cuda without a GPU stops here, never on the CPU.
        try:
            args.device = resolve_device(args.device)
        except RuntimeError as e:
            print(f"foveax_torch: {e}", file=sys.stderr)
            return 2
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
