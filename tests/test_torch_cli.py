"""The port's CLI (``foveax_torch.cli.main``) against foveax's
(``foveax.cli.main``) on the same synthetic sources, each run into its own
directory, the port with ``--device cpu`` (its kernels' plain versions).

Tolerances:
- PNGs and transcoded frames of the log-rectilinear paths: bit-equal
  (every sampler is bit-identical, and the port's exact unwarp is
  bit-equal to foveax's jitted one);
- log-polar blur and unwarp, and pictures made from them: within 1 LSB
  before any lossy encode (foveax's CLI calls them eagerly);
- the gnomonic viewport: at most 5% of pixels differ (foveax's own test
  allows as much);
- printed metrics: within the tolerances of ``test_torch_metrics.py``
  plus one unit in the last printed digit (the CLI rounds what it
  prints); ``svd_bench``'s error within ``test_torch_svd.py``'s 5e-7 of
  the SAT maximum;
- printed lines other than timings: identical.
"""

import re

import numpy as np
import pytest
import torch

from foveax.cli import main as fx_cli
from foveax.io.gaze import synthetic_trace
from foveax.io.png import load_png
from foveax.io.video import VideoReader
from foveax_torch.cli import main as pt_cli

torch.set_num_threads(1)

SRC = "synthetic://96x64@30/{}"
PSNR_DB = 1e-4  # test_torch_metrics.py
SSIM_ABS = 1e-5
SVD_REL = 5e-7  # test_torch_svd.py


def _run(tmp_path, argv, capsys):
    """Run both CLIs on ``argv`` (``{d}`` in an argument becomes each
    run's own directory): returns ((rc, out) of foveax, (rc, out) of the
    port)."""
    res = []
    for name, cli, pre in (("fx", fx_cli, []), ("pt", pt_cli, ["--device", "cpu"])):
        d = tmp_path / name
        d.mkdir(exist_ok=True)
        rc = cli.main(pre + [a.format(d=d) for a in argv])
        res.append((rc, capsys.readouterr().out))
    return res


def _frames(path):
    with VideoReader(path) as r:
        return [np.ascontiguousarray(f) for f in r]


def _same_frames(a, b):
    fa, fb = _frames(a), _frames(b)
    assert len(fa) == len(fb) > 0
    for x, y in zip(fa, fb):
        np.testing.assert_array_equal(x, y)
    return fa


def _lines_without(out, pattern):
    return [re.sub(pattern, "", line) for line in out.splitlines()]


def test_single_frame(tmp_path, capsys):
    (rc_f, out_f), (rc_p, out_p) = _run(tmp_path, [
        "single_frame", SRC.format(5), "2", "{d}/sf", "--gaze", "0.4,0.6"
    ], capsys)
    assert rc_f == rc_p == 0
    assert out_p == out_f.replace(str(tmp_path / "fx"), str(tmp_path / "pt"))
    for suffix in ("_source.png", "_foveated.png"):
        assert (tmp_path / "pt" / f"sf{suffix}").read_bytes() == (
            tmp_path / "fx" / f"sf{suffix}").read_bytes()
    assert load_png(tmp_path / "pt" / "sf_foveated.png").shape == (48, 64, 3)


def test_interpolate_sampled(tmp_path, capsys):
    (rc_f, _), (rc_p, _) = _run(tmp_path, [
        "interpolate_sampled", SRC.format(3), "0", "{d}/is"
    ], capsys)
    assert rc_f == rc_p == 0
    for suffix in ("_source.png", "_foveated.png", "_restored.png"):
        assert (tmp_path / "pt" / f"is{suffix}").read_bytes() == (
            tmp_path / "fx" / f"is{suffix}").read_bytes()
    restored = load_png(tmp_path / "pt" / "is_restored.png")
    src = load_png(tmp_path / "pt" / "is_source.png")
    # Fovea at the default gaze centre is exact.
    np.testing.assert_array_equal(restored[31:34, 47:50], src[31:34, 47:50])


def test_encode_bitrate_with_gaze_trace(tmp_path, capsys):
    trace = tmp_path / "trace.txt"
    trace.write_text(synthetic_trace(10))
    (rc_f, out_f), (rc_p, out_p) = _run(tmp_path, [
        "encode_bitrate", SRC.format(10), "{d}/fov.mp4", "--gaze-trace", str(trace)
    ], capsys)
    assert rc_f == rc_p == 0
    frames = _same_frames(tmp_path / "pt" / "fov.mp4", tmp_path / "fx" / "fov.mp4")
    assert len(frames) == 10 and frames[0].shape == (48, 64, 3)
    timing = r" in [0-9.]+s \([0-9.]+ fps\)"
    assert _lines_without(out_p, timing) == _lines_without(
        out_f.replace(str(tmp_path / "fx"), str(tmp_path / "pt")), timing)


def test_foveate_no_encoding_then_decode(tmp_path, capsys):
    (rc_f, _), (rc_p, _) = _run(tmp_path, [
        "foveate_no_encoding", SRC.format(6), "{d}/roundtrip.mp4",
        "--gaze", "0.5,0.5",
    ], capsys)
    assert rc_f == rc_p == 0
    frames = _same_frames(tmp_path / "pt" / "roundtrip.mp4",
                          tmp_path / "fx" / "roundtrip.mp4")
    assert frames[0].shape == (64, 96, 3)

    # decode: both unwarp the same already-foveated clip.
    fov = tmp_path / "fov.mp4"
    assert fx_cli.main(["encode_bitrate", SRC.format(6), str(fov)]) == 0
    (rc_f, _), (rc_p, _) = _run(tmp_path, [
        "decode", str(fov), "{d}/restored.mp4", "--width", "96", "--height", "64"
    ], capsys)
    assert rc_f == rc_p == 0
    frames = _same_frames(tmp_path / "pt" / "restored.mp4",
                          tmp_path / "fx" / "restored.mp4")
    assert len(frames) == 6 and frames[0].shape == (64, 96, 3)


@pytest.mark.parametrize("tech, lsb", [
    ("logrect_point", 0), ("logpolar", 1), ("logpolar_pyramid", 1),
])
def test_single_frame_techniques(tmp_path, capsys, tech, lsb):
    (rc_f, out_f), (rc_p, out_p) = _run(tmp_path, [
        "single_frame", SRC.format(3), "1", "{d}/" + tech, "--technique", tech
    ], capsys)
    assert rc_f == rc_p == 0
    got = load_png(tmp_path / "pt" / f"{tech}_foveated.png").astype(np.int32)
    want = load_png(tmp_path / "fx" / f"{tech}_foveated.png").astype(np.int32)
    assert got.shape == want.shape == (48, 64, 3)
    assert np.abs(got - want).max() <= lsb


def test_viewport(tmp_path, capsys):
    (rc_f, _), (rc_p, _) = _run(tmp_path, [
        "viewport", SRC.format(2), "0", "{d}/vp.png", "--width", "48",
        "--height", "24",
    ], capsys)
    assert rc_f == rc_p == 0
    got = load_png(tmp_path / "pt" / "vp.png")
    want = load_png(tmp_path / "fx" / "vp.png")
    assert got.shape == want.shape == (24, 48, 3)
    assert (got != want).any(axis=-1).mean() <= 0.05


def test_svd_bench(tmp_path, capsys):
    (rc_f, out_f), (rc_p, out_p) = _run(tmp_path, [
        "svd_bench", SRC.format(2), "--rank", "8", "--iters", "1"
    ], capsys)
    assert rc_f == rc_p == 0
    printed = [re.search(r"rel_err=(\S+)", o).group(1) for o in (out_f, out_p)]
    err = [float(t) for t in printed]
    # The contraction agrees within SVD_REL of the SAT maximum per value;
    # the printed error is the mean over the SAT's mean, with three
    # significant digits.
    from foveax_torch.core.sat import build_sat
    from foveax_torch.io.video import open_video

    frame = open_video(SRC.format(2)).read()
    sat = build_sat(torch.from_numpy(frame)).view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bound = SVD_REL * float(sat.max()) / float(sat.double().mean())
    last_digit = 10.0 ** (int(printed[0].split("e")[1]) - 2)
    assert abs(err[0] - err[1]) <= bound + last_digit


def test_montage(tmp_path, capsys):
    (rc_f, _), (rc_p, _) = _run(tmp_path, [
        "montage", "synthetic://192x128@30/3", "1", "{d}/m.jpg", "--gaze", "0.6,0.4"
    ], capsys)
    assert rc_f == rc_p == 0
    got = load_png(tmp_path / "pt" / "m.jpg").astype(np.int32)
    want = load_png(tmp_path / "fx" / "m.jpg").astype(np.int32)
    assert got.shape == want.shape == (128, 192, 3)
    # Three panels come from bit-equal paths; the log-polar panel may
    # differ by 1 LSB before the JPEG encode.
    top = slice(0, 64)
    np.testing.assert_array_equal(got[top], want[top])
    np.testing.assert_array_equal(got[64:, :96], want[64:, :96])


def test_doctor(tmp_path, capsys):
    (rc_f, out_f), (rc_p, out_p) = _run(tmp_path, ["doctor"], capsys)
    assert rc_f == rc_p == 0
    assert "kernels: plain versions (cpu)" in out_p and "native muxer:" in out_p
    assert "compute: sum(arange(8)) = 28 (expect 28)" in out_p
    host = ("native muxer:", "opencv", "jpeg codec:", "websockets")
    pick = lambda out: [l for l in out.splitlines() if l.startswith(host)]
    assert pick(out_p) == pick(out_f)


def test_encode_ladder_smoke(tmp_path, capsys):
    from foveax_torch.io.wirecodec import available_wire_codecs

    codec = "h264" if "h264" in available_wire_codecs() else "jpeg"
    (rc_f, out_f), (rc_p, out_p) = _run(tmp_path, [
        "encode_ladder", "--codecs", codec, "--presets", "ultrafast",
        "--sizes", "192x96", "--frames", "3", "--bitrate", "0",
    ], capsys)
    assert rc_f == rc_p == 0
    assert "members/core" in out_p and "composed capacity" in out_p
    assert codec in out_p
    # Rows: codec, preset, size, mode, ms, kbit/s, PSNR, members; the
    # encoded bytes and PSNR are the host codec's, the same for both.
    rows = lambda out: [l.split() for l in out.splitlines() if l.startswith(codec)]
    assert [r[:4] + r[5:7] for r in rows(out_p)] == [
        r[:4] + r[5:7] for r in rows(out_f)]


def test_encode_capacity_smoke(tmp_path, capsys):
    from foveax_torch.io.wirecodec import available_wire_codecs

    if "h264" not in available_wire_codecs():
        pytest.skip("native h264 shim not built")
    (rc_f, out_f), (rc_p, out_p) = _run(tmp_path, [
        "encode_capacity", "--size", "192x96", "--ticks", "4",
        "--max-members", "2", "--workers", "2",
    ], capsys)
    assert rc_f == rc_p == 0
    assert "sustained:" in out_p and "p90 tick encode" in out_p
    assert out_p.splitlines()[0] == out_f.splitlines()[0]


METRIC = re.compile(r"([a-z-]+)=([0-9.]+)(dB)?")


def _metric_tol(name: str, text: str) -> float:
    last = 10.0 ** -len(text.split(".")[1]) if "." in text else 1.0
    return (SSIM_ABS if "ssim" in name else PSNR_DB) + last


def _same_metrics(out_p, out_f):
    lp, lf = out_p.splitlines(), out_f.splitlines()
    assert len(lp) == len(lf) > 0
    for a, b in zip(lp, lf):
        assert METRIC.sub("", a) == METRIC.sub("", b)
        for (name, x, _), (_, y, _) in zip(METRIC.findall(a), METRIC.findall(b)):
            assert abs(float(x) - float(y)) <= _metric_tol(name, y), (name, a, b)


@pytest.mark.parametrize("tech", ["logrect", "logpolar"])
def test_quality(tmp_path, capsys, tech):
    (rc_f, out_f), (rc_p, out_p) = _run(tmp_path, [
        "quality", SRC.format(4), "--techniques", tech, "--gaze-trace",
        "synthetic:2",
    ], capsys)
    assert rc_f == rc_p == 0
    _same_metrics(out_p, out_f)


def test_gaze_eval(tmp_path, capsys):
    (rc_f, out_f), (rc_p, out_p) = _run(tmp_path, [
        "gaze_eval", "--frames", "120", "--saccades"
    ], capsys)
    assert rc_f == rc_p == 0
    assert out_p == out_f and "best:" in out_p


def test_ladder(tmp_path, capsys):
    from foveax_torch.io.wirecodec import available_wire_codecs

    if "h264" not in available_wire_codecs():
        pytest.skip("native h264 shim not built")
    (rc_f, out_f), (rc_p, out_p) = _run(tmp_path, [
        "ladder", SRC.format(3), "--bitrates", "300", "--techniques",
        "logrect", "logpolar", "downsample",
    ], capsys)
    assert rc_f == rc_p == 0
    cells = lambda out: [l.split("|")[1:-1] for l in out.splitlines()[2:]]
    rows_p, rows_f = cells(out_p), cells(out_f)
    assert len(rows_p) == len(rows_f) == 3
    names = ["PSNR", "WS-PSNR", "foveal", "ecc", "ssim", "foveal-ssim"]
    for a, b in zip(rows_p, rows_f):
        assert a[:3] == b[:3]  # technique, target and actual kbit/s
        for name, x, y in zip(names, a[3:], b[3:]):
            assert abs(float(x) - float(y)) <= _metric_tol(name.lower(), y.strip())


def test_perf(tmp_path, capsys):
    """Both CLIs print the same line.  ``perf`` prints it only where the
    timed span (a chain of ``--frames`` + 2 steps less one of 2) is
    positive; over one frame timer noise on a loaded host can turn it
    negative, so the span is 8 frames."""
    (rc_f, out_f), (rc_p, out_p) = _run(tmp_path, [
        "perf", "--resolutions", "1080p", "--frames", "8"
    ], capsys)
    assert rc_f == rc_p == 0
    timing = r"  [0-9.]+ ms/frame  [0-9.]+ fps"
    line = "1080p: 1920x1080 -> 1072x608"
    assert _lines_without(out_p, timing) == _lines_without(out_f, timing) == [line]


@pytest.mark.parametrize("stage", [1, 2])
def test_stages(capsys, stage):
    from foveax.cli import stages as fx_stages
    from foveax_torch.cli import stages as pt_stages

    name = ["stage1_single_frame_warp", "stage2_sat_roundtrip"][stage - 1]
    assert getattr(fx_stages, name)()
    out_f = capsys.readouterr().out
    assert getattr(pt_stages, name)(device="cpu")
    out_p = capsys.readouterr().out
    timing = r" in [0-9.]+s"
    assert _lines_without(out_p, timing) == _lines_without(out_f, timing)


@pytest.mark.parametrize("argv", [
    ["perf", "--sampler", "direct", "--resolutions", "1080p", "--frames", "4"],
    ["perf", "--batch-sampler", "direct", "--clients", "2", "--resolutions",
     "1080p", "--frames", "4"],
], ids=["perf-sampler", "perf-batch-sampler"])
def test_direct_sampler_runs(tmp_path, capsys, argv):
    """``perf`` with the direct sampler, single gaze or batched, prints
    foveax's lines (perf's smallest resolution is 1080p).  foveax's few
    milliseconds a jitted step can drown in timer noise here, and then it
    prints its noise message to stderr in place of a line."""
    (rc_f, out_f), (rc_p, out_p) = _run(tmp_path, argv, capsys)
    assert rc_f == rc_p == 0
    timing = r" +[0-9.]+ ms/frame  [0-9.]+ (client-)?fps"
    want = ["1080p: 1920x1080 -> 1072x608"]
    if "--clients" in argv:
        want.append("1080p x2 clients (SAT-free direct, batched):")
    assert _lines_without(out_p, timing) == want
    assert set(_lines_without(out_f, timing)) <= set(want)


def test_serve_direct_broadcast(tmp_path, capsys):
    """``serve --broadcast --batch-sampler direct`` (a subprocess of the
    port's CLI) serves a client on ``synthetic://96x64``: every received
    frame is written."""
    pngs = _serve_and_receive(tmp_path, ["--broadcast", "--batch-sampler", "direct"])
    assert [p.name for p in pngs] == [f"frame_{i:03d}.png" for i in range(4)]
    assert "frames" in capsys.readouterr().out


def _subcommands(cli):
    parser = cli.build_parser()
    (sub,) = [a for a in parser._actions if a.dest == "cmd"]
    return parser, sub.choices


def test_help_lists_every_subcommand():
    fx_parser, fx_subs = _subcommands(fx_cli)
    pt_parser, pt_subs = _subcommands(pt_cli)
    assert set(pt_subs) == set(fx_subs)
    opts = lambda p: {o for a in p._actions for o in a.option_strings}
    assert "--platform" in opts(fx_parser) and "--platform" not in opts(pt_parser)
    assert "--device" in opts(pt_parser)
    for name, sub in fx_subs.items():
        assert opts(pt_subs[name]) == opts(sub), name


DEVICE_SUBCOMMANDS = [
    ["single_frame", SRC.format(2), "0", "{d}/x"],
    ["interpolate_sampled", SRC.format(2), "0", "{d}/x"],
    ["viewport", SRC.format(2), "0", "{d}/x.png"],
    ["montage", SRC.format(2), "0", "{d}/x.jpg"],
    ["quality", SRC.format(2)],
    ["ladder", SRC.format(2)],
    ["svd_bench", SRC.format(2)],
    ["encode_bitrate", SRC.format(2), "{d}/x.mp4"],
    ["decode", SRC.format(2), "{d}/x.mp4"],
    ["foveate_no_encoding", SRC.format(2), "{d}/x.mp4"],
    ["perf", "--resolutions", "1080p", "--frames", "1"],
    ["stages"],
    ["doctor"],
    ["serve", "--port", "0"],
    ["client", "--uri", "ws://127.0.0.1:1"],
]


@pytest.mark.parametrize("argv", DEVICE_SUBCOMMANDS, ids=[a[0] for a in DEVICE_SUBCOMMANDS])
def test_default_device_is_cuda_without_fallback(tmp_path, capsys, argv):
    """Without ``--device`` every subcommand that touches a device asks
    for cuda; with no GPU it exits non-zero with resolve_device's message
    and writes nothing (no fallback to the CPU)."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device works here")
    rc = pt_cli.main([a.format(d=tmp_path) for a in argv])
    assert rc != 0
    err = capsys.readouterr().err
    assert "runs on a CUDA device by default and none is available" in err
    assert list(tmp_path.iterdir()) == []


def test_serve_mesh_argument_checks(capsys, monkeypatch):
    """``serve --mesh`` checks its argument as foveax's does: it needs
    ``--broadcast``, a DATAxSPACE shape and, on the card, as many CUDA
    devices as the mesh has entries."""
    assert pt_cli.main(["--device", "cpu", "serve", "--mesh", "1x1"]) == 1
    assert "--mesh requires --broadcast" in capsys.readouterr().err
    assert pt_cli.main(["--device", "cpu", "serve", "--broadcast", "--mesh", "2y4"]) == 1
    assert "expected DATAxSPACE" in capsys.readouterr().err
    # One visible card (nothing is launched: the check comes first).
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert pt_cli.main(["serve", "--broadcast", "--mesh", "2x1"]) == 1
    assert "needs 2 devices, have 1" in capsys.readouterr().err


def test_serve_mesh_builds_a_mesh_server(monkeypatch):
    """``serve --broadcast --mesh 2x4 --device cpu`` serves through a 2x4
    mesh of CPU entries (``run`` is replaced: the test only builds the
    server the command would serve with)."""
    from foveax_torch.serve.server import FoveaxServer

    served = []

    async def run(self, port):
        served.append(self)

    monkeypatch.setattr(FoveaxServer, "run", run)
    argv = ["--device", "cpu", "serve", "--broadcast", "--mesh", "2x4",
            "--batch-sampler", "sat"]
    assert pt_cli.main(argv) == 0
    (server,) = served
    assert server.mesh.shape == {"data": 2, "space": 4}
    assert server.mesh.flat() == [torch.device("cpu")] * 8
    assert server.batch_sampler == "sat" and server.broadcast


def _serve_and_receive(tmp_path, serve_args):
    """Start ``serve`` (a subprocess of the port's CLI, jpeg wire, plus
    ``serve_args``) and run ``client --out-dir`` against it on the CPU;
    returns the PNGs the client wrote."""
    import socket
    import subprocess
    import sys
    import time
    from pathlib import Path

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    root = Path(__file__).resolve().parents[1]
    server = subprocess.Popen(
        [sys.executable, "-m", "foveax_torch.cli.main", "--device", "cpu",
         "serve", "--port", str(port), "--wire-codec", "jpeg", *serve_args],
        cwd=root, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
    )
    try:
        deadline = time.monotonic() + 60
        while True:
            try:
                socket.create_connection(("127.0.0.1", port), timeout=1).close()
                break
            except OSError:
                assert server.poll() is None and time.monotonic() < deadline
                time.sleep(0.2)
        out_dir = tmp_path / "frames"
        rc = pt_cli.main([
            "--device", "cpu", "client", "--uri", f"ws://127.0.0.1:{port}",
            "--video", SRC.format(10), "--max-frames", "4", "--source-size",
            "96x64", "--out-dir", str(out_dir), "--gaze", "0.4,0.6",
        ])
    finally:
        server.terminate()
        server.wait(timeout=30)
    assert rc == 0
    return sorted(out_dir.iterdir())


def test_serve_and_client_subcommands(tmp_path, capsys):
    """``serve`` (a subprocess of the port's CLI) and ``client --out-dir``
    on the CPU: the client writes every received frame as a PNG and prints
    its stats."""
    pngs = _serve_and_receive(tmp_path, [])
    assert [p.name for p in pngs] == [f"frame_{i:03d}.png" for i in range(4)]
    assert all(load_png(p).shape == (64, 96, 3) for p in pngs)
    assert "frames" in capsys.readouterr().out
