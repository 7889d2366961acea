"""Bitrate-ladder experiment: bandwidth vs quality per technique
(counterpart of ``foveax/cli/ladder.py``).

The paper's headline evaluation compares foveated transcodes at explicit
bitrates (reference: the encode_bitrate program takes a bits/s argument,
src/run_satlogrectilinear.cc:660-763,669-676, feeding the explicit-bitrate
encoder config, src/video_encoder.cc:210-342).  This module reproduces
that axis: for each technique (log-rectilinear, log-polar, plain
downsample) and each ladder rung, the reduced stream goes through a real
rate-controlled inter-frame encode, gets decoded back, is restored to full
resolution, and is scored against the source (full-frame, foveal, and
eccentricity-weighted PSNR).

The ladder answers the question the reference system exists to answer:
how many bits/s does each technique need for a given perceived quality?
The foveation, the restore and the metrics run on ``device`` (``cuda``
unless the caller passes ``"cpu"``); the codec runs on the host.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from foveax_torch.device import resolve_device
from foveax_torch.pipeline.runner import upload


@dataclasses.dataclass
class Rung:
    technique: str
    target_kbps: float
    actual_kbps: float
    psnr: float
    ws: float
    foveal: float
    ecc: float
    ssim: float
    foveal_ssim: float
    frames: int


def _technique_fns(technique, cfg, device):
    """(reduce_fn, restore_fn, center_fn) for one technique — built once
    per technique; the reduced stream is bitrate-independent, so ladder
    rungs reuse the same reduced frames and only re-encode."""
    from foveax_torch.pipeline.frames import FoveationPipeline

    w, h = cfg.source_width, cfg.source_height
    rw, rh = cfg.reduced_width, cfg.reduced_height

    if technique == "logrect":
        p = FoveationPipeline(cfg, device=device)
        reduce_fn = lambda f, c: p.foveate(upload(f, device), c).cpu().numpy()
        restore_fn = lambda red, c: p.unwarp(upload(red, device), c).cpu().numpy()
        center_fn = p.center
    elif technique == "logpolar":
        from foveax_torch.core.logpolar import (
            logpolar_gaussian_blur,
            make_logpolar_grid,
            sample_logpolar,
            unwarp_logpolar,
        )

        g = make_logpolar_grid(rw, rh, w, h, device=device)
        reduce_fn = lambda f, c: logpolar_gaussian_blur(
            sample_logpolar(upload(f, device), g, c)
        ).cpu().numpy()
        restore_fn = lambda red, c: unwarp_logpolar(
            upload(red, device), w, h, c
        ).cpu().numpy()
        center_fn = lambda cx, cy: torch.tensor(
            [cx, cy], dtype=torch.float32, device=device
        )
    elif technique == "downsample":
        # The no-foveation baseline: uniform bilinear downscale to the
        # same transmitted pixel budget, upscaled back at the client.
        import cv2

        reduce_fn = lambda f, c: cv2.resize(f, (rw, rh), interpolation=cv2.INTER_AREA)
        restore_fn = lambda red, c: cv2.resize(
            red, (w, h), interpolation=cv2.INTER_LINEAR
        )
        center_fn = lambda cx, cy: (cx, cy)
    else:
        raise ValueError(f"unknown technique {technique!r}")
    return reduce_fn, restore_fn, center_fn


def _restored_stream(reduced_frames, centers, frames, restore_fn, cfg,
                     bitrate, fps, codec):
    """(restored, source) pairs + total wire bytes for one rung: push the
    precomputed reduced stream through a real rate-controlled encode."""
    from foveax_torch.io.wirecodec import make_wire_decoder, make_wire_encoder

    rw, rh = cfg.reduced_width, cfg.reduced_height
    enc = make_wire_encoder(
        codec, rw, rh, fps, bitrate=int(bitrate), crf=-1, gop_size=30
    )
    dec = make_wire_decoder(enc.sample_format, enc.codec_config)
    total_bytes = 0
    pairs = []
    for reduced, c, frame in zip(reduced_frames, centers, frames):
        sample, _ = enc.encode(reduced)
        total_bytes += len(sample)
        got = dec.decode(sample)
        pairs.append((restore_fn(got, c), frame))
    enc.close()
    dec.close()
    return pairs, total_bytes


def run_ladder(
    frames: list[np.ndarray],
    gaze,
    cfg,
    *,
    bitrates_kbps=(500, 1000, 2000, 4000, 8000),
    techniques=("logrect", "logpolar", "downsample"),
    fps: float = 30.0,
    codec: str = "h264",
    device: str | torch.device | None = None,
) -> list[Rung]:
    from foveax_torch.core.metrics import (
        eccentricity_weighted_psnr,
        foveal_psnr,
        foveal_ssim,
        psnr,
        ssim,
        ws_psnr,
    )

    dev = resolve_device(device)
    rungs: list[Rung] = []
    for technique in techniques:
        # The device foveation is bitrate-independent: reduce once per
        # technique, re-encode per rung.
        reduce_fn, restore_fn, center_fn = _technique_fns(technique, cfg, dev)
        centers = [center_fn(*gaze(i)) for i in range(len(frames))]
        reduced_frames = [
            reduce_fn(f, c) for f, c in zip(frames, centers)
        ]
        for kbps in bitrates_kbps:
            pairs, total_bytes = _restored_stream(
                reduced_frames, centers, frames, restore_fn, cfg,
                kbps * 1000, fps, codec,
            )
            full, ws, fov, ecc, ss, fss = [], [], [], [], [], []
            for i, (restored, src) in enumerate(pairs):
                c = torch.tensor(list(gaze(i)), dtype=torch.float32, device=dev)
                rj, sj = upload(restored, dev), upload(src, dev)
                full.append(float(psnr(rj, sj)))
                ws.append(float(ws_psnr(rj, sj)))
                fov.append(float(foveal_psnr(rj, sj, c)))
                ecc.append(float(eccentricity_weighted_psnr(rj, sj, c)))
                # Structural twin: PSNR flatters the periphery's blur and
                # the codec's low-bitrate smoothing; SSIM does not.
                ss.append(float(ssim(rj, sj)))
                fss.append(float(foveal_ssim(rj, sj, c)))
            n = len(pairs)
            rungs.append(
                Rung(
                    technique=technique,
                    target_kbps=float(kbps),
                    actual_kbps=total_bytes * 8 * fps / n / 1e3,
                    psnr=sum(full) / n,
                    ws=sum(ws) / n,
                    foveal=sum(fov) / n,
                    ecc=sum(ecc) / n,
                    ssim=sum(ss) / n,
                    foveal_ssim=sum(fss) / n,
                    frames=n,
                )
            )
    return rungs


def format_table(rungs: list[Rung]) -> str:
    lines = [
        "| technique | target kbit/s | actual kbit/s | PSNR dB | WS-PSNR dB | foveal dB | ecc-weighted dB | SSIM | foveal SSIM |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in rungs:
        lines.append(
            f"| {r.technique} | {r.target_kbps:.0f} | {r.actual_kbps:.0f} "
            f"| {r.psnr:.2f} | {r.ws:.2f} | {r.foveal:.2f} | {r.ecc:.2f} "
            f"| {r.ssim:.4f} | {r.foveal_ssim:.4f} |"
        )
    return "\n".join(lines)
