"""Video encoding without ffmpeg.

Counterpart of ``brax_tracking_tpu/native/video.py``, its writers copied
as they are: ``save_video`` writes an MP4 through ``imageio`` (and ffmpeg)
where they import and work, else an MJPEG AVI (JPEG frames through Pillow,
the RIFF container by hand), else a GIF89a by numpy alone. Neither
``imageio`` nor Pillow is needed: each is imported only inside the writer
that uses it, and its absence falls to the next writer, as in the JAX
package (so on a machine with neither, ``save_video`` writes the GIF).
``count_frames`` reads back how many frames a written AVI or GIF holds.
"""

from __future__ import annotations

import io
import struct
from typing import Iterable, List

import numpy as np


def _jpeg(frame: np.ndarray, quality: int) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(frame).save(buf, format="JPEG", quality=quality)
    return buf.getvalue()


def write_mjpeg_avi(path: str, frames: Iterable[np.ndarray], fps: float = 50.0,
                    quality: int = 85) -> str:
    """Encode RGB uint8 frames (H,W,3) as MJPEG inside an AVI container."""
    jpegs: List[bytes] = []
    h = w = None
    for f in frames:
        f = np.ascontiguousarray(f)
        if h is None:
            h, w = f.shape[:2]
        jpegs.append(_jpeg(f, quality))
    if not jpegs:
        raise ValueError("no frames")
    n = len(jpegs)
    max_size = max(len(j) for j in jpegs)

    def chunk(fourcc: bytes, payload: bytes) -> bytes:
        pad = b"\x00" if len(payload) % 2 else b""
        return fourcc + struct.pack("<I", len(payload)) + payload + pad

    def lst(fourcc: bytes, payload: bytes) -> bytes:
        return chunk(b"LIST", fourcc + payload)

    avih = struct.pack(
        "<14I",
        int(1e6 / fps),      # usec per frame
        max_size * int(fps), # max bytes/s
        0,                   # padding granularity
        0x10,                # AVIF_HASINDEX
        n, 0, 1, max_size, w, h, 0, 0, 0, 0,
    )
    # AVISTREAMHEADER: type, handler, flags, priority, language, initialFrames,
    # scale, rate, start, length, suggestedBuffer, quality, sampleSize, rcFrame
    strh = struct.pack(
        "<4s4sIHHIIIIIIII4h",
        b"vids", b"MJPG", 0, 0, 0, 0,
        1, int(round(fps)), 0, n, max_size, 0xFFFFFFFF, 0,
        0, 0, w, h,
    )
    # BITMAPINFOHEADER
    strf = struct.pack("<IiiHH4sIiiII", 40, w, h, 1, 24, b"MJPG", w * h * 3, 0, 0, 0, 0)

    hdrl = lst(b"hdrl", chunk(b"avih", avih) + lst(b"strl", chunk(b"strh", strh) + chunk(b"strf", strf)))

    movi_payload = b""
    index = b""
    offset = 4  # after 'movi' fourcc
    for j in jpegs:
        c = chunk(b"00dc", j)
        index += b"00dc" + struct.pack("<3I", 0x10, offset, len(j))
        offset += len(c)
        movi_payload += c
    movi = lst(b"movi", movi_payload)
    idx1 = chunk(b"idx1", index)

    body = hdrl + movi + idx1
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", len(body) + 4) + b"AVI " + body)
    return path


def write_gif(path: str, frames: Iterable[np.ndarray], fps: float = 50.0) -> str:
    """First-party GIF89a writer — the no-dependency fallback (no ffmpeg, no
    Pillow). Colors quantize to the 6x6x6 web cube; pixel data is encoded as
    literal LZW codes with periodic clear codes (the classic "uncompressed
    GIF" scheme), so packing is one vectorized np.packbits per frame."""
    frames = list(frames)
    if not frames:
        raise ValueError("no frames")
    h, w = frames[0].shape[:2]

    # global palette: 6-level cube (216 colors) padded to 256
    levels = np.array([0, 51, 102, 153, 204, 255], np.uint8)
    pal = np.zeros((256, 3), np.uint8)
    grid = np.stack(
        np.meshgrid(levels, levels, levels, indexing="ij"), -1
    ).reshape(-1, 3)
    pal[: grid.shape[0]] = grid

    def lzw_literal(idx: np.ndarray) -> bytes:
        """9-bit literal codes + clear every 254 symbols keeps the decoder's
        table below 512 entries so the code width never grows."""
        CLEAR, EOI = 256, 257
        flat = idx.reshape(-1).astype(np.uint16)
        n = flat.size
        step = 254
        nblk = (n + step - 1) // step
        codes = np.full(n + nblk + 1, CLEAR, np.uint16)
        pos = np.arange(n)
        codes[pos + 1 + pos // step] = flat  # leading CLEAR per block
        codes[-1] = EOI
        bits = (codes[:, None] >> np.arange(9)) & 1
        return np.packbits(
            bits.astype(np.uint8).reshape(-1), bitorder="little"
        ).tobytes()

    def subblocks(data: bytes) -> bytes:
        out = b""
        for i in range(0, len(data), 255):
            blk = data[i : i + 255]
            out += bytes([len(blk)]) + blk
        return out + b"\x00"

    delay = max(1, int(round(100.0 / fps)))  # GIF delay is in 1/100 s
    parts = [
        b"GIF89a",
        struct.pack("<HHBBB", w, h, 0xF7, 0, 0),  # 256-color global table
        pal.tobytes(),
        b"\x21\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\x00",  # loop forever
    ]
    for f in frames:
        f = np.ascontiguousarray(f[..., :3])
        q = (f.astype(np.uint16) + 25) // 51  # round to nearest level
        idx = (q[..., 0] * 36 + q[..., 1] * 6 + q[..., 2]).astype(np.uint8)
        # graphic control extension: intro, label, size, flags, delay,
        # transparent index, terminator
        parts.append(
            bytes([0x21, 0xF9, 4, 0]) + struct.pack("<H", delay) + b"\x00\x00"
        )
        parts.append(struct.pack("<BHHHHB", 0x2C, 0, 0, w, h, 0))
        parts.append(b"\x08" + subblocks(lzw_literal(idx)))  # min code size 8
    parts.append(b"\x3b")
    with open(path, "wb") as fh:
        fh.write(b"".join(parts))
    return path


def save_video(path: str, frames: Iterable[np.ndarray], fps: float = 50.0) -> str:
    """MP4 via imageio/ffmpeg when present, else MJPEG AVI (Pillow JPEG),
    else first-party GIF — the harness always produces a playable artifact."""
    frames = list(frames)
    if path.endswith(".mp4"):
        try:
            import imageio

            with imageio.get_writer(path, fps=fps) as wtr:
                for f in frames:
                    wtr.append_data(f)
            return path
        except Exception:
            path = path[:-4] + ".avi"
    if not path.endswith(".avi"):
        path += ".avi"
    try:
        return write_mjpeg_avi(path, frames, fps=fps)
    except ImportError:
        return write_gif(path[:-4] + ".gif", frames, fps=fps)


def count_frames(path: str) -> int:
    """The frames of an AVI (its idx1 index entries) or a GIF (its image
    descriptors, the extension blocks skipped) that this module wrote."""
    with open(path, "rb") as fh:
        data = fh.read()
    if data[:4] == b"RIFF" and data[8:12] == b"AVI ":
        at = data.rindex(b"idx1")
        return struct.unpack_from("<I", data, at + 4)[0] // 16
    if data[:6] not in (b"GIF87a", b"GIF89a"):
        raise ValueError(f"{path} is neither an AVI nor a GIF")

    def skip_subblocks(i):
        while data[i]:
            i += data[i] + 1
        return i + 1

    flags = data[10]
    i = 13 + (3 << ((flags & 7) + 1) if flags & 0x80 else 0)
    frames = 0
    while data[i] != 0x3B:
        if data[i] == 0x21:  # extension: label, sub-blocks
            i = skip_subblocks(i + 2)
        elif data[i] == 0x2C:  # image: descriptor, local table, code size, data
            packed = data[i + 9]
            i += 10 + (3 << ((packed & 7) + 1) if packed & 0x80 else 0)
            i = skip_subblocks(i + 1)
            frames += 1
        else:
            raise ValueError(f"{path}: unknown GIF block 0x{data[i]:02x} at byte {i}")
    return frames
