"""Image staging and device prep (counterpart of ``mx_rcnn_tpu/data/image.py``
``bucket_shape``/``compute_scale``/``stage_raw_to_bucket``/
``space_to_depth2`` and ``mx_rcnn_tpu/data/device_prep.py:_prep_one``).

The host parks raw RGB ``uint8`` pixels in the orientation's static bucket
(:func:`stage_raw_to_bucket`); the device resamples them to the effective
extent by cv2's ``resize(fx=s)`` INTER_LINEAR rule, mirrors them for a
flipped record, normalises, zero-pads and regroups to space-to-depth
(:func:`prep_images`).  No cv2: the machine with the card has none, so the
host's pre-shrink of an oversized raw reproduces cv2's ``uint8`` resize in
numpy (:func:`resize_uint8`).

Image files (counterpart of ``get_image``): :func:`get_image` reads the
format from the file's signature, as cv2 does, and decodes PNG itself
(:func:`decode_png`, ``zlib`` and numpy) and JPEG through PIL when PIL is
installed; :func:`image_size` reads (h, w) from the header alone.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Optional, Sequence, Tuple

import numpy as np
import torch


def bucket_shape(scale: Tuple[int, int], stride: int,
                 landscape: bool = True) -> Tuple[int, int]:
    """Static padded (H, W) for a (short, long) scale pair: both sides
    rounded up to the stride, one shape per orientation."""
    stride = max(int(stride), 1)
    short, long_ = scale
    s = int(np.ceil(short / stride) * stride)
    l = int(np.ceil(long_ / stride) * stride)
    return (s, l) if landscape else (l, s)


def compute_scale(h: int, w: int, scale: Tuple[int, int]) -> float:
    """Reference resize rule: short side → scale[0], long side ≤ scale[1]."""
    short, long_ = min(h, w), max(h, w)
    s = float(scale[0]) / short
    if s * long_ > scale[1]:
        s = float(scale[1]) / long_
    return s


def _resample(img: torch.Tensor, raw_hw: torch.Tensor, ratio: torch.Tensor,
              out_h: int, out_w: int,
              flip: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, Hs, Ws, C) float32 → (B, out_h, out_w, C): bilinear with
    ``src = (dst + 0.5) · ratio − 0.5``, mirrored to ``(w − 1) − src`` on
    the x axis where ``flip`` (B,) is set, clamped to the valid raw extent
    ``raw_hw`` (B, 2), ``y1 = min(y0 + 1, h − 1)`` — cv2 INTER_LINEAR with
    border replicate, computed in float32 as ``_prep_one`` does."""
    dev = img.device
    h = raw_hw[:, 0].to(torch.float32)[:, None]
    w = raw_hw[:, 1].to(torch.float32)[:, None]
    r = ratio.to(torch.float32)[:, None]
    ys = (torch.arange(out_h, dtype=torch.float32, device=dev) + 0.5) * r - 0.5
    xs = (torch.arange(out_w, dtype=torch.float32, device=dev) + 0.5) * r - 0.5
    if flip is not None:
        xs = torch.where(flip[:, None], (w - 1.0) - xs, xs)
    ys = torch.minimum(torch.clamp_min(ys, 0.0), h - 1.0)     # (B, out_h)
    xs = torch.minimum(torch.clamp_min(xs, 0.0), w - 1.0)     # (B, out_w)
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    wy = (ys - y0)[:, :, None, None]
    wx = (xs - x0)[:, None, :, None]
    y0i = y0.long()
    x0i = x0.long()
    y1i = torch.minimum(y0i + 1, raw_hw[:, 0:1].long() - 1)
    x1i = torch.minimum(x0i + 1, raw_hw[:, 1:2].long() - 1)

    c = img.shape[-1]

    def rows(yi):      # (B, out_h, Ws, C)
        return torch.gather(img, 1, yi[:, :, None, None].expand(
            -1, -1, img.shape[2], c))

    def cols(t, xi):   # (B, out_h, out_w, C)
        return torch.gather(t, 2, xi[:, None, :, None].expand(
            -1, t.shape[1], -1, c))

    r0, r1 = rows(y0i), rows(y1i)
    top = cols(r0, x0i) * (1.0 - wx) + cols(r0, x1i) * wx
    bot = cols(r1, x0i) * (1.0 - wx) + cols(r1, x1i) * wx
    return top * (1.0 - wy) + bot * wy


# cv2's fixed-point INTER_LINEAR on uint8: 11-bit weights per axis
# (INTER_RESIZE_COEF_BITS), a horizontal pass into int32, and a vertical
# pass that the SIMD code (which covers every element here) rounds as
# ((S0 >> 4)·b0 >> 16) + ((S1 >> 4)·b1 >> 16), then (+2) >> 2
_COEF_BITS = 11


def _linear_taps(n_src: int, n_dst: int, scale: float, clamp_end: bool):
    """One axis of cv2's INTER_LINEAR table: source rows/columns (i0, i1)
    and 11-bit weights (w0, w1).  ``fx = float((d + 0.5)·scale − 0.5)``,
    ``i0 = floor(fx)``; the x axis pins taps before the start and at or past
    the last pixel (``clamp_end``), the y axis only clips the row index."""
    f = ((np.arange(n_dst, dtype=np.float64) + 0.5) * scale - 0.5).astype(
        np.float32)
    i0 = np.floor(f).astype(np.int64)
    f = f - i0.astype(np.float32)
    if clamp_end:
        pin = (i0 < 0) | (i0 >= n_src - 1)
        f[pin] = 0.0
        i0 = np.clip(i0, 0, n_src - 1)
    one = np.float32(1 << _COEF_BITS)
    w0 = np.rint((np.float32(1.0) - f) * one).astype(np.int64)
    w1 = np.rint(f * one).astype(np.int64)
    return (np.clip(i0, 0, n_src - 1), np.clip(i0 + 1, 0, n_src - 1), w0, w1)


def _shrink_half_area(im: np.ndarray, dh: int, dw: int) -> np.ndarray:
    """cv2's exact-2× path (INTER_LINEAR switches to INTER_AREA there):
    each full 2×2 block is ``(sum + 2) >> 2``; a block cut by an odd edge
    is the rounded (half to even) float mean of the pixels it has."""
    h, w, c = im.shape
    hh, ww = min(h, 2 * dh), min(w, 2 * dw)
    px = np.zeros((2 * dh, 2 * dw, c), np.int64)
    px[:hh, :ww] = im[:hh, :ww]
    n = np.zeros((2 * dh, 2 * dw), np.int64)
    n[:hh, :ww] = 1
    sums = px.reshape(dh, 2, dw, 2, c).sum(axis=(1, 3))
    counts = n.reshape(dh, 2, dw, 2).sum(axis=(1, 3))
    out = np.rint(sums.astype(np.float32)
                  / counts[..., None].astype(np.float32)).astype(np.int64)
    fh, fw = min(dh, h // 2), min(dw, w // 2)
    out[:fh, :fw] = (sums[:fh, :fw] + 2) >> 2
    return out.astype(np.uint8)


def resize_uint8(im: np.ndarray, s: float) -> np.ndarray:
    """``cv2.resize(im, None, fx=s, fy=s, interpolation=INTER_LINEAR)`` on
    a (H, W, C) uint8 image, byte for byte, in numpy: output size
    ``round(dim·s)`` (half to even, as cvRound), the exact-2× INTER_AREA
    switch, else the fixed-point bilinear above."""
    h, w, _ = im.shape
    dh, dw = int(round(h * s)), int(round(w * s))
    scale = 1.0 / s
    if abs(scale - round(scale)) < np.finfo(np.float64).eps and \
            round(scale) == 2:
        return _shrink_half_area(im, dh, dw)
    x0, x1, a0, a1 = _linear_taps(w, dw, scale, clamp_end=True)
    y0, y1, b0, b1 = _linear_taps(h, dh, scale, clamp_end=False)
    px = im.astype(np.int64)
    rows = px[:, x0] * a0[None, :, None] + px[:, x1] * a1[None, :, None]
    v = (((rows[y0] >> 4) * b0[:, None, None]) >> 16) + \
        (((rows[y1] >> 4) * b1[:, None, None]) >> 16)
    return np.clip((v + 2) >> 2, 0, 255).astype(np.uint8)


def stage_raw_to_bucket(im: np.ndarray, scale: Tuple[int, int], stride: int):
    """Park RAW uint8 pixels in the orientation's bucket for
    :func:`prep_images`.

    Returns ``(staged (Hb, Wb, 3) uint8, raw_hw (2,) int32, ratio ()
    float32, im_info (3,) float32)``: the valid raw extent, the dst→src
    factor ``1/s`` the device uses on both axes, and ``[eh, ew, s]`` with
    ``eh, ew = round(h·s), round(w·s)`` (cv2's output size).

    A raw image larger than the bucket is pre-shrunk on the host to its
    effective size with :func:`resize_uint8` (the JAX package's cv2 call,
    reproduced byte for byte) and staged with ratio 1.
    """
    h, w = im.shape[:2]
    s = compute_scale(h, w, scale)
    hb, wb = bucket_shape(scale, stride, landscape=(w >= h))
    if h > hb or w > wb:
        im = resize_uint8(im, s)[:hb, :wb]
        h, w = im.shape[:2]
        eh, ew, ratio = h, w, 1.0
    else:
        eh, ew = min(int(round(h * s)), hb), min(int(round(w * s)), wb)
        ratio = 1.0 / s
    out = np.zeros((hb, wb) + im.shape[2:], np.uint8)
    out[:h, :w] = im
    return (out, np.asarray([h, w], np.int32), np.float32(ratio),
            np.asarray([eh, ew, s], np.float32))


def space_to_depth2(im: np.ndarray) -> np.ndarray:
    """2×2 space-to-depth: (H, W, C) → (H/2, W/2, 4C), channel order
    (di, dj, c) — the stem's regroup, done on the host."""
    h, w, c = im.shape
    if h % 2 or w % 2:
        raise ValueError(f"space_to_depth2 needs even sides, got {(h, w)}")
    return (im.reshape(h // 2, 2, w // 2, 2, c)
            .transpose(0, 2, 1, 3, 4)
            .reshape(h // 2, w // 2, 4 * c))


def prep_images(staged: torch.Tensor, raw_hw: torch.Tensor,
                ratio: torch.Tensor, im_info: torch.Tensor, *,
                pixel_means, pixel_stds,
                s2d: bool, dtype: torch.dtype = torch.float32,
                flip: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Staged raw batch → network input, on the tensors' device.

    staged (B, Hb, Wb, 3) uint8, raw_hw (B, 2) int, ratio (B,) float,
    im_info (B, 3), flip (B,) bool or None → (B, Hb, Wb, 3), or (B, Hb/2,
    Wb/2, 12) with ``s2d``: resampled (mirrored where ``flip``: the raw
    bytes arrive unflipped, the roidb's boxes already are),
    ``(v − mean) / std``, zero outside the effective extent.
    ``pixel_means``/``pixel_stds``: three numbers each, or (3,) float32
    tensors already on the device (no host copy then).
    """
    b, hb, wb, c = staged.shape
    dev = staged.device
    v = _resample(staged.to(torch.float32), raw_hw, ratio, hb, wb, flip)
    mean = torch.as_tensor(pixel_means, dtype=torch.float32, device=dev)
    std = torch.as_tensor(pixel_stds, dtype=torch.float32, device=dev)
    v = (v - mean) / std
    ehi = im_info[:, 0].to(torch.int32)[:, None]
    ewi = im_info[:, 1].to(torch.int32)[:, None]
    inside = ((torch.arange(hb, device=dev)[None, :] < ehi)[:, :, None]
              & (torch.arange(wb, device=dev)[None, :] < ewi)[:, None, :])
    v = torch.where(inside[..., None], v, 0.0)
    if s2d:
        v = (v.reshape(b, hb // 2, 2, wb // 2, 2, c)
             .permute(0, 1, 3, 2, 4, 5)
             .reshape(b, hb // 2, wb // 2, 4 * c))
    return v.to(dtype)


# ---- image files --------------------------------------------------------------

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
_JPEG_SIG = b"\xff\xd8\xff"
# JPEG start-of-frame markers: every SOFn but DHT (C4), JPG (C8) and DAC (CC)
_SOF = frozenset(range(0xC0, 0xD0)) - {0xC4, 0xC8, 0xCC}
# PNG colour types of 8-bit samples this decoder reads: gray, RGB, RGBA
_PNG_CHANNELS = {0: 1, 2: 3, 6: 4}


def _png_chunks(data: bytes):
    """(type, payload) of every chunk after the signature, CRCs checked."""
    pos = len(_PNG_SIG)
    while pos + 12 <= len(data):
        n, = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        crc, = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if len(body) != n or zlib.crc32(kind + body) != crc:
            raise ValueError(f"corrupt PNG chunk {kind!r}")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + n
    raise ValueError("PNG ends without an IEND chunk")


def _png_unfilter(filt: np.ndarray, ftype: np.ndarray) -> np.ndarray:
    """Undo PNG's per-row filters on (H, W, C) int32 filtered samples of
    8-bit depth (the left neighbour of a sample is the same channel of the
    previous pixel).  Sub, Average and Paeth depend on the reconstructed
    left neighbour and every filter on the row above, so the pixels are
    reconstructed one anti-diagonal y + x = d at a time, all of a diagonal
    at once, each row by its own filter."""
    h, w, c = filt.shape
    out = np.zeros((h + 1, w + 1, c), np.int32)   # row 0 and column 0: zero
    for d in range(h + w - 1):
        ys = np.arange(max(0, d - w + 1), min(h, d + 1))
        xs = d - ys
        a = out[ys + 1, xs]                        # left
        b = out[ys, xs + 1]                        # up
        cc = out[ys, xs]                           # up-left
        p = a + b - cc
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - cc)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, cc))
        t = ftype[ys][:, None]
        pred = np.select([t == 1, t == 2, t == 3, t == 4],
                         [a, b, (a + b) >> 1, paeth], 0)
        out[ys + 1, xs + 1] = (filt[ys, xs] + pred) & 0xFF
    return out[1:, 1:]


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes → RGB uint8 (H, W, 3), as ``cv2.imread(IMREAD_COLOR)`` then
    BGR→RGB gives it: gray replicated to three channels, alpha dropped.
    Reads 8-bit gray, RGB and RGBA images without interlace; any other
    kind raises ``ValueError``."""
    if not data.startswith(_PNG_SIG):
        raise ValueError("not a PNG file")
    header, idat = None, []
    for kind, body in _png_chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG without an IHDR chunk")
    w, h, depth, ctype, comp, filt_method, interlace = header
    if depth != 8 or ctype not in _PNG_CHANNELS or comp or filt_method \
            or interlace:
        raise ValueError(f"unsupported PNG: bit depth {depth}, colour type "
                         f"{ctype}, interlace {interlace} (this decoder "
                         f"reads 8-bit gray, RGB and RGBA, not interlaced)")
    c = _PNG_CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (w * c + 1):
        raise ValueError(f"PNG data holds {raw.size} bytes, expected "
                         f"{h * (w * c + 1)}")
    rows = raw.reshape(h, w * c + 1)
    ftype = rows[:, 0].astype(np.int32)
    if (ftype > 4).any():
        raise ValueError(f"unknown PNG filter type {int(ftype.max())}")
    im = _png_unfilter(rows[:, 1:].reshape(h, w, c).astype(np.int32), ftype)
    im = im.astype(np.uint8)
    if c == 1:
        return np.repeat(im, 3, axis=2)
    return np.ascontiguousarray(im[..., :3])


def _read_head(path: str, n: int) -> bytes:
    if not os.path.isfile(path):
        raise FileNotFoundError(path)
    with open(path, "rb") as f:
        return f.read(n)


def get_image(path: str, flipped: bool = False) -> np.ndarray:
    """Image file → RGB uint8 (H, W, 3) (counterpart of the JAX package's
    ``cv2.imread`` + BGR→RGB).  The format is taken from the file's
    signature, not its name, as cv2 does: PNG through :func:`decode_png`;
    JPEG through PIL when it is importable, else a ``RuntimeError`` that
    names the missing decoder.  ``flipped`` mirrors the columns."""
    head = _read_head(path, 8)
    if head.startswith(_PNG_SIG):
        with open(path, "rb") as f:
            im = decode_png(f.read())
    elif head.startswith(_JPEG_SIG):
        try:
            from PIL import Image
        except ImportError:
            raise RuntimeError(
                f"{path}: JPEG decoding needs PIL (Pillow), which is not "
                f"installed; the port decodes PNG itself") from None
        with Image.open(path) as f:
            im = np.asarray(f.convert("RGB"))
    else:
        raise ValueError(f"{path}: neither PNG nor JPEG")
    if flipped:
        im = im[:, ::-1, :]
    return im


def image_size(path: str) -> Tuple[int, int]:
    """(height, width) of a PNG or JPEG file from its header (the PNG IHDR,
    the JPEG start-of-frame marker), without decoding the pixels."""
    head = _read_head(path, 24)
    if head.startswith(_PNG_SIG):
        w, h = struct.unpack(">II", head[16:24])
        return int(h), int(w)
    if not head.startswith(_JPEG_SIG):
        raise ValueError(f"{path}: neither PNG nor JPEG")
    with open(path, "rb") as f:
        f.seek(2)
        while True:
            byte = f.read(1)
            if not byte:
                break
            if byte != b"\xff":
                continue
            marker = f.read(1)
            while marker == b"\xff":                 # fill bytes
                marker = f.read(1)
            if not marker:
                break
            m = marker[0]
            if m == 0x01 or 0xD0 <= m <= 0xD9:       # no length follows
                continue
            n, = struct.unpack(">H", f.read(2))
            if m in _SOF:
                _, h, w = struct.unpack(">BHH", f.read(5))
                return int(h), int(w)
            f.seek(n - 2, os.SEEK_CUR)
    raise ValueError(f"{path}: no JPEG start-of-frame marker")
