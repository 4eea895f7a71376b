"""Mask R-CNN mask paste on the device (counterpart of
``mx_rcnn_tpu/ops/mask_paste.py``: ``_axis_weights``, ``paste_masks``).

Bilinear resize is separable, so a 28×28 probability map pasted into the
padded image frame is ``Wy @ prob @ Wxᵀ`` with one weight matrix per axis
and box; the product is thresholded at 0.5 and bit-packed on the device,
so a batch's masks come back in one readback of packed bits and the host
only runs the RLE encoder (``native.rle_encode_packed``).  The products
are library matmuls in float32 with TF32 switched off: a TF32 product
rounds the inputs to 10 mantissa bits and flips pixels at the threshold.

Semantics of ``eval/tester.py:paste_mask``: the integer window [floor(x1),
ceil(x2)] × [floor(y1), ceil(y2)], source position ``(j + 0.5) · M /
extent − 0.5`` clamped to the map's edge, threshold ``>= 0.5``.

Output layout, transposed for the encoder's column-major scan: (B, R, Wp,
Hp/8) uint8, bit ``y & 7`` of byte ``[x, y >> 3]`` is pixel (y, x).
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def no_tf32():
    """float32 matmuls in full precision for the block (torch's flag is
    process-wide; it is restored on exit)."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def _axis_weights(lo: torch.Tensor, hi: torch.Tensor, npix: int,
                  m: int) -> torch.Tensor:
    """(…) box edges (inclusive, any float) → (…, npix, m) paste weights:
    row ``p`` holds the source-bin weights of frame pixel ``p``, zero
    outside the integer paste window."""
    lo_i = torch.floor(lo)[..., None]
    extent = torch.clamp_min(torch.ceil(hi)[..., None] - lo_i + 1.0, 1.0)
    pix = torch.arange(npix, dtype=torch.float32, device=lo.device)
    j = pix - lo_i                                          # (…, npix)
    inside = (j >= 0.0) & (j <= extent - 1.0)
    src = (j + 0.5) * (float(m) / extent) - 0.5
    i0 = torch.floor(src)
    f = src - i0
    bins = torch.arange(m, dtype=torch.float32, device=lo.device)
    lo_bin = torch.clamp(i0, 0, m - 1)[..., None]
    hi_bin = torch.clamp(i0 + 1.0, 0, m - 1)[..., None]
    w = ((bins == lo_bin) * (1.0 - f)[..., None]
         + (bins == hi_bin) * f[..., None])
    return torch.where(inside[..., None], w, 0.0)


def paste_masks(probs: torch.Tensor, boxes: torch.Tensor, hp: int, wp: int,
                chunk: int = 8) -> torch.Tensor:
    """(B, R, M, M) probabilities + (B, R, 4) original-frame boxes → (B,
    R, wp, hp // 8) uint8 packed masks in the padded (hp, wp) frame.

    ``hp`` is a multiple of 64 (the encoder reads 64-bit words down a
    column), ``wp`` ≥ the image width; pixels past the true (h, w) are
    never read.  ``chunk`` boxes at a time bound the (B, chunk, wp, hp)
    float32 slab.
    """
    if hp % 64:
        raise ValueError(f"hp={hp} must be a multiple of 64")
    b, r, m, _ = probs.shape
    probs = probs.to(torch.float32)
    boxes = boxes.to(torch.float32)
    bitw = (1 << torch.arange(8, device=probs.device)).to(torch.uint8)
    out = []
    with no_tf32():
        for c0 in range(0, r, chunk):
            p = probs[:, c0:c0 + chunk]                     # (B, C, M, M)
            bx = boxes[:, c0:c0 + chunk]
            wy = _axis_weights(bx[..., 1], bx[..., 3], hp, m)  # (B,C,hp,M)
            wx = _axis_weights(bx[..., 0], bx[..., 2], wp, m)  # (B,C,wp,M)
            # out[w, h] = Σ_n wx[w, n] Σ_m p[m, n] wy[h, m]: transposed, so
            # the packed axis (h) is the minor one
            pasted = torch.matmul(wx, torch.matmul(wy, p).transpose(-1, -2))
            bits = (pasted >= 0.5).to(torch.uint8)
            bits = bits.reshape(b, -1, wp, hp // 8, 8)
            out.append((bits * bitw).sum(dim=-1, dtype=torch.uint8))
    return torch.cat(out, dim=1)
