"""YCbCr -> RGBA color conversion in int32 torch ops.

Port of `mpeg_tpu.ops.color` (`ycbcr_to_rgb_int`, `ycbcr420_to_rgba`,
`flat_frame_to_rgba`): the exact integer BT.601 conversion of Go's
image/color.YCbCrToRGB, which the reference's Frame.RGBA reaches through
image/draw.  JAX computes it in
`jnp` outside any Pallas kernel, so plain torch is its port; it runs on
any torch device.  The fixed-point constants are Go's (91881/65536 =
1.402 etc.).
"""

from __future__ import annotations

import torch

from .video_recon import FrameGeometry

__all__ = ["flat_frame_to_rgba", "ycbcr420_to_rgba", "ycbcr_to_rgb_int"]


def _squash(c: torch.Tensor) -> torch.Tensor:
    # Go: if uint32(c)&0xff000000 == 0 { c >>= 16 }
    #     else { c = ^(c>>31) & 0xffff }
    # On int32, uint32(c)'s top byte is zero exactly when c >> 24 == 0;
    # the out-of-range value's low byte (0 or 0xff) is what uint8 keeps.
    return torch.where((c >> 24) == 0, c >> 16, (~(c >> 31)) & 0xFF) \
        .to(torch.uint8)


def ycbcr_to_rgb_int(y, cb, cr):
    """Exact Go image/color.YCbCrToRGB on integer tensors of one shape ->
    (r, g, b) uint8."""
    yy1 = y.to(torch.int32) * 0x10101
    cb1 = cb.to(torch.int32) - 128
    cr1 = cr.to(torch.int32) - 128
    return (_squash(yy1 + 91881 * cr1),
            _squash(yy1 - 22554 * cb1 - 46802 * cr1),
            _squash(yy1 + 116130 * cb1))


def ycbcr420_to_rgba(y_plane, cb_plane, cr_plane, width: int, height: int):
    """4:2:0 planes (macroblock-rounded, any leading axes) ->
    [..., height, width, 4] RGBA uint8: each chroma sample covers a 2x2
    luma block; alpha 255 (reference: `mpeg_tpu.ops.color.ycbcr420_to_rgba`,
    Frame.RGBA)."""
    rows = torch.arange(height, device=y_plane.device) // 2
    cols = torch.arange(width, device=y_plane.device) // 2
    up = lambda p: p[..., rows, :][..., cols]                # noqa: E731
    r, g, b = ycbcr_to_rgb_int(y_plane[..., :height, :width], up(cb_plane),
                               up(cr_plane))
    return torch.stack([r, g, b, torch.full_like(r, 255)], dim=-1)


def flat_frame_to_rgba(flat: torch.Tensor, geom: FrameGeometry):
    """Shared-layout flat frame buffers uint8 [..., total_size] ->
    [..., height, width, 4] RGBA uint8."""
    lead = flat.shape[:-1]
    cb0 = geom.luma_size
    cr0 = geom.luma_size + geom.chroma_size
    y = flat[..., :cb0].reshape(*lead, geom.luma_height, geom.luma_width)
    cb = flat[..., cb0:cr0].reshape(*lead, geom.chroma_height,
                                    geom.chroma_width)
    cr = flat[..., cr0:geom.frame_size].reshape(*lead, geom.chroma_height,
                                                geom.chroma_width)
    return ycbcr420_to_rgba(y, cb, cr, geom.width, geom.height)
