"""Pinhole camera model.

Replaces the reference's PinholeCamera4f (libvis/src/libvis/camera.h:1608-1611).
Convention: the stored (cx, cy) are in "pixel corner" coordinates — the TUM
loader adds +0.5 to the calibration values (rgbd_video_io_tum_dataset.h:243-244)
— and kernels unproject pixel centers using cx - 0.5 (e.g.
cuda_depth_processing.cu:258-264).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class PinholeCamera:
    width: int
    height: int
    fx: float
    fy: float
    cx: float  # pixel-corner convention (calibration cx + 0.5)
    cy: float

    def scaled(self, factor: float) -> "PinholeCamera":
        """Scaled camera for pyramid levels (camera.h Scaled(); main.cc:749-757)."""
        return PinholeCamera(
            width=int(round(factor * self.width)),
            height=int(round(factor * self.height)),
            fx=factor * self.fx,
            fy=factor * self.fy,
            cx=factor * self.cx,
            cy=factor * self.cy,
        )

    def pyramid_level(self, level: int) -> "PinholeCamera":
        return self.scaled(1.0 / (1 << level)) if level > 0 else self

    @property
    def unprojection(self):
        """(fx_inv, fy_inv, cx_inv, cy_inv) for pixel-center unprojection.

        point.xy = depth * (fx_inv * px + cx_inv), matching the intrinsics
        computed in every preprocessing launcher (cuda_depth_processing.cu:258-264).
        """
        fx_inv = 1.0 / self.fx
        fy_inv = 1.0 / self.fy
        cx_pixel_center = self.cx - 0.5
        cy_pixel_center = self.cy - 0.5
        return (fx_inv, fy_inv,
                -cx_pixel_center / self.fx, -cy_pixel_center / self.fy)

    def __eq__(self, other) -> bool:
        return (self.width == other.width and self.height == other.height and
                self.fx == other.fx and self.fy == other.fy and
                self.cx == other.cx and self.cy == other.cy)
