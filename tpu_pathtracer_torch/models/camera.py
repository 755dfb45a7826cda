"""Pinhole camera and primary-ray generation.

Equivalent of the ``rayGenerator`` kernel (reference:
renderer/Shaders.metal:75-103): camera at ``up - view*2.35`` = (0, 1, 2.35)
looking down -z, 90-degree horizontal FOV, aspect-corrected, with an AA
jitter of +-1/(dim-1) in normalized coords.  Rows count top-down; the
reference's ``threadId.y`` is ``H-1-row``.  The port of
``tpu_pathtracer/models/camera.py``, with its thin-lens extension
(``aperture > 0``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.math3d import normalize
from ..render.timing import span


class Camera(NamedTuple):
    t: float = 0.0          # turntable angle, 0.0 in the reference
    aperture: float = 0.0   # thin-lens radius (extension; 0 = pinhole)
    focus: float = 3.35

    @staticmethod
    def reference_default() -> "Camera":
        return Camera()


def generate_rays_flat(camera: Camera, rows: torch.Tensor, cols: torch.Tensor,
                       jitter: torch.Tensor, full_height: int, full_width: int,
                       lens_u: torch.Tensor | None = None, trace=None):
    """Primary rays for an arbitrary pixel enumeration.

    ``rows``/``cols``: (N,) absolute pixel coordinates; ``jitter``: (2, N)
    AA uniforms (the reference's noiseSample.xy); ``lens_u``: (2, N)
    thin-lens disk uniforms, used only when ``camera.aperture > 0``.
    Returns origins (3, N) and directions (3, N), float32.  The three basis
    vectors reach the device as copies from host memory, each of which waits
    for the stream: ``trace`` (render/timing.py) spans each as a host read."""
    dev = jitter.device
    f32 = np.float32
    aspect = float(f32(full_height) / f32(full_width))
    ct, st = float(np.cos(f32(camera.t))), float(np.sin(f32(camera.t)))
    with span(trace, "host_read"):
        side = torch.tensor([ct, 0.0, st], dtype=torch.float32, device=dev)
    with span(trace, "host_read"):
        up = torch.tensor([0.0, 1.0, 0.0], dtype=torch.float32, device=dev)
    with span(trace, "host_read"):
        view = torch.tensor([st, 0.0, -ct], dtype=torch.float32, device=dev)

    x = cols.to(torch.float32)
    y = float(full_height - 1) - rows.to(torch.float32)  # rows count bottom-up

    wm1 = float(max(full_width - 1, 1))
    hm1 = float(max(full_height - 1, 1))
    du = (jitter[0] * 2.0 - 1.0) / wm1
    dv = (jitter[1] * 2.0 - 1.0) / hm1
    ncx = 2.0 * x / wm1 - 1.0
    ncy = 2.0 * y / hm1 - 1.0

    dx = du + ncx
    # parity quirk: aspect scales only the pixel coordinate, NOT the jitter
    # (renderer/Shaders.metal:92-98)
    dy = dv + ncy * aspect
    directions = side[:, None] * dx[None, :] + up[:, None] * dy[None, :] + view[:, None]
    directions = normalize(directions)
    origin = up - view * 2.35
    origins = origin[:, None].expand(directions.shape).contiguous()
    if camera.aperture > 0.0 and lens_u is not None:
        # thin lens: every lens point aims at the pinhole ray's focal-plane
        # point, so geometry at ``focus`` (along the view axis) stays sharp
        ft = float(np.float32(camera.focus)) / torch.clamp(
            (directions * view[:, None]).sum(0), min=1e-6)
        target = origins + directions * ft[None]
        r = float(np.float32(camera.aperture)) * torch.sqrt(lens_u[0])
        th = float(np.float32(2.0 * 3.14159265358979)) * lens_u[1]
        lx = r * torch.cos(th)
        ly = r * torch.sin(th)
        origins = origins + side[:, None] * lx[None] + up[:, None] * ly[None]
        directions = normalize(target - origins)
    return origins, directions

