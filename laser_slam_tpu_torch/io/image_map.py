"""Occupancy maps from images and back (port of ``io/image_map.py``).

Dark pixels are occupied, light ones free, mid-gray unknown (the
reference's ``CVPmap::constructFromImage`` thresholds); image row 0 is the
map's top. PIL reads and writes the files and is imported only there.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.device import resolve_device
from ..mapping.occupancy import (
    LO_MAX,
    LO_MIN,
    LOCALIZATION_RESOLUTION,
    GridSpec2D,
    OccupancyGrid,
)

# Pixel thresholds (<= 100 occupied, >= 200 free).
OCC_PIXEL_MAX = 100
FREE_PIXEL_MIN = 200


def grid_from_image(
    path: str,
    resolution: float = LOCALIZATION_RESOLUTION,
    origin_x: float = 0.0,
    origin_y: float = 0.0,
    device=None,
) -> OccupancyGrid:
    """Load an image as an occupancy grid on ``device`` (default ``cuda``;
    raises where there is none, ``"cpu"`` asks for the CPU)."""
    from PIL import Image

    dev = resolve_device(device)
    img = np.asarray(Image.open(path).convert("L"))
    img = img[::-1]  # image y-down → grid y-up
    lo = np.zeros(img.shape, np.float32)
    lo[img <= OCC_PIXEL_MAX] = LO_MAX
    lo[img >= FREE_PIXEL_MIN] = LO_MIN
    h, w = img.shape
    return OccupancyGrid(
        log_odds=torch.as_tensor(lo, device=dev),
        spec=GridSpec2D(origin_x, origin_y, resolution, w, h),
    )


def grid_to_image_array(grid: OccupancyGrid) -> np.ndarray:
    """Inverse: uint8 image (0 = occupied, 255 = free, 128 = unknown)."""
    lo = grid.log_odds.detach().cpu().numpy()
    img = np.full(lo.shape, 128, np.uint8)
    img[lo > 0] = 0
    img[lo < 0] = 255
    return img[::-1]


def save_grid_image(grid: OccupancyGrid, path: str) -> None:
    from PIL import Image

    Image.fromarray(grid_to_image_array(grid)).save(path)
