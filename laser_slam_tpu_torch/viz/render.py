"""Map and trajectory rendering to PNG (numpy; port of ``viz/render.py``).

The PNG is encoded with ``zlib`` from the standard library, so rendering
needs no imaging package.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from ..mapping.occupancy import OccupancyGrid


def grid_to_image(grid: OccupancyGrid) -> np.ndarray:
    """Render the grid to ``[H, W, 3]`` uint8: white = free, black =
    occupied, gray = unknown."""
    lo = np.asarray(grid.log_odds.detach().cpu())
    p = 1.0 / (1.0 + np.exp(-lo))
    img = np.full(lo.shape + (3,), 200, dtype=np.uint8)  # unknown gray
    known = np.abs(lo) > 1e-6
    shade = np.clip((1.0 - p) * 255.0, 0, 255).astype(np.uint8)
    for c in range(3):
        img[..., c] = np.where(known, shade, img[..., c])
    return img[::-1]  # y-up


def draw_trajectory(
    img: np.ndarray, grid: OccupancyGrid, poses: np.ndarray,
    color=(220, 30, 30),
) -> np.ndarray:
    """Overlay trajectory points onto a rendered grid image."""
    spec = grid.spec
    h = spec.height
    xy = np.asarray(poses)[:, :2]
    ix = np.floor((xy[:, 0] - spec.origin_x) / spec.resolution).astype(int)
    iy = np.floor((xy[:, 1] - spec.origin_y) / spec.resolution).astype(int)
    ok = (ix >= 0) & (ix < spec.width) & (iy >= 0) & (iy < h)
    rows = (h - 1 - iy[ok])  # image is y-flipped
    img = img.copy()
    img[rows, ix[ok]] = color
    return img


def save_png(img: np.ndarray, path: str) -> None:
    """Write an ``[H, W, 3]`` uint8 image as an 8-bit RGB PNG."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    h, w = img.shape[:2]
    raw = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * 3)], axis=1)

    def chunk(tag: bytes, data: bytes) -> bytes:
        body = tag + data
        return struct.pack(">I", len(data)) + body + struct.pack(">I", zlib.crc32(body))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)))
        f.write(chunk(b"IEND", b""))


def render_map_png(
    grid: OccupancyGrid, path: str, poses: np.ndarray | None = None
) -> None:
    img = grid_to_image(grid)
    if poses is not None:
        img = draw_trajectory(img, grid, poses)
    save_png(img, path)
