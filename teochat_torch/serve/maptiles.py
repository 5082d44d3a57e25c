"""Offline map-tile math: Web-Mercator coordinates, tile URLs, stitching.

The port's own copy of teochat_tpu/serve/maptiles.py (host-only: numpy, and
Pillow where a view is saved), kept equal to it
(tests/test_torch_host_copies.py).

The reference demo renders satellite basemaps by handing tile URL templates to
plotly's raster-mapbox layer (teochat_demo.py:548-627: Google / four
PlanetScope quarterly mosaics / USGS, `center_map`, `get_single_map_image`,
`get_temporal_map_image_paths`). That hides the tile math inside plotly and
needs network egress at call time.

Here the same capability is pure logic behind an injected `fetcher`:
- slippy-map (Web-Mercator XYZ) coordinate math (`deg2num`),
- the reference's exact URL templates (`tile_url`),
- view planning + stitching + center-crop (`render_map_view`), and
- the temporal 4-quarter sequence the demo feeds the model
  (`get_temporal_map_images`, same quarter order as teochat_demo.py:612-616).

`fetcher(url) -> np.ndarray[tile_px, tile_px, 3]` is injected so tests run
from canned tiles and production can plug any HTTP client; the default
raises a clear error in this egress-free deployment.
"""

from __future__ import annotations

import math
import os
import tempfile
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

TILE_PX = 256

# teochat_demo.py:553-560 — exact templates (Planet keys appended at call time)
BASEMAP_SOURCES = {
    "Google Maps": "https://mt0.google.com/vt/lyrs=s&hl=en&x={x}&y={y}&z={z}",
    "PlanetScope Q2 2024": "https://tiles.planet.com/basemaps/v1/planet-tiles/global_quarterly_2024q2_mosaic/gmap/{z}/{x}/{y}.png?api_key=",
    "PlanetScope Q1 2024": "https://tiles.planet.com/basemaps/v1/planet-tiles/global_quarterly_2024q1_mosaic/gmap/{z}/{x}/{y}.png?api_key=",
    "PlanetScope Q4 2023": "https://tiles.planet.com/basemaps/v1/planet-tiles/global_quarterly_2023q4_mosaic/gmap/{z}/{x}/{y}.png?api_key=",
    "PlanetScope Q3 2023": "https://tiles.planet.com/basemaps/v1/planet-tiles/global_quarterly_2023q3_mosaic/gmap/{z}/{x}/{y}.png?api_key=",
    "United States Geological Survey": "https://basemap.nationalmap.gov/arcgis/rest/services/USGSImageryOnly/MapServer/tile/{z}/{y}/{x}",
}

# the temporal demo's quarter order: Q3 2023 is the "first" frame, the rest
# follow (teochat_demo.py:612-616)
TEMPORAL_BASEMAPS = (
    "PlanetScope Q3 2023",
    "PlanetScope Q2 2024",
    "PlanetScope Q1 2024",
    "PlanetScope Q4 2023",
)


def deg2num(lat: float, lon: float, zoom: int) -> Tuple[float, float]:
    """WGS84 degrees -> fractional slippy-map tile coordinates (x, y)."""
    n = 2.0 ** zoom
    x = (lon + 180.0) / 360.0 * n
    lat_r = math.radians(lat)
    y = (1.0 - math.asinh(math.tan(lat_r)) / math.pi) / 2.0 * n
    return x, y


def num2deg(x: float, y: float, zoom: int) -> Tuple[float, float]:
    """Inverse of deg2num: tile coords -> (lat, lon) of the point."""
    n = 2.0 ** zoom
    lon = x / n * 360.0 - 180.0
    lat = math.degrees(math.atan(math.sinh(math.pi * (1.0 - 2.0 * y / n))))
    return lat, lon


def tile_url(basemap: str, x: int, y: int, z: int,
             planet_api_key: Optional[str] = None) -> str:
    """URL for one XYZ tile; mirrors center_map's source handling
    (teochat_demo.py:561-566 incl. the Planet key requirement)."""
    template = BASEMAP_SOURCES[basemap]
    if "Planet" in basemap:
        if planet_api_key is None:
            raise ValueError("Please provide a Planet API key using --planet-api-key")
        template += planet_api_key
    return template.format(x=x, y=y, z=z)


def _default_fetcher(url: str) -> np.ndarray:
    raise RuntimeError(
        "map-tile fetch needs network egress, which this deployment blocks; "
        "inject fetcher=your_http_client into render_map_view / "
        f"get_temporal_map_images (wanted: {url})"
    )


def plan_view(lat: float, lon: float, zoom: int, size_px: int = 512,
              tile_px: int = TILE_PX) -> Tuple[List[Tuple[int, int]], Tuple[int, int]]:
    """Tiles needed for a size_px square centered on (lat, lon).

    Returns (tile_list [(x, y), ...], origin_px (px0, py0)) where origin_px is
    the view's top-left corner in GLOBAL pixel coordinates at this zoom.
    Tile indices wrap in x (antimeridian) and clamp in y (poles).
    """
    xf, yf = deg2num(lat, lon, zoom)
    cx, cy = xf * tile_px, yf * tile_px  # center in global pixels
    px0 = int(math.floor(cx - size_px / 2))
    py0 = int(math.floor(cy - size_px / 2))
    t0x = math.floor(px0 / tile_px)
    t0y = math.floor(py0 / tile_px)
    t1x = math.floor((px0 + size_px - 1) / tile_px)
    t1y = math.floor((py0 + size_px - 1) / tile_px)
    n = 2 ** zoom
    tiles = [
        (tx % n, min(max(ty, 0), n - 1))
        for ty in range(t0y, t1y + 1)
        for tx in range(t0x, t1x + 1)
    ]
    return tiles, (px0, py0)


def stitch_tiles(
    tiles: Dict[Tuple[int, int], np.ndarray],
    origin_px: Tuple[int, int],
    size_px: int,
    zoom: int,
    tile_px: int = TILE_PX,
) -> np.ndarray:
    """Paste fetched tiles into one [size_px, size_px, 3] uint8 view.

    `tiles` maps (x, y) tile indices (wrapped/clamped as plan_view emits
    them) to [tile_px, tile_px, 3] arrays; missing tiles stay black.
    """
    out = np.zeros((size_px, size_px, 3), np.uint8)
    px0, py0 = origin_px
    n = 2 ** zoom
    t0x = math.floor(px0 / tile_px)
    t0y = math.floor(py0 / tile_px)
    t1x = math.floor((px0 + size_px - 1) / tile_px)
    t1y = math.floor((py0 + size_px - 1) / tile_px)
    for ty in range(t0y, t1y + 1):
        for tx in range(t0x, t1x + 1):
            key = (tx % n, min(max(ty, 0), n - 1))
            tile = tiles.get(key)
            if tile is None:
                continue
            # tile's global-pixel box
            gx, gy = tx * tile_px, ty * tile_px
            x_lo = max(gx, px0)
            y_lo = max(gy, py0)
            x_hi = min(gx + tile_px, px0 + size_px)
            y_hi = min(gy + tile_px, py0 + size_px)
            if x_lo >= x_hi or y_lo >= y_hi:
                continue
            out[y_lo - py0 : y_hi - py0, x_lo - px0 : x_hi - px0] = np.asarray(
                tile, np.uint8
            )[y_lo - gy : y_hi - gy, x_lo - gx : x_hi - gx]
    return out


def center_crop_square(img: np.ndarray) -> np.ndarray:
    """Center crop to the shortest dimension (teochat_demo.py:597-607)."""
    h, w = img.shape[:2]
    if w > h:
        left = (w - h) // 2
        return img[:, left : left + h]
    top = (h - w) // 2
    return img[top : top + w]


def render_map_view(
    lat: float,
    lon: float,
    zoom: int,
    basemap: str,
    *,
    fetcher: Callable[[str], np.ndarray] = _default_fetcher,
    planet_api_key: Optional[str] = None,
    size_px: int = 512,
    tile_px: int = TILE_PX,
) -> np.ndarray:
    """get_single_map_image equivalent: fetch + stitch + square view.

    Already square by construction (size_px x size_px), matching the
    reference's crop-to-square postprocessing of plotly's render.
    """
    tile_list, origin = plan_view(lat, lon, zoom, size_px, tile_px)
    fetched = {
        (x, y): fetcher(tile_url(basemap, x, y, zoom, planet_api_key))
        for (x, y) in dict.fromkeys(tile_list)
    }
    return stitch_tiles(fetched, origin, size_px, zoom, tile_px)


def get_temporal_map_images(
    lat: float,
    lon: float,
    zoom: int,
    *,
    fetcher: Callable[[str], np.ndarray] = _default_fetcher,
    planet_api_key: Optional[str] = None,
    size_px: int = 512,
) -> List[np.ndarray]:
    """The demo's 4-quarter temporal sequence (teochat_demo.py:611-616),
    ordered TEMPORAL_BASEMAPS (Q3 2023 first)."""
    return [
        render_map_view(
            lat, lon, zoom, bm, fetcher=fetcher,
            planet_api_key=planet_api_key, size_px=size_px,
        )
        for bm in TEMPORAL_BASEMAPS
    ]


def get_temporal_map_image_paths(
    lat: float,
    lon: float,
    zoom: int,
    *,
    fetcher: Callable[[str], np.ndarray] = _default_fetcher,
    planet_api_key: Optional[str] = None,
    size_px: int = 512,
    tmpdir: Optional[str] = None,
) -> Tuple[str, List[str]]:
    """File-path variant matching the reference's return contract
    (first_image_path, other_image_paths) — teochat_demo.py:611-627."""
    from PIL import Image

    tmpdir = tmpdir or os.environ.get("TMPDIR") or tempfile.gettempdir()
    imgs = get_temporal_map_images(
        lat, lon, zoom, fetcher=fetcher, planet_api_key=planet_api_key,
        size_px=size_px,
    )
    paths = []
    for img in imgs:
        fd, path = tempfile.mkstemp(suffix=".png", dir=tmpdir)
        os.close(fd)
        Image.fromarray(img).save(path)
        paths.append(path)
    return paths[0], paths[1:]
