"""Minimal WKT parsing + polygon rasterization (shapely-free).

The reference uses shapely only to parse TEOChatlas WKT polygon strings and
hand their exterior rings to PIL's ImageDraw.polygon (detection.py:137-158) —
holes are ignored by that code path. This module reproduces exactly that:
parse POLYGON / MULTIPOLYGON / GEOMETRYCOLLECTION exteriors and rasterize with
`ImageDraw.polygon(outline=1, fill=1)`, so masks are pixel-identical to the
reference's.

The port's own copy of teochat_tpu/eval/geometry.py. Pillow is imported
inside `create_mask`, the one function that draws, so that the
classification metrics and eval.py import without it.
"""

from __future__ import annotations

import re
from typing import List, Sequence, Tuple, Union

import numpy as np

Ring = List[Tuple[float, float]]


def _parse_ring(text: str) -> Ring:
    pts = []
    for pair in text.split(","):
        nums = pair.split()
        if len(nums) < 2:
            raise ValueError(f"bad WKT coordinate: {pair!r}")
        pts.append((float(nums[0]), float(nums[1])))
    return pts


def _split_top_level(text: str) -> List[str]:
    """Split on commas at parenthesis depth 0."""
    parts, depth, start = [], 0, 0
    for i, c in enumerate(text):
        if c == "(":
            depth += 1
        elif c == ")":
            depth -= 1
        elif c == "," and depth == 0:
            parts.append(text[start:i])
            start = i + 1
    parts.append(text[start:])
    return [p.strip() for p in parts if p.strip()]


def wkt_exteriors(wkt: Union[str, Sequence[str]]) -> List[Ring]:
    """Exterior rings of the geometry(ies) in a WKT string (or list of them)."""
    if not isinstance(wkt, str):
        rings: List[Ring] = []
        for w in wkt:
            rings.extend(wkt_exteriors(w))
        return rings

    s = wkt.strip()
    if not s or s.upper().endswith("EMPTY"):
        return []
    m = re.match(r"^\s*([A-Za-z ]+?)\s*\((.*)\)\s*$", s, re.S)
    if not m:
        raise ValueError(f"unparseable WKT: {s[:80]!r}")
    gtype = m.group(1).strip().upper()
    body = m.group(2).strip()

    if gtype == "POLYGON":
        # body = "(ring), (hole), ..." — exterior is the first ring
        rings = _split_top_level(body)
        first = rings[0].strip()
        if first.startswith("("):
            first = first[1:-1]
        return [_parse_ring(first)]
    if gtype == "MULTIPOLYGON":
        # body = "((ring),(hole)), ((ring))"
        out = []
        for poly in _split_top_level(body):
            poly = poly.strip()
            if poly.startswith("("):
                poly = poly[1:-1]
            out.extend(wkt_exteriors(f"POLYGON ({poly})"))
        return out
    if gtype == "GEOMETRYCOLLECTION":
        out = []
        for geom in _split_top_level(body):
            out.extend(wkt_exteriors(geom))
        return out
    if gtype in ("POINT", "LINESTRING", "MULTIPOINT", "MULTILINESTRING"):
        return []  # zero-area geometries rasterize to nothing in the reference
    raise ValueError(f"unsupported WKT type: {gtype}")


def create_mask(polygons: Union[str, Sequence, Ring], im_size: Tuple[int, int]) -> np.ndarray:
    """Rasterize exterior rings to a uint8 mask (reference create_mask
    semantics: ImageDraw.polygon(outline=1, fill=1) per polygon)."""
    if isinstance(polygons, str) or (
        polygons and isinstance(polygons, (list, tuple))
        and isinstance(polygons[0], str)
    ):
        rings = wkt_exteriors(polygons)
    elif polygons and isinstance(polygons[0], tuple):
        rings = [polygons]  # already a single ring
    else:
        rings = list(polygons)

    from PIL import Image, ImageDraw

    img = Image.new("L", im_size, 0)
    draw = ImageDraw.Draw(img)
    for ring in rings:
        if len(ring) >= 2:
            draw.polygon([(float(x), float(y)) for x, y in ring], outline=1, fill=1)
    return np.array(img)


def boxes_to_wkt(boxes: Sequence[Sequence[float]]) -> List[str]:
    """[x1,y1,x2,y2] -> rectangle POLYGON WKT (reference detection.py:205-208)."""
    return [
        f"POLYGON (({b[0]} {b[1]}, {b[0]} {b[3]}, {b[2]} {b[3]}, {b[2]} {b[1]}, {b[0]} {b[1]}))"
        for b in boxes
    ]
