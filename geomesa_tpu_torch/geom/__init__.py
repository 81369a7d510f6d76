"""Geometry subset for ECQL literals (counterpart: ``geomesa_tpu/geom``)."""

from geomesa_tpu_torch.geom.base import (
    Envelope,
    Geometry,
    LineString,
    MultiLineString,
    MultiPoint,
    MultiPolygon,
    Point,
    Polygon,
)
from geomesa_tpu_torch.geom.predicates import points_in_polygon, polygon_edges
from geomesa_tpu_torch.geom.wkt import parse_wkt, to_wkt

__all__ = [
    "Envelope",
    "Geometry",
    "Point",
    "LineString",
    "Polygon",
    "MultiPoint",
    "MultiLineString",
    "MultiPolygon",
    "parse_wkt",
    "points_in_polygon",
    "polygon_edges",
    "to_wkt",
]
