"""Wire-format content negotiation for feature-emitting endpoints.

Copy of ``geomesa_tpu/results/negotiate.py``. The port serves GeoJSON and
BIN; a request that negotiates Arrow is answered 406 by the server (the
card's host has no ``pyarrow``, ROADMAP section 3), so no body ever goes
out under Arrow's content type.

One table: the explicit ``f=`` query parameter wins, else the request's
``Accept`` header is scanned in client order for a media type we serve,
else GeoJSON. Every endpoint that emits features routes through
:func:`negotiate_format` so ``/features``, ``/knn``, ``/tube`` and
``/proximity`` agree on the same spellings and content types.
"""

from __future__ import annotations

#: formats the result plane serves, in documentation order
FORMATS = ("geojson", "arrow", "bin")

#: response Content-Type per format
CONTENT_TYPES = {
    "geojson": "application/json",
    "arrow": "application/vnd.apache.arrow.stream",
    "bin": "application/vnd.geomesa.bin",
}

#: Content-Type per format of the push plane (``GET /subscribe/<type>``):
#: GeoJSON goes out as Server-Sent Events; Arrow answers 406 in the port
PUSH_CONTENT_TYPES = {
    "geojson": "text/event-stream",
    "arrow": CONTENT_TYPES["arrow"],
    "bin": CONTENT_TYPES["bin"],
}

#: ``f=`` spellings accepted per format (case-insensitive)
_PARAM_ALIASES = {
    "geojson": "geojson",
    "json": "geojson",
    "arrow": "arrow",
    "bin": "bin",
}

#: Accept-header media types we recognize (exact match per entry)
_ACCEPT_TYPES = {
    "application/vnd.apache.arrow.stream": "arrow",
    "application/vnd.geomesa.bin": "bin",
    "application/geo+json": "geojson",
    "application/json": "geojson",
}


def negotiate_format(q: dict, accept: "str | None" = None) -> str:
    """Resolve the response format for a request.

    ``q`` is the parsed query dict (``f=`` wins; an unknown value
    raises ValueError -> 400, never a silent GeoJSON fallback), then
    the ``Accept`` header's media types in client order (first
    recognized type wins; a ``;q=0`` entry is an explicit rejection
    and is skipped, other q-weights are not ranked; ``*/*`` and
    unknown types fall through), then GeoJSON."""
    f = q.get("f")
    if f is not None:
        fmt = _PARAM_ALIASES.get(f.strip().lower())
        if fmt is None:
            raise ValueError(f"unknown format {f!r}")
        return fmt
    for part in (accept or "").split(","):
        media, _, params = part.partition(";")
        fmt = _ACCEPT_TYPES.get(media.strip().lower())
        if fmt is None:
            continue
        rejected = False
        for p in params.split(";"):
            k, _, v = p.partition("=")
            if k.strip().lower() == "q":
                try:
                    rejected = float(v.strip()) == 0.0
                except ValueError:
                    pass
                break
        if not rejected:
            return fmt
    return "geojson"
