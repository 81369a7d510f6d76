"""BIN engine selection: the device pack against its numpy host twin.

Copy of ``geomesa_tpu/results/binrider.py`` (lines 15-63).
``DeviceIndex.bin_rider`` packs the 16/24-byte track records on the
device (a count, then a compaction of the record lanes) so that only the
packed records cross to the host; ``DeviceIndex.bin_export`` is the
bit-identical numpy twin. ``results.bin.engine`` picks; ``auto`` resolves
by the index's device: the device pack for an index on the card, the twin
for one on the CPU (the counterpart's all-CPU rule, read off the
tensor's device).
"""

from __future__ import annotations


def bin_engine(di) -> str:
    """Resolve ``results.bin.engine`` for index ``di`` (auto -> ``device``
    on the card, ``host`` on the CPU)."""
    from geomesa_tpu_torch.conf import sys_prop

    eng = sys_prop("results.bin.engine")
    if eng != "auto":
        return eng
    return "device" if di.device.type == "cuda" else "host"


def resident_bin(
    di,
    query,
    track_attr: str,
    *,
    dtg_attr: "str | None" = None,
    geom_attr: "str | None" = None,
    label_attr: "str | None" = None,
    sort: bool = False,
    loose: "bool | None" = None,
    auths=None,
) -> bytes:
    """BIN bytes for a resident index's hits under the configured engine.
    The device rider declines shapes it cannot express (labeled staging,
    host-residual filters, non-point geometry): ``auto``/``host`` take the
    twin; a pinned ``device`` raises, so an operator's explicit pin never
    silently changes engines. (The counterpart tests the resolved engine,
    so its ``auto`` on an accelerator raises too, against its own
    docstring; here only the pin raises.)"""
    from geomesa_tpu_torch.conf import sys_prop

    kw = dict(
        dtg_attr=dtg_attr, geom_attr=geom_attr, label_attr=label_attr,
        sort=sort, loose=loose, auths=auths,
    )
    if bin_engine(di) != "host":
        data = di.bin_rider(query, track_attr, **kw)
        if data is not None:
            return data
        if sys_prop("results.bin.engine") == "device":
            raise ValueError(
                "results.bin.engine=device but the query shape is not "
                "device-expressible (labeled staging, host-residual "
                "filter or non-point geometry); use auto or host"
            )
    return di.bin_export(query, track_attr, **kw)
