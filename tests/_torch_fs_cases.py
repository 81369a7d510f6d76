"""Shared inputs of the file-system store parity tests
(``tests/test_torch_fs_*.py``): seeded rows of the four key spaces, random
ECQL trees, a store pair (the JAX package's ``FileSystemDataStore`` under
``tmp_path`` beside the port's on ``device="cpu"``) and the comparisons.

Coordinates and query constants are float32-exact (points rounded to
float32, polygon corners and query constants on a 1/64-degree grid): the
JAX package's CPU runner stages float64 planes, the port float32, as the
JAX package does on its TPU (ROADMAP section 3, Definitions).
"""

from __future__ import annotations

import json
import os
from contextlib import ExitStack, contextmanager

import numpy as np

from geomesa_tpu import conf as jconf
from geomesa_tpu.query.plan import Query as JQuery
from geomesa_tpu.store.fs import FileSystemDataStore as JFS
from geomesa_tpu_torch import conf
from geomesa_tpu_torch.features.batch import VIS_COLUMN
from geomesa_tpu_torch.query.plan import Query
from geomesa_tpu_torch.store.fs import FileSystemDataStore

T0 = 1_577_836_800_000  # 2020-01-01
DAY = 86_400_000
SPECS = {
    "z3": "name:String,count:Int,val:Double,dtg:Date,*geom:Point:srid=4326",
    "z2": "name:String,count:Int,*geom:Point:srid=4326",
    "xz2": "name:String,count:Int,*geom:Polygon:srid=4326",
    "xz3": "name:String,count:Int,dtg:Date,*geom:Polygon:srid=4326",
}
AUTHS = [None, ("A",), ("A", "B", "C")]
LABELS = np.array(["", "A", "B", "A&B", "A|C", "(A|B)&C"], object)


def f32(a):
    return np.asarray(a, np.float64).astype(np.float32).astype(np.float64)


def rows(kind: str, n: int, seed: int, labels: bool = False, days: int = 6) -> dict:
    """Seeded rows of ``kind``: points in 16 clusters (z3, z2) or boxes on a
    1/64-degree grid (xz2, xz3), ``days`` days of dates, null names."""
    rng = np.random.default_rng(seed)
    cols = {
        "name": np.array(["a", "b", "c", None], object)[rng.integers(0, 4, n)],
        "count": rng.integers(0, 1000, n),
    }
    if kind in ("z3", "z2"):
        centres = rng.uniform([-150, -60], [150, 60], (16, 2))
        c = centres[rng.integers(0, 16, n)] + rng.normal(0, 4.0, (n, 2))
        cols["geom"] = f32(np.clip(c, [-180, -90], [180, 90]))
    else:
        c = np.round(rng.uniform([-60, -40], [60, 40], (n, 2)) * 64) / 64
        w = rng.integers(1, 128, (n, 2)) / 64.0
        cols["geom"] = [
            f"POLYGON(({a} {b}, {a + dx} {b}, {a + dx} {b + dy}, {a} {b + dy}, {a} {b}))"
            for a, b, dx, dy in zip(c[:, 0], c[:, 1], w[:, 0], w[:, 1])]
    if kind == "z3":
        cols["val"] = np.round(rng.uniform(0, 10, n), 2)
    if kind in ("z3", "xz3"):
        cols["dtg"] = T0 + rng.integers(0, days * DAY, n)
    if labels:
        cols[VIS_COLUMN] = LABELS[rng.integers(0, len(LABELS), n)]
    return cols


def _iso(ms: int) -> str:
    return str(np.datetime64(int(ms), "ms")) + "Z"


def random_ecql(rng, kind: str, depth: int = 2, days: int = 6) -> str:
    """A random filter tree of depth <= ``depth`` over the leaves the
    schema supports, under AND / OR / NOT."""
    def box():
        x0 = float(rng.integers(-180 * 4, 150 * 4)) / 4
        y0 = float(rng.integers(-90 * 4, 60 * 4)) / 4
        w = float(rng.integers(1, 90 * 4)) / 4
        h = float(rng.integers(1, 45 * 4)) / 4
        return x0, y0, min(x0 + w, 180.0), min(y0 + h, 90.0)

    def leaf() -> str:
        choices = ["bbox", "bbox", "cmp", "between", "in", "like", "null", "poly", "all"]
        if kind in ("z3", "xz3"):
            choices += ["during", "during"]
        if kind == "z3":
            choices += ["before"]  # open intervals: not on xz3 (ROADMAP section 3)
        c = choices[rng.integers(len(choices))]
        if c == "bbox":
            return "BBOX(geom, {}, {}, {}, {})".format(*box())
        if c == "cmp":
            op = [">", "<", ">=", "<=", "=", "<>"][rng.integers(6)]
            return f"count {op} {int(rng.integers(0, 1000))}"
        if c == "between":
            a = int(rng.integers(0, 900))
            return f"count BETWEEN {a} AND {a + int(rng.integers(1, 400))}"
        if c == "in":
            return "name IN ({})".format(", ".join(f"'{v}'" for v in rng.choice(["a", "b", "c", "z"], 2)))
        if c == "like":
            return f"name LIKE '{rng.choice(['a', 'b', 'c'])}%'"
        if c == "null":
            return "name IS NULL"
        if c == "poly":
            x0, y0, x1, y1 = box()
            xm = (x0 + x1) / 2
            return f"INTERSECTS(geom, POLYGON(({x0} {y0}, {x1} {y0}, {xm} {y1}, {x0} {y0})))"
        if c == "during":
            t0 = T0 + int(rng.integers(0, days * 4)) * DAY // 4
            return f"dtg DURING {_iso(t0)}/{_iso(t0 + int(rng.integers(1, days * 4)) * DAY // 4)}"
        if c == "before":
            op = ["BEFORE", "AFTER"][rng.integers(2)]
            return f"dtg {op} {_iso(T0 + int(rng.integers(0, days * 4)) * DAY // 4)}"
        return ["INCLUDE", "EXCLUDE"][rng.integers(2)] if rng.random() < 0.3 else "INCLUDE"

    def tree(d: int) -> str:
        if d == 0 or rng.random() < 0.4:
            return leaf()
        op = rng.integers(3)
        if op == 2:
            return f"NOT ({tree(d - 1)})"
        kids = [tree(d - 1) for _ in range(int(rng.integers(2, 4)))]
        return "(" + (" AND " if op == 0 else " OR ").join(kids) + ")"

    return tree(depth)


@contextmanager
def props(**kv):
    """Set a system property in both packages (dots as underscores)."""
    with ExitStack() as stack:
        for k, v in kv.items():
            name = k.replace("_", ".")
            stack.enter_context(conf.prop_override(name, v))
            stack.enter_context(jconf.prop_override(name, v))
        yield


def pair(root, kind: str, scheme=None, psize: int = 64):
    """(port store, JAX store) under ``root``, one type ``t`` each."""
    spec = SPECS[kind] + (f";geomesa.fs.partition-scheme={scheme}" if scheme else "")
    tds = FileSystemDataStore(os.path.join(root, "port"), partition_size=psize, device="cpu")
    jds = JFS(os.path.join(root, "jax"), partition_size=psize)
    for ds in (tds, jds):
        ds.create_schema("t", spec)
    return tds, jds


def written(tmp_path, kind, scheme, seed, n=(400, 200), labels=None):
    """A store pair with two flushed writes (the second with fids from
    50,000); a third of the seeds carry labeled rows."""
    tds, jds = pair(str(tmp_path), kind, scheme)
    lab = seed % 3 == 0 if labels is None else labels
    first = rows(kind, n[0], seed, labels=lab)
    second = rows(kind, n[1], seed + 1, labels=lab)
    for ds in (tds, jds):
        ds.write("t", first)
        ds.flush("t")
        ds.write("t", second, fids=np.arange(50_000, 50_000 + n[1]))
        ds.flush("t")
    return tds, jds


def same(got, want):
    """Query results equal: rows scanned, total, index, fids in order and
    every column."""
    assert (got.scanned, got.total) == (want.scanned, want.total)
    assert got.plan.index_name == want.plan.index_name
    assert [str(f) for f in got.batch.fids] == [str(f) for f in want.batch.fids]
    assert sorted(got.batch.columns) == sorted(want.batch.columns)
    for k, v in want.batch.columns.items():
        g = got.batch.columns[k]
        if v.dtype == object:
            assert [str(a) for a in g] == [str(a) for a in v], k
        else:
            np.testing.assert_array_equal(g, v, err_msg=k)


def manifest(ds, type_name: str = "t") -> dict:
    with open(os.path.join(ds.root, type_name, "schema.json")) as fh:
        return json.load(fh)


def same_manifest(tds, jds, type_name: str = "t"):
    """The manifests' partitions (pid, leaf, key bounds, count, bbox, time
    range), chunk statistics (the chunk blocks' byte sizes aside: the
    files' formats differ by design), stats, interval, primary, format."""
    got, want = manifest(tds, type_name), manifest(jds, type_name)
    for k in ("format", "primary", "data_interval", "stats", "spec"):
        assert got[k] == want[k], k
    assert len(got["partitions"]) == len(want["partitions"])
    for a, b in zip(got["partitions"], want["partitions"]):
        for k in ("pid", "start", "stop", "key_lo", "key_hi", "count", "bbox", "time_range", "leaf"):
            assert a[k] == b[k], k
        ca, cb = a["chunks"], b["chunks"]
        assert (ca is None) == (cb is None)
        if ca is not None:
            ca, cb = dict(ca), dict(cb)
            assert (ca.pop("nbytes") is None) == (cb.pop("nbytes") is None)
            assert ca == cb


def _options(rng, kind):
    q = {}
    if rng.random() < 0.3:
        q["hints"] = {"auths": AUTHS[rng.integers(len(AUTHS))]}
    if rng.random() < 0.3:
        q["sort_by"] = "count"
        q["sort_desc"] = bool(rng.random() < 0.5)
    if rng.random() < 0.3:
        q["max_features"] = int(rng.integers(1, 50))
    if rng.random() < 0.2:
        q["properties"] = ["count", "geom"]
    return q


def check_case(tmp_path, kind, scheme, fmt, seed, queries=5):
    """Two flushed writes to a store pair, the manifests compared, then
    ``queries`` random trees with random options (the first two also
    through ``count``) and ``explain``."""
    with props(store_format_version=fmt, store_chunk_rows=16):
        tds, jds = written(tmp_path, kind, scheme, seed)
        same_manifest(tds, jds)
        rng = np.random.default_rng(seed)
        for i in range(queries):
            f = random_ecql(rng, kind)
            opts = _options(rng, kind)
            same(tds.query("t", Query(filter=f, **opts)), jds.query("t", JQuery(filter=f, **opts)))
            if i < 2:
                assert tds.count("t", f) == jds.count("t", f), f
        assert tds.explain("t", "INCLUDE") == jds.explain("t", "INCLUDE")
