"""Density viewports of zero width or height on every rung.

A ``/density`` request whose ``bbox`` has no area but is not inverted
counts the rows on its line in cell 0 of the zero axis on the resident
rung, in both packages. The port's store rung (``process/density.py``)
and the file-system store's chunk pushdown (``store/pushdown.py``) answer
with the same grid; the JAX package's store rung divides by the zero
extent and raises (ROADMAP section 3, reference faults the port does not
copy), so the port's store answers are held to the resident rung's.

- the server parity case: the resident rung of both servers, over memory
  stores, with a zero-width and a zero-height bbox;
- the store rung of a server that is not resident answers 200 with the
  resident rung's grid;
- ``process.density`` on the memory store path, and on a file-system
  store through its pushdown (every kept chunk refined at row level),
  equal to the resident grid; an inverted viewport gives zeros on each.
"""

import json

import numpy as np
import pytest
from _torch_fs_cases import pair
from _torch_server_cases import fetch, memory_pair, q, reset_singletons, serving

from geomesa_tpu_torch.device_cache import DeviceIndex
from geomesa_tpu_torch.geom import Envelope
from geomesa_tpu_torch.process.density import density
from geomesa_tpu_torch.query.plan import Query
from geomesa_tpu_torch.store.memory import MemoryDataStore

SPEC = "name:String,count:Int,val:Double,dtg:Date,*geom:Point:srid=4326"
T0 = 1_577_836_800_000
#: zero-width, zero-height and a point, each through rows placed on it
LINES = [(0.0, -5.0, 0.0, 15.0), (-5.0, 0.0, 15.0, 0.0), (0.0, 0.0, 0.0, 0.0)]
LINE_IDS = ["zero-width", "zero-height", "point"]
INVERTED = (10.0, -5.0, -10.0, 15.0)
FILTERS = ["INCLUDE", "count > 300", "BBOX(geom, -2, -2, 8, 8)"]


def _line_rows(n: int, seed: int) -> dict:
    """Seeded float32-exact points, a share of them on x = 0, on y = 0 and
    on (0, 0)."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-20, 20, (n, 2))
    k = n // 8
    xy[:k, 0] = 0.0
    xy[k:2 * k, 1] = 0.0
    xy[2 * k:2 * k + 5] = 0.0
    return {
        "name": np.array(["a", "b", "c"], object)[rng.integers(0, 3, n)],
        "count": rng.integers(0, 1000, n),
        "val": np.round(rng.uniform(0, 10, n), 2),
        "dtg": T0 + rng.integers(0, 5 * 86_400_000, n),
        "geom": xy.astype(np.float32).astype(np.float64),
    }


@pytest.fixture(autouse=True)
def _fresh(tmp_path):
    reset_singletons(tmp_path / "flightrec")
    yield
    reset_singletons()


@pytest.mark.parametrize("env", LINES[:2], ids=LINE_IDS[:2])
@pytest.mark.parametrize("wh", [(8, 4), (3, 5)])
def test_resident_rung_answers_a_line_as_the_reference(env, wh):
    tds, jds = memory_pair(n=2000, seed=13)
    with serving(tds, jds, resident=True) as (purl, jurl, _, _):
        for cql in ("INCLUDE", "count > 300"):
            path = (f"/density/gdelt?cql={q(cql)}&bbox={','.join(str(v) for v in env)}"
                    f"&width={wh[0]}&height={wh[1]}")
            a, b = fetch(purl, path), fetch(jurl, path)
            assert a[0] == b[0] == 200, (a[2][:200], b[2][:200])
            assert json.loads(a[2]) == json.loads(b[2])


@pytest.mark.parametrize("env", LINES + [INVERTED], ids=LINE_IDS + ["inverted"])
def test_the_store_rung_answers_the_resident_grid_over_http(env):
    """A server that is not resident answers from the store rung: 200 with
    the grid the resident server answers (the JAX package's store rung
    answers 500 to a line)."""
    from geomesa_tpu_torch.server import serve_background

    tds = MemoryDataStore(device="cpu")
    tds.create_schema("gdelt", SPEC)
    cols = _line_rows(2000, seed=14)
    tds.write("gdelt", cols, fids=np.arange(len(cols["count"])))
    path = f"/density/gdelt?bbox={','.join(str(v) for v in env)}&width=6&height=4"
    got = {}
    for resident in (True, False):
        srv, _ = serve_background(tds, resident=resident)
        try:
            host, port = srv.server_address[:2]
            st, _, body = fetch(f"http://{host}:{port}", path)
            assert st == 200, body[:200]
            got[resident] = json.loads(body)["counts"]
        finally:
            srv.shutdown()
            srv.server_close()
    assert got[False] == got[True]
    assert (np.asarray(got[True]).sum() > 0) == (env != INVERTED)


def _resident(ds):
    return DeviceIndex(ds, "t", z_planes=True, device="cpu")


@pytest.mark.parametrize("env", LINES + [INVERTED], ids=LINE_IDS + ["inverted"])
@pytest.mark.parametrize("cql", FILTERS)
def test_store_path_and_fs_pushdown_answer_the_resident_grid(tmp_path, env, cql):
    cols = _line_rows(1500, seed=7)
    mem = MemoryDataStore(device="cpu")
    fs, _ = pair(str(tmp_path), "z3", psize=256)
    for ds in (mem, fs):
        if ds is mem:
            ds.create_schema("t", SPEC)
        ds.write("t", cols, fids=np.arange(len(cols["count"])))
        if ds is fs:
            ds.flush("t")
    want = density(mem, "t", cql, Envelope(*env), 9, 7, device_index=_resident(mem))
    assert (want.sum() > 0) == (env != INVERTED)
    for use_device in (True, False):
        got = density(mem, "t", cql, Envelope(*env), 9, 7, use_device=use_device, device="cpu")
        np.testing.assert_array_equal(got, want)
    # the pushdown answers by itself (refining every kept chunk) ...
    pushed = fs.density_pushdown("t", Query(filter=cql), Envelope(*env), 9, 7)
    if pushed is not None:
        np.testing.assert_array_equal(pushed, want)
    # ... and process.density over the fs store (pushdown or row scan)
    got = density(fs, "t", cql, Envelope(*env), 9, 7, device="cpu")
    np.testing.assert_array_equal(got, want)
    got = density(fs, "t", Query(filter=cql, hints={"agg.pushdown": False}), Envelope(*env), 9, 7,
                  device="cpu")
    np.testing.assert_array_equal(got, want)


def test_the_fs_pushdown_refines_a_line_instead_of_prorating(tmp_path):
    """The pushdown of a line reads the rows: the coarse cells would
    prorate no mass onto a pixel of zero width."""
    cols = _line_rows(1500, seed=9)
    fs, _ = pair(str(tmp_path), "z3", psize=256)
    fs.write("t", cols, fids=np.arange(len(cols["count"])))
    fs.flush("t")
    for env in LINES:
        pushed = fs.density_pushdown("t", Query(filter="INCLUDE"), Envelope(*env), 4, 4)
        assert pushed is not None and pushed.sum() > 0
        on_line = (cols["geom"][:, 0] >= env[0]) & (cols["geom"][:, 0] <= env[2]) & \
            (cols["geom"][:, 1] >= env[1]) & (cols["geom"][:, 1] <= env[3])
        assert pushed.sum() == on_line.sum()
