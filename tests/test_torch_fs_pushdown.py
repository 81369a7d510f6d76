"""Port parity for the file-system store's aggregation pushdown
(``store/pushdown.py``) and the processes that take it.

On z3 and z2 points in v2 (and a v1 store, which has no chunk statistics
and answers by the row scan), without a scheme and under ``daily,z2-2bit``
or ``z2-2bit``, 16-row chunks: ``count`` (the count pushdown) and
``stats_pushdown`` equal the JAX package's exactly, ``density_pushdown``
has the same total mass and every cell within rtol 1e-6; a query the
chunk statistics cannot decide answers None in both. The boundary chunks
are refined through the runner, one filter-scan run per partition that
has any (on the CPU the wrapper runs its plain version and counts no
launch). ``process.density`` and ``run_stats`` take the pushdown on an fs
store as the JAX package's do, and the row scan under auths.
"""

import numpy as np
import pytest
from _torch_fs_cases import props, written

from geomesa_tpu.geom import Envelope as JEnvelope
from geomesa_tpu.query.plan import Query as JQuery
from geomesa_tpu_torch import kernels
from geomesa_tpu_torch.geom import Envelope
from geomesa_tpu_torch.query.plan import Query

BOXES = ["BBOX(geom, -40.5, -20.25, 60.75, 45.5)", "BBOX(geom, -180, -90, 180, 90)",
         "BBOX(geom, 10, 10, 10.25, 10.5)", "BBOX(geom, -120, -60, -20, 0) OR BBOX(geom, 0, 0, 90, 60)"]
WINDOWS = ["dtg DURING 2020-01-02T00:00:00Z/2020-01-05T00:00:00Z",
           "dtg DURING 2020-01-02T06:00:00Z/2020-01-02T18:30:00Z"]


def _agg_queries(kind):
    qs = BOXES[:2] + ["count > 500"]
    if kind == "z3":
        qs += [f"{b} AND {w}" for b, w in zip(BOXES[::2], WINDOWS)] + WINDOWS[:1]
    return qs


PUSH_CASES = [("z3", None, 2), ("z3", "daily:z2-2bit", 2), ("z3", None, 1), ("z2", "z2-2bit", 2)]


@pytest.mark.parametrize("kind,scheme,fmt", PUSH_CASES, ids=[f"{k}-{s}-v{f}" for k, s, f in PUSH_CASES])
def test_pushdowns_equal_the_reference(tmp_path, kind, scheme, fmt):
    spec = 'Count();MinMax("count")' + (';MinMax("dtg")' if kind == "z3" else "")
    env, jenv = Envelope(-60.0, -45.0, 75.0, 50.0), JEnvelope(-60.0, -45.0, 75.0, 50.0)
    with props(store_format_version=fmt, store_chunk_rows=16):
        tds, jds = written(tmp_path, kind, scheme, seed=1, labels=False)
        for f in _agg_queries(kind):
            kernels.reset_counts()
            assert tds.count("t", f) == jds.count("t", f), f
            got = tds.density_pushdown("t", Query(filter=f), env, 48, 24)
            want = jds.density_pushdown("t", JQuery(filter=f), jenv, 48, 24)
            assert (got is None) == (want is None), f
            if got is not None:
                want = np.asarray(want)
                assert got.dtype == want.dtype == np.float32
                assert float(got.astype(np.float64).sum()) == float(want.astype(np.float64).sum())
                np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
            gs = tds.stats_pushdown("t", Query(filter=f), spec)
            ws = jds.stats_pushdown("t", JQuery(filter=f), spec)
            assert (gs is None) == (ws is None), f
            if gs is not None:
                assert gs.to_json() == ws.to_json()
        # a veto and a cap take the row scan in both packages
        vetoed = Query(filter=BOXES[0], hints={"agg.pushdown": False})
        assert tds.density_pushdown("t", vetoed, env, 8, 8) is None
        assert jds.density_pushdown("t", JQuery(filter=BOXES[0], hints={"agg.pushdown": False}),
                                    jenv, 8, 8) is None
        assert tds.stats_pushdown("t", Query(filter=BOXES[0], max_features=3), spec) is None


def test_pushdown_refines_boundary_chunks_through_the_filter_scan(tmp_path, monkeypatch):
    """Interior chunks answer from the manifest; the boundary chunks of
    each surviving partition go through the runner: one filter-scan run
    per partition that has any, and a query one per surviving partition
    (on the CPU the plain version runs: no launch is counted)."""
    from geomesa_tpu_torch.query import runner
    from geomesa_tpu_torch.store import chunkstats as cks

    runs = []
    real = runner._scan_run

    def spy(built, compiled, device, start, stop, depth=0):
        runs.append(stop - start)
        return real(built, compiled, device, start, stop, depth)

    monkeypatch.setattr(runner, "_scan_run", spy)
    with props(store_chunk_rows=16):
        tds, jds = written(tmp_path, "z3", None, seed=4, n=(900, 300), labels=False)
        f = f"{BOXES[0]} AND {WINDOWS[0]}"
        plan = tds.plan("t", f)
        parts = tds._pruned_parts("t", plan)
        refined = 0
        for p in parts:
            klass = cks.classify(p.chunks, *plan.agg_bounds)
            sel = np.nonzero(klass == cks.BOUNDARY)[0]
            sel = sel[cks.chunks_overlapping(p.chunks, plan.ranges)[sel]]
            refined += bool(len(sel))
        kernels.reset_counts()
        runs.clear()
        assert tds.count("t", f) == jds.count("t", f) > 0
        assert 0 < refined < sum(len(p.chunks) for p in parts)
        assert len(runs) == refined
        assert not any(kernels.LAUNCHES.values())  # the CPU runs the plain version
        runs.clear()
        res = tds.query("t", f)
        assert runs == [p.count for p in parts]
        assert len(res) == tds.count("t", f)


def test_process_probes_take_the_pushdown(tmp_path):
    """``process.density`` and ``run_stats`` answer from the pushdown on an
    fs store, as the JAX package's do, and fall back to the row scan under
    auths (or with a weight)."""
    from geomesa_tpu.process.density import density as jdensity
    from geomesa_tpu.process.statsproc import run_stats as jrun_stats
    from geomesa_tpu_torch.process.density import density
    from geomesa_tpu_torch.process.statsproc import run_stats

    with props(store_chunk_rows=16):
        tds, jds = written(tmp_path, "z3", "daily", seed=3, labels=True)
        env, jenv = Envelope(-60.0, -45.0, 75.0, 50.0), JEnvelope(-60.0, -45.0, 75.0, 50.0)
        f = f"{BOXES[0]} AND {WINDOWS[0]}"
        got = density(tds, "t", f, env, 40, 20, device="cpu")
        want = np.asarray(jdensity(jds, "t", f, jenv, 40, 20))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
        for auths in (("A",), None):
            g = density(tds, "t", f, env, 40, 20, auths=auths, weight_attr="val", device="cpu")
            w = np.asarray(jdensity(jds, "t", f, jenv, 40, 20, auths=auths, weight_attr="val"))
            np.testing.assert_allclose(g, w, rtol=1e-6)
        spec = 'Count();MinMax("count");MinMax("dtg")'
        assert run_stats(tds, "t", f, spec).to_json() == jrun_stats(jds, "t", f, spec).to_json()
        hist = 'Count();Histogram("count",10,0,1000)'
        assert run_stats(tds, "t", f, hist, auths=("A",)).to_json() == \
            jrun_stats(jds, "t", f, hist, auths=("A",)).to_json()
