"""Port parity for the operator's command line: every store, stats and
environment command of ``geomesa_tpu_torch.tools.cli`` against
``geomesa_tpu.tools.cli``, and the server-side views (``trace``, ``slo``,
``ledger``) against each package's own server.

Each case runs a sequence of commands through the JAX package's ``main``
over one file-system root and the port's ``main(["--root", R, "--device",
"cpu", ...])`` over another, both written with the same rows and fids: a
z3 point type ``t`` (partitions of 64 rows, 2^16-row chunks) and an xz2
polygon type ``poly``. The printed lines must be equal, with the exit code
of a refused command, and so must the stores afterwards (schemas, the
manifests' partitions and chunk statistics, every row). Masked, and
nothing else:

- the roots' paths;
- byte sizes (``fsck``'s swept bytes): the port's partition files are its
  own (ROADMAP section 3);
- ``env``'s backend line (the torch build and its CUDA device where the
  reference prints the JAX backend);
- ``env``'s system properties are compared key by key over the port's
  keys, which are a subset of the reference's (the port's ``conf.py``
  holds only the keys it reads).

The server views print timings, trace ids, latency verdicts and (in the
reference) XLA compile attributions that no two runs share: their lines
are compared with numbers, trace ids and the SLO burning flag masked and
the compile block dropped (the port on the CPU builds no kernel).
"""

import io
import re
import time
from contextlib import redirect_stdout

import numpy as np
import pytest
from _torch_fs_cases import rows, same, same_manifest
from _torch_server_cases import fetch, memory_pair, q, reset_singletons, serving

from geomesa_tpu.store.fs import FileSystemDataStore as JFS
from geomesa_tpu.tools.cli import main as jmain
from geomesa_tpu_torch.features.batch import fids_in
from geomesa_tpu_torch.store.fs import FileSystemDataStore
from geomesa_tpu_torch.tools.cli import main

Z3 = "name:String,count:Int,val:Double,dtg:Date,*geom:Point:srid=4326"
POLY = "name:String,count:Int,*geom:Polygon:srid=4326"
BOX = "BBOX(geom, -40.5, -20.25, 60.75, 45.5)"
Q = f"{BOX} AND dtg DURING 2020-01-02T00:00:00Z/2020-01-04T12:00:00Z"
STATS = 'Count();MinMax("count");Histogram("count",10,0,1000);TopK("count",3)'
CUT = "2020-01-03T06:00:00"


def _z3_rows() -> dict:
    """``rows("z3")`` with every name set (a TopK over a null name raises
    in both packages) and float32-exact values (a resident index stages
    float32 planes in the port, float64 in the JAX package on the CPU)."""
    cols = rows("z3", 400, 11)
    cols["name"] = np.where(cols["name"] == None, "d", cols["name"])  # noqa: E711
    cols["val"] = np.round(cols["val"] * 64) / 64
    return cols


def _write(ds):
    ds.create_schema("t", Z3)
    ds.create_schema("poly", POLY)
    ds.write("t", _z3_rows(), fids=np.arange(400))
    poly = rows("xz2", 150, 12)
    poly["name"] = np.where(poly["name"] == None, "d", poly["name"])  # noqa: E711
    ds.write("poly", poly, fids=np.arange(150))
    for tn in ("t", "poly"):
        ds.flush(tn)


@pytest.fixture
def roots(tmp_path):
    """(port root, JAX root): the same rows and fids in each."""
    proot, jroot = str(tmp_path / "port"), str(tmp_path / "jax")
    _write(FileSystemDataStore(proot, partition_size=64, device="cpu"))
    _write(JFS(jroot, partition_size=64))
    return proot, jroot


def _run(fn, argv: list, root: str) -> "tuple[str, object]":
    """(stdout with the root masked, the exit code or message of a refused
    command)."""
    buf = io.StringIO()
    code = None
    with redirect_stdout(buf):
        try:
            fn(argv)
        except SystemExit as e:
            code = e.code
    out = buf.getvalue().replace(root, "<root>")
    if isinstance(code, str):
        code = code.replace(root, "<root>")
    return out, code


_BYTES = re.compile(r"\d+ bytes")


def _mask(cmd: list, out: str) -> str:
    if cmd[0] == "fsck":
        out = _BYTES.sub("<n> bytes", out)
    return out


def _env_lines(out: str) -> "tuple[list, dict]":
    """``env``'s lines but the backend line and the properties, and the
    properties as a dict."""
    lines, props = [], {}
    for line in out.splitlines():
        if line.startswith(("jax backend:", "torch ")):
            continue
        m = re.match(r"  geomesa\.(\S+) = (.*)$", line)
        if m:
            props[m.group(1)] = m.group(2)
        else:
            lines.append(line)
    return lines, props


CASES = {
    "create-schema": [["create-schema", "-f", "new", "-s", Z3 + ";geomesa.z3.interval=day"],
                      ["get-sfts"], ["describe-schema", "-f", "new"], ["count", "-f", "new"]],
    "get-sfts": [["get-sfts"]],
    "describe-schema": [["describe-schema", "-f", "t"], ["describe-schema", "-f", "poly"],
                        ["describe-schema", "-f", "nope"]],
    "remove-schema": [["remove-schema", "-f", "poly"], ["get-sfts"],
                      ["remove-schema", "-f", "poly"]],
    "explain": [["explain", "-f", "t", "-q", Q], ["explain", "-f", "poly", "-q", BOX],
                ["explain", "-f", "t", "-q", "count > 500"]],
    "count": [["count", "-f", "t"], ["count", "-f", "t", "-q", Q], ["count", "-f", "poly", "-q", BOX],
              ["count", "-f", "t", "-q", "BBOX(nope, 0, 0, 1, 1)"]],
    "stats": [["stats", "-f", "t", "-s", STATS, "-q", Q],
              ["stats", "--resident", "-f", "t", "-s", STATS, "-q", Q],
              ["stats", "-f", "poly", "-s", 'Count();MinMax("count")']],
    "stats-count": [["stats-count", "-f", "t"], ["stats-count", "-f", "t", "-q", Q],
                    ["stats-count", "--resident", "-f", "t", "-q", Q]],
    "stats-bounds": [["stats-bounds", "-f", "t"], ["stats-bounds", "-f", "t", "-q", Q, "-a", "count,val"],
                     ["stats-bounds", "-f", "poly"], ["stats-bounds", "--resident", "-f", "t"]],
    "stats-top-k": [["stats-top-k", "-f", "t", "-a", "name", "-k", "2"],
                    ["stats-top-k", "--resident", "-f", "t", "-a", "count", "-q", Q]],
    "stats-histogram": [["stats-histogram", "-f", "t", "-a", "count", "--bins", "5"],
                        ["stats-histogram", "--resident", "-f", "t", "-a", "val", "-q", Q],
                        ["stats-histogram", "-f", "t", "-a", "count", "--min", "0", "--max", "100"],
                        ["stats-histogram", "-f", "t", "-a", "count", "-q", "count > 5000"]],
    "stats-analyze": [["stats-analyze", "-f", "t"], ["stats-analyze", "--resident", "-f", "t", "-q", Q],
                      ["stats-analyze", "-f", "poly"]],
    "delete-features": [["delete-features", "-f", "t", "--ids", "0,1,2,399"],
                        ["delete-features", "-f", "t", "-q", Q], ["count", "-f", "t"],
                        ["delete-features", "-f", "t"]],
    "age-off": [["age-off", "-f", "t", "--before", CUT, "--dry-run"], ["age-off", "-f", "t", "--before", CUT],
                ["count", "-f", "t"], ["age-off", "-f", "poly", "--before", CUT, "--dry-run"]],
    "keywords": [["keywords", "-f", "t", "-a", "gdelt", "news"], ["keywords", "-f", "t"],
                 ["keywords", "-f", "t", "-r", "news"], ["keywords", "-f", "t", "-a", "gdelt"],
                 ["describe-schema", "-f", "t"]],
    "reindex": [["reindex", "-f", "t", "--index", "z2"], ["count", "-f", "t", "-q", BOX],
                ["explain", "-f", "t", "-q", BOX], ["reindex", "-f", "t", "--index", "xz2"]],
    "repartition": [["repartition", "-f", "t", "--scheme", "daily"], ["count", "-f", "t", "-q", Q],
                    ["repartition", "-f", "t"], ["count", "-f", "t"]],
    "compact": [["compact", "-f", "t"], ["compact", "-f", "poly"], ["count", "-f", "t", "-q", Q]],
    "fsck": [["fsck"], ["fsck", "-f", "t", "--no-verify"], ["fsck", "-f", "nope"]],
    "version": [["version"]],
    "env": [["env"]],
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_command_prints_as_the_reference(roots, case):
    proot, jroot = roots
    for cmd in CASES[case]:
        got = _run(main, ["--root", proot, "--device", "cpu", *cmd], proot)
        want = _run(jmain, ["--root", jroot, *cmd], jroot)
        if cmd[0] == "env":
            (glines, gprops), (wlines, wprops) = _env_lines(got[0]), _env_lines(want[0])
            assert glines == wlines and got[1] == want[1]
            assert gprops and set(gprops) <= set(wprops)
            assert gprops == {k: wprops[k] for k in gprops}
            assert "torch " in got[0] and "devices)" in got[0]
            continue
        assert (_mask(cmd, got[0]), got[1]) == (_mask(cmd, want[0]), want[1]), cmd
    # the stores are equal afterwards
    tds = FileSystemDataStore(proot, device="cpu")
    jds = JFS(jroot)
    assert tds.type_names == jds.type_names
    for tn in tds.type_names:
        assert tds.get_schema(tn).spec == jds.get_schema(tn).spec
        same_manifest(tds, jds, tn)
        same(tds.query(tn, "INCLUDE"), jds.query(tn, "INCLUDE"))


def test_fsck_exits_non_zero_on_drift_as_the_reference(roots):
    """A partition's chunk statistics edited in the manifest: both report
    the drift and exit with the same message."""
    import json
    import os

    proot, jroot = roots
    for root in (proot, jroot):
        path = os.path.join(root, "t", "schema.json")
        with open(path) as fh:
            doc = json.load(fh)
        doc["partitions"][0]["chunks"]["bbox"][0][2] -= 1.0
        with open(path, "w") as fh:
            json.dump(doc, fh)
    got = _run(main, ["--root", proot, "--device", "cpu", "fsck", "-f", "t"], proot)
    want = _run(jmain, ["--root", jroot, "fsck", "-f", "t"], jroot)
    assert got[1] == want[1] and str(got[1]).startswith("error: 0 corrupt")
    assert _mask(["fsck"], got[0]) == _mask(["fsck"], want[0])


_FID_CASES = [
    (np.arange(10), [3, "3", np.int64(4), 5.0, 6.5, True, "x"]),
    (np.arange(10, dtype=np.int32), ["1", 2, np.uint8(7)]),
    (np.array(["a", "b", "1", "2"]), ["b", 1, "2", None]),
    (np.array([1, "1", "a", 2.0, None], dtype=object), [1, "a", 2, None]),
    (np.arange(5), []),
    (np.array([], dtype=np.int64), [1, "1"]),
]


@pytest.mark.parametrize("col,fids", _FID_CASES)
def test_fid_membership_equals_the_reference_rule(col, fids):
    """``fids_in`` answers what the reference's ``np.isin`` over an object
    array answers, on integer, str and object fid columns."""
    want = np.isin(col, np.asarray(list(fids), dtype=object))
    assert fids_in(col, fids).tolist() == want.tolist()


def test_age_off_of_half_a_type_takes_linear_time(tmp_path):
    """``age-off`` of half of 2^16 rows: the reference's object-array
    membership compares every row with every id, minutes at this size; the
    port's is linear (ROADMAP section 3). The count after it equals
    numpy."""
    n = 1 << 16
    cols = rows("z3", n, 21)
    ds = FileSystemDataStore(str(tmp_path), device="cpu")
    ds.create_schema("t", Z3)
    ds.write("t", cols, fids=np.arange(n))
    ds.flush("t")
    cut = "2020-01-04T00:00:00"
    t0 = time.perf_counter()
    got = _run(main, ["--root", str(tmp_path), "--device", "cpu", "age-off", "-f", "t", "--before", cut],
               str(tmp_path))
    took = time.perf_counter() - t0
    old = int((cols["dtg"] < np.datetime64(cut, "ms").astype(np.int64)).sum())
    assert got == (f"removed {old} features\n", None) and 0 < old < n
    assert FileSystemDataStore(str(tmp_path), device="cpu").count("t") == n - old
    assert took < 20.0


_DIGITS = re.compile(r"\d+(\.\d+)?")
_IDS = re.compile(r"\b[0-9a-f]{16,32}\b")


def _shape(out: str) -> list:
    """A server view's non-blank lines, sorted, with trace ids, numbers
    and the latency verdicts (the burning flag, a trace's ``[slow]``)
    masked, runs of blanks as
    one, and the compile-attribution block dropped."""
    lines, skip = [], False
    for line in out.splitlines():
        if line.startswith("compile attribution"):
            skip = True
            continue
        if skip and line.startswith("  "):
            continue
        skip = False
        line = _DIGITS.sub("#", _IDS.sub("<id>", line))
        line = re.sub(r"\b(YES|no)\b", "<burn>", line).replace(" [slow]", "")
        line = " ".join(line.split())
        if line:
            lines.append(line)
    return sorted(lines)  # tables rank their rows by cost: timings decide the order


def test_server_views_print_as_the_reference(tmp_path):
    """``trace`` (the list, one tree, Perfetto to a file), ``slo`` and
    ``ledger`` against both packages' servers after the same requests."""
    reset_singletons(tmp_path / "flightrec")
    tds, jds = memory_pair(n=600, seed=9)
    try:
        with serving(tds, jds, resident=True) as (purl, jurl, _, _):
            ids = {}
            for base in (purl, jurl):
                for path in (f"/count/gdelt?cql={q(BOX)}", f"/features/gdelt?cql={q(BOX)}&maxFeatures=3",
                             "/stats/gdelt2?stats=Count()"):
                    st, hdrs, _ = fetch(base, path)
                    assert st == 200
                ids[base] = hdrs["X-Request-Id"]
            time.sleep(0.05)
            for cmd in (["slo"], ["ledger"], ["trace"], ["trace", "--limit", "1"]):
                got, _ = _run(main, [*cmd, "--url", purl], purl)
                want, _ = _run(jmain, [*cmd, "--url", jurl], jurl)
                assert _shape(got) == _shape(want), cmd
            got, _ = _run(main, ["trace", "--url", purl, ids[purl]], purl)
            want, _ = _run(jmain, ["trace", "--url", jurl, ids[jurl]], jurl)
            assert got.splitlines()[0].split()[:2] == ["trace", ids[purl]]
            assert "span coverage of request wall time:" in got
            assert [ln for ln in want.splitlines() if ln.startswith("span coverage")]
            out = str(tmp_path / "p.json")
            got, _ = _run(main, ["trace", "--url", purl, ids[purl], "--perfetto", "-o", out], purl)
            assert got.startswith(f"wrote Perfetto trace to {out}")
            import json

            with open(out) as fh:
                assert json.load(fh)["traceEvents"]
            assert _run(main, ["trace", "--url", purl, "nope"], purl)[1].startswith("error: HTTP 404")
    finally:
        reset_singletons()
