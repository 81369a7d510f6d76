"""The port's command line.

Counterpart of ``geomesa_tpu/tools/cli.py``: each command is a copy of its
reference function (line numbers below), with the same flags and the same
printed lines. Every command takes the top-level ``--device`` (default
``cuda``: stores scan and resident indexes stage on ``cuda:0``; ``cpu``
runs the plain versions on the host, as the tests do).

    python -m geomesa_tpu_torch.tools --root DIR create-schema -f NAME -s SPEC
    python -m geomesa_tpu_torch.tools --root DIR get-sfts | describe-schema -f NAME
                                      | remove-schema -f NAME
    python -m geomesa_tpu_torch.tools --root DIR explain -f NAME -q CQL
    python -m geomesa_tpu_torch.tools --root DIR count -f NAME [-q CQL]
    python -m geomesa_tpu_torch.tools --root DIR stats -f NAME -s SPEC [-q CQL] [--resident]
    python -m geomesa_tpu_torch.tools --root DIR stats-count | stats-bounds | stats-top-k
                                      | stats-histogram | stats-analyze -f NAME [--resident]
    python -m geomesa_tpu_torch.tools --root DIR delete-features -f NAME (-q CQL | --ids a,b)
    python -m geomesa_tpu_torch.tools --root DIR age-off -f NAME --before ISO [--dry-run]
    python -m geomesa_tpu_torch.tools --root DIR keywords -f NAME [-a KW...] [-r KW...]
    python -m geomesa_tpu_torch.tools --root DIR reindex -f NAME --index z2
                                      | repartition -f NAME [--scheme S] | compact -f NAME
    python -m geomesa_tpu_torch.tools --root DIR fsck [-f NAME] [--no-verify]
    python -m geomesa_tpu_torch.tools version | env
    python -m geomesa_tpu_torch.tools trace | slo | ledger --url URL
    python -m geomesa_tpu_torch.tools warmup [--url URL | --root DIR [-f NAME]]
    python -m geomesa_tpu_torch.tools --root DIR serve --resident [--warm] [--sched] [--stream]
    python -m geomesa_tpu_torch.tools --root DIR load-driver -f NAME [-q CQL] [--loose] \
        [--subscribe K --append-every N]
    python -m geomesa_tpu_torch.tools subs --url URL [--id ID [--cancel]]

Copied: ``_store`` (reference line 69), the schema commands (78-118),
``cmd_explain`` (223), ``cmd_version`` and ``cmd_env`` (228-254; ``env``
prints torch's version and the CUDA device's name and count where the
reference prints the JAX backend), the maintenance commands (256-375 and
``cmd_fsck``, 438), the stats commands (645-781), the scheduler and
host-I/O flags (780-857), ``cmd_serve`` (858) with ``--warm``,
``cmd_load_driver`` (1181) in its single-endpoint mode with the mixed
leg's synthetic appends and standing subscriptions, ``cmd_trace`` (1419),
``cmd_slo`` (1491), ``cmd_subs`` (1544), ``cmd_ledger`` (1612),
``cmd_warmup`` (1653; building the kernel libraries takes the place of
the reference's persistent compilation cache), ``cmd_count`` and
``cmd_stats`` (1698-1712).

Left out, each with its ROADMAP item: ``ingest``, ``export`` and
``convert`` (5j, converters, ingest and export); ``wal``, ``backup``,
``restore``, ``route`` and ``fleet``, ``serve``'s replication flags and
``load-driver --backends`` (the replication tier); ``lint``, which lints
the JAX package itself and is not queued.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def _store(args):
    from geomesa_tpu_torch.store.fs import FileSystemDataStore

    root = args.root or os.environ.get("GEOMESA_TPU_ROOT")
    if not root:
        sys.exit("error: --root (or $GEOMESA_TPU_ROOT) is required")
    return FileSystemDataStore(root, device=args.device)


def cmd_create_schema(args):
    store = _store(args)
    sft = store.create_schema(args.feature_name, args.spec)
    print(f"created schema {sft.type_name!r} with {len(sft.attributes)} attributes")


def cmd_get_sfts(args):
    store = _store(args)
    for name in store.type_names:
        print(name)


def cmd_describe_schema(args):
    store = _store(args)
    sft = store.get_schema(args.feature_name)
    print(f"{sft.type_name}:")
    for a in sft.attributes:
        marks = []
        if a.default_geom or (a.is_geometry and a.name == sft.geom_field):
            marks.append("default geometry")
        if a.name == sft.dtg_field:
            marks.append("default dtg")
        if a.indexed:
            marks.append("indexed")
        suffix = f"  ({', '.join(marks)})" if marks else ""
        print(f"  {a.name}: {a.type_name}{suffix}")
    if sft.user_data:
        print("user data:")
        for k, v in sft.user_data.items():
            print(f"  {k}={v}")


def cmd_remove_schema(args):
    import shutil

    store = _store(args)
    if args.feature_name not in store.type_names:
        sys.exit(f"error: no schema {args.feature_name!r}")
    shutil.rmtree(os.path.join(store.root, args.feature_name))
    print(f"removed {args.feature_name!r}")


def cmd_explain(args):
    store = _store(args)
    print(store.explain(args.feature_name, args.cql))


def cmd_version(args):
    import geomesa_tpu_torch

    print(f"geomesa-tpu {geomesa_tpu_torch.__version__}")


def cmd_env(args):
    """Print the effective environment: root, the torch build and its CUDA
    device, system properties, schemas (ref: EnvironmentCommand)."""
    import torch

    import geomesa_tpu_torch
    from geomesa_tpu_torch.conf import _DEFS, sys_prop

    root = args.root or os.environ.get("GEOMESA_TPU_ROOT")
    print(f"geomesa-tpu {geomesa_tpu_torch.__version__}")
    print(f"root: {root or '(unset)'}")
    if torch.cuda.is_available():
        card = f"cuda: {torch.cuda.get_device_name(0)}"
    else:
        card = "no CUDA device"
    print(f"torch {torch.__version__}: {card} ({torch.cuda.device_count()} devices)")
    print("system properties:")
    for name in sorted(_DEFS):
        print(f"  geomesa.{name} = {sys_prop(name)}")
    if root and os.path.isdir(root):
        store = _store(args)
        print("schemas:")
        for name in store.type_names:
            print(f"  {name}")


def cmd_delete_features(args):
    from geomesa_tpu_torch.query.plan import internal_query

    store = _store(args)
    if args.cql:
        res = store.query(args.feature_name, internal_query(args.cql))
        fids = list(res.batch.fids)
    elif args.ids:
        # both forms of a numeric-looking id, so it matches features stored
        # with integer or string fids
        fids = []
        for s in args.ids.split(","):
            fids.append(s)
            if s.lstrip("-").isdigit():
                fids.append(int(s))
    else:
        sys.exit("error: delete-features needs -q CQL or --ids")
    n = store.delete(args.feature_name, fids)
    print(f"deleted {n} features")


def cmd_age_off(args):
    from geomesa_tpu_torch.filter import ast
    from geomesa_tpu_torch.filter.ecql import parse_instant
    from geomesa_tpu_torch.query.plan import internal_query

    store = _store(args)
    before = parse_instant(args.before)
    if args.dry_run:
        dtg = store.get_schema(args.feature_name).dtg_field
        if dtg is None:
            sys.exit(f"error: {args.feature_name!r} has no Date field")
        n = len(store.query(args.feature_name, internal_query(ast.Compare("<", dtg, before))))
        print(f"would remove {n} features (dry run)")
    else:
        n = store.age_off(args.feature_name, before)
        print(f"removed {n} features")


KEYWORDS_KEY = "geomesa.keywords"


def cmd_keywords(args):
    store = _store(args)
    sft = store.get_schema(args.feature_name)
    current = [k for k in str(sft.user_data.get(KEYWORDS_KEY, "")).split(",") if k]
    changed = False
    if args.add:
        for k in args.add:
            if k not in current:
                current.append(k)
                changed = True
    if args.remove:
        current = [k for k in current if k not in args.remove]
        changed = True
    if changed:
        store.update_user_data(
            args.feature_name, {KEYWORDS_KEY: ",".join(current) if current else None})
    for k in current:
        print(k)


def cmd_reindex(args):
    store = _store(args)
    store.reindex(args.feature_name, args.index)
    print(f"reindexed {args.feature_name!r} on {args.index!r}")


def cmd_repartition(args):
    store = _store(args)
    store.repartition(args.feature_name, args.scheme or None)
    print(f"repartitioned {args.feature_name!r} ({args.scheme or 'no scheme'})")


def cmd_compact(args):
    store = _store(args)
    store.compact(args.feature_name)
    print(f"compacted {args.feature_name!r}")


def cmd_fsck(args):
    """Recovery sweep and full checksum verification: reclaims files of
    interrupted flushes, repairs a lagging generation sidecar, verifies
    every partition file against its manifest checksum, cross-checks the
    v2 chunk statistics against the decoded rows, and reports what it
    found. Exits non-zero on corruption or chunk-stat drift: drifted
    statistics mean pruning and pushdown could answer wrong."""
    store = _store(args)
    names = [args.feature_name] if args.feature_name else store.type_names
    corrupt = 0
    drifted = 0
    for name in names:
        rep = store.recover(name)
        line = f"{name}: swept {rep['files']} orphan file(s), {rep['bytes']} bytes"
        if rep["gen_repaired"]:
            line += "; repaired generation sidecar"
        print(line)
        if args.no_verify:
            continue
        errors = store.verify_partitions(name)
        total = len(store._types[name].partitions)
        for pid, path, err in errors:
            print(f"  partition {pid} CORRUPT ({path}): {err}")
        print(f"  verified {total - len(errors)}/{total} partition file(s) ok")
        corrupt += len(errors)
        if errors:
            continue  # corrupt files cannot be decoded for the stat checks
        chunked = sum(1 for p in store._types[name].partitions if p.chunks is not None)
        if not chunked:
            continue
        drift = store.verify_chunk_stats(name)
        for pid, ci, err in drift:
            where = f"chunk {ci}" if ci >= 0 else "chunks"
            print(f"  partition {pid} {where} DRIFT: {err}")
        print(f"  chunk stats cross-checked on {chunked} partition(s): {len(drift)} drift finding(s)")
        drifted += len(drift)
    if corrupt or drifted:
        sys.exit(f"error: {corrupt} corrupt partition file(s), {drifted} drifted chunk-stat record(s)")


def _stat_json(stat) -> dict:
    """to_json, with bulky payloads (HLL registers) swapped for estimates."""
    j = stat.to_json()
    if j.get("type") == "cardinality":
        j = {"type": "cardinality", "attr": j.get("attr"), "estimate": round(float(stat.estimate), 1)}
    j.pop("table", None)  # count-min table: thousands of ints
    # z3 histogram occupancy map (old dict form and parallel-list form)
    j.pop("cells", None)
    j.pop("cell_keys", None)
    j.pop("cell_counts", None)
    return j


def _run_stat(args, spec: str, store=None, device_index=None):
    from geomesa_tpu_torch.process.statsproc import run_stats

    if store is None:
        store = _store(args)
    if device_index is None:
        device_index = _resident_index(args, store)
    return run_stats(store, args.feature_name, args.cql or "INCLUDE", spec,
                     device_index=device_index)


def _resident_index(args, store):
    """--resident: stage the type's scan and key planes on the store's
    device, so the stats fuse into the device scan (DeviceIndex.stats)
    instead of taking the matched batch to the host."""
    if not getattr(args, "resident", False):
        return None
    from geomesa_tpu_torch.device_cache import DeviceIndex

    return DeviceIndex(store, args.feature_name, z_planes=True, device=store.device)


def cmd_stats_count(args):
    seq = _run_stat(args, "Count()")
    print(json.dumps(seq.stats[0].to_json()))


def cmd_stats_bounds(args):
    store = _store(args)
    sft = store.get_schema(args.feature_name)
    attrs = (
        args.attributes.split(",")
        if args.attributes
        else [a.name for a in sft.attributes
              if a.type_name in ("Integer", "Long", "Double", "Float", "Date")]
    )
    if attrs:
        # one combined spec: one scan for every attribute
        seq = _run_stat(args, ";".join(f'MinMax("{a}")' for a in attrs), store=store)
        for a, st in zip(attrs, seq.stats):
            print(f"{a}: {json.dumps(_stat_json(st))}")
    geom = sft.geom_field
    if geom is not None:
        res = store.query(args.feature_name, args.cql or "INCLUDE")
        col = res.batch.columns.get(geom)
        if col is not None and len(col):
            if col.dtype != object:
                bbox = [col[:, 0].min(), col[:, 1].min(), col[:, 0].max(), col[:, 1].max()]
            else:
                e = col[0].envelope
                for g in col[1:]:
                    e = e.expand(g.envelope)
                bbox = [e.xmin, e.ymin, e.xmax, e.ymax]
            print(f"{geom}: bbox {[round(float(v), 6) for v in bbox]}")


def cmd_stats_top_k(args):
    seq = _run_stat(args, f'TopK("{args.attribute}",{args.k})')
    print(json.dumps(seq.stats[0].to_json()))


def cmd_stats_histogram(args):
    store = _store(args)
    # one resident staging shared by the bounds pass and the histogram pass
    di = _resident_index(args, store)
    if args.min is None or args.max is None:
        mm = _run_stat(args, f'MinMax("{args.attribute}")', store=store,
                       device_index=di).stats[0].to_json()
        lo = args.min if args.min is not None else mm["min"]
        hi = args.max if args.max is not None else mm["max"]
        if lo is None or hi is None:
            sys.exit("error: no data to derive histogram bounds from; pass --min/--max")
    else:
        lo, hi = args.min, args.max
    seq = _run_stat(args, f'Histogram("{args.attribute}",{args.bins},{float(lo)},{float(hi)})',
                    store=store, device_index=di)
    print(json.dumps(seq.stats[0].to_json()))


def cmd_stats_analyze(args):
    """Summary stats for every attribute (ref: stats-analyze), in one scan:
    every attribute's stats ride a single combined spec."""
    store = _store(args)
    sft = store.get_schema(args.feature_name)
    pieces = ["Count()"]
    layout = []  # (attr, n_stats) in order
    for a in sft.attributes:
        if a.is_geometry:
            continue
        if a.type_name in ("Integer", "Long", "Double", "Float", "Date"):
            pieces += [f'MinMax("{a.name}")', f'Cardinality("{a.name}")']
        else:
            pieces += [f'Cardinality("{a.name}")', f'TopK("{a.name}",5)']
        layout.append((a.name, 2))
    seq = _run_stat(args, ";".join(pieces), store=store)
    stats = list(seq.stats)
    print(json.dumps(stats[0].to_json()))
    i = 1
    for name, n in layout:
        group = stats[i: i + n]
        i += n
        print(f"{name}: " + "; ".join(json.dumps(_stat_json(st)) for st in group))


def cmd_count(args):
    store = _store(args)
    print(store.count(args.feature_name, args.cql or "INCLUDE"))


def cmd_stats(args):
    from geomesa_tpu_torch.process.statsproc import run_stats

    store = _store(args)
    seq = run_stats(store, args.feature_name, args.cql or "INCLUDE", args.stat_spec,
                    device_index=_resident_index(args, store))
    for s in seq.stats:
        print(json.dumps(s.to_json()))


def _add_io_flags(sp):
    sp.add_argument(
        "--io-workers", type=int, default=None,
        help="host-I/O pipeline decode threads for partition reads "
        "(0 = serial; default: the io.workers system property)",
    )
    sp.add_argument(
        "--io-readahead", type=int, default=None,
        help="partition chunks in flight ahead of the consumer "
        "(0 = auto: 2 x workers)",
    )
    sp.add_argument(
        "--io-queue-mb", type=int, default=None,
        help="byte budget (MiB) for decoded chunks waiting in the "
        "prefetch queue (0 = unbounded)",
    )


def _apply_io_flags(args):
    """Route the --io-* flags into the io.* system properties."""
    from geomesa_tpu_torch.conf import set_prop

    if getattr(args, "io_workers", None) is not None:
        set_prop("io.workers", args.io_workers)
    if getattr(args, "io_readahead", None) is not None:
        set_prop("io.readahead", args.io_readahead)
    if getattr(args, "io_queue_mb", None) is not None:
        set_prop("io.queue.bytes", args.io_queue_mb << 20)


def _sched_config(args):
    """SchedConfig from the --sched* flags, or None when --sched is off.
    Unset flags fall back to the ``sched.*`` conf keys; an explicit flag
    wins."""
    if not getattr(args, "sched", False):
        return None
    import dataclasses

    from geomesa_tpu_torch.sched import SchedConfig

    cfg = SchedConfig.from_props()
    explicit = {
        k: v
        for k, v in (
            ("max_queue", args.sched_queue),
            ("max_inflight", args.sched_workers),
            ("fusion_window_ms", args.sched_fusion_ms),
        )
        if v is not None
    }
    return dataclasses.replace(cfg, **explicit) if explicit else cfg


def _add_sched_flags(sp):
    sp.add_argument(
        "--sched", action="store_true",
        help="route queries through the device query scheduler "
        "(bounded admission -> 429 on overload, deadlines, priority "
        "lanes, micro-batch scan fusion; see /stats/sched)",
    )
    sp.add_argument("--sched-queue", type=int, default=None,
                    help="admission queue bound (default: sched.max.queue)")
    sp.add_argument("--sched-workers", type=int, default=None,
                    help="in-flight concurrency cap (default: sched.max.inflight)")
    sp.add_argument("--sched-fusion-ms", type=float, default=None,
                    help="micro-batch fusion window in milliseconds "
                    "(default: sched.fusion.window.ms)")


def cmd_serve(args):
    """Serve the store over HTTP (GeoServer-bridge analog)."""
    from geomesa_tpu_torch.server import make_server

    _apply_io_flags(args)
    store = _store(args)
    server = make_server(
        store, args.host, args.port, resident=args.resident,
        warm=args.warm, sched=_sched_config(args),
        mesh=True if args.mesh else None,
        stream=True if args.stream else None,
    )
    host, port = server.server_address[:2]
    mode = " (resident device caches)" if args.resident else ""
    if args.sched:
        mode += " (query scheduler)"
    if server.stream_layer is not None:
        mode += " (streaming live layer)"
    print(f"serving {store.root} on http://{host}:{port}{mode}", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.shutdown()
    finally:
        # serve_forever also returns after POST /admin/shutdown
        server.server_close()


def _print_cost_table(title: str, table: dict):
    if not table:
        return
    print(f"\n{title}:")
    print(
        f"  {'key':<26}{'req':>7}{'err':>5}{'p50':>9}{'p99':>9}"
        f"{'device_s':>10}{'compile_s':>10}{'read_mb':>9}{'degr':>6}"
    )
    for key, agg in table.items():
        c = agg.get("cost", {})
        print(
            f"  {key[:26]:<26}{agg['requests']:>7}{agg['errors']:>5}"
            f"{(agg['p50_ms'] or 0):>7.1f}ms{(agg['p99_ms'] or 0):>7.1f}ms"
            f"{c.get('device_seconds', 0):>10.3f}"
            f"{c.get('compile_seconds', 0):>10.3f}"
            f"{c.get('read_bytes', 0) / 1e6:>9.2f}"
            f"{int(c.get('degraded', 0)):>6}"
        )


def _synth_columns(attrs: list, n: int, rng) -> dict:
    """Minimal append columns for an arbitrary schema (from /capabilities
    attribute metadata): the load driver's write leg."""
    cols = {}
    for a in attrs:
        t = a["type"].lower()
        if "point" in t or "geometry" in t or "line" in t or "polygon" in t:
            cols[a["name"]] = [[float(rng.uniform(-180, 180)), float(rng.uniform(-90, 90))]
                               for _ in range(n)]
        elif "string" in t:
            cols[a["name"]] = [f"ld-{i}" for i in range(n)]
        elif "date" in t:
            cols[a["name"]] = [1_000_000 + i for i in range(n)]
        elif "float" in t or "double" in t:
            cols[a["name"]] = [float(rng.uniform(0, 100)) for _ in range(n)]
        elif "bool" in t:
            cols[a["name"]] = [True] * n
        else:  # Int / Long / anything numeric-ish
            cols[a["name"]] = [int(rng.integers(0, 100)) for _ in range(n)]
    return cols


def _hold_subscriptions(url: str, type_name: str, k: int, lock):
    """``--subscribe K``: K standing world-bbox subscriptions, each under
    its own ``sub<k>`` tenant (the ledger's matched-alert cost lands on the
    subscriber), each read by a thread that counts its SSE match events.
    Returns ``(finish, counts)``: ``finish()`` cancels them and joins the
    readers."""
    import threading
    import urllib.request

    from geomesa_tpu_torch.spawn import spawn_thread

    subs = []
    for i in range(k):
        req = urllib.request.Request(
            f"{url}/subscribe/{type_name}?tenant=sub{i}",
            data=json.dumps({"bbox": [-180.0, -90.0, 180.0, 90.0]}).encode(), method="POST",
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=30) as r:
            subs.append(json.loads(r.read()))
    counts = [0] * k
    stop = threading.Event()

    def reader(i: int, sub: dict):
        target = f"{url}/subscribe/{type_name}?id={sub['id']}&from={sub['cursor']}"
        try:
            with urllib.request.urlopen(target, timeout=300) as resp:
                buf = b""
                while not stop.is_set():
                    chunk = resp.read1(1 << 16)
                    if not chunk:
                        break
                    buf += chunk
                    while b"\n\n" in buf:
                        ev, buf = buf.split(b"\n\n", 1)
                        if b"event: match" in ev:
                            with lock:
                                counts[i] += 1
        except Exception:
            pass  # a torn stream still reports its partial count

    threads = [spawn_thread(reader, name=f"load-sub-{i}", args=(i, s), context=False)
               for i, s in enumerate(subs)]
    for t in threads:
        t.start()

    def finish():
        # in-flight matches get a beat to deliver; then the cancels end
        # each stream ("cancelled") and the readers drain
        import time

        time.sleep(0.5)
        stop.set()
        for s in subs:
            try:
                req = urllib.request.Request(f"{url}/subscribe/{type_name}?id={s['id']}",
                                             method="DELETE")
                urllib.request.urlopen(req, timeout=10).close()
            except Exception:
                pass
        for t in threads:
            t.join(timeout=5)

    return finish, counts


def cmd_load_driver(args):
    """Concurrent load driver: M threads x N requests against a serving
    endpoint (an already-running --url, or a self-served store with a
    scheduler), reporting throughput, latency percentiles, shed load
    (429s) and the scheduler's fusion counters from /stats/sched. With
    ``--append-every N`` every Nth request of a thread is a synthetic POST
    /append of ``--append-rows`` rows, and ``--subscribe K`` holds K
    standing push streams open through the load (the mixed appends,
    subscriptions and reads leg); a self-served store then runs the live
    layer."""
    import threading
    import time
    import urllib.error
    import urllib.request
    from urllib.parse import quote

    import numpy as np

    from geomesa_tpu_torch.spawn import spawn_thread

    url, server = args.url, None
    writes = bool(args.append_every or args.subscribe)
    if url is None:
        from geomesa_tpu_torch.server import serve_background

        _apply_io_flags(args)
        store = _store(args)
        args.sched = True  # self-serve always schedules
        server, _ = serve_background(store, resident=args.resident, sched=_sched_config(args),
                                     stream=True if writes else None)
        host, port = server.server_address[:2]
        url = f"http://{host}:{port}"
    try:
        target = f"{url}/{args.endpoint}/{args.feature_name}?cql={quote(args.cql or 'INCLUDE')}"
        if args.loose:
            target += "&loose=1"
        if args.lane:
            target += f"&lane={args.lane}"
        # one warm request: first-touch staging and kernel builds are not load
        try:
            with urllib.request.urlopen(target, timeout=300) as r:
                r.read()
        except urllib.error.HTTPError as e:
            sys.exit(f"error: warmup request failed with HTTP {e.code} "
                     f"({e.read().decode(errors='replace')[:200]})")
        lats: list = []
        shed = [0, 0]  # 429s, other errors
        appends = {"attempted": 0, "acked_rows": 0, "shed": 0, "errors": 0}
        lock = threading.Lock()
        attrs = None
        if args.append_every:
            with urllib.request.urlopen(f"{url}/capabilities", timeout=30) as r:
                attrs = json.loads(r.read())["types"][args.feature_name]["attributes"]

        def append(tid: int, rng, fid0: int) -> None:
            n = args.append_rows
            body = json.dumps({"columns": _synth_columns(attrs, n, rng),
                               "fids": list(range(fid0, fid0 + n))}).encode()
            with lock:
                appends["attempted"] += 1
            try:
                req = urllib.request.Request(
                    f"{url}/append/{args.feature_name}", data=body, method="POST",
                    headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=60) as r:
                    out = json.loads(r.read())
                with lock:
                    appends["acked_rows"] += int(out.get("acked", 0))
            except urllib.error.HTTPError as e:
                with lock:
                    appends["shed" if e.code in (429, 503) else "errors"] += 1
            except Exception:
                with lock:
                    appends["errors"] += 1

        def worker(tid: int):
            # --tenants K spreads the load over K synthetic tenant ids for
            # the ledger's per-tenant view; 0 keeps the client address
            t_url = target
            if args.tenants > 0:
                t_url += f"&tenant=lt{tid % args.tenants}"
            rng = np.random.default_rng(tid)
            fid0 = 1_000_000_000 + tid * 1_000_000
            for i in range(args.requests):
                if args.append_every and i % args.append_every == 0:
                    append(tid, rng, fid0)
                    fid0 += args.append_rows
                    continue
                t0 = time.perf_counter()
                try:
                    with urllib.request.urlopen(t_url, timeout=120) as r:
                        r.read()
                except urllib.error.HTTPError as e:
                    with lock:
                        shed[0 if e.code == 429 else 1] += 1
                    continue
                with lock:
                    lats.append(time.perf_counter() - t0)

        finish = None
        if args.subscribe > 0:
            finish, sub_counts = _hold_subscriptions(url, args.feature_name, args.subscribe, lock)
        threads = [spawn_thread(worker, name=f"loadmt-worker-{i}", args=(i,), context=False)
                   for i in range(args.threads)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        lats.sort()
        rep = {
            "url": target,
            "threads": args.threads,
            "requests": args.threads * args.requests,
            "ok": len(lats),
            "rejected_429": shed[0],
            "errors": shed[1],
            "wall_s": round(wall, 3),
            "qps": round(len(lats) / wall, 1) if wall > 0 else None,
            "p50_ms": round(lats[len(lats) // 2] * 1e3, 2) if lats else None,
            "p99_ms": (round(lats[min(len(lats) - 1, int(len(lats) * 0.99))] * 1e3, 2)
                       if lats else None),
        }
        if args.append_every:
            rep["appends"] = appends
        if finish is not None:
            finish()
            with lock:
                counts = list(sub_counts)
            rep["pubsub"] = {"subscriptions": args.subscribe, "events_per_sub": counts,
                             "total_events": sum(counts)}
        try:
            with urllib.request.urlopen(f"{url}/stats/sched", timeout=10) as r:
                rep["sched"] = json.loads(r.read())
        except Exception:
            pass  # no scheduler on the target: the latency numbers stand
        print(json.dumps(rep, indent=2))
        # exit summary: who spent what, from the server's cost ledger
        try:
            with urllib.request.urlopen(f"{url}/stats/ledger", timeout=10) as r:
                led = json.loads(r.read())
            if led.get("enabled"):
                _print_cost_table("per-tenant cost + latency (from the ledger)",
                                  led.get("tenants", {}))
                comp = led.get("compile", {})
                if comp.get("compiles"):
                    print(f"\ncompile attribution: {comp['compiles']} kernel builds, "
                          f"{comp['total_s']}s blocked, {comp.get('cache_hits', 0)} cache hits")
        except Exception:
            pass  # the load report above stands
    finally:
        if server is not None:
            server.shutdown()  # drains and joins the scheduler too
            server.server_close()


def _fetch_json(url: str):
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=30) as r:
            return json.loads(r.read())
    except urllib.error.HTTPError as e:
        sys.exit(f"error: HTTP {e.code} ({e.read().decode(errors='replace')[:200]})")


def cmd_trace(args):
    """Fetch request traces from a running server's ``/debug/traces`` and
    print the span tree (or dump Perfetto JSON): the operator's view of
    where one slow query's time went."""
    import urllib.error
    import urllib.request

    from geomesa_tpu_torch.tracing import coverage, format_trace

    base = args.url.rstrip("/")
    if not args.trace_id:
        with urllib.request.urlopen(f"{base}/debug/traces?limit={args.limit}", timeout=30) as r:
            doc = json.loads(r.read())
        traces = doc.get("traces", [])
        if not traces:
            print("(no retained traces — see trace.sample / trace.slow_ms)")
            return
        for t in traces:
            flags = " [slow]" if t.get("slow") else ""
            print(f"{t['trace_id']}  {t['duration_ms']:>10.2f}ms  {t['name']}{flags}")
        return
    url = f"{base}/debug/traces/{args.trace_id}"
    if args.perfetto:
        url += "?format=perfetto"
    try:
        with urllib.request.urlopen(url, timeout=30) as r:
            doc = json.loads(r.read())
    except urllib.error.HTTPError as e:
        sys.exit(f"error: HTTP {e.code} ({e.read().decode(errors='replace')[:200]})")
    if args.perfetto:
        text = json.dumps(doc)
        if args.output and args.output != "-":
            with open(args.output, "w") as fh:
                fh.write(text)
            print(f"wrote Perfetto trace to {args.output} (open in https://ui.perfetto.dev)")
        else:
            print(text)
        return
    print(format_trace(doc))
    print(f"span coverage of request wall time: {coverage(doc) * 100:.1f}%")
    from geomesa_tpu_torch.ledger import cost_from_trace

    costs = cost_from_trace(doc)
    if costs:
        print("cost breakdown (span-derived):")
        for k, v in costs.items():
            print(f"  {k:<18} {v:g}")


def cmd_slo(args):
    """The trace family's SLO view: the burn table and windowed
    percentiles from a running server's ``/stats/slo``."""
    doc = _fetch_json(f"{args.url.rstrip('/')}/stats/slo")
    if not doc.get("enabled", False):
        print("(slo engine disabled — see the slo.enabled conf key)")
        return
    hdr = (
        f"{'slo':<13}{'objective':>10}{'threshold':>11}{'window':>9}"
        f"{'fast burn':>11}{'slow burn':>11}{'burning':>9}"
        f"{'requests':>10}{'bad':>6}"
    )
    print(hdr)
    for name, s in sorted(doc.get("slos", {}).items()):
        b = s["burn"]
        print(
            f"{name:<13}{s['objective'] * 100:>9.2f}%"
            f"{s['threshold_ms']:>9.0f}ms{s['window_s']:>8.0f}s"
            f"{b['fast']['rate']:>11.3f}{b['slow']['rate']:>11.3f}"
            f"{'YES' if s['burning'] else 'no':>9}"
            f"{s['requests']:>10}{s['bad']:>6}"
        )
    series = doc.get("series", {})
    if series:
        print("\nwindowed latency (endpoint|lane):")
        for key, s in sorted(series.items()):
            print(
                f"  {key:<26} p50={s['p50_ms']}ms p99={s['p99_ms']}ms "
                f"p999={s['p999_ms']}ms  ({s['requests']} req, {s['bad']} bad)"
            )


def cmd_ledger(args):
    """The trace family's cost view: per-tenant and per-shape top-K cost
    tables, the most expensive requests and the compile-attribution table
    (the kernel builds) from a running server's ``/stats/ledger``."""
    doc = _fetch_json(f"{args.url.rstrip('/')}/stats/ledger")
    if not doc.get("enabled", False):
        print("(cost ledger disabled — see the ledger.enabled conf key)")
        return
    print(f"ledgered requests: {doc.get('requests', 0)}")
    _print_cost_table("tenants (top-K by cost)", doc.get("tenants", {}))
    _print_cost_table("query shapes (top-K by cost)", doc.get("shapes", {}))
    top = doc.get("top_requests", [])
    if top:
        print("\nmost expensive requests:")
        for r in top:
            print(
                f"  {r['trace_id']:<18}{r['shape']:<24}"
                f"tenant={r['tenant']:<12}{r['duration_ms']:>9.1f}ms"
                f"  cost={r['cost_s']:.3f}s"
            )
    comp = doc.get("compile", {})
    sigs = comp.get("by_signature", {})
    if sigs:
        print(
            f"\ncompile attribution ({comp.get('compiles', 0)} compiles, "
            f"{comp.get('total_s', 0)}s total, "
            f"{comp.get('cache_hits', 0)} cache hits):"
        )
        for sig, s in sigs.items():
            trace = f"  last trace {s['last_trace_id']}" if s.get("last_trace_id") else ""
            print(
                f"  {sig[:40]:<40}{s['compiles']:>4}x "
                f"{s['total_s']:>8.3f}s (max {s['max_s']:.3f}s, "
                f"{s['cache_hits']} cache hits){trace}"
            )


def cmd_warmup(args):
    """The resident warmup. With ``--url``: report a running server's
    progress (the ``/stats`` warmup and compile-cache documents). Without:
    build the kernel libraries (on the card), stage ``--root``'s types
    into resident indexes and run the full plan (the kNN k ladder, the
    fused widths) once, printing the progress document: a deploy step that
    leaves the libraries built for the next server's start."""
    if getattr(args, "url", None):
        doc = _fetch_json(f"{args.url.rstrip('/')}/stats")
        w = doc.get("warmup", {})
        print(f"state: {w.get('state', 'unknown')}")
        print(
            f"signatures: {w.get('done', 0)}/"
            f"{w.get('signatures_total', 0)} "
            f"(compiled {w.get('compiled', 0)}, "
            f"from cache {w.get('from_cache', 0)}, "
            f"failed {w.get('failed', 0)})"
        )
        if w.get("seconds"):
            print(f"wall: {w['seconds']}s")
        cc = doc.get("compile_cache", {})
        print(
            f"persistent cache: enabled={bool(cc.get('enabled'))} "
            f"entries={cc.get('entries', 0)} hits={cc.get('hits', 0)} "
            f"misses={cc.get('misses', 0)}"
        )
        return
    from geomesa_tpu_torch import ledger, warmup
    from geomesa_tpu_torch.device import resolve_device
    from geomesa_tpu_torch.device_cache import DeviceIndex

    store = _store(args)
    types = [args.feature_name] if getattr(args, "feature_name", None) else list(store.type_names)
    if not types:
        sys.exit("error: no schemas in the store root")
    ledger.install()  # the nvcc runs below are the compile ledger's compiles
    if resolve_device(store.device).type == "cuda":
        from geomesa_tpu_torch.kernels import _build

        _build.build_all()
    indexes = {tn: DeviceIndex(store, tn, z_planes=True, device=store.device) for tn in types}
    print(json.dumps(warmup.run(indexes)))


def cmd_subs(args):
    """Operate on the continuous-query push tier of a running server: list
    the standing subscriptions with their delivery-cursor lag, inspect one,
    or cancel one (``--cancel``)."""
    import urllib.request

    base = args.url.rstrip("/")
    if args.cancel:
        if not args.id:
            sys.exit("error: --cancel needs --id <subscription>")
        doc = _fetch_json(f"{base}/stats/pubsub")
        sub = next((s for s in doc.get("subscriptions", ()) if s["id"] == args.id), None)
        if sub is None:
            sys.exit(f"error: no subscription {args.id!r}")
        req = urllib.request.Request(f"{base}/subscribe/{sub['type']}?id={args.id}",
                                     method="DELETE")
        with urllib.request.urlopen(req, timeout=30) as r:
            print(json.dumps(json.loads(r.read()), indent=2))
        return
    doc = _fetch_json(f"{base}/stats/pubsub")
    if not doc.get("enabled", False):
        print("(push tier disabled — the server runs without the streaming live layer)")
        return
    if args.id:
        sub = next((s for s in doc.get("subscriptions", ()) if s["id"] == args.id), None)
        if sub is None:
            sys.exit(f"error: no subscription {args.id!r}")
        print(json.dumps(sub, indent=2))
        return
    subs = doc.get("subscriptions", [])
    print(f"subscriptions: {len(subs)}  connections: {doc.get('connections', 0)}  "
          f"matched batches: {doc.get('matched_records', 0)}  "
          f"fused launches: {doc.get('fused_launches', 0)}")
    if not subs:
        return
    print(f"\n  {'id':<14}{'type':<16}{'tenant':<14}{'conns':>6}{'cursor':>10}{'lag':>8}  predicate")
    for s in subs:
        pred = []
        if s.get("bbox"):
            b = s["bbox"]
            pred.append(f"bbox[{b[0]:g},{b[1]:g},{b[2]:g},{b[3]:g}]")
        if s.get("dwithin"):
            d = s["dwithin"]
            pred.append(f"dwithin({d['x']:g},{d['y']:g},{d['distance']:g})")
        if s.get("cql"):
            pred.append(s["cql"][:40])
        print(f"  {s['id']:<14}{s['type']:<16}{s['tenant']:<14}{s['connected']:>6}"
              f"{s['cursor']:>10}{s['lag']:>8}  " + (" AND ".join(pred) or "-"))


_RESIDENT_HELP = "fuse stats into the device scan via a resident index"


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="geomesa_tpu_torch.tools")
    p.add_argument("--root", help="store root directory (default $GEOMESA_TPU_ROOT)")
    p.add_argument("--device", default="cuda",
                   help="where scans and resident indexes run: cuda (cuda:0) or cpu")
    sub = p.add_subparsers(dest="command", required=True)

    def add(name, fn, **kw):
        sp = sub.add_parser(name, **kw)
        sp.set_defaults(fn=fn)
        return sp

    sp = add("create-schema", cmd_create_schema)
    sp.add_argument("-f", "--feature-name", required=True)
    sp.add_argument("-s", "--spec", required=True)

    add("get-sfts", cmd_get_sfts)

    sp = add("describe-schema", cmd_describe_schema)
    sp.add_argument("-f", "--feature-name", required=True)

    sp = add("remove-schema", cmd_remove_schema)
    sp.add_argument("-f", "--feature-name", required=True)

    sp = add("explain", cmd_explain)
    sp.add_argument("-f", "--feature-name", required=True)
    sp.add_argument("-q", "--cql", required=True)

    sp = add("count", cmd_count)
    sp.add_argument("-f", "--feature-name", required=True)
    sp.add_argument("-q", "--cql")

    sp = add("stats", cmd_stats)
    sp.add_argument("--resident", action="store_true", help=_RESIDENT_HELP)
    sp.add_argument("-f", "--feature-name", required=True)
    sp.add_argument("-s", "--stat-spec", required=True)
    sp.add_argument("-q", "--cql")

    add("version", cmd_version)
    add("env", cmd_env)

    sp = add("delete-features", cmd_delete_features)
    sp.add_argument("-f", "--feature-name", required=True)
    sp.add_argument("-q", "--cql")
    sp.add_argument("--ids", help="comma-separated feature ids")

    sp = add("age-off", cmd_age_off)
    sp.add_argument("-f", "--feature-name", required=True)
    sp.add_argument("--before", required=True, help="ISO instant cutoff")
    sp.add_argument("--dry-run", action="store_true")

    sp = add("keywords", cmd_keywords)
    sp.add_argument("-f", "--feature-name", required=True)
    sp.add_argument("-a", "--add", nargs="*")
    sp.add_argument("-r", "--remove", nargs="*")

    sp = add("reindex", cmd_reindex)
    sp.add_argument("-f", "--feature-name", required=True)
    sp.add_argument("--index", required=True, help="z3|z2|xz3|xz2|id|attr:<name>")

    sp = add("repartition", cmd_repartition)
    sp.add_argument("-f", "--feature-name", required=True)
    sp.add_argument("--scheme", help="partition scheme spec; omit to drop")

    sp = add("compact", cmd_compact)
    sp.add_argument("-f", "--feature-name", required=True)

    sp = add("fsck", cmd_fsck)
    sp.add_argument("-f", "--feature-name", help="one schema; omit for every schema in the root")
    sp.add_argument("--no-verify", action="store_true",
                    help="recovery sweep only, skip checksum verification")

    sp = add("stats-count", cmd_stats_count)
    sp.add_argument("--resident", action="store_true", help=_RESIDENT_HELP)
    sp.add_argument("-f", "--feature-name", required=True)
    sp.add_argument("-q", "--cql")

    sp = add("stats-bounds", cmd_stats_bounds)
    sp.add_argument("--resident", action="store_true", help=_RESIDENT_HELP)
    sp.add_argument("-f", "--feature-name", required=True)
    sp.add_argument("-q", "--cql")
    sp.add_argument("-a", "--attributes", help="comma-separated attributes")

    sp = add("stats-top-k", cmd_stats_top_k)
    sp.add_argument("--resident", action="store_true", help=_RESIDENT_HELP)
    sp.add_argument("-f", "--feature-name", required=True)
    sp.add_argument("-q", "--cql")
    sp.add_argument("-a", "--attribute", required=True)
    sp.add_argument("-k", type=int, default=10)

    sp = add("stats-histogram", cmd_stats_histogram)
    sp.add_argument("--resident", action="store_true", help=_RESIDENT_HELP)
    sp.add_argument("-f", "--feature-name", required=True)
    sp.add_argument("-q", "--cql")
    sp.add_argument("-a", "--attribute", required=True)
    sp.add_argument("--bins", type=int, default=10)
    sp.add_argument("--min", type=float)
    sp.add_argument("--max", type=float)

    sp = add("stats-analyze", cmd_stats_analyze)
    sp.add_argument("--resident", action="store_true", help=_RESIDENT_HELP)
    sp.add_argument("-f", "--feature-name", required=True)
    sp.add_argument("-q", "--cql")

    sp = add("serve", cmd_serve)
    sp.add_argument("--host", default="127.0.0.1")
    sp.add_argument("--port", type=int, default=8080)
    sp.add_argument("--resident", action="store_true",
                    help="stage each type's planes on the card and serve "
                    "count/features/stats/density/kNN from resident scans")
    sp.add_argument("--warm", action="store_true",
                    help="with --resident: stage every type before serving, then run "
                    "each kernel family once in a bounded background pool "
                    "(compile.warmup.* conf keys; /readyz gates or stamps `warming` "
                    "until done, so no request pays a first-touch staging or a "
                    "kernel's first use)")
    sp.add_argument("--mesh", action="store_true",
                    help="mesh serving; with one card it serves single-card")
    sp.add_argument("--stream", action="store_true",
                    help="enable the streaming live layer: POST /append acks at "
                    "the WAL and serves at once (stream.*/wal.* conf keys)")
    _add_sched_flags(sp)
    _add_io_flags(sp)

    sp = add("load-driver", cmd_load_driver)
    sp.add_argument("-f", "--feature-name", required=True)
    sp.add_argument("-q", "--cql")
    sp.add_argument("--tenants", type=int, default=0,
                    help="spread requests over K synthetic tenant ids "
                    "(0 = the server's client-address default)")
    sp.add_argument("--url", help="existing server base URL; omit to "
                    "self-serve --root with a scheduler")
    sp.add_argument("--endpoint", default="count",
                    choices=["count", "features", "density", "knn"])
    sp.add_argument("--threads", type=int, default=8)
    sp.add_argument("--requests", type=int, default=25, help="requests per thread")
    sp.add_argument("--loose", action="store_true", help="key-only (fusable) scans: loose=1")
    sp.add_argument("--lane", choices=["interactive", "batch"])
    sp.add_argument("--resident", action=argparse.BooleanOptionalAction, default=True,
                    help="self-serve in resident mode (--no-resident "
                    "load-tests the store path instead)")
    sp.add_argument("--append-every", type=int, default=0,
                    help="every Nth request per thread is a synthetic POST /append "
                    "(0 = reads only)")
    sp.add_argument("--append-rows", type=int, default=8, help="rows per synthetic append")
    sp.add_argument("--subscribe", type=int, default=0,
                    help="hold K standing subscriptions (SSE push streams) open through "
                    "the load: the mixed appends+subscriptions+reads leg; per-subscriber "
                    "match counts ride the report and matched-alert cost lands on the "
                    "sub<k> tenants")
    _add_sched_flags(sp)
    _add_io_flags(sp)

    sp = add("trace", cmd_trace)
    sp.add_argument("--url", required=True,
                    help="running server base URL (e.g. http://host:port)")
    sp.add_argument("trace_id", nargs="?",
                    help="trace id (the X-Request-Id); omit to list recent traces")
    sp.add_argument("--perfetto", action="store_true",
                    help="emit Chrome-trace/Perfetto JSON instead of the pretty tree")
    sp.add_argument("-o", "--output", default="-", help="with --perfetto: write the JSON here")
    sp.add_argument("--limit", type=int, default=50, help="max traces to list (no trace_id)")

    sp = add("slo", cmd_slo)
    sp.add_argument("--url", required=True,
                    help="running server base URL (e.g. http://host:port)")

    sp = add("ledger", cmd_ledger)
    sp.add_argument("--url", required=True,
                    help="running server base URL (e.g. http://host:port)")

    sp = add("warmup", cmd_warmup)
    sp.add_argument("--url",
                    help="running server base URL: report its warmup progress; omit "
                    "to build the kernels and warm --root's full plan here")
    sp.add_argument("-f", "--feature-name", help="local mode: warm one schema (default: all)")

    sp = add("subs", cmd_subs)
    sp.add_argument("--url", required=True,
                    help="running server base URL (e.g. http://host:port)")
    sp.add_argument("--id", help="inspect (or with --cancel, cancel) one subscription")
    sp.add_argument("--cancel", action="store_true",
                    help="cancel the subscription named by --id")

    args = p.parse_args(argv)
    if args.device == "cuda":
        args.device = None  # cuda:0 through device.resolve_device
    try:
        args.fn(args)
    except KeyError as e:
        sys.exit(f"error: unknown schema or attribute {e}")
    except (ValueError, FileNotFoundError) as e:
        sys.exit(f"error: {e}")
    except BrokenPipeError:
        # a downstream pipe (head, less) closed early: not an error
        try:
            sys.stdout.close()
        except Exception:
            pass
        os._exit(0)


if __name__ == "__main__":
    main()
