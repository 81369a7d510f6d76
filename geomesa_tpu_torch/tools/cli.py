"""The port's command line: ``serve``, ``load-driver`` and ``subs``.

Counterpart of ``geomesa_tpu/tools/cli.py``, trimmed to the store opener
``_store`` (reference line 69), the scheduler and host-I/O flags
(``_add_sched_flags``/``_sched_config``, ``_add_io_flags``/
``_apply_io_flags``, lines 780-857), ``cmd_serve`` (line 858),
``cmd_load_driver`` (line 1181) in its single-endpoint mode with the
mixed leg's synthetic appends and standing subscriptions (``--append-every``,
``--append-rows``, ``--subscribe``, lines 925-946 and 1062-1150) and
``cmd_subs`` (line 1544). Every subcommand takes ``--device`` (default
``cuda``; ``cpu`` serves the plain versions on the host, as the tests do).

    python -m geomesa_tpu_torch.tools --root DIR serve --resident [--sched] [--stream]
    python -m geomesa_tpu_torch.tools --root DIR load-driver -f NAME [-q CQL] [--loose] \
        [--subscribe K --append-every N]
    python -m geomesa_tpu_torch.tools subs --url URL [--id ID [--cancel]]

Left out: ``serve``'s ``--warm`` (ROADMAP item 5b) and replication flags,
``load-driver --backends`` (the replication item), and every other
subcommand of the counterpart.
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
        sched=_sched_config(args),
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

    sp = add("serve", cmd_serve)
    sp.add_argument("--host", default="127.0.0.1")
    sp.add_argument("--port", type=int, default=8080)
    sp.add_argument("--resident", action="store_true",
                    help="stage each type's planes on the card and serve "
                    "count/features/stats/density/kNN from resident scans")
    sp.add_argument("--warm", action="store_true",
                    help="not in the port yet (ROADMAP item 5b)")
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

    sp = add("subs", cmd_subs)
    sp.add_argument("--url", required=True,
                    help="running server base URL (e.g. http://host:port)")
    sp.add_argument("--id", help="inspect (or with --cancel, cancel) one subscription")
    sp.add_argument("--cancel", action="store_true",
                    help="cancel the subscription named by --id")

    args = p.parse_args(argv)
    if args.device == "cuda":
        args.device = None  # cuda:0 through device.resolve_device
    if getattr(args, "warm", False):
        sys.exit("error: --warm is not in the port yet (ROADMAP item 5b)")
    args.fn(args)


if __name__ == "__main__":
    main()
