"""The server's listen backlog under a burst of concurrent HTTP clients.

Serves 2^22 GDELT-shaped rows from a resident, scheduled memory store and
sends a burst of 64 client threads x 16 loose counts (new connection per
request, as urllib does) at the server listening with the stdlib's
backlog of 5 and with the server's 128, in turns (5, 128, 128, 5), on one
card in one process. Prints per turn the requests/s and the client p50,
p99 and max (ms), beside the card's name and power limit.

    python -m geomesa_tpu_torch.tools.serve_backlog_probe [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import threading
import time
import urllib.request

import numpy as np


def _card(device: str) -> str:
    if device == "cpu":
        return "cpu"
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        import torch

        return torch.cuda.get_device_name(0)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--device", default=None, help="cpu to run on the host (default cuda:0)")
    p.add_argument("--rows", type=int, default=1 << 22)
    p.add_argument("--threads", type=int, default=64)
    p.add_argument("--requests", type=int, default=16)
    args = p.parse_args(argv)
    from geomesa_tpu_torch import server as srv
    from geomesa_tpu_torch.store.memory import MemoryDataStore

    rng = np.random.default_rng(20200101)
    n = args.rows
    ds = MemoryDataStore(device=args.device)
    ds.create_schema("t", "count:Int,dtg:Date,*geom:Point:srid=4326")
    cx, cy = rng.uniform(-170, 170, 64), rng.uniform(-60, 70, 64)
    cid = rng.integers(0, 64, n)
    xy = np.stack([cx[cid] + rng.normal(0, 0.2, n), cy[cid] + rng.normal(0, 0.2, n)], 1)
    ds.write("t", {"count": rng.integers(0, 1000, n), "dtg": 1_577_836_800_000 + rng.integers(0, 60 * 86_400_000, n),
                   "geom": np.clip(xy, [-180, -90], [180, 90]).astype(np.float32)})
    tiles = [f"BBOX(geom, {cx[j] - 1:.3f}, {cy[j] - 1:.3f}, {cx[j] + 1:.3f}, {cy[j] + 1:.3f})"
             for j in range(args.requests)]
    card = _card(args.device or "cuda")
    out = []
    default = srv._GeomesaHTTPServer.request_queue_size
    try:
        for backlog in (5, default, default, 5):
            srv._GeomesaHTTPServer.request_queue_size = backlog
            server, _ = srv.serve_background(ds, resident=True, sched=True)
            base = "http://%s:%d" % server.server_address[:2]
            q = urllib.request.quote
            for t in tiles:  # staging and the first launches are not the burst
                urllib.request.urlopen(f"{base}/count/t?loose=1&cql={q(t)}", timeout=300).read()
            lat, lock = [], threading.Lock()

            def client(i):
                for j in range(args.requests):
                    t0 = time.perf_counter()
                    url = f"{base}/count/t?loose=1&cql={q(tiles[(i + j) % len(tiles)])}"
                    with urllib.request.urlopen(url, timeout=120) as r:
                        r.read()
                    with lock:
                        lat.append(time.perf_counter() - t0)

            th = [threading.Thread(target=client, args=(i,)) for i in range(args.threads)]
            t0 = time.perf_counter()
            for t in th:
                t.start()
            for t in th:
                t.join(timeout=600)
            wall = time.perf_counter() - t0
            server.shutdown()
            server.server_close()
            ms = np.sort(np.asarray(lat)) * 1e3
            row = {"backlog": backlog, "requests": len(ms), "requests_s": len(ms) / wall,
                   "p50_ms": float(np.percentile(ms, 50)), "p99_ms": float(np.percentile(ms, 99)),
                   "max_ms": float(ms[-1]), "card": card}
            out.append(row)
            print(f"backlog {backlog}: {row['requests_s']:.1f} requests/s, p50 {row['p50_ms']:.3f} ms, "
                  f"p99 {row['p99_ms']:.3f} ms, max {row['max_ms']:.3f} ms [{card}]", flush=True)
    finally:
        srv._GeomesaHTTPServer.request_queue_size = default
    print(json.dumps({"serve_backlog": out}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
