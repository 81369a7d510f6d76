#!/usr/bin/env python3
"""Drive geomesa_tpu_torch's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases:
  0. the card (nvidia-smi name and power limit), torch and CUDA versions;
  1. build every CUDA kernel from csrc/ (one nvcc per source, in parallel);
  2. every kernel against its plain PyTorch version on the card, at ragged
     sizes with edge rows (dim scans at R in {1,2,4,8} and z2; the baked dim
     scan with 0 to 16 bt ranges; the interleaved scan at n in {0, 1, 1000,
     2^20+17} with 1 to 64 bin entries (29 among them), ids with gaps,
     padded, all-padded and contiguous, and its z2 variant; the filter scan
     over a fixed filter list; the density kernel at n in {0, 1, 1000,
     2^20+17} on six grids from 16x16 to 2048x1024, clustered and uniform
     points, with and without a mask, on the engine each grid takes and
     forced onto every engine that can hold it (cluster sizes 1, 2, 4, 8,
     hot-cell), a zero-width viewport on every engine, and the
     entry points on an inverted and a zero-width viewport; the filter
     scan over the envelope planes of a Polygon schema at n in {1, 1000,
     2^20+17}, edges on, one float32 ulp inside and outside the box:
     BBOX, BBOX AND DURING, DWITHIN around a point and a polygon, an
     INTERSECTS's envelope prefilter, a NOT/OR mix): bit-exact,
     weighted density grids within rtol 1e-6; and the AIS processes'
     torch ops (ops/knn.py, ops/window.py) on the card against the same
     functions on CPU tensors, bit for bit, at n in {0, 1, 1000, 2^20+17}:
     kNN with exact duplicates at one distance and rows on the radius
     box's edges and one ulp either side, k in {1, 10, 120, 8192}; the
     union mask over m in {1, 2, 64, 257} windows with and without time
     windows, rows on window edges and one ulp around them; the Q-batched
     scans of the scheduler's fused paths (the dim scan at Q in {1, 3, 8,
     16, 64} and R in {0, 1, 2, 4, 8}, the interleaved z3 scan over mixed
     bin layouts and its z2 variant, padded queries among them) against
     per-query loops of the plain versions, bit for bit; the validity
     operand of the five scans that take one (the dim scan, the
     interleaved scan, the filter scan, both batched scans at Q in {1, 4,
     64}) at 2^26 rows, count and mask, against the plain version ANDed
     with the plane: a null pointer, a plane of ones, 50% live at random,
     the last 2^20 rows dead, no row live; the join slice's torch ops on
     the card against the same functions on CPU tensors, bit for bit, at n
     in {0, 1, 1000, 2^20+17}: the pair pack of window_pairs_query over 1,
     64, 65 and 263 windows (rows on window edges and one ulp around them,
     with and without a row gate, a forced overflow past a cap of 16), the
     join refinement's count and compaction over run batches of point and
     envelope planes, and the BIN compaction of 4 and 6 lanes; then the fixed
     cost of one filter-scan launch (an empty CUDA event pair, 0 and 4,096
     rows beside 2^20 and 2^21, and the host's time to issue each call);
  3. the main path at full size: a GDELT-shaped resident Z3 point type
     (count:Int,dtg:Date,*geom:Point, 2^26 rows from a fixed seed: 90% of
     points in 64 city clusters, coordinates float32, dtg over 60 days from
     2020-01-01) and its date-less Z2 sibling, staged through
     DeviceIndex(BatchStore(batch)) and queried with 32 bbox+during
     filters through count(loose=True), count(loose=False), query() and
     query(loose=True), each Z3 window also through the baked dim scan
     against the runtime one; then 9 density calls (INCLUDE over the world at
     512x256 and 128x128, the Europe 5-day query exact, loose and weighted,
     a city viewport, grids up to 2048x1024, one on Z2) and 4 Count/MinMax/Histogram stats calls;
     every answer is checked on the host with numpy, and the launch counts
     of each drive show which kernels carried it;
  3c. (run before 3b, while the main path's answers are held) the
     interleaved key layout on the same rows: the Z3 and Z2 indexes
     staged with dim_planes=False (every loose count, mask and fid set equal
     to the dim-plane index's; loose density and stats), then the first
     2^25 of the points with dtg over 2015-02-18 .. 2024-12-31 in day bins, which the
     staging must put in the interleaved layout by itself (windows of 1 day
     to 8 weeks on the interleaved scan, longer ones on the filter scan;
     loose answers against numpy over host-encoded keys on a subsample,
     exact counts against numpy);
  3b. a labeled Z3 index of 2^22 rows (labels from a fixed seed over six
     visibility expressions): counts, fid sets, density grids, a Count()
     stat, two kNN calls (one with a base filter) and a BIN request
     through resident_bin (the rider declines a labeled staging; the twin
     answers) under three auth sets, checked against numpy with a
     per-label verdict table;
  3d. the xz path, non-point footprints: 2^21 OSM-building-shaped
     polygons (85% 4-to-12-vertex, 10% with a hole, 5% MultiPolygons,
     5-60 m across, 90% in phase 3's city clusters) staged as xz2
     (name:String,count:Int,*geom:Polygon), the first 2^20 with dates as
     xz3 (week bins, 60 days), driven with a map client's requests (16
     BBOX windows from 0.005 to 10 degrees, loose and exact, count, mask
     and query; on xz3 the same windows AND DURING of 1 to 21 days; 4
     INTERSECTS with 32-64-vertex district rings, 2 DWITHIN, 2 BBOX AND
     TOUCHES, 1 BBOX AND RELATE; Count/MinMax stats loose and exact) and a
     2^20-row labeled xz2 index under phase 3b's auth sets; the staged xz
     keys equal the host XZ2SFC/XZ3SFC.index, loose answers a numpy range
     cover of the host codes and cover the exact ones, exact BBOX and
     DWITHIN equal numpy over the float32 envelope planes, residual
     answers equal evaluate_host, from_planes answers alike, and the launch
     counts show every exact count and mask on the filter-scan kernel;
  3e. the AIS processes, BASELINE config #4: 2^26 AIS position reports
     shaped like NOAA MarineCadastre's
     (mmsi:Int,vessel_type:Int,sog:Float,cog:Float,dtg:Date,*geom:Point;
     2^14 vessels x 4,096 three-minute fixes shuttling between phase 3's
     64 city centres as ports, 10% moored, starts over 30 days, rows in
     report-time order, coordinates exact in float32) staged with key
     planes; 24 DeviceIndex.knn calls (busy lanes and ports, open ocean,
     75N, the antimeridian; k from 1 to 8192; 4 at radius 0.5 in sparse
     water; 8 with base filters on the filter-scan kernel) and 4 through
     process.knn, 6 tube_select calls on vessels' own tracks of 17-257
     fixes, 4 proximity_search calls (8 ports, a 128-vertex lane, a
     harbour polygon, one with a base filter) and 4 one-day density calls
     over a 512x512 sea viewport (exact, loose, weighted by sog); every
     kNN answer equals a numpy oracle of the same float32 formula bit for
     bit, tube and proximity fid sets (and distances) equal numpy, grids
     equal numpy, and the launch counts show the filter-scan kernel for
     every base filter and the density kernel for every density call; then
     BIN output (track mmsi): 4 exact one-day bbox windows over busy lanes,
     2 loose ones, 1 labeled by vessel_type and sorted, and INCLUDE over
     all 2^26 rows (1.07 GB of 16-byte records), each through the device
     rider, resident_bin and the host twin bin_export, byte for byte equal
     to numpy, the launch counts showing the scan kernel under every mask
     and results_bin_device_launches counting every rider call (p50 of each
     engine per request);
  3f. the device query scheduler (QueryScheduler, SchedConfig defaults
     with max_queue raised to 2,048) over phase 3's z3 and z2 dim-plane
     indexes and phase 3c's interleaved z3 and z2 indexes: 64 map-client
     threads each submit one pan of 16 loose tile counts (0.5-4 degree
     tiles around a city centre, over one day; bbox only on z2) and 16
     threads one loose feature request each, all at once, spread over the
     four indexes; then the same burst with
     max_fusion=1, unfused. Every count and fid set equals the serial
     loose answer; the launch counts equal, kernel by kernel, the fused
     groups and lone requests the requests' sched.execute spans show;
     fused_queries equals the requests that rode a fused group, the fused
     run launches fewer times than requests, no fused group fell back to
     serial, nothing is rejected or expired; per-request latency p50/p99
     (submit to the scheduler completing the request), requests/s
     and the fusion factor, fused and unfused;
  3g. the streaming index: phase 3's first 2^22 rows staged into
     StreamingDeviceIndex(z_planes=True, capacity=2^22 + stream.memtable.rows)
     (capacity 2^23, dim planes), fed through attach_live: 64 Puts of 2^14
     new rows, 64 Removes evicting 2^20 random fids, 16 Puts moving 2^12
     held rows to another city (p50/p99 of each, restages 1,
     delta_appends 80); then phase 3's 32 queries (count loose and exact,
     query exact and loose), the 9 density and 4 stats calls, 64 fused
     loose tile counts, 4 fused loose tile queries and 2 kNN calls, every
     answer against numpy over the live rows (kept from the messages
     alone) and against a DeviceIndex staged anew from them; a burst of
     256 fused loose counts through QueryScheduler beside a thread that
     appends and evicts away from every tile (each count equals the
     restaged index's); the same feed, reduced, on 2^22-row interleaved
     z3, z2 and interleaved z2 streaming indexes; growth (capacity 2^22
     -> 2^24) and compaction (55% dead) at 2^22 rows, with their restage
     seconds. Every scan launch of a streaming drive read the validity
     plane (``kernels.VALID_LAUNCHES``). On the fed 2^22-row index (part of
     phase 3h's drive): an envelope join of 16 city windows, again after one
     more append and one more eviction (each rebuilding the join layout for
     the new staged generation), each equal to numpy over the live rows,
     and one BIN rider call equal to numpy over the live rows;
  3h. spatial joins, BASELINE config #3: 2^26 NYC-Taxi-shaped pickups
     (passenger_count:Int,trip_distance:Float,dtg:Date,*geom:Point; January
     2015 inside (-74.26, 40.49, -73.70, 40.92), 70% in Manhattan-like
     clusters; synthetic from the seed) staged with key planes; the right
     sides are 263 zone envelopes (a seeded kd split of the extent, each
     widened by 0.002 degrees), 5 borough-like polygons of 32-64 vertices
     and 64 station points. Calls: the envelope join of every row against
     the zones, the same gated by one day and by four one-hour windows,
     window_pairs_query over the zones with a one-day base filter, an
     intersects join of the day against the boroughs and a dwithin 0.003
     degrees join of the day against the stations (each once, JOIN_REPEATS),
     all through spatial_join / DeviceIndex on the
     device engine, with join.broadcast.windows at 8 (the boroughs
     broadcast; the stations and zones plan their runs). Envelope pairs
     equal a numpy oracle (a sorted-x searchsorted per zone, then an
     inclusive float64 compare), and the day's join also equals itself
     under join.engine=host; predicate pairs equal the host
     engine and numpy (an even-odd crossing test; hypot); window pairs
     equal numpy over the float32 planes widened one ulp; the launch counts
     show the filter-scan kernel under every gate and base filter. Prints
     the prepare seconds, each call kind's p50, pairs/s, plan and refine
     seconds;
  3i. (run after 3h, while the main path's answers are held) the store
     path, BASELINE config #1 as users call it: phase 3's first 2^25 rows
     (a cut: 3j drives the same queries over all 2^26 through the
     file-system store) written into
     DataStoreFinder.get_data_store({"memory": "true"}) and
     flushed (the z3, z2 and id host index builds in partitions of 2^20,
     the write-time stats; seconds and host RSS printed); phase 3's 32
     bbox+during queries each through get_feature_source().get_count,
     get_features and store.query; an attribute-only filter (count > 500:
     a full-table scan, 32 partitions in 4 runs of 2^23), an INTERSECTS
     polygon (the kernel's float32 point-in-polygon on a point schema,
     checked by numpy in the same float32 operations), an INTERSECTS line
     (the host residual behind the envelope prefilter), a Query
     with sort_by, max_features and properties, explain, run_stats with
     seven sketches, a DeviceIndex staged from the store (its 32 exact
     counts equal the store's), and phase 3b's 2^22 labeled rows as a
     second type under its three auth sets; every answer against numpy
     over the float32 rows, phase 3's DeviceIndex answers on the same
     rows and the verdict table; the launch counts equal one filter_scan_mask per contiguous
     run of every plan (the ledger's device_launches too), with no
     device_fn call; p50/p99 per call kind, runs and scanned rows per
     query, the ledger's stage, launch and device seconds. Then the store
     path of process.knn, tube_select (4 tracks) and proximity_search (3
     inputs) on 2^22 AIS reports (phase 3e's generator, 2^10 vessels: a
     cut), each equal to the resident answer on the same rows;
  3j. (run after 3i, once its memory store is dropped) the file-system
     store, BASELINE config #1 via geomesa-fs: phase 3's 2^26 rows written
     through DataStoreFinder.get_data_store({"fs.path": <a temporary
     directory>}) into a z3 type (64 partitions of 2^20) and the first 2^23
     of them (a cut) under the daily,z2-2bit partition scheme, format v2,
     store.fsync on,
     2^16-row chunks (flush seconds, bytes on disk, write GB/s and host RSS
     printed; too little disk raises); on each type phase 3's 32 queries
     through store.query with the partition cache dropped (cold), then
     store.query (warm) and the count
     pushdown (warm, and cold: only the boundary chunks' blocks read), the
     full-table count > 500, phase 3's 9 density calls and one over a
     box on the coarse cells' edges through process.density and 4
     Count/MinMax stats calls through
     run_stats (both taking the pushdown), explain, verify_partitions and
     verify_chunk_stats (both empty); then (the z3 type only: a cut) the
     root reopened under store.verify=always and the 32 counts read cold
     through the feature source's get_count (get_count and get_features
     drive store.query's scan, as 3i drives them on the same rows: cuts).
     Counts and sorted
     fids against numpy (and, over its first 2^25 rows, phase 3i's memory
     store on the z3 type), stats exact, each
     pushdown density grid equal to the same store's on the CPU with its
     mass against numpy (exact for the box on the cells' edges, else
     within the rows of the coarse cells its box cuts and of its edges),
     weighted grids against numpy; the launch counts equal one filter_scan_mask per
     surviving partition of every plan and per partition a pushdown
     refines, with no device_fn call; p50/p99 per call kind (cold and
     warm), partitions scanned, chunks read and pruned, the read and
     decode seconds beside the runner's stage, launch and device seconds;
     then (the z3 type) the device trace: 4 warm store.query calls under a
     sampled request trace with trace.device.dir set (run_device_trace):
     one Chrome trace a surviving partition, each holding the one
     gm_filter_scan kernel event of its filter_scan_mask launch (no CUDA
     activity at all fails), the kernel's share of each traced block and
     profiling.report() (query.scan, plan.scan_ranges);
  3k. (inside 3j, after the z3 type's checks) the streaming live layer
     over 3j's z3 type in place, its store object (2^26 rows, 64
     partitions, fsync on):
     StreamingStore with stream.run.rows 2^16, stream.memtable.rows 2^22
     and wal.max.generations 16 (the daemon's due test held off: the
     script picks the compaction's instant), a StreamingDeviceIndex
     (capacity 2^27, dim planes) staged from the merged view and fed by
     the delta listener; 64 acked appends of 2^14 fresh GDELT-shaped rows
     (phase 3's generator on its city centres, another seed), each
     refresh a delta and no restage; after the 64 appends phase 3's 32
     queries through the layer's count and query (fid sets) and the
     index's exact and loose counts and loose mask, against numpy over
     the base and the acked rows (loose: phase 3's numpy-checked base
     counts plus numpy over the new rows' host dim planes), the
     filter-scan launches equal to the surviving partitions, the
     pushdown's refinements and the runs each plan touches, every index
     launch reading the validity plane; an append at 16 runs shed (next
     seq unchanged, no row visible); two process.density grids and a
     run_stats with runs live (the pushdowns decline) against numpy;
     compact_now beside a thread repeating the 32 counts (every answer
     exact; afterwards no run, the manifest's wal_watermark the last
     acked seq, one WAL segment left, the queries one launch a surviving
     partition); the shed append retried and 15 more (2^18 rows), then
     close(compact=False) and a reopen whose replay recovers exactly
     those rows, the 32 queries equal to numpy again. Prints append (ack)
     and delta-refresh p50/p99, merged count/query p50/p99 with 16 runs
     live and with none, compaction and replay seconds, WAL bytes and
     fsyncs, ingest rows/s (a {"stream_layer": ...} line);
  3l. (run after 3k) the HTTP serving bridge: 3j/3k's root reopened and
     served by serve_background(store, resident=True, sched=True,
     stream=True) on 127.0.0.1, driven by a urllib client (run_server_path
     says what each request checks against numpy and which launches it
     must count); the degradation ladder fails the resident rung alone
     (fail.resident.launch) and holds the store rung's answers, made by
     the filter scan on the card, to numpy. Prints each endpoint's p50/p99
     and the burst's requests/s (a {"server": ...} line);
  3m. (inside 3i, then 3j) the SQL layer: 64 district polygons, one
     around each of phase 3's city centres (rings of 16-64 vertices,
     0.2-2 degrees across, 8 with a hole, 4 MultiPolygons, from a fixed
     seed), written as a second type (name:String,*geom:Polygon) into 3i's
     memory store; SpatialFrame over 3i's type with the Europe query, and
     with select/sort/limit, whose collect (fids in order), count and
     explain equal ds.query / ds.explain of the same Query and 3i's
     answers; with_auths over 3i's labeled type under 3b's auth sets
     against numpy and the verdict table; spatial_join of a one-day
     DURING of 3i's type against the districts a BBOX keeps (REGIONS'
     africa box: the seeded centres put none in the Europe box) with
     within, intersects and dwithin 0.05, through the store path and
     again with device_index set to the DeviceIndex 3i staged from the
     store, both equal to a numpy point-in-polygon (and edge distance)
     over the float64 columns; the envelope join of the day's rows
     against the 64 districts' envelopes with no device_index, its pairs
     by fid equal to the resident engine's; st_geoHash,
     st_distanceSphere to a city centre and st_transform to 3857 and back
     over the Europe batch, timed and checked (every geohash cell holds
     its point, the haversine within rtol 1e-12, the round trip within
     1e-9 degrees); then over 3j's z3 type, partitions() (one batch per
     surviving partition with a hit), map_partitions(len, parallelism=4)
     and count() against numpy. The launch counts equal one
     filter_scan_mask per run every collect, count and pushdown plan
     scans (per surviving partition on the fs store), plus one per
     resident join's gate. Prints each call's time (a {"sql": ...} and a
     {"sql_fs": ...} line);
  4. each kernel's time at the main path's shapes (CUDA events) beside its
     bound, its plain version's time and, for density, torch.bincount;
     the interleaved scan also at 29 day bins (rows with a "case" key);
     the density kernel on every engine at every grid size of the density
     drive, clustered and uniform, counted and weighted; the filter scan
     over envelope planes (BBOX, BBOX AND DURING) at 2^26 synthetic rows
     made on the card and on the xz drive's planes; and, on a line of
     their own, the torch ops that replace no TPU kernel (the xz range
     masks, the card key encode, the kNN pass at k = 10 and 8192 and the
     union mask of 16 and 256 tube windows at 2^26 AIS rows); the batched
     scans at Q in {1, 4, 8, 64} (the z3 dim scan at R = 1 and 2) with phase
     3f's tile queries, beside Q launches of the single-query kernel;
     and beside each scan row (the batched ones at Q = 4 and 64) the same
     launch under a validity plane of 50% live rows (``"valid": true``;
     every row carries ``valid_launches``, its phase 3g launches with the
     plane); on the torch-ops line also the join slice's passes at phase
     3h's shapes: the pair pack of one 64-zone group at 2^26 rows, one
     refinement batch of 2^20 candidates, and the BIN compaction at 2^26
     AIS rows, each beside its bound; the filter-scan mask over one store
     run as phase 3i stages it (the z3 index's first 2^20 and 2^23 rows,
     the Europe query, and the full-table filter at 2^23 beside the one
     torch compare that computes it; rows with a "case" key, the run's
     "stage_ms" and the wrapper's host time per call, "host_ms").

Prints the kernel table as one JSON line, the card line, and last
{"ok": true, "device": {...}}. Any failure raises and exits non-zero;
without a CUDA device it exits 2 and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

SEED = 20200101
N_ROWS = 1 << 26
T0 = 1_577_836_800_000  # 2020-01-01T00:00:00Z
DAY = 86_400_000
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
# Operations bounds. The scans are 32-bit integer and compare work, which
# Hopper issues at 64 lanes per SM per clock: 132 SMs x 64 x 1.98 GHz. A
# compare counts once: the card's ISETP also ANDs or ORs its result into a
# predicate (the batched z2 dim scan ran under a count that added the ANDs,
# and its SASS shows 4 ISETP a row and query); a 64-bit compare of two
# 32-bit words is two, a bitwise word operation one. The
# density kernel's float64 pixel math (separate multiplies and subtracts,
# no FMA) runs at the same 64 lanes per SM per clock; the data sheet's
# 67 TFLOP/s float32 and 34 TFLOP/s float64 count an FMA as two.
INT32_OPS_PER_S = 132 * 64 * 1.98e9
F64_OPS_PER_S = 132 * 64 * 1.98e9
GDELT_SPEC = "count:Int,dtg:Date,*geom:Point:srid=4326"
Z2_SPEC = "count:Int,*geom:Point:srid=4326"


CARD = ""  # "name, power limit" from nvidia-smi, set in main(); beside every time


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# -- phase 2: kernels against plain versions ----------------------------------


class Errs:
    """max |kernel - plain| per kernel over every comparison made."""

    def __init__(self):
        self.err: dict = {}

    def check(self, name, got, want, what):
        import torch

        if got.shape != want.shape:
            raise AssertionError(f"{name} {what}: shape {tuple(got.shape)} != {tuple(want.shape)}")
        if got.dtype == want.dtype == torch.bool:  # masks: 1 where any row differs, on the device
            err = 0 if torch.equal(got, want) else 1
        else:
            g, w = got.to(torch.int64).cpu(), want.to(torch.int64).cpu()
            err = int((g - w).abs().max()) if g.numel() else 0
        self.err[name] = max(self.err.get(name, 0), err)
        if err:
            raise AssertionError(f"{name} {what}: kernel != plain (max abs err {err})")

    def check_grid(self, name, got, want, rtol, what):
        """Float grids: equal when ``rtol`` is 0, else |got - want| <=
        rtol * |want| cell by cell."""
        import torch

        if got.shape != want.shape:
            raise AssertionError(f"{name} {what}: shape {tuple(got.shape)} != {tuple(want.shape)}")
        diff = (got.to(torch.float64) - want.to(torch.float64)).abs()
        err = float(diff.max()) if diff.numel() else 0.0
        self.err[name] = max(self.err.get(name, 0.0), err)
        ok = torch.equal(got, want) if rtol == 0 else bool(
            (diff <= rtol * want.to(torch.float64).abs()).all())
        if not ok:
            raise AssertionError(f"{name} {what}: kernel != plain (max abs err {err})")


def check_dimscans(dev, errs: Errs):
    import torch

    from geomesa_tpu_torch.ops import zscan

    maxi, sent = (1 << 21) - 1, 0xFFFFFFFF
    for n in (1, 1000, (1 << 20) + 17):
        rng = np.random.default_rng(SEED + n)
        nx = rng.integers(0, maxi + 1, n).astype(np.uint32)
        ny = rng.integers(0, maxi + 1, n).astype(np.uint32)
        bt = rng.integers(0, 12 << 21, n).astype(np.uint32)
        edge = min(n, 4)
        bt[:edge] = sent  # out-of-window sentinel rows never match
        nx[-edge:] = maxi  # rows at max_index
        ny[-edge:] = maxi
        planes = [torch.from_numpy(a).to(dev) for a in (nx, ny, bt)]
        for r in (0, 1, 2, 4, 8):
            q = np.empty(4 + 2 * r, np.uint32)
            q[:4] = [0, maxi, rng.integers(0, maxi), maxi]  # bounds at max_index
            for k in range(r):
                a, b = np.sort(rng.integers(0, 12 << 21, 2))
                q[4 + 2 * k: 6 + 2 * k] = (sent, 0) if k % 2 else (a, b)  # inverted pads
            ps = planes[:2] if r == 0 else planes
            z = "z2" if r == 0 else "z3"
            want = zscan.dimscan_plain(q, *ps)
            errs.check(f"dimscan_{z}_mask", zscan.dimscan_mask(q, *ps), want, f"n={n} R={r}")
            errs.check(
                f"dimscan_{z}_count", zscan.dimscan_count(q, *ps).reshape(1),
                want.sum(dtype=torch.int32).reshape(1), f"n={n} R={r}",
            )
    torch.cuda.synchronize()


def check_baked_dimscans(dev, errs: Errs):
    """The baked dim scan against its plain version: 0 to 16 bt ranges,
    inverted ranges among them, sentinel rows and rows at max_index."""
    import torch

    from geomesa_tpu_torch.ops import zscan

    maxi, sent = (1 << 21) - 1, 0xFFFFFFFF
    for n in (0, 1, 1000, (1 << 20) + 17):
        rng = np.random.default_rng(SEED + 7 * n)
        nx = rng.integers(0, maxi + 1, n).astype(np.uint32)
        ny = rng.integers(0, maxi + 1, n).astype(np.uint32)
        bt = rng.integers(0, 40 << 21, n).astype(np.uint32)
        edge = min(n, 4)
        bt[:edge] = sent
        nx[-edge:] = maxi
        planes = [torch.from_numpy(a).to(dev) for a in (nx, ny, bt)]
        for r in (0, 1, 2, 3, 8, 16):
            qnx = tuple(int(v) for v in np.sort(rng.integers(0, maxi + 1, 2)))
            qny = (int(rng.integers(0, maxi)), maxi)
            ranges = [tuple(int(v) for v in np.sort(rng.integers(0, 40 << 21, 2)))
                      for _ in range(r)]
            if r > 2:
                ranges[2] = (sent, 0)  # inverted: never matches
            count_fn, mask_fn = zscan.build_z3_dimscan_pallas(qnx, qny, ranges)
            want = zscan.z3_dimscan_mask(*planes, qnx, qny, ranges)
            errs.check("dimscan_baked_mask", mask_fn(*planes), want, f"n={n} ranges={r}")
            errs.check("dimscan_baked_count", count_fn(*planes).reshape(1),
                       want.sum(dtype=torch.int32).reshape(1), f"n={n} ranges={r}")
    torch.cuda.synchronize()


def check_zscans(dev, errs: Errs):
    """The interleaved scan against its plain version: keys of random
    points over 64 week bins (a few rows in bin -1), 1 to 64 bin entries
    (29 among them) from the curve's own cell bounds or random words:
    shuffled ids with gaps and some padded, every query once more
    all-padded (counts 0), and contiguous bins padded to a power of two;
    the z2 variant on the same points."""
    import torch

    from geomesa_tpu_torch.curves.z2 import Z2SFC
    from geomesa_tpu_torch.curves.z3 import Z3SFC
    from geomesa_tpu_torch.curves.zorder import u64_hi_lo
    from geomesa_tpu_torch.ops import zscan

    maxi = (1 << 21) - 1
    for n in (0, 1, 1000, (1 << 20) + 17):
        rng = np.random.default_rng(SEED + 3 * n)
        x, y = rng.uniform(-180, 180, n), rng.uniform(-90, 90, n)
        off = rng.uniform(0, 604_800, n)
        k = min(n, 3)
        x[:k], y[:k], off[:k] = 180.0, 90.0, 604_800.0  # max_index corners
        bins = (2600 + rng.integers(0, 64, n)).astype(np.int32)
        bins[n - k:] = -1
        h3, l3 = u64_hi_lo(Z3SFC().index(x, y, off))
        h2, l2 = u64_hi_lo(Z2SFC().index(x, y))
        p3 = [torch.from_numpy(a).to(dev) for a in (bins, h3, l3)]
        p2 = [torch.from_numpy(a).to(dev) for a in (h2, l2)]
        for b in (1, 2, 5, 28, 29, 64):
            for random_words in (False, True):
                if random_words:
                    bounds = rng.integers(0, 1 << 32, (b, 3, 6), dtype=np.uint64).astype(np.uint32)
                else:
                    bounds = np.stack([zscan.z3_dim_bounds(tuple(lo), tuple(hi)) for lo, hi in (
                        np.sort(rng.integers(0, maxi + 1, (2, 3)), axis=0) for _ in range(b))])
                ids = (2600 + rng.permutation(64)[:b]).astype(np.int32)  # gaps between bins
                ids[rng.random(b) < 0.25] = -1
                # a window's own layout: contiguous bins padded to a power of two
                pb, pi = zscan.pad_bins(bounds, (2600 + np.arange(b)).astype(np.int32))
                for bb, ii in ((bounds, ids), (bounds, np.full(b, -1, np.int32)), (pb, pi)):
                    what = f"n={n} B={b} {'random' if random_words else 'cells'} {len(ii)} entries"
                    count_fn, mask_fn = zscan.build_z3_pallas_scan(bb, ii)
                    want = zscan.z3_zscan_mask(p3[1], p3[2], p3[0], bb, ii)
                    errs.check("zscan_z3_mask", mask_fn(*p3), want, what)
                    got_c = count_fn(*p3)
                    errs.check("zscan_z3_count", got_c.reshape(1),
                               want.sum(dtype=torch.int32).reshape(1), what)
                    if (ii < 0).all() and int(got_c):
                        raise AssertionError(f"zscan_z3_count {what}: all-padded query counted rows")
        for random_words in (False, True):
            if random_words:
                bounds = rng.integers(0, 1 << 32, (2, 6), dtype=np.uint64).astype(np.uint32)
            else:
                lo, hi = np.sort(rng.integers(0, (1 << 31), (2, 2)), axis=0)
                bounds = zscan.z2_dim_bounds(tuple(lo), tuple(hi))
            count_fn, mask_fn = zscan.build_z2_zscan(bounds)
            want = zscan.z2_zscan_mask(*p2, bounds)
            errs.check("zscan_z2_mask", mask_fn(*p2), want, f"n={n}")
            errs.check("zscan_z2_count", count_fn(*p2).reshape(1),
                       want.sum(dtype=torch.int32).reshape(1), f"n={n}")
    torch.cuda.synchronize()


def batch_qmat(rng, nq, r, span):
    """(nq, 4 + 2r) dim-scan query vectors: random boxes and bt ranges,
    some ranges inverted, and for nq > 2 the last query the never-matching
    padding vector of the fused paths."""
    maxi, sent = (1 << 21) - 1, 0xFFFFFFFF
    q = np.empty((nq, 4 + 2 * r), np.uint32)
    for i in range(nq):
        q[i, 0:2] = np.sort(rng.integers(0, maxi + 1, 2))
        q[i, 2:4] = (rng.integers(0, maxi), maxi) if i % 2 else np.sort(rng.integers(0, maxi + 1, 2))
        for k in range(r):
            q[i, 4 + 2 * k: 6 + 2 * k] = (sent, 0) if (i + k) % 3 == 2 else np.sort(
                rng.integers(0, span, 2))
    if nq > 2:
        q[-1] = [1, 0, 1, 0] + [sent, 0] * r
    return q


BATCH_EDGES = ("touching 0 and 0xFFFFFFFF", "identical queries", "nested, shared endpoints",
               "adjacent and overlapping bt ranges", "all padding")


def batch_qmat_edge(rng, name, nq, r, span):
    """(nq, 4 + 2r) dim-scan query vectors of one edge group of
    BATCH_EDGES, where an interval table over uint32 cuts can go wrong:
    ranges from or to 0 and 0xFFFFFFFF (hi + 1 wraps; a row at the top);
    nq copies of one query (every interval's word all ones or zeros);
    nested ranges and ranges sharing an endpoint (repeated cuts); a
    query's bt ranges adjacent (hi + 1 == the next lo) or overlapping (a
    query's ranges ORed); the fused paths' padding only ([1, 0] and
    [0xFFFFFFFF, 0] inverted ranges: no cut, no bit)."""
    sent = 0xFFFFFFFF
    q = np.empty((nq, 4 + 2 * r), np.uint32)
    if name == "touching 0 and 0xFFFFFFFF":
        def one():
            a = int(rng.integers(1, sent))
            return [(0, a), (a, sent), (0, sent), (0, 0), (sent, sent), (0, 1), (sent - 1, sent)][
                int(rng.integers(0, 7))]
        for i in range(nq):
            for k in range(2 + r):
                q[i, 2 * k: 2 * k + 2] = one()
    elif name == "identical queries":
        q[:] = batch_qmat(rng, 1, r, span)[0]
    elif name == "nested, shared endpoints":
        c, top = 1 << 20, (1 << 21) - 1
        a, b = np.sort(rng.integers(0, span, 2))
        for i in range(nq):
            w = (nq - i) * (c // (nq + 1))
            q[i, 0:2] = (c - w, c + w)  # nested
            q[i, 2:4] = (c // 2, c // 2 + int(rng.integers(0, c))) if i % 2 else (0, c // 2)  # shared ends
            for k in range(r):
                q[i, 4 + 2 * k: 6 + 2 * k] = (a + i, b) if k % 2 else (a, b - i)
        q[:, 1] = np.minimum(q[:, 1], top)
    elif name == "adjacent and overlapping bt ranges":
        q[:] = batch_qmat(rng, nq, r, span)
        for i in range(nq):
            lo = int(rng.integers(0, span // 2))
            for k in range(r):
                hi = lo + int(rng.integers(0, span // (4 * r)))
                q[i, 4 + 2 * k: 6 + 2 * k] = (lo, hi)
                # adjacent for even queries, overlapping (by up to 3) for odd ones
                lo = hi + 1 if i % 2 == 0 else max(int(q[i, 4 + 2 * k]), hi - int(rng.integers(0, 4)))
    elif name == "all padding":
        for i in range(nq):
            q[i] = ([1, 0, 1, 0] if i % 2 else [sent, 0, sent, 0]) + [sent, 0] * r
            if i % 3 == 1 and r:
                q[i, 4:6] = (1, 0)
    else:
        raise ValueError(name)
    return q


def batch_edge_planes(rng, qmat, n):
    """nx, ny (and bt when qmat has bt ranges) uint32 planes of n rows whose
    values lie at the group's range ends and one either side of them (wrapped
    to uint32), at 0, 1, 0xFFFFFFFE and 0xFFFFFFFF, a quarter of them at
    random in [0, 2^21)."""
    q = np.asarray(qmat, np.int64)
    r = (q.shape[1] - 4) // 2
    cols = [q[:, 0:2], q[:, 2:4]] + ([q[:, 4:]] if r else [])
    out = []
    for c in cols:
        v = np.unique(np.concatenate([c.ravel() + d for d in (-1, 0, 1)] + [[0, 1, 0xFFFFFFFE, 0xFFFFFFFF]]))
        vals = (rng.choice(v % (1 << 32), n)).astype(np.uint32)
        pick = rng.random(n) < 0.25
        vals[pick] = rng.integers(0, 1 << 21, int(pick.sum())).astype(np.uint32)
        out.append(vals)
    return out


def batch_zbounds(rng, nq, n_bins):
    """(nq, B, 3, 6) bounds and (nq, B) ids over bins 2600.. in mixed
    layouts: per query 1 to 8 entries, contiguous and padded to a power of
    two, or shuffled with gaps and some padded; cell boxes or random words;
    for nq > 2 the last query all padding."""
    from geomesa_tpu_torch.ops import zscan

    maxi = (1 << 21) - 1
    per = []
    for i in range(nq):
        b = int(rng.integers(1, 9))
        if i % 3 == 1:
            bounds = rng.integers(0, 1 << 32, (b, 3, 6), dtype=np.uint64).astype(np.uint32)
        else:
            bounds = np.stack([zscan.z3_dim_bounds(tuple(lo), tuple(hi)) for lo, hi in (
                np.sort(rng.integers(0, maxi + 1, (2, 3)), axis=0) for _ in range(b))])
        if i % 3 == 0:
            ids = (2600 + int(rng.integers(0, n_bins - b)) + np.arange(b)).astype(np.int32)
            bounds, ids = zscan.pad_bins(bounds, ids)
        else:
            ids = (2600 + rng.permutation(n_bins)[:b]).astype(np.int32)
            ids[rng.random(b) < 0.25] = -1
        per.append((bounds, ids))
    bmax = max(len(i) for _, i in per)
    out_b = np.zeros((nq, bmax, 3, 6), np.uint32)
    out_i = np.full((nq, bmax), -1, np.int32)
    for i, (b, d) in enumerate(per):
        out_b[i, : len(d)], out_i[i, : len(d)] = b, d
    if nq > 2:
        out_i[-1] = -1
    return out_b, out_i


BATCH_QS = (1, 3, 8, 16, 47, 64)


def ordered_words(rng, shape):
    """Random-word bounds with lo <= hi in every dimension: masked records
    that stay in the table (an entry with lo > hi is dropped as empty)."""
    b = rng.integers(0, 1 << 32, shape + (6,), dtype=np.uint64).astype(np.uint32)
    lo, hi = b[..., 2:4].copy(), b[..., 4:6].copy()
    swap = (lo[..., 0] > hi[..., 0]) | ((lo[..., 0] == hi[..., 0]) & (lo[..., 1] > hi[..., 1]))
    b[..., 2:4], b[..., 4:6] = np.where(swap[..., None], hi, lo), np.where(swap[..., None], lo, hi)
    return b


def batch_zforms(rng, n_bins):
    """Groups that put the batched interleaved scan's packer on each of its
    ways: (name, bounds (Q, B, 3, 6), ids (Q, B)): flat groups (at most
    FLAT_MAX_RECORDS records, every row tests every record) of cell boxes
    (two queries a bin: compact; one record a bin: masked,
    MASKED_MAX_MEET) and of random words, binned groups (the bin index) of each form and
    mixed, and groups of 64 queries x 64 bins, cell boxes and random words,
    whose tables exceed one launch's and split by queries."""
    from geomesa_tpu_torch.ops import zscan

    maxi = (1 << 21) - 1

    def cells(shape):
        lo, hi = np.sort(rng.integers(0, maxi + 1, (2,) + shape + (3,)), axis=0)
        out = np.empty(shape + (3, 6), np.uint32)
        for i in np.ndindex(*shape):
            out[i] = zscan.z3_dim_bounds(tuple(lo[i]), tuple(hi[i]))
        return out

    def ids(nq, b):
        return np.stack([(2600 + rng.permutation(n_bins)[:b]).astype(np.int32) for _ in range(nq)])

    mixed = cells((13, 6))
    mixed[1::2] = ordered_words(rng, (6, 6, 3))
    return [("flat, compact", cells((2, 2)), np.tile(ids(1, 2), (2, 1))),
            ("flat, cell boxes one a bin (masked)", cells((1, 3)), ids(1, 3)),
            ("flat, masked", ordered_words(rng, (2, 2, 3)), ids(2, 2)),
            ("binned, compact", cells((13, 6)), ids(13, 6)),
            ("binned, masked", ordered_words(rng, (13, 6, 3)), ids(13, 6)),
            ("binned, mixed", mixed, ids(13, 6)),
            ("split, compact", cells((64, 64)), ids(64, 64)),
            ("split, masked", ordered_words(rng, (64, 64, 3)), ids(64, 64))]


def check_batched_scans(dev, errs: Errs):
    """The Q-batched scans of the scheduler's fused paths against their
    plain versions (per-query loops of the single-query plain versions):
    the dim scan at Q in {1, 3, 8, 16, 47, 64} and R in {0, 1, 2, 4, 8}, on
    random groups and on each edge group of BATCH_EDGES (rows at the
    group's range ends), with and without a validity plane (half live),
    through the wrappers and with each of its two ways forced,
    the interleaved z3 scan over mixed bin layouts (up to 8 entries a
    query, padded, gapped, all-padded queries) and its z2 variant, at n in
    {1, 1000, 2^20+17}; then the interleaved z3 scan's compact and masked
    records under both ways of finding a row's records and split into
    several launches (2^20+17 rows), each against the reference and the
    plain version on the packed layout; rows in bin -1 never match."""
    import torch

    from geomesa_tpu_torch import kernels
    from geomesa_tpu_torch.curves.z2 import Z2SFC
    from geomesa_tpu_torch.curves.z3 import Z3SFC
    from geomesa_tpu_torch.curves.zorder import MAX_MASK_2D, u64_hi_lo
    from geomesa_tpu_torch.ops import zscan

    maxi, sent = (1 << 21) - 1, 0xFFFFFFFF
    cases = 0
    for n in (1, 1000, (1 << 20) + 17):
        rng = np.random.default_rng(SEED + 11 * n)
        nx = rng.integers(0, maxi + 1, n).astype(np.uint32)
        ny = rng.integers(0, maxi + 1, n).astype(np.uint32)
        bt = rng.integers(0, 12 << 21, n).astype(np.uint32)
        bt[: min(n, 4)] = sent
        planes = [torch.from_numpy(a).to(dev) for a in (nx, ny, bt)]
        gen = torch.Generator(device=dev)
        gen.manual_seed(SEED + n)
        half = torch.rand(n, generator=gen, device=dev) < 0.5
        for r in (0, 1, 2, 4, 8):
            ps = planes[:2] if r == 0 else planes
            z = "z2" if r == 0 else "z3"
            for nq in BATCH_QS:
                groups = [("random", batch_qmat(rng, nq, r, 12 << 21), ps)]
                for edge in BATCH_EDGES:
                    qe = batch_qmat_edge(rng, edge, nq, r, 12 << 21)
                    groups.append((edge, qe, [torch.from_numpy(a).to(dev)
                                              for a in batch_edge_planes(rng, qe, n)]))
                for group, q, pls in groups:
                    for v in (None, half):
                        want = zscan.batched_dim_mask_rt(r)(*pls, q, valid=v)
                        what = f"n={n} R={r} Q={nq} {group}{'' if v is None else ', half live'}"
                        if v is None:
                            errs.check(f"dimscan_batched_{z}_mask", zscan.batched_dimscan(q).plain(*pls),
                                       want, f"{what}, plain on the packed layout")
                        errs.check(f"dimscan_batched_{z}_mask",
                                   zscan.batched_dimscan_mask(q, *pls, valid=v), want, what)
                        errs.check(f"dimscan_batched_{z}_count",
                                   zscan.batched_dimscan_count(q, *pls, valid=v),
                                   want.sum(dim=1, dtype=torch.int32), what)
                        for compare in (True, False):  # each way, whatever the shape picks
                            pk = zscan.batched_dimscan(q, compare=compare)
                            way = f"{what}, the {'compare' if compare else 'lookup'} way"
                            errs.check(f"dimscan_batched_{z}_mask", pk.run(pls, True, valid=v), want, way)
                            errs.check(f"dimscan_batched_{z}_count", pk.run(pls, False, valid=v),
                                       want.sum(dim=1, dtype=torch.int32), way)
                        cases += 1
        x, y = rng.uniform(-180, 180, n), rng.uniform(-90, 90, n)
        off = rng.uniform(0, 604_800, n)
        bins = (2600 + rng.integers(0, 16, n)).astype(np.int32)
        bins[: min(n, 3)] = -1
        h3, l3 = (torch.from_numpy(a).to(dev) for a in u64_hi_lo(Z3SFC().index(x, y, off)))
        h2, l2 = (torch.from_numpy(a).to(dev) for a in u64_hi_lo(Z2SFC().index(x, y)))
        b3 = torch.from_numpy(bins).to(dev)
        for nq in BATCH_QS:
            bounds, ids = batch_zbounds(rng, nq, 16)
            want = zscan.batched_kind_mask("z3")(h3, l3, b3, bounds, ids)
            what = f"n={n} Q={nq} B={ids.shape[1]}"
            errs.check("zscan_batched_z3_mask", zscan.batched_zscan_mask(bounds, ids, h3, l3, bins=b3),
                       want, what)
            errs.check("zscan_batched_z3_count", zscan.batched_zscan_count(bounds, ids, h3, l3, bins=b3),
                       want.sum(dim=1, dtype=torch.int32), what)
            b2 = np.empty((nq, 2, 6), np.uint32)
            for i in range(nq):
                lo, hi = np.sort(rng.integers(0, MAX_MASK_2D + 1, (2, 2)), axis=0)
                b2[i] = zscan.z2_dim_bounds(tuple(lo), tuple(hi))
            b2[1::3] = ordered_words(rng, (len(b2[1::3]), 2))
            if nq > 2:
                b2[-1] = 0
                b2[-1, :, 3] = 1  # the fused paths' z2 padding: lo_lo 1 > hi 0
            want = zscan.batched_kind_mask("z2")(h2, l2, b2)
            errs.check("zscan_batched_z2_mask", zscan.batched_zscan_mask(b2, None, h2, l2), want,
                       f"n={n} Q={nq}")
            errs.check("zscan_batched_z2_count", zscan.batched_zscan_count(b2, None, h2, l2),
                       want.sum(dim=1, dtype=torch.int32), f"n={n} Q={nq}")
            cases += 2
    # the packer's ways, at 2^20 + 17 rows over 128 week bins
    bins = (2600 + rng.integers(0, 128, n)).astype(np.int32)
    bins[:3] = -1
    b3 = torch.from_numpy(bins).to(dev)
    ways = []
    for name, bounds, ids in batch_zforms(rng, 128):
        pk = zscan.batched_zscan(bounds, ids)
        want = zscan.batched_kind_mask("z3")(h3, l3, b3, bounds, ids)
        what = f"{name}, Q={len(ids)}, n={n}"
        before = dict(kernels.LAUNCHES)
        errs.check("zscan_batched_z3_mask", pk.run(b3, h3, l3, want_mask=True), want, what)
        errs.check("zscan_batched_z3_count", pk.run(b3, h3, l3, want_mask=False),
                   want.sum(dim=1, dtype=torch.int32), what)
        errs.check("zscan_batched_z3_mask", pk.plain(b3, h3, l3), want, f"{what}, plain on the packed layout")
        for k in ("zscan_batched_z3_mask", "zscan_batched_z3_count"):
            if kernels.LAUNCHES[k] - before[k] != len(pk.launches):
                raise AssertionError(f"{what}: {k} launched {kernels.LAUNCHES[k] - before[k]} times "
                                     f"for {len(pk.launches)} packed tables")
        lcs = pk.launches
        ways.append((name, len(lcs), sorted({"binned" if lc.binned else "flat" for lc in lcs}),
                     sum(lc.nc for lc in lcs), sum(lc.nm for lc in lcs)))
        cases += 1
    torch.cuda.synchronize()
    got = {w for _, k, finding, nc, nm in ways for w in finding + ["compact"] * (nc > 0)
           + ["masked"] * (nm > 0) + ["split"] * (k > 1)}
    if got != {"flat", "binned", "compact", "masked", "split"}:
        raise AssertionError(f"the batched interleaved scan's checks reached only {sorted(got)}")
    log(f"batched scans: {cases} cases (dim scan Q in {list(BATCH_QS)} x R in 0-8 on random "
        f"groups and the edge groups {list(BATCH_EDGES)}, each with and without a plane, the "
        f"shape's way and both ways forced; "
        f"interleaved z3 and z2; the packer's ways {ways} as (case, launches, finding, "
        f"compact records, masked records)), kernel == plain bit for bit")


VALID_QS = (1, 4, 64)  # the batched scans' widths under a validity plane


def valid_patterns(n, dev, seed):
    """(name, plane) of the validity cases: a null pointer, a plane of
    ones (every row live: equal to the null pointer), 50% live at random,
    the last min(n, 2^20) rows dead, no row live."""
    import torch

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    tail = torch.ones(n, dtype=torch.bool, device=dev)
    tail[max(0, n - (1 << 20)):] = False
    return [("null", None), ("ones", torch.ones(n, dtype=torch.bool, device=dev)),
            ("half live", torch.rand(n, generator=gen, device=dev) < 0.5),
            ("last 2^20 dead", tail), ("none live", torch.zeros(n, dtype=torch.bool, device=dev))]


def validity_cases(dev, n, seed, qs=VALID_QS) -> list:
    """The five kernels that take a validity operand, on random planes of
    n rows made on the card: (kernel prefix, case, run(valid, mask) -> the
    count or the mask, plain() -> the plain version's mask without
    validity). The dim scan at R = 2 and z2; the interleaved scan over 16
    week bins and z2; the filter scan of a bbox+during program; the batched
    scans at Q in ``qs`` (query vectors and bounds from batch_qmat and
    batch_zbounds)."""
    import torch

    from geomesa_tpu_torch.features.sft import SimpleFeatureType
    from geomesa_tpu_torch.filter.compile import compile_filter
    from geomesa_tpu_torch.filter.ecql import parse_ecql
    from geomesa_tpu_torch.ops import filter_scan, zscan

    maxi, span = (1 << 21) - 1, 12 << 21
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def u32(hi):
        if hi is None:  # random words
            return torch.randint(-(1 << 31), 1 << 31, (n,), generator=gen, device=dev,
                                 dtype=torch.int32).view(torch.uint32)
        return torch.randint(0, hi, (n,), generator=gen, device=dev).to(torch.int32).view(torch.uint32)

    nx, ny, bt = u32(maxi + 1), u32(maxi + 1), u32(span)
    hi, lo = u32(None), u32(None)
    bins = torch.randint(2600, 2616, (n,), generator=gen, device=dev, dtype=torch.int32)
    cases = []
    for r, ps in ((2, (nx, ny, bt)), (0, (nx, ny))):
        q = batch_qmat(rng, 1, r, span)[0]
        z = "z3" if r else "z2"
        cases.append((f"dimscan_{z}", f"R={r}",
                      lambda v, m, q=q, ps=ps: (zscan.dimscan_mask if m else zscan.dimscan_count)(
                          q, *ps, valid=v),
                      lambda q=q, ps=ps: zscan.dimscan_plain(q, *ps)))
    bounds = np.stack([zscan.z3_dim_bounds(tuple(a), tuple(b)) for a, b in (
        np.sort(rng.integers(0, maxi + 1, (2, 3)), axis=0) for _ in range(4))])
    ids = (2600 + rng.permutation(16)[:4]).astype(np.int32)
    c3, m3 = zscan.build_z3_pallas_scan(bounds, ids)
    cases.append(("zscan_z3", "4 bin entries",
                  lambda v, m: (m3 if m else c3)(bins, hi, lo, valid=v),
                  lambda: zscan.z3_zscan_mask(hi, lo, bins, bounds, ids)))
    a, b = np.sort(rng.integers(0, 1 << 31, (2, 2)), axis=0)
    b2 = zscan.z2_dim_bounds(tuple(a), tuple(b))
    c2, m2 = zscan.build_z2_zscan(b2)
    cases.append(("zscan_z2", "one entry", lambda v, m: (m2 if m else c2)(hi, lo, valid=v),
                  lambda: zscan.z2_zscan_mask(hi, lo, b2)))
    sft = SimpleFeatureType.create("g", GDELT_SPEC)
    prog = compile_filter(parse_ecql(
        "BBOX(geom, -10, 35, 30, 60) AND dtg DURING 2020-01-10T00:00:00Z/2020-01-15T00:00:00Z"),
        sft).program
    dtg = torch.randint(T0, T0 + 60 * DAY, (n,), generator=gen, device=dev)
    fcols = {"geom__x": (torch.rand(n, generator=gen, device=dev) * 360 - 180),
             "geom__y": (torch.rand(n, generator=gen, device=dev) * 180 - 90),
             "dtg__hi": (dtg >> 32).to(torch.int32),
             "dtg__lo": (dtg & 0xFFFFFFFF).to(torch.int32).view(torch.uint32)}
    fcols = {c: fcols[c] for c in prog.cols}
    cases.append(("filter_scan", "bbox+during",
                  lambda v, m: (filter_scan.filter_scan_mask if m else filter_scan.filter_scan_count)(
                      prog, fcols, valid=v),
                  lambda: filter_scan.run_program_plain(prog, fcols)))
    for nq in qs:
        for r, ps in ((1, (nx, ny, bt)), (0, (nx, ny))):
            qm = batch_qmat(rng, nq, r, span)
            z = "z3" if r else "z2"
            cases.append((f"dimscan_batched_{z}", f"Q={nq} R={r}",
                          lambda v, m, qm=qm, ps=ps: (zscan.batched_dimscan_mask if m else
                                                      zscan.batched_dimscan_count)(qm, *ps, valid=v),
                          lambda qm=qm, ps=ps, r=r: zscan.batched_dim_mask_rt(r)(*ps, qm)))
        zb, zi = batch_zbounds(rng, nq, 16)
        pk = zscan.batched_zscan(zb, zi)
        cases.append(("zscan_batched_z3", f"Q={nq} B={zi.shape[1]}",
                      lambda v, m, pk=pk: pk.run(bins, hi, lo, want_mask=m, valid=v),
                      lambda zb=zb, zi=zi: zscan.batched_kind_mask("z3")(hi, lo, bins, zb, zi)))
        zb2 = np.stack([zscan.z2_dim_bounds(tuple(a), tuple(b)) for a, b in (
            np.sort(rng.integers(0, 1 << 31, (2, 2)), axis=0) for _ in range(nq))])
        pk2 = zscan.batched_zscan(zb2, None)
        cases.append(("zscan_batched_z2", f"Q={nq}",
                      lambda v, m, pk=pk2: pk.run(None, hi, lo, want_mask=m, valid=v),
                      lambda zb=zb2: zscan.batched_kind_mask("z2")(hi, lo, zb)))
    return cases


def check_validity(dev, errs: Errs, n, seed=SEED + 5, qs=VALID_QS, kinds=None) -> int:
    """Each kernel's count and mask with a validity operand against its
    plain version ANDed with the plane (``validity_cases`` x
    ``valid_patterns``), bit for bit; a plane of ones equals the null
    pointer. ``kinds`` keeps the cases whose kernel prefix it names.
    Returns the number of comparisons."""
    import torch

    from geomesa_tpu_torch import kernels

    pats = valid_patterns(n, dev, seed)
    done = 0
    for prefix, case, run, plain in validity_cases(dev, n, seed, qs):
        if kinds is not None and prefix not in kinds:
            continue
        base = plain()
        for pname, v in pats:
            want = base if v is None else base & v
            what = f"n={n} {case}, validity: {pname}"
            before = kernels.VALID_LAUNCHES[f"{prefix}_mask"]
            errs.check(f"{prefix}_mask", run(v, True), want, what)
            errs.check(f"{prefix}_count", run(v, False).reshape(-1),
                       want.sum(dim=-1, dtype=torch.int32).reshape(-1), what)
            if v is not None and dev.type == "cuda" and \
                    kernels.VALID_LAUNCHES[f"{prefix}_mask"] == before:
                raise AssertionError(f"{prefix}_mask {what}: no launch read the plane")
            done += 2
        del base
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return done


def launch_floor(dev) -> None:
    """The fixed cost of one filter-scan launch as phase 4 times it (50
    launches between one CUDA event pair): an empty event pair, the
    wrapper over 0 rows (a mask launches nothing; a count launches one
    block, which writes 0, and the one-block sum) and over 4,096 rows, beside 2^20 and 2^21 rows (one and two
    store partitions); and for each the host's time to issue one call, which bounds
    the rate of back-to-back launches from below."""
    import torch

    from geomesa_tpu_torch.features.sft import SimpleFeatureType
    from geomesa_tpu_torch.filter.compile import compile_filter
    from geomesa_tpu_torch.filter.ecql import parse_ecql
    from geomesa_tpu_torch.ops import filter_scan

    prog = compile_filter(parse_ecql(ENV_FILTERS[0]), SimpleFeatureType.create("osm3", XZ3_SPEC)).program
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    pair = []
    for _ in range(20):
        start.record()
        end.record()
        torch.cuda.synchronize()
        pair.append(start.elapsed_time(end))
    out = {"event_pair_ms": float(np.median(pair))}
    for n in (0, 4096, 1 << 20, 1 << 21):
        planes = envelope_planes(n, SEED + 13)
        cols = {c: torch.from_numpy(planes[c]).to(dev) for c in prog.cols}
        for kind, fn in (("count", filter_scan.filter_scan_count), ("mask", filter_scan.filter_scan_mask)):
            call = lambda fn=fn, cols=cols: fn(prog, cols)  # noqa: E731
            ms = time_ms(call, 50)
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(50):
                call()
            host = (time.perf_counter() - t) / 50 * 1e3
            torch.cuda.synchronize()
            out[f"{kind}_{n}"] = {"ms": ms, "host_issue_ms": host,
                                  "bound_ms": (16 * n + (n if kind == "mask" else 4)) / HBM_BYTES_PER_S * 1e3}
    log(json.dumps({"launch_floor": out, "card": CARD}))


def _ring(k, cx=10.0, cy=45.0, r=12.0):
    a = np.linspace(0.0, 2 * np.pi, k, endpoint=False)
    pts = [(cx + r * np.cos(t) * (1.0 + 0.3 * (i % 3)), cy + r * np.sin(t))
           for i, t in enumerate(a)]
    pts.append(pts[0])
    return ", ".join(f"{float(x)!r} {float(y)!r}" for x, y in pts)


W32 = 1 << 32
SCAN_FILTERS = [
    "BBOX(geom, -10, 35, 30, 60)",
    "BBOX(geom, -10, 35, 30, 60) AND dtg DURING 2020-01-10T00:00:00Z/2020-01-15T00:00:00Z",
    "DWITHIN(geom, POINT(5 45), 500, kilometers)",
    "INTERSECTS(geom, POLYGON((-10 35, 30 40, 20 60, -5 55, -10 35)))",
    "DISJOINT(geom, POLYGON((-10 35, 30 40, 20 60, -5 55, -10 35)))",
    f"INTERSECTS(geom, POLYGON(({_ring(64)})))",
    f"DISJOINT(geom, POLYGON(({_ring(64)})))",
    "count > 500 AND count <= 900.5",
    "count IN (1, 2, 3, 42, 999)",
    "NOT (count < 200 OR BBOX(geom, 0, 0, 90, 45)) OR dtg > '2020-02-20T00:00:00Z'",
    f"dtg BETWEEN {W32 - 1} AND {2 * W32}",
]


def check_filter_scans(dev, errs: Errs):
    import torch

    from geomesa_tpu_torch.features.batch import FeatureBatch
    from geomesa_tpu_torch.features.sft import SimpleFeatureType
    from geomesa_tpu_torch.filter.compile import compile_filter
    from geomesa_tpu_torch.filter.ecql import parse_ecql
    from geomesa_tpu_torch.ops import filter_scan
    from geomesa_tpu_torch.ops.scan import stage_columns

    sft = SimpleFeatureType.create("gdelt", GDELT_SPEC)
    for n in (1, 1000, (1 << 20) + 17):
        cols = make_columns(n, SEED + n)
        dtg = cols["dtg"]
        k = min(n, 6)
        dtg[:k] = [W32 - 1, W32, W32 + 1, 2 * W32, -W32, -1][:k]  # i64 word edges
        batch = FeatureBatch.from_columns(sft, cols)
        for ecql in SCAN_FILTERS:
            cf = compile_filter(parse_ecql(ecql), sft)
            if cf.program is None:
                raise AssertionError(f"the filter-scan kernel refused {ecql}")
            staged = stage_columns(batch, cf.device_cols, dev)
            want = filter_scan.run_program_plain(cf.program, staged)
            errs.check("filter_scan_mask", cf.mask(staged), want, f"n={n} {ecql[:40]}")
            errs.check(
                "filter_scan_count", cf.count(staged).reshape(1),
                want.sum(dtype=torch.int32).reshape(1), f"n={n} {ecql[:40]}",
            )
    torch.cuda.synchronize()


ENV_BOX = (-10.0, 35.0, 30.0, 60.0)
ENV_FILTERS = [
    "BBOX(geom, -10, 35, 30, 60)",
    "BBOX(geom, -10, 35, 30, 60) AND dtg DURING 2020-01-10T00:00:00Z/2020-01-15T00:00:00Z",
    "DWITHIN(geom, POINT(5 45), 500, kilometers)",
    "DWITHIN(geom, POLYGON((-10 35, 30 40, 20 60, -5 55, -10 35)), 50, kilometers)",
    "INTERSECTS(geom, POLYGON((-10 35, 30 40, 20 60, -5 55, -10 35)))",
    "NOT (count < 200 OR BBOX(geom, -10, 35, 30, 60)) OR dtg > '2020-02-20T00:00:00Z'",
]


def envelope_planes(n, seed, box=ENV_BOX):
    """Float32 envelope planes of n synthetic footprints around ``box``,
    the first rows with one edge exactly on a box edge or one float32 ulp
    inside or outside it (x1 at xmin, y1 at ymin, x0 at xmax, y0 at ymax),
    plus count and dtg planes."""
    rng = np.random.default_rng(seed)
    x0 = rng.uniform(box[0] - 20, box[2] + 10, n).astype(np.float32)
    y0 = rng.uniform(box[1] - 20, box[3] + 10, n).astype(np.float32)
    x1 = (x0 + rng.uniform(0, 3, n)).astype(np.float32)
    y1 = (y0 + rng.uniform(0, 3, n)).astype(np.float32)
    edges = []
    for v in box:
        f = np.float32(v)
        edges += [f, np.nextafter(f, np.float32(-1e9)), np.nextafter(f, np.float32(1e9))]
    cx, cy = np.float32((box[0] + box[2]) / 2), np.float32((box[1] + box[3]) / 2)
    for i, e in enumerate(edges[:n]):
        x0[i], y0[i], x1[i], y1[i] = cx - 1, cy - 1, cx + 1, cy + 1
        k = i // 3
        lo_plane, hi_plane = ((x0, x1), (y0, y1), (x0, x1), (y0, y1))[k]
        if k < 2:
            hi_plane[i], lo_plane[i] = e, e - np.float32(1)
        else:
            lo_plane[i], hi_plane[i] = e, e + np.float32(1)
    dtg = rng.integers(T0, T0 + 60 * DAY, n)
    return {"geom__x0": x0, "geom__y0": y0, "geom__x1": x1, "geom__y1": y1,
            "count": rng.integers(0, 1000, n).astype(np.int32),
            "dtg__hi": (dtg >> 32).astype(np.int32),
            "dtg__lo": (dtg & 0xFFFFFFFF).astype(np.uint32)}


def check_envelope_scans(dev, errs: Errs):
    """The filter scan over the envelope planes of a Polygon schema (the
    exact xz path): BBOX, BBOX AND DURING, DWITHIN around a point and a
    polygon, an INTERSECTS's envelope prefilter and a NOT/OR mix."""
    import torch

    from geomesa_tpu_torch.features.sft import SimpleFeatureType
    from geomesa_tpu_torch.filter.compile import compile_filter
    from geomesa_tpu_torch.filter.ecql import parse_ecql
    from geomesa_tpu_torch.ops import filter_scan

    sft = SimpleFeatureType.create("osm3", XZ3_SPEC)
    for n in (1, 1000, (1 << 20) + 17):
        planes = envelope_planes(n, SEED + n)
        for ecql in ENV_FILTERS:
            cf = compile_filter(parse_ecql(ecql), sft)
            if cf.program is None or not any(c.endswith("__x0") for c in cf.device_cols):
                raise AssertionError(f"{ecql}: no envelope-plane program")
            cols = {c: torch.from_numpy(planes[c]).to(dev) for c in cf.device_cols}
            want = filter_scan.run_program_plain(cf.program, cols)
            errs.check("filter_scan_mask", cf.mask(cols), want, f"envelope n={n} {ecql[:40]}")
            errs.check("filter_scan_count", cf.count(cols).reshape(1),
                       want.sum(dtype=torch.int32).reshape(1), f"envelope n={n} {ecql[:40]}")
    torch.cuda.synchronize()


DENSITY_ENV = (-60.0, -45.0, 100.0, 60.0)
DENSITY_GRIDS = [(16, 16), (100, 37), (256, 256), (512, 512), (1024, 1024), (2048, 1024)]


def density_case(n, width, height, clustered, seed):
    """float32 points: clustered (8 centres, sigma 0.2 degrees) or uniform
    over a box wider than the viewport; the first rows sit on cell edges,
    on the viewport border and just outside it."""
    rng = np.random.default_rng(seed)
    x0, y0, x1, y1 = DENSITY_ENV
    if clustered:
        centres = rng.uniform([x0 + 5, y0 + 5], [x1 - 5, y1 - 5], (8, 2))
        xy = centres[rng.integers(0, 8, n)] + rng.normal(0.0, 0.2, (n, 2))
    else:
        xy = rng.uniform([x0 - 10, y0 - 10], [x1 + 10, y1 + 10], (n, 2))
    k = min(n, 64)
    xy[:k, 0] = x0 + rng.integers(0, width + 1, k) * (x1 - x0) / width
    xy[:k, 1] = y0 + rng.integers(0, height + 1, k) * (y1 - y0) / height
    if n >= 4:
        xy[:4] = [[x0, y0], [x1, y1], [x0 - 1e-3, 0.0], [0.0, y1 + 1e-3]]
    x = np.ascontiguousarray(xy[:, 0], np.float32)
    y = np.ascontiguousarray(xy[:, 1], np.float32)
    return x, y, rng.random(n) < 0.6, rng.uniform(0.5, 2.0, n).astype(np.float32)


def _engine_name(engine) -> str:
    return f"{engine[0]}{engine[1] or ''}"


def check_density(dev, errs: Errs):
    """The density kernel on the engine each grid takes (density_grid) and,
    at n >= 1000, forced onto every engine that can hold the grid (cluster
    sizes 1, 2, 4, 8, hot-cell); then a zero-width viewport on every
    engine, and the entry points on an inverted and a zero-width one."""
    import torch

    from geomesa_tpu_torch.ops.density import _launch, density_grid, density_plain, engines

    for n in (0, 1, 1000, (1 << 20) + 17):
        for width, height in DENSITY_GRIDS:
            for clustered in (True, False):
                x, y, m, w = (torch.from_numpy(a).to(dev) for a in
                              density_case(n, width, height, clustered, SEED + n + width))
                for mask in (None, m):
                    what = (f"n={n} {width}x{height} {'clustered' if clustered else 'uniform'}"
                            f"{' masked' if mask is not None else ''}")
                    args = (x, y, DENSITY_ENV, width, height)
                    want = density_plain(*args, mask=mask)
                    want_w = density_plain(*args, mask=mask, weights=w)
                    errs.check_grid("density_count", density_grid(*args, mask=mask), want, 0.0, what)
                    errs.check_grid("density_weighted", density_grid(*args, mask=mask, weights=w),
                                    want_w, 1e-6, what)
                    if n < 1000:
                        continue
                    for weighted in (False, True):
                        for engine in engines(width, height, weighted):
                            got = _launch(*args, mask, w if weighted else None, engine=engine)
                            errs.check_grid(
                                "density_weighted" if weighted else "density_count", got,
                                want_w if weighted else want, 1e-6 if weighted else 0.0,
                                f"{what} {_engine_name(engine)} engine")
    check_density_viewports(dev, errs)
    torch.cuda.synchronize()


def check_density_viewports(dev, errs: Errs):
    """A zero-width viewport (rows on its line land in column 0) on every
    engine against the plain version; then DeviceIndex.density and the
    store path of process.density on the card: an inverted viewport gives
    a zero grid and launches nothing, a zero-width one counts the rows on
    the line, on the store path as on the resident one (the counterpart's
    store path raises ZeroDivisionError there: ROADMAP section 3)."""
    import torch

    from geomesa_tpu_torch import kernels
    from geomesa_tpu_torch.device_cache import DeviceIndex
    from geomesa_tpu_torch.features.batch import FeatureBatch
    from geomesa_tpu_torch.features.sft import SimpleFeatureType
    from geomesa_tpu_torch.geom import Envelope
    from geomesa_tpu_torch.ops.density import _launch, density_plain, engines
    from geomesa_tpu_torch.process.density import density
    from geomesa_tpu_torch.store.direct import BatchStore

    line = (-20.0, 10.0, -20.0, 40.0)
    n = (1 << 20) + 17
    for clustered in (True, False):
        x, y, m, w = (torch.from_numpy(a).to(dev) for a in density_case(n, 64, 64, clustered, SEED))
        x[: n // 3] = line[0]
        y[: n // 3] = torch.linspace(0.0, 50.0, n // 3, device=dev)
        for mask in (None, m):
            for weighted in (False, True):
                wt = w if weighted else None
                want = density_plain(x, y, line, 256, 256, mask=mask, weights=wt, lines=True)
                if int((want != 0).sum()) == 0 or bool(want[:, 1:].any()):
                    raise AssertionError("the zero-width case must count rows in column 0 only")
                for engine in engines(256, 256, weighted):
                    got = _launch(x, y, line, 256, 256, mask, wt, engine=engine, lines=True)
                    errs.check_grid("density_weighted" if weighted else "density_count", got, want,
                                    1e-6 if weighted else 0.0,
                                    f"zero-width viewport {_engine_name(engine)} engine")
    # the entry points on 2^18 rows, a quarter of them on the line x = 0
    n = 1 << 18
    rng = np.random.default_rng(SEED)
    xy = rng.uniform(-50.0, 50.0, (n, 2)).astype(np.float32).astype(np.float64)
    xy[: n // 4, 0] = 0.0
    sft = SimpleFeatureType.create("t", GDELT_SPEC)
    cols = {"count": rng.integers(0, 1000, n).astype(np.int32),
            "dtg": rng.integers(T0, T0 + 60 * DAY, n), "geom": xy}
    store = BatchStore(FeatureBatch.from_columns(sft, cols))
    di = DeviceIndex(store, "t", z_planes=True, device=dev)
    for env in ((170.0, -10.0, -170.0, 10.0), (0.0, -10.0, 0.0, 30.0)):
        for weight in (None, "count"):
            sel = (xy[:, 0] >= env[0]) & (xy[:, 0] <= env[2]) & (xy[:, 1] >= env[1]) & (xy[:, 1] <= env[3])
            want = np.zeros((64, 32), np.float32)
            if sel.any():
                py = np.clip(np.floor((xy[sel, 1] - env[1]) * 64 / (env[3] - env[1])), 0, 63)
                want[:, 0] = np.bincount(py.astype(np.int64), minlength=64, weights=(
                    cols["count"][sel].astype(np.float64) if weight else None))
            kernels.reset_counts()
            got = di.density("INCLUDE", Envelope(*env), 32, 64, weight_attr=weight)
            launched = sum(kernels.LAUNCHES.values())
            inverted = env[2] < env[0]
            if launched != (0 if inverted else 1) or not same_grid(got, want, weight is not None):
                raise AssertionError(f"DeviceIndex.density {env} {weight}: {launched} launches, "
                                     f"grid {'==' if same_grid(got, want, weight is not None) else '!='} numpy")
            if inverted:
                got = density(store, "t", "INCLUDE", Envelope(*env), 32, 64, weight_attr=weight,
                              device=dev)
                if got.shape != (64, 32) or got.any():
                    raise AssertionError("store-path density over an inverted viewport is not zero")
            else:
                sgot = density(store, "t", "INCLUDE", Envelope(*env), 32, 64, weight_attr=weight,
                               device=dev)
                if not (same_grid(sgot, want, weight is not None) and same_grid(sgot, got, weight is not None)):
                    raise AssertionError(f"store-path density over a zero-width viewport {weight}: grid != "
                                         "numpy / the resident grid")
    del di
    log(f"density viewports: zero-width on every engine == plain; inverted and zero-width "
        f"through DeviceIndex.density == numpy (inverted launched nothing); store path "
        f"zero / the resident grid")


RAGGED = (0, 1, 1000, (1 << 20) + 17)


def _ulps(v) -> list:
    """float32 ``v`` and one ulp above and below it."""
    e = np.float32(v)
    return [e, np.nextafter(e, np.float32(np.inf)), np.nextafter(e, np.float32(-np.inf))]


def check_ais_ops(dev):
    """The AIS processes' torch ops (ops/knn.py, ops/window.py; no TPU
    kernel behind them) on the card against the same functions on CPU
    tensors, bit for bit: kNN distance and selection with 40 exact
    duplicates at one distance and rows on the radius box's edges and one
    ulp either side; the union mask over m in {1, 2, 64, 257} windows, with
    and without time windows, rows on a window's edges and one ulp around."""
    import torch

    from geomesa_tpu_torch.ops import knn as knn_ops
    from geomesa_tpu_torch.ops.int64lanes import split_array_np
    from geomesa_tpu_torch.ops.window import union_mask, widen

    cpu = torch.device("cpu")
    cases = 0
    for n in RAGGED:
        rng = np.random.default_rng(SEED + n)
        x = rng.uniform(9.0, 11.0, n).astype(np.float32)
        y = rng.uniform(19.0, 21.0, n).astype(np.float32)
        if n >= 1000:
            x[100:140], y[100:140] = np.float32(10.25), np.float32(20.125)
            edge = _ulps(10.5) + _ulps(9.5)
            x[200:206], y[200:206] = edge, np.float32(20.0)
            y[300:306], x[300:306] = _ulps(20.5) + _ulps(19.5), np.float32(10.0)
        mask = rng.random(n) < 0.8
        q = (10.0, 20.0, 0.5, knn_ops.lon_factor(20.0))
        for k in (1, 10, 120, 8192):
            out = []
            for d in (dev, cpu):
                xt, yt = torch.from_numpy(x).to(d), torch.from_numpy(y).to(d)
                qt = knn_ops.query_vector(*q, d)
                out.append([knn_ops.knn_d2(xt, yt, qt).cpu()] + [
                    t.cpu() for t in knn_ops.knn(xt, yt, qt, k, torch.from_numpy(mask).to(d))])
            if not all(torch.equal(a, b) for a, b in zip(*out)):
                raise AssertionError(f"knn ops n={n} k={k}: the card != the CPU")
            cases += 1
        t = T0 + rng.integers(0, DAY, n)
        hi, lo = split_array_np(t)
        for m in (1, 2, 64, 257):
            c = rng.uniform(9.0, 11.0, (m, 2))
            h = rng.uniform(0.01, 0.5, (m, 2))
            envs = _f32(np.concatenate([c - h, c + h], axis=1))
            envs[3::7] = envs[3::7][:, [2, 3, 0, 1]]  # inverted windows
            if n >= 1000:
                x[400:403], y[400:403] = _ulps(envs[0, 2]), np.float32((envs[0, 1] + envs[0, 3]) / 2)
                x[403:406], y[403:406] = _ulps(envs[0, 0]), np.float32((envs[0, 1] + envs[0, 3]) / 2)
            t0 = T0 + rng.integers(0, DAY, m)
            times = np.stack([t0, t0 + rng.integers(0, DAY // 4, m)], axis=1)
            for tm in (None, times):
                out = []
                for d in (dev, cpu):
                    lanes = (None, None) if tm is None else (
                        torch.from_numpy(hi).to(d), torch.from_numpy(lo).to(d))
                    out.append(union_mask(torch.from_numpy(x).to(d), torch.from_numpy(y).to(d),
                                          widen(envs), *lanes, times=tm).cpu())
                if not torch.equal(*out):
                    raise AssertionError(f"union mask n={n} m={m} times={tm is not None}: "
                                         "the card != the CPU")
                cases += 1
    torch.cuda.synchronize()
    log(f"AIS torch ops: {cases} kNN and union-mask cases, the card == the CPU bit for bit")


JOIN_WINDOW_COUNTS = (1, 64, 65, 263)  # one window, one group, a group and one, the zones


def _join_case_windows(rng, x, y, m):
    """m float64 windows over the rows' area; window 0 has its corners on
    rows 0 and 1, and rows 2-7 sit on its right and top edges and one
    float32 ulp either side (n >= 8); every 7th window is inverted."""
    c = rng.uniform(9.0, 11.0, (m, 2))
    h = rng.uniform(0.01, 0.5, (m, 2))
    envs = _f32(np.concatenate([c - h, c + h], axis=1))
    envs[3::7] = envs[3::7][:, [2, 3, 0, 1]]
    if len(x) >= 8:
        envs[0] = [min(x[0], x[1]), min(y[0], y[1]), max(x[0], x[1]), max(y[0], y[1])]
        mid = np.float32((envs[0, 1] + envs[0, 3]) / 2)
        x[2:5], y[2:5] = _ulps(envs[0, 2]), mid
        y[5:8], x[5:8] = _ulps(envs[0, 3]), np.float32((envs[0, 0] + envs[0, 2]) / 2)
    return envs


def check_join_ops(dev):
    """The join slice's torch ops (no TPU kernel behind them) on the card
    against the same functions on CPU tensors, bit for bit, at n in {0, 1,
    1000, 2^20+17}: the pair pack of window_pairs_query (ops/window.py
    pairs_pack and group_words) over 1, 64, 65 and 263 windows widened one
    float32 ulp, rows on window edges and one ulp around them, with and
    without a row gate, at the index's cap and at a cap of 16 (a forced
    overflow: the group's count passes the cap); the join refinement's
    expand-and-refine passes (ops/join.py count_pairs, compact_pairs) over
    run batches of point and envelope planes, interior runs and a gate;
    and the BIN compaction (ops/binpack.py bin_count, bin_pack) of 4 and 6
    lanes under random, empty and full masks."""
    import torch

    from geomesa_tpu_torch.ops import binpack
    from geomesa_tpu_torch.ops import join as jops
    from geomesa_tpu_torch.ops.window import group_words, pairs_pack, widen

    cpu = torch.device("cpu")
    cases = overflowed = 0
    for n in RAGGED:
        rng = np.random.default_rng(SEED + 7 + n)
        x = rng.uniform(9.0, 11.0, n).astype(np.float32)
        y = rng.uniform(9.0, 11.0, n).astype(np.float32)
        gate = rng.random(n) < 0.7
        for m in JOIN_WINDOW_COUNTS:
            envs = _join_case_windows(rng, x, y, m)
            groups = 1 << (-(-m // 64) - 1).bit_length()
            env = np.empty((64 * groups, 4), np.float32)
            env[:m] = widen(envs)
            env[m:] = [1.0, 1.0, 0.0, 0.0]
            # at the largest n, two of the four (gate, cap) cases: the CPU side is slow there
            combos = [(g, c) for g in (None, gate) for c in (max(4096, n // 32), 16)]
            for g, cap in combos if n <= 1000 else combos[::3]:
                out = []
                for d in (dev, cpu):
                    xt, yt = torch.from_numpy(x).to(d), torch.from_numpy(y).to(d)
                    gt = None if g is None else torch.from_numpy(g).to(d)
                    out.append([t.cpu() for t in pairs_pack(xt, yt, env, gt, cap)]
                               + [group_words(xt, yt, env[:64], gt).cpu()])
                if not all(torch.equal(a, b) for a, b in zip(*out)):
                    raise AssertionError(f"pairs_pack n={n} m={m} cap={cap} gated={g is not None}: "
                                         "the card != the CPU")
                overflowed += int((out[0][2] > cap).sum())
                cases += 1
        # the refinement: runs over the rows, against the windows
        xs, ys = x.astype(np.float64), y.astype(np.float64)
        planes = {2: (xs, ys), 4: (xs, ys, xs + rng.uniform(0, 0.3, n), ys + rng.uniform(0, 0.3, n))}
        envs = _join_case_windows(rng, x, y, 263).astype(np.float64)
        r = 0 if n == 0 else 400
        starts = rng.integers(0, max(n, 1), r)
        lens = np.minimum(rng.integers(0, max(n // 8, 2), r), n - starts)
        keep = lens > 0
        starts, lens = starts[keep], lens[keep]
        wins = rng.integers(0, 263, len(lens))
        interior = rng.random(len(lens)) < 0.1
        total = int(lens.sum())
        for k, pl in planes.items():
            for g in (None, gate):
                out = []
                for d in (dev, cpu):
                    up = lambda a, dt: torch.from_numpy(np.ascontiguousarray(a)).to(d, dt)  # noqa: E731
                    args = (tuple(up(p, torch.float64) for p in pl), up(starts, torch.int64),
                            up(lens, torch.int64), up(np.cumsum(lens), torch.int64),
                            up(wins, torch.int64), up(interior, torch.bool),
                            up(envs, torch.float64), total)
                    gt = None if g is None else up(g, torch.bool)
                    cnt = jops.count_pairs(*args, gt)
                    rr, ww = jops.compact_pairs(*args, gt)
                    out.append((cnt, rr.cpu(), ww.cpu()))
                (c1, r1, w1), (c2, r2, w2) = out
                if not (c1 == c2 == len(r1) and torch.equal(r1, r2) and torch.equal(w1, w2)):
                    raise AssertionError(f"join refine n={n} planes={k} gated={g is not None}: "
                                         "the card != the CPU")
                cases += 1
        # the BIN compaction
        for L in (4, 6):
            lanes = rng.integers(-(2**31), 2**31, (L, n)).astype(np.int32)
            for mask in (rng.random(n) < 0.3, np.zeros(n, bool), np.ones(n, bool)):
                out = []
                for d in (dev, cpu):
                    mt = torch.from_numpy(mask).to(d)
                    out.append((binpack.bin_count(mt), binpack.bin_pack(mt, torch.from_numpy(lanes).to(d))))
                if out[0][0] != out[1][0] or not np.array_equal(out[0][1], out[1][1]):
                    raise AssertionError(f"bin pack n={n} lanes={L}: the card != the CPU")
                cases += 1
    if not overflowed:
        raise AssertionError("the pair pack's forced overflow never passed its cap")
    torch.cuda.synchronize()
    log(f"join torch ops: {cases} pair-pack, refinement and BIN-compaction cases ({overflowed} "
        f"groups over their cap), the card == the CPU bit for bit")


# -- phase 3: the main path ---------------------------------------------------


def make_columns(n: int, seed: int, centers: "np.ndarray | None" = None) -> dict:
    """GDELT-shaped rows: 90% of points in 64 city clusters (sigma 0.2
    degrees), the rest uniform; float32 coordinates; dtg over 60 days.
    ``centers`` (64, 2) puts the clusters on given city centres."""
    rng = np.random.default_rng(seed)
    cx = rng.uniform(-170.0, 170.0, 64)
    cy = rng.uniform(-60.0, 70.0, 64)
    if centers is not None:
        cx, cy = centers[:, 0], centers[:, 1]
    cid = rng.integers(0, 64, n)
    x = cx[cid] + rng.normal(0.0, 0.2, n)
    y = cy[cid] + rng.normal(0.0, 0.2, n)
    uni = rng.random(n) >= 0.9
    x[uni] = rng.uniform(-180.0, 180.0, int(uni.sum()))
    y[uni] = rng.uniform(-90.0, 90.0, int(uni.sum()))
    xy = np.empty((n, 2), np.float64)
    xy[:, 0] = np.clip(x, -180.0, 180.0).astype(np.float32)
    xy[:, 1] = np.clip(y, -90.0, 90.0).astype(np.float32)
    return {
        "count": rng.integers(0, 1000, n).astype(np.int32),
        "dtg": rng.integers(T0, T0 + 60 * DAY, n),
        "geom": xy,
        "_centers": np.stack([cx, cy], axis=1),
    }


def _day(d: float) -> str:
    ms = T0 + int(d * DAY)
    return str(np.datetime64(ms, "ms")) + "Z"


REGIONS = [
    ("europe", (-10, 35, 30, 60)),
    ("north_america", (-130, 20, -60, 55)),
    ("south_america", (-82, -56, -34, 13)),
    ("africa", (-18, -35, 52, 38)),
    ("asia", (60, 5, 150, 55)),
    ("oceania", (110, -48, 180, -10)),
    ("france", (-5, 42, 8, 51)),
    ("japan", (129, 31, 146, 46)),
    ("india", (68, 6, 97, 36)),
    ("usa", (-125, 24, -66, 49)),
    ("brazil", (-74, -34, -34, 5)),
    ("world", (-180, -90, 180, 90)),
]
WINDOWS = [(9, 14), (0, 1), (3.25, 5.5), (6, 13), (20, 34), (27, 55), (40, 41),
           (13.5, 14.5), (1, 29), (50, 59.99)]


def main_queries(centers: np.ndarray) -> list:
    """32 bbox+during filters, city to continent boxes, 1-day to 4-week
    windows; the first is the bench's Europe 5-day query."""
    qs = []
    for i, (_, box) in enumerate(REGIONS):
        w = WINDOWS[i % len(WINDOWS)]
        qs.append((box, w))
    for i in range(20):  # city boxes around cluster centres
        cx, cy = centers[i]
        h = (0.1, 0.25, 0.5, 1.0)[i % 4]
        box = (round(cx - h, 3), round(cy - h, 3), round(cx + h, 3), round(cy + h, 3))
        qs.append((box, WINDOWS[(i + 3) % len(WINDOWS)]))
    return [
        (f"BBOX(geom, {b[0]}, {b[1]}, {b[2]}, {b[3]}) AND "
         f"dtg DURING {_day(w[0])}/{_day(w[1])}", b, w)
        for b, w in qs
    ]


def window_ms(w) -> tuple:
    """A window in days from T0 as the (start, end) ms its DURING gives."""
    return T0 + int(w[0] * DAY), T0 + int(w[1] * DAY)


def pct(v, p):
    return float(np.percentile(np.asarray(v) * 1e3, p))


def read_launches(tag: str, calls: dict) -> dict:
    """The launch counts since the last reset_counts(), held against the
    calls the drive made (every other kernel: 0); device_fn must serve
    nothing."""
    from geomesa_tpu_torch import kernels

    launches = dict(kernels.LAUNCHES)
    fallbacks = dict(kernels.DEVICE_FN_CALLS)
    want = {k: calls.get(k, 0) for k in kernels.KERNEL_NAMES}
    log(f"{tag} launches:", json.dumps(launches), "device_fn calls:", json.dumps(fallbacks))
    if launches != want:
        raise AssertionError(f"{tag}: launch counts {launches} != the calls made {want}")
    if any(fallbacks.values()):
        raise AssertionError(f"{tag}: device_fn served scans: {fallbacks}")
    return launches


def run_main_path(dev, cols):
    """Stage both indexes, then run every query through the public entry
    points; return timings and the state the checks need."""
    import torch

    from geomesa_tpu_torch import kernels
    from geomesa_tpu_torch.curves.z3 import Z3SFC
    from geomesa_tpu_torch.device_cache import Z_BT, Z_NX, Z_NY, DeviceIndex
    from geomesa_tpu_torch.features.batch import FeatureBatch
    from geomesa_tpu_torch.features.sft import SimpleFeatureType
    from geomesa_tpu_torch.ops import zscan
    from geomesa_tpu_torch.store.direct import BatchStore

    n = len(cols["count"])
    t = time.time()
    sft3 = SimpleFeatureType.create("gdelt", GDELT_SPEC)
    b3 = FeatureBatch.from_columns(sft3, {k: cols[k] for k in ("count", "dtg", "geom")})
    di3 = DeviceIndex(BatchStore(b3), "gdelt", z_planes=True, device=dev)
    torch.cuda.synchronize()
    stage3 = time.time() - t
    if not (di3._z_kind == "z3" and Z_BT in di3._cols):
        raise AssertionError("the Z3 index is not in dim-plane mode")
    t = time.time()
    sft2 = SimpleFeatureType.create("points", Z2_SPEC)
    b2 = FeatureBatch.from_columns(sft2, {k: cols[k] for k in ("count", "geom")})
    di2 = DeviceIndex(BatchStore(b2), "points", z_planes=True, device=dev)
    torch.cuda.synchronize()
    stage2 = time.time() - t
    if not (di2._z_kind == "z2" and Z_NX in di2._cols and Z_NY in di2._cols):
        raise AssertionError("the Z2 index is not in dim-plane mode")
    log(f"staged {n:,} rows: z3 {stage3:.2f} s ({di3.nbytes / 1e9:.3f} GB resident), "
        f"z2 {stage2:.2f} s ({di2.nbytes / 1e9:.3f} GB resident)")

    queries = main_queries(cols["_centers"])
    z2_queries = [f"BBOX(geom, {b[0]}, {b[1]}, {b[2]}, {b[3]})" for _, b, _ in queries[:8]]
    lat = {k: [] for k in ("count_loose", "count_exact", "query_exact", "query_loose")}
    res3, res2 = [], []
    planes3 = (di3._cols[Z_NX], di3._cols[Z_NY], di3._cols[Z_BT])
    sfc3 = Z3SFC()
    kernels.reset_counts()
    for ecql, box, w in queries:
        out = {}
        for key, fn in (
            ("count_loose", lambda: di3.count(ecql, loose=True)),
            ("count_exact", lambda: di3.count(ecql, loose=False)),
            ("query_exact", lambda: di3.query(ecql)),
            ("query_loose", lambda: di3.query(ecql, loose=True)),
        ):
            t = time.perf_counter()
            out[key] = fn()
            lat[key].append(time.perf_counter() - t)
        res3.append(out)
        # the baked dim scan (the cross-check engine) on the same window
        # against the runtime kernel's answer
        qnx, qny, ranges = zscan.z3_dim_plane_query(sfc3, *box, *window_ms(w), di3._bt_base)
        count_fn, mask_fn = zscan.build_z3_dimscan_pallas(qnx, qny, ranges)
        if int(count_fn(*planes3)) != out["count_loose"] or not np.array_equal(
                np.flatnonzero(mask_fn(*planes3).cpu().numpy()), np.sort(out["query_loose"].fids)):
            raise AssertionError(f"{ecql}: the baked dim scan != the runtime dim scan")
    for ecql in z2_queries:
        res2.append({
            "count_loose": di2.count(ecql, loose=True),
            "count_exact": di2.count(ecql, loose=False),
            "query_exact": di2.query(ecql),
            "query_loose": di2.query(ecql, loose=True),
        })
    q3, q2 = len(queries), len(z2_queries)
    launches = read_launches("main path (count/query)", {
        "dimscan_z3_count": q3, "dimscan_z3_mask": q3,
        "dimscan_baked_count": q3, "dimscan_baked_mask": q3,
        "dimscan_z2_count": q2, "dimscan_z2_mask": q2,
        "filter_scan_count": q3 + q2, "filter_scan_mask": q3 + q2,
    })
    for key, v in lat.items():
        log(f"latency z3 {key}: p50 {pct(v, 50):.3f} ms  p99 {pct(v, 99):.3f} ms  "
            f"({n / np.median(v) / 1e9:.2f} G rows/s at p50) [{CARD}]")
    return di3, di2, queries, z2_queries, res3, res2, launches


def np_exact(x, y, dtg, b, w=None):
    """numpy bbox(+during) over float32 rows: bounds rounded to float32 as
    the filter compiles them."""
    m = (x >= np.float32(b[0])) & (x <= np.float32(b[2]))
    m &= (y >= np.float32(b[1])) & (y <= np.float32(b[3]))
    if w is not None:
        m &= (dtg >= T0 + int(w[0] * DAY)) & (dtg <= T0 + int(w[1] * DAY))
    return m


def np_loose(q, planes):
    """numpy dim scan over host dim planes (nx, ny[, bt])."""
    m = (planes[0] >= q[0]) & (planes[0] <= q[1]) & (planes[1] >= q[2]) & (planes[1] <= q[3])
    if len(planes) == 3:
        tm = np.zeros(len(m), bool)
        for k in range((len(q) - 4) // 2):
            tm |= (planes[2] >= q[4 + 2 * k]) & (planes[2] <= q[5 + 2 * k])
        m &= tm
    return m


def _spans(n: int, parts: int = 8) -> list:
    """[a, b) row ranges splitting n rows into ``parts`` (one when empty)."""
    step = max(-(-n // parts), 1)
    return [(a, min(a + step, n)) for a in range(0, n, step)] or [(0, 0)]


def host_z3_planes(cols, base=None):
    """(nx, ny, bt) uint32 dim planes from the host quantizer, the bt words
    packed around ``base`` (default: the rows' least bin). Elementwise, so
    it runs on 8 threads over row ranges and gives the same words."""
    from geomesa_tpu_torch.curves.binnedtime import to_binned_time
    from geomesa_tpu_torch.curves.z3 import Z3SFC
    from geomesa_tpu_torch.ops import zscan

    s3 = Z3SFC()
    spans = _spans(len(cols["dtg"]))
    with ThreadPoolExecutor(max_workers=8) as pool:
        binned = list(pool.map(lambda sp: to_binned_time(cols["dtg"][sp[0]:sp[1]], s3.period), spans))
        lo = int(min(b.min() for b, _ in binned if len(b))) if base is None else int(base)

        def planes(i):
            (a, b), (bins, off) = spans[i], binned[i]
            rel = (bins - lo).astype(np.uint32)
            hx = s3.lon.normalize(cols["geom"][a:b, 0]).astype(np.uint32)
            hy = s3.lat.normalize(cols["geom"][a:b, 1]).astype(np.uint32)
            hbt = (rel << np.uint32(21)) | s3.time.normalize(off).astype(np.uint32)
            hbt[rel >= zscan.BT_BIN_SPAN - 1] = 0xFFFFFFFF
            return hx, hy, hbt

        parts = list(pool.map(planes, range(len(spans))))
    return tuple(np.concatenate([p[k] for p in parts]) for k in range(3))


def check_main_path(cols, di3, di2, queries, z2_queries, res3, res2):
    """Every main-path answer against numpy over the same float32 rows.
    Returns the host dim planes (z3, z2) for the later checks."""
    from geomesa_tpu_torch.curves.z2 import Z2SFC
    from geomesa_tpu_torch.device_cache import Z_BT, Z_NX, Z_NY
    from geomesa_tpu_torch.filter.ecql import parse_ecql

    t = time.time()
    x = cols["geom"][:, 0].astype(np.float32)
    y = cols["geom"][:, 1].astype(np.float32)
    dtg = cols["dtg"]
    # host dim planes from the host quantizer, held against the staged ones
    hx, hy, hbt = host_z3_planes(cols)
    s2 = Z2SFC()
    for name, h in ((Z_NX, hx), (Z_NY, hy), (Z_BT, hbt)):
        if not np.array_equal(di3._cols[name].cpu().numpy(), h):
            raise AssertionError(f"staged z3 plane {name} != the host quantizer")
    h2x = s2.lon.normalize(cols["geom"][:, 0]).astype(np.uint32)
    h2y = s2.lat.normalize(cols["geom"][:, 1]).astype(np.uint32)
    for name, h in ((Z_NX, h2x), (Z_NY, h2y)):
        if not np.array_equal(di2._cols[name].cpu().numpy(), h):
            raise AssertionError(f"staged z2 plane {name} != the host quantizer")

    def exact(b, w=None):
        return np_exact(x, y, dtg, b, w)

    def verify(di, ecql, b, w, out, planes, tag):
        em = exact(b, w)
        n_exact = int(em.sum())
        if out["count_exact"] != n_exact:
            raise AssertionError(f"{tag} {ecql}: exact count {out['count_exact']} != numpy {n_exact}")
        if not np.array_equal(np.sort(out["query_exact"].fids), np.nonzero(em)[0]):
            raise AssertionError(f"{tag} {ecql}: query fid set != numpy")
        lb = di._loose_bounds(parse_ecql(ecql))
        if lb is None:
            raise AssertionError(f"{tag} {ecql}: the key planes could not answer")
        lm = np_loose(lb[1], planes)
        if out["count_loose"] != int(lm.sum()) or out["count_loose"] < n_exact:
            raise AssertionError(
                f"{tag} {ecql}: loose count {out['count_loose']} vs numpy {int(lm.sum())}, "
                f"exact {n_exact}"
            )
        if not np.array_equal(np.sort(out["query_loose"].fids), np.nonzero(lm)[0]):
            raise AssertionError(f"{tag} {ecql}: loose fid set != numpy")
        if np.any(em & ~lm):
            raise AssertionError(f"{tag} {ecql}: loose is not a superset of exact")
        return n_exact, int(lm.sum())

    # one query per thread: numpy's elementwise passes release the GIL,
    # so the host's cores share the 40 full-size checks
    with ThreadPoolExecutor(max_workers=8) as pool:
        hits = list(pool.map(
            lambda a: verify(di3, *a, (hx, hy, hbt), "z3"),
            [(ecql, b, w, out) for (ecql, b, w), out in zip(queries, res3)],
        ))
        list(pool.map(
            lambda a: verify(di2, *a, (h2x, h2y), "z2"),
            [(ecql, b, None, out) for ecql, (_, b, _), out
             in zip(z2_queries, queries[: len(z2_queries)], res2)],
        ))
    ex = [h[0] for h in hits]
    lo = [h[1] for h in hits]
    log(f"checked {len(queries)} z3 + {len(z2_queries)} z2 queries against numpy in "
        f"{time.time() - t:.1f} s; z3 exact hits min/median/max "
        f"{min(ex)}/{int(np.median(ex))}/{max(ex)}, loose/exact overscan median "
        f"{np.median([l / max(e, 1) for e, l in zip(ex, lo)]):.3f}")
    return (hx, hy, hbt), (h2x, h2y)


# -- phase 3: density and stats on the same indexes ---------------------------

WORLD = (-180.0, -90.0, 180.0, 90.0)
EUROPE = (-10.0, 35.0, 30.0, 60.0)
STATS_SPEC = 'Count();MinMax("count");MinMax("dtg");Histogram("count",20,0,1000)'


def _bbox(b) -> str:
    return f"BBOX(geom, {b[0]}, {b[1]}, {b[2]}, {b[3]})"


def density_calls(queries) -> list:
    """(tag, index, filter, loose, envelope, (width, height), weight, box,
    window): the density drive; ``box``/``window`` give the exact rows
    (None: all rows), loose calls take their rows from the dim planes."""
    europe, eb, ew = queries[0]  # the bench's Europe 5-day query
    city, cb, cw = queries[12]
    na = REGIONS[1][1]
    return [
        ("world include", "z3", "INCLUDE", None, WORLD, (512, 256), None, None, None),
        ("world overview", "z3", "INCLUDE", None, WORLD, (128, 128), None, None, None),
        ("europe exact", "z3", europe, False, EUROPE, (256, 256), None, eb, ew),
        ("europe loose", "z3", europe, True, EUROPE, (256, 256), None, eb, ew),
        ("europe weighted", "z3", europe, False, EUROPE, (256, 256), "count", eb, ew),
        ("city", "z3", city, False, cb, (512, 512), None, cb, cw),
        ("north america", "z3", _bbox(na), False, na, (1024, 1024), None, na, None),
        ("world days 20-34 loose weighted", "z3", f"dtg DURING {_day(20)}/{_day(34)}",
         True, WORLD, (2048, 1024), "count", WORLD, (20, 34)),
        ("europe z2", "z2", _bbox(EUROPE), False, EUROPE, (256, 256), None, EUROPE, None),
    ]


def stats_calls(queries) -> list:
    """(tag, filter, loose, box, window, min count exclusive)."""
    europe, eb, ew = queries[0]
    asia = REGIONS[4][1]
    return [
        ("include", "INCLUDE", None, None, None, None),
        ("europe exact", europe, False, eb, ew, None),
        ("europe loose", europe, True, eb, ew, None),
        ("asia count>500", f"count > 500 AND {_bbox(asia)}", False, asia, None, 500),
    ]


def run_density_path(di3, di2, queries):
    """Every density and stats call through the public entry points, with
    the launch counts of the drive."""
    from geomesa_tpu_torch import kernels
    from geomesa_tpu_torch.geom import Envelope

    dcalls, scalls = density_calls(queries), stats_calls(queries)
    kernels.reset_counts()
    grids, lat = [], []
    for _, idx, ecql, loose, env, (w, h), weight, _, _ in dcalls:
        di = di3 if idx == "z3" else di2
        t = time.perf_counter()
        grids.append(di.density(ecql, Envelope(*env), w, h, weight_attr=weight, loose=loose))
        lat.append(time.perf_counter() - t)
    seqs = [di3.stats(ecql, STATS_SPEC, loose=loose).to_json()
            for _, ecql, loose, _, _, _ in scalls]
    launches = read_launches("main path (density/stats)", {
        "density_count": 7, "density_weighted": 2,
        "filter_scan_mask": 5 + 2, "dimscan_z3_mask": 2 + 1,
    })
    log(f"latency density ({len(lat)} calls, 2^{int(np.log2(len(di3)))} rows): "
        f"p50 {pct(lat, 50):.3f} ms  p99 {pct(lat, 99):.3f} ms; per call "
        + ", ".join(f"{c[0]} {v * 1e3:.2f}" for c, v in zip(dcalls, lat)) + f" [{CARD}]")
    return dcalls, grids, scalls, seqs, launches


def np_density(x, y, sel, env, wh, weights=None) -> np.ndarray:
    """numpy density over float32 rows: float64 pixel math, then
    np.bincount (float64 sums for weights), on 8 threads over row ranges
    whose grids add up (counts exactly; weighted sums in another order,
    which the weighted comparison's tolerance covers)."""
    w, h = wh
    idx = None if sel is None else np.nonzero(sel)[0]
    xmin, ymin, xmax, ymax = (float(v) for v in env)
    sx, sy = w / (xmax - xmin), h / (ymax - ymin)

    def part(span):
        rows = slice(*span) if idx is None else idx[span[0]:span[1]]
        xs, ys = x[rows].astype(np.float64), y[rows].astype(np.float64)
        inside = (xs >= xmin) & (xs <= xmax) & (ys >= ymin) & (ys <= ymax)
        px = np.clip(np.floor((xs - xmin) * sx), 0, w - 1).astype(np.int64)
        py = np.clip(np.floor((ys - ymin) * sy), 0, h - 1).astype(np.int64)
        wt = None if weights is None else weights[rows].astype(np.float32).astype(np.float64)[inside]
        return np.bincount((py * w + px)[inside], weights=wt, minlength=w * h)

    with ThreadPoolExecutor(max_workers=8) as pool:
        grids = list(pool.map(part, _spans(len(x) if idx is None else len(idx))))
    return np.sum(grids, axis=0).reshape(h, w).astype(np.float32)


def same_grid(got, want, weighted) -> bool:
    if got is None or got.shape != want.shape or got.dtype != np.float32:
        return False
    if not weighted:
        return np.array_equal(got, want)
    g, w = got.astype(np.float64), want.astype(np.float64)
    return bool(np.all(np.abs(g - w) <= 1e-6 * np.abs(w)))


def np_stats(cols, sel) -> list:
    """The to_json() of STATS_SPEC over the selected rows, from numpy."""
    c = cols["count"] if sel is None else cols["count"][sel]
    d = cols["dtg"] if sel is None else cols["dtg"][sel]
    n = len(c)
    bins = np.clip(np.floor((c.astype(np.float64) - 0.0) * (20 / (1000.0 - 0.0))), 0, 19)
    mm = lambda a, v: {"type": "minmax", "attr": a, "min": int(v.min()) if n else None,  # noqa: E731
                       "max": int(v.max()) if n else None, "count": n}
    return [
        {"type": "count", "count": n}, mm("count", c), mm("dtg", d),
        {"type": "histogram", "attr": "count", "bins": 20, "lo": 0.0, "hi": 1000.0,
         "counts": np.bincount(bins.astype(np.int64), minlength=20).tolist()},
    ]


def check_density_path(cols, di3, di2, planes3, planes2, dcalls, grids, scalls, seqs):
    """Every grid and stat against numpy over the same float32 rows."""
    from geomesa_tpu_torch.filter.ecql import parse_ecql

    t = time.time()
    x = cols["geom"][:, 0].astype(np.float32)
    y = cols["geom"][:, 1].astype(np.float32)
    dtg = cols["dtg"]

    def rows(di, planes, ecql, loose, box, window):
        if box is None:
            return None
        if loose:
            return np_loose(di._loose_bounds(parse_ecql(ecql))[1], planes)
        return np_exact(x, y, dtg, box, window)

    for (tag, idx, ecql, loose, env, wh, weight, box, window), got in zip(dcalls, grids):
        di, planes = (di3, planes3) if idx == "z3" else (di2, planes2)
        sel = rows(di, planes, ecql, loose, box, window)
        want = np_density(x, y, sel, env, wh, cols["count"] if weight else None)
        if not same_grid(got, want, weight is not None):
            raise AssertionError(f"density {tag}: grid != numpy")
        if not weight and want.sum() == 0:
            raise AssertionError(f"density {tag}: an empty grid checks nothing")
    for (tag, ecql, loose, box, window, cmin), got in zip(scalls, seqs):
        sel = rows(di3, planes3, ecql, loose, box, window)
        if cmin is not None:
            sel &= cols["count"] > cmin
        if got != np_stats(cols, sel):
            raise AssertionError(f"stats {tag}: {got} != numpy {np_stats(cols, sel)}")
    log(f"checked {len(dcalls)} density grids and {len(scalls)} stats against numpy "
        f"in {time.time() - t:.1f} s")


# -- phase 3c: the interleaved key layout --------------------------------------

WIDE_T0 = 1_424_217_600_000  # 2015-02-18T00:00:00Z
WIDE_T1 = 1_735_689_600_000  # 2025-01-01T00:00:00Z, exclusive
WIDE_SPEC = GDELT_SPEC + ";geomesa.z3.interval=day"
WIDE_SAMPLE = 1 << 23  # rows of the host-encoded subsample
WIDE_ROWS = 1 << 25  # the wide span's rows: phase 3's first half, in day bins (a cut, PERF.md section 4)


def _iso(ms: int) -> str:
    return str(np.datetime64(int(ms), "ms")) + "Z"


def wide_queries(centers: np.ndarray) -> list:
    """(ecql, box, (t0, t1) ms) over the day-binned data: windows of 1 day
    to 8 weeks (2 to 57 bins: the interleaved scan), then 70 and 180 days
    (past 64 bins: the filter scan). The short windows take boxes around
    cluster centres, so that the subsample holds hits."""
    spans = [(100.25, 1), (731, 3), (1200, 7), (1800.5, 14), (2500, 28), (3000, 56),
             (3300, 70), (1000, 180)]
    city = [tuple(round(float(v), 3) for v in (c[0] - h, c[1] - h, c[0] + h, c[1] + h))
            for c, h in ((centers[0], 1.0), (centers[1], 2.0))]
    boxes = city + [REGIONS[i][1] for i in (1, 4, 11, 3, 0, 2)]
    out = []
    for (d0, days), b in zip(spans, boxes):
        t0, t1 = WIDE_T0 + int(d0 * DAY), WIDE_T0 + int((d0 + days) * DAY)
        out.append((f"{_bbox(b)} AND dtg DURING {_iso(t0)}/{_iso(t1)}", b, (t0, t1)))
    return out


def np_zscan(bins, z, bounds, ids) -> np.ndarray:
    """numpy masked compare over host-encoded uint64 keys: any entry with
    id >= 0 and id == bin whose dims all hold lo <= (z & mask) <= hi."""
    u = np.uint64
    m = np.zeros(len(z), bool)
    for e, bid in zip(bounds, ids):
        if bid < 0:
            continue
        hit = bins == bid
        for w in e.astype(np.uint64):
            zm = z & ((w[0] << u(32)) | w[1])
            hit &= (zm >= ((w[2] << u(32)) | w[3])) & (zm <= ((w[4] << u(32)) | w[5]))
        m |= hit
    return m


def _staged_keys_match(di, idx, z, bins=None) -> None:
    """The interleaved planes at rows ``idx`` against host-encoded keys."""
    import torch

    from geomesa_tpu_torch.curves.zorder import u64_hi_lo
    from geomesa_tpu_torch.device_cache import Z_BIN, Z_HI, Z_LO

    hi, lo = u64_hi_lo(z)
    ti = torch.from_numpy(idx).to(di.device)
    for name, want in ((Z_HI, hi), (Z_LO, lo), (Z_BIN, bins)):
        if want is None:
            continue
        # gather through an int32 view: CUDA has no uint32 indexing
        got = di._cols[name].view(torch.int32)[ti].cpu().numpy().view(want.dtype)
        if not np.array_equal(got, want):
            raise AssertionError(f"staged {name} != the host encode")


def _stage(dev, store, type_name, **kw):
    import torch

    from geomesa_tpu_torch.device_cache import Z_HI, DeviceIndex

    t = time.time()
    di = DeviceIndex(store, type_name, z_planes=True, device=dev, **kw)
    torch.cuda.synchronize()
    if di._dim_mode or Z_HI not in di._cols:
        raise AssertionError(f"{type_name}: not in the interleaved layout")
    return di, time.time() - t


def run_interleaved_path(dev, cols, di3, di2, queries, z2_queries, res3, res2, planes2,
                         dcalls, grids, scalls, seqs) -> dict:
    """Stage the interleaved Z3 and Z2 indexes over the main path's rows and
    a day-binned index over 2015-2024; drive them through the entry points
    (three drives, each with its launch counts) and check every answer."""
    from geomesa_tpu_torch import kernels
    from geomesa_tpu_torch.curves.binnedtime import TimePeriod, to_binned_time
    from geomesa_tpu_torch.curves.z2 import Z2SFC
    from geomesa_tpu_torch.curves.z3 import Z3SFC
    from geomesa_tpu_torch.features.batch import FeatureBatch
    from geomesa_tpu_torch.features.sft import SimpleFeatureType
    from geomesa_tpu_torch.filter.ecql import parse_ecql
    from geomesa_tpu_torch.geom import Envelope
    from geomesa_tpu_torch.store.direct import BatchStore

    n = len(cols["count"])
    x = cols["geom"][:, 0].astype(np.float32)
    y = cols["geom"][:, 1].astype(np.float32)
    idx = np.sort(np.random.default_rng(SEED + 5).choice(n, WIDE_SAMPLE, replace=False))
    xs, ys = cols["geom"][idx, 0], cols["geom"][idx, 1]
    totals = {k: 0 for k in kernels.KERNEL_NAMES}

    def add(launches):
        for k, v in launches.items():
            totals[k] += v

    # 1. interleaved Z3 on the week-binned main-path rows
    di3i, st3 = _stage(dev, di3.store, "gdelt", dim_planes=False)
    bins_s, off_s = to_binned_time(cols["dtg"][idx], TimePeriod.WEEK)
    _staged_keys_match(di3i, idx, Z3SFC().index(xs, ys, off_s), bins_s.astype(np.int32))
    kernels.reset_counts()
    got3, lat = [], []
    for ecql, _, _ in queries:
        t = time.perf_counter()
        c = di3i.count(ecql, loose=True)
        lat.append(time.perf_counter() - t)
        got3.append((c, di3i.mask(ecql, loose=True), di3i.query(ecql, loose=True).fids))
    dens = [di3i.density(dcalls[i][2], Envelope(*dcalls[i][4]), *dcalls[i][5],
                         weight_attr=dcalls[i][6], loose=True) for i in (3, 7)]
    seq = di3i.stats(scalls[2][1], STATS_SPEC, loose=True).to_json()
    q3 = len(queries)
    add(read_launches("interleaved z3", {
        "zscan_z3_count": q3, "zscan_z3_mask": 2 * q3 + 3,
        "density_count": 1, "density_weighted": 1,
    }))
    for (ecql, _, _), (c, m, fids), want in zip(queries, got3, res3):
        loose = np.sort(want["query_loose"].fids)
        if c != want["count_loose"] or not np.array_equal(np.flatnonzero(m), loose) \
                or not np.array_equal(np.sort(fids), loose):
            raise AssertionError(f"interleaved z3 {ecql}: loose answer != the dim-plane index's")
    if not (same_grid(dens[0], grids[3], False) and same_grid(dens[1], grids[7], True)):
        raise AssertionError("interleaved z3: loose density != the dim-plane index's")
    if seq != seqs[2]:
        raise AssertionError(f"interleaved z3: loose stats {seq} != {seqs[2]}")
    log(f"phase 3c: interleaved z3 staged in {st3:.2f} s ({di3i.nbytes / 1e9:.3f} GB resident); "
        f"{q3} loose counts, masks and fid sets, 2 loose density grids and a loose stats call "
        f"equal to the dim-plane index's; count(loose=True) p50 {pct(lat, 50):.3f} ms "
        f"p99 {pct(lat, 99):.3f} ms [{CARD}]")

    # 2. interleaved Z2 on the date-less sibling
    di2i, st2 = _stage(dev, di2.store, "points", dim_planes=False)
    _staged_keys_match(di2i, idx, Z2SFC().index(xs, ys))
    kernels.reset_counts()
    got2 = [(di2i.count(ecql, loose=True), di2i.mask(ecql, loose=True),
             di2i.query(ecql, loose=True).fids) for ecql in z2_queries]
    g2 = di2i.density(_bbox(EUROPE), Envelope(*EUROPE), 256, 256, loose=True)
    q2 = len(z2_queries)
    add(read_launches("interleaved z2", {
        "zscan_z2_count": q2, "zscan_z2_mask": 2 * q2 + 1, "density_count": 1,
    }))
    for ecql, (c, m, fids), want in zip(z2_queries, got2, res2):
        loose = np.sort(want["query_loose"].fids)
        if c != want["count_loose"] or not np.array_equal(np.flatnonzero(m), loose) \
                or not np.array_equal(np.sort(fids), loose):
            raise AssertionError(f"interleaved z2 {ecql}: loose answer != the dim-plane index's")
    sel = np_loose(di2._loose_bounds(parse_ecql(_bbox(EUROPE)))[1], planes2)
    if not same_grid(g2, np_density(x, y, sel, EUROPE, (256, 256)), False):
        raise AssertionError("interleaved z2: loose density != numpy")
    log(f"phase 3c: interleaved z2 staged in {st2:.2f} s ({di2i.nbytes / 1e9:.3f} GB resident); "
        f"{q2} loose counts, masks and fid sets equal to the dim-plane index's, "
        f"a loose density grid equal to numpy")

    # 3. day bins over ten years: the staging falls back by itself
    t = time.time()
    nw = min(n, WIDE_ROWS)
    iw = idx[idx < nw]  # the subsample's rows among them
    dtg_w = np.random.default_rng(SEED + 6).integers(WIDE_T0, WIDE_T1, nw)
    sftw = SimpleFeatureType.create("gdelt_wide", WIDE_SPEC)
    bw = FeatureBatch.from_columns(sftw, {"count": cols["count"][:nw], "dtg": dtg_w,
                                          "geom": cols["geom"][:nw]})
    diw, stw = _stage(dev, BatchStore(bw), "gdelt_wide")
    span = diw._bin_range[1] - diw._bin_range[0] + 1
    if span <= 2047:
        raise AssertionError(f"the wide index spans only {span} bins")
    bins_s, off_s = to_binned_time(dtg_w[iw], TimePeriod.DAY)
    z_s = Z3SFC(TimePeriod.DAY).index(cols["geom"][iw, 0], cols["geom"][iw, 1], off_s)
    _staged_keys_match(diw, iw, z_s, bins_s.astype(np.int32))
    wq = wide_queries(cols["_centers"])
    lbs = [diw._loose_bounds(parse_ecql(ecql)) for ecql, _, _ in wq]
    wide_bins = [None if lb is None else int((lb[2] >= 0).sum()) for lb in lbs]
    kernels.reset_counts()
    gotw = [(diw.count(ecql, loose=True), diw.count(ecql), diw.mask(ecql, loose=True))
            for ecql, _, _ in wq]
    short = sum(b is not None for b in wide_bins)
    add(read_launches("wide span", {
        "zscan_z3_count": short, "zscan_z3_mask": short,
        "filter_scan_count": len(wq) + (len(wq) - short), "filter_scan_mask": len(wq) - short,
    }))
    if short == len(wq) or short == 0:
        raise AssertionError(f"wide span: bins per window {wide_bins} miss a route")
    xw, yw = x[:nw], y[:nw]

    def check(i):
        (ecql, b, (t0, t1)), lb, (c_loose, c_exact, m) = wq[i], lbs[i], gotw[i]
        em = (xw >= np.float32(b[0])) & (xw <= np.float32(b[2])) & (yw >= np.float32(b[1])) \
            & (yw <= np.float32(b[3])) & (dtg_w >= t0) & (dtg_w <= t1)
        if c_exact != int(em.sum()):
            raise AssertionError(f"wide {ecql}: exact count {c_exact} != numpy {int(em.sum())}")
        if lb is None:  # past 64 bins: the exact scan answers
            if c_loose != c_exact or not np.array_equal(m, em):
                raise AssertionError(f"wide {ecql}: loose past 64 bins != exact")
            return c_exact, c_loose, None
        lm = np_zscan(bins_s, z_s, lb[1], lb[2])
        if not np.array_equal(m[iw], lm) or c_loose != int(m.sum()) or np.any(em & ~m):
            raise AssertionError(f"wide {ecql}: loose mask != numpy over host keys")
        if not lm.any():
            raise AssertionError(f"wide {ecql}: the subsample holds no hit")
        return c_exact, c_loose, int(lm.sum())

    with ThreadPoolExecutor(max_workers=8) as pool:
        checked = list(pool.map(check, range(len(wq))))
    log(f"phase 3c: wide span ({nw:,} rows, {span} day bins) generated and staged in "
        f"{time.time() - t:.2f} s (staging {stw:.2f} s, {diw.nbytes / 1e9:.3f} GB resident); "
        f"bins per window {wide_bins} (None: past 64, the filter scan); exact/loose/subsample "
        f"hits {checked}; all equal to numpy")
    return {"di3i": di3i, "di2i": di2i, "diw": diw, "launches": totals, "wide": wq}


# -- phase 3i: the store path (BASELINE config #1) -----------------------------

STORE_ROWS = 1 << 25  # phase 3i's rows: phase 3's first half (a cut, PERF.md section 4)
STORE_RUN_ROWS = (1 << 20, 1 << 23)  # one partition; eight merged, the largest run
STORE_LABELED = 1 << 22  # phase 3b's labeled rows at 3b's size
STORE_AIS_VESSELS = 1 << 10  # 2^10 vessels x 4,096 fixes: 2^22 AIS reports (cut from 2^26)
SEVEN_SKETCHES = ('Count();MinMax("count");MinMax("dtg");Histogram("count",20,0,1000);'
                  'Cardinality("count");TopK("count",300);Frequency("count");Z3Histogram("geom","dtg")')


def _rss_gb() -> "tuple[float, float]":
    """(current, peak) resident set of this process in GB: /proc's VmRSS
    and getrusage's ru_maxrss (KiB on Linux)."""
    import resource

    rss = 0.0
    with open("/proc/self/status") as fh:
        for line in fh:
            if line.startswith("VmRSS:"):
                rss = int(line.split()[1]) * 1024 / 1e9
    return rss, resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e9


def check_store_device(ds) -> None:
    """The store a user gets from DataStoreFinder scans on the card."""
    from geomesa_tpu_torch.device import resolve_device

    if resolve_device(ds.device).type != "cuda":
        raise AssertionError("phase 3i: the store does not scan on the card")


def plan_runs(ds, type_name, plan) -> int:
    """The mask launches a memory-store plan makes: one per contiguous run
    of the partitions it keeps (none for a plan with no device
    predicate)."""
    from geomesa_tpu_torch.query.runner import _contiguous_runs

    built = ds._state(type_name).indices.get(plan.index_name)
    if built is None or not plan.compiled.device_cols:
        return 0
    return len(_contiguous_runs(built.prune(plan.ranges)))


class StoreRuns:
    """The mask launches the store path must make (``plan_runs``), counted
    from each answer's own plan."""

    def __init__(self, ds):
        self.ds, self.runs, self.scanned, self.lat = ds, 0, [], {}

    def of(self, type_name, res, times: int = 1) -> int:
        n = plan_runs(self.ds, type_name, res.plan)
        self.runs += times * n
        self.scanned.append((n, res.scanned))
        return n

    def timed(self, kind, fn):
        t = time.perf_counter()
        out = fn()
        self.lat.setdefault(kind, []).append(time.perf_counter() - t)
        return out


def _polygon_near(cx: float, cy: float) -> np.ndarray:
    """An irregular 7-vertex ring around a city centre, vertices on a
    1/64-degree grid (float32-exact)."""
    a = np.linspace(0.0, 2 * np.pi, 7, endpoint=False)
    r = np.array([0.30, 0.22, 0.35, 0.18, 0.28, 0.40, 0.25])
    ring = np.stack([cx + r * np.cos(a), cy + r * np.sin(a)], axis=1)
    ring = np.round(ring * 64) / 64
    return np.concatenate([ring, ring[:1]])


def np_pip_f32(x, y, ring) -> np.ndarray:
    """numpy of the filter scan's point-in-polygon over float32 planes: per
    edge the constants (y1, y2, x1, x2 - x1, y2 - y1 or 1) rounded to
    float32 once, then the even-odd crossing test in float32 operations in
    the kernel's order (a point on a vertex's horizontal, which the float64
    test may count otherwise, is decided as the card decides it)."""
    f32 = np.float32
    x1, y1, x2, y2 = ring[:-1, 0], ring[:-1, 1], ring[1:, 0], ring[1:, 1]
    ey1, ey2, ex1 = y1.astype(f32), y2.astype(f32), x1.astype(f32)
    dxe = (x2 - x1).astype(f32)
    den = np.where(y2 != y1, y2 - y1, 1.0).astype(f32)
    out = np.zeros(len(x), bool)
    for s in range(0, len(x), 1 << 18):
        px, py = x[s: s + (1 << 18), None], y[s: s + (1 << 18), None]
        straddle = (ey1 > py) != (ey2 > py)
        xint = ex1 + ((py - ey1) * dxe) / den
        out[s: s + (1 << 18)] = (straddle & (px < xint)).sum(axis=1) % 2 == 1
    return out


def _near_knn(tag, store_res, res_res, x64, y64, px, py) -> None:
    """The store path's kNN (float64 distances) against the resident one
    (the float32 formula): the same fids, except rows whose float64
    distance lies within 1e-6 relative of the k-th (float32 rounding can
    swap rows at the boundary)."""
    a, b = set(store_res[0].fids.tolist()), set(res_res[0].fids.tolist())
    if a == b:
        return
    d = store_res[1]
    kth = float(d[-1]) if len(d) else 0.0
    rows = np.array(sorted(a ^ b))
    dd = np.hypot((x64[rows] - px) * np.cos(np.radians(py)), y64[rows] - py)
    if len(a) != len(b) or not np.all(np.abs(dd - kth) <= 1e-6 * max(kth, 1e-12)):
        raise AssertionError(f"{tag}: store-path kNN != the resident kNN ({len(a ^ b)} rows differ)")
    log(f"{tag}: {len(a ^ b)} rows at the k-th distance swap between float64 and float32")


def run_store_path(dev, cols, di3, queries, res3) -> dict:
    """Phase 3i, BASELINE config #1 through the store: phase 3's first
    STORE_ROWS rows written into DataStoreFinder's memory store (flush: the
    z3, z2 and id index builds and the write-time stats), then phase 3's 32
    bbox+during queries through the feature source and store.query, an attribute-only
    full-table filter, an INTERSECTS polygon (the kernel's point-in-polygon
    on a point schema), an INTERSECTS line (the host residual behind the
    envelope prefilter), a Query with sort, max features and properties,
    explain, phase 3b's labeled rows under its auth sets, run_stats with
    the seven sketches, and a DeviceIndex staged from the store; every
    answer against numpy and phase 3's DeviceIndex, the launches against
    the runs each plan scanned. Then the store path of the AIS processes on
    2^22 reports against the resident answers."""
    import torch

    from geomesa_tpu_torch import kernels, ledger
    from geomesa_tpu_torch.api import DataStoreFinder
    from geomesa_tpu_torch.device_cache import DeviceIndex
    from geomesa_tpu_torch.features.batch import VIS_COLUMN, FeatureBatch
    from geomesa_tpu_torch.process.statsproc import run_stats
    from geomesa_tpu_torch.query.plan import Query
    from geomesa_tpu_torch.stats import parse_stat

    every, cols = cols, {k: v if k == "_centers" else v[:STORE_ROWS] for k, v in cols.items()}
    t = time.time()
    ds = DataStoreFinder.get_data_store({"memory": "true"})
    ds.create_schema("gdelt", GDELT_SPEC)
    ds.write("gdelt", {k: cols[k] for k in ("count", "dtg", "geom")})
    ds.stats("gdelt")  # the flush: three index builds and the stats
    flush_s = time.time() - t
    check_store_device(ds)
    st = ds._state("gdelt")
    rss, hwm = _rss_gb()
    log(f"phase 3i: wrote {len(st.data):,} rows and flushed (indexes {list(st.indices)}, "
        f"{len(st.indices['z3'].partitions)} partitions each) in {flush_s:.1f} s; host RSS "
        f"{rss:.1f} GB (peak {hwm:.1f} GB)")
    src = ds.get_feature_source("gdelt")
    x = cols["geom"][:, 0].astype(np.float32)
    y = cols["geom"][:, 1].astype(np.float32)
    dtg = cols["dtg"]
    runs = StoreRuns(ds)
    europe, eb, ew = queries[0]
    cx, cy = cols["_centers"][0]
    ring = _polygon_near(float(cx), float(cy))
    poly = "INTERSECTS(geom, POLYGON((" + ", ".join(f"{a} {b}" for a, b in ring) + ")))"
    # a line: no kernel test for a point against it, so the host residual
    # (the line's envelope, for points) runs behind the device's envelope
    # prefilter
    lpts = np.round((np.array([[-0.3, -0.2], [0.1, 0.25], [0.35, 0.05]]) + (cx, cy)) * 64) / 64
    line = "INTERSECTS(geom, LINESTRING(" + ", ".join(f"{a} {b}" for a, b in lpts) + "))"
    opts = Query(filter=europe, sort_by="count", sort_desc=True, max_features=1000,
                 properties=["count", "dtg"])
    kernels.reset_counts()
    out = []
    with ledger.collect_cost() as cost:
        for ecql, _, _ in queries:
            n = runs.timed("get_count", lambda: src.get_count(ecql))
            fids = runs.timed("get_features", lambda: src.get_features(ecql).batch.fids)
            res = runs.timed("query", lambda: ds.query("gdelt", ecql))
            runs.of("gdelt", res, times=3)
            out.append((n, fids, res))
        full = [runs.timed("full_table", lambda: ds.query("gdelt", "count > 500")) for _ in range(2)]
        for r in full:
            runs.of("gdelt", r)
        pres = [runs.timed("intersects", lambda: ds.query("gdelt", poly)) for _ in range(2)]
        for r in pres:
            runs.of("gdelt", r)
        lres = runs.timed("residual", lambda: ds.query("gdelt", line))
        runs.of("gdelt", lres)
        ores = runs.timed("options", lambda: ds.query("gdelt", opts))
        runs.of("gdelt", ores)
        seq = runs.timed("run_stats", lambda: run_stats(ds, "gdelt", Query(filter=europe), SEVEN_SKETCHES))
        # the stats query's scan and this one
        runs.of("gdelt", ds.query("gdelt", europe), times=2)
    torch.cuda.synchronize()
    fields = cost.snapshot_fields()
    launches = read_launches("store path (phase 3i)", {"filter_scan_mask": runs.runs})
    if fields.get("device_launches", 0) != runs.runs:
        raise AssertionError(f"phase 3i: the ledger charged {fields.get('device_launches')} launches, "
                             f"not the {runs.runs} runs")
    explains = [ds.explain("gdelt", q) for q in (europe, "count > 500", poly)]
    for q, text, want in zip((europe, "count > 500", poly), explains,
                             ("Chosen index: z3", "FULL SCAN", "Chosen index: z2")):
        if want not in text:
            raise AssertionError(f"phase 3i: explain({q[:40]}) lacks {want!r}")
        log("phase 3i explain: " + " | ".join(line.strip() for line in text.splitlines()[:5]))
    for kind, v in runs.lat.items():
        log(f"latency store {kind}: p50 {pct(v, 50):.3f} ms  p99 {pct(v, 99):.3f} ms ({len(v)} calls) [{CARD}]")
    log(f"phase 3i runs per query {[r for r, _ in runs.scanned[:32]]}; scanned rows per query "
        f"{[s for _, s in runs.scanned[:32]]}; full table {runs.scanned[32]}; ledger: stage "
        f"{fields.get('stage_seconds', 0):.3f} s, {int(fields.get('device_launches', 0))} launches, "
        f"device {fields.get('device_seconds', 0):.3f} s [{CARD}]")

    # -- checks: numpy over the float32 planes, phase 3's DeviceIndex -------------
    t = time.time()
    with ThreadPoolExecutor(max_workers=8) as pool:
        masks = list(pool.map(lambda q: np_exact(x, y, dtg, q[1], q[2]), queries))
    for (ecql, _, _), em, (n, fids, res), r3 in zip(queries, masks, out, res3):
        want = np.nonzero(em)[0]
        r3f = np.sort(r3["query_exact"].fids)
        r3f = r3f[r3f < len(x)]  # phase 3's DeviceIndex holds every row: its hits among these
        if not (n == len(want) == len(r3f) == len(res)):
            raise AssertionError(f"phase 3i {ecql}: counts {n}/{len(res)} != numpy {len(want)} / "
                                 f"the DeviceIndex {len(r3f)}")
        if not (np.array_equal(np.sort(fids), want) and np.array_equal(np.sort(res.batch.fids), want)
                and np.array_equal(r3f, want)):
            raise AssertionError(f"phase 3i {ecql}: fid sets != numpy / the DeviceIndex")
    big = cols["count"] > 500
    for r in full:
        if r.scanned != len(x) or not np.array_equal(np.sort(r.batch.fids), np.nonzero(big)[0]):
            raise AssertionError("phase 3i: the full-table filter != numpy")
    env = (ring[:, 0].min(), ring[:, 1].min(), ring[:, 0].max(), ring[:, 1].max())
    cand = np.nonzero((x >= env[0]) & (x <= env[2]) & (y >= env[1]) & (y <= env[3]))[0]
    inside = cand[np_pip_f32(x[cand], y[cand], ring)]
    for r in pres:
        if not np.array_equal(np.sort(r.batch.fids), inside):
            raise AssertionError(f"phase 3i: INTERSECTS {len(r)} rows != numpy {len(inside)}")
    lb = (lpts[:, 0].min(), lpts[:, 1].min(), lpts[:, 0].max(), lpts[:, 1].max())
    in_line = np.nonzero((x >= lb[0]) & (x <= lb[2]) & (y >= lb[1]) & (y <= lb[3]))[0]
    if lres.plan.compiled.fully_on_device or not np.array_equal(np.sort(lres.batch.fids), in_line):
        raise AssertionError(f"phase 3i: the host residual {len(lres)} rows != numpy {len(in_line)}")
    em = masks[0]
    top = np.sort(cols["count"][em])[::-1][:1000]
    if not (sorted(ores.batch.columns) == ["count", "dtg"] and len(ores) == min(1000, int(em.sum()))
            and np.array_equal(ores.batch.column("count"), top)
            and np.all(em[ores.batch.fids])
            and np.array_equal(ores.batch.column("count"), cols["count"][ores.batch.fids])
            and np.array_equal(ores.batch.column("dtg"), dtg[ores.batch.fids])):
        raise AssertionError("phase 3i: the Query with sort, max features and properties != numpy")
    sft = ds.get_schema("gdelt")
    rows = np.nonzero(em)[0]
    want_seq = parse_stat(SEVEN_SKETCHES)
    want_seq.observe_batch(FeatureBatch.from_columns(
        sft, {"count": cols["count"][rows], "dtg": dtg[rows], "geom": cols["geom"][rows]}))
    # the resident stats over phase 3's every row, against numpy over them
    frows = np.nonzero(np_exact(every["geom"][:, 0].astype(np.float32),
                                every["geom"][:, 1].astype(np.float32), every["dtg"], eb, ew))[0]
    want_res = parse_stat(SEVEN_SKETCHES)
    want_res.observe_batch(FeatureBatch.from_columns(
        sft, {"count": every["count"][frows], "dtg": every["dtg"][frows], "geom": every["geom"][frows]}))
    res_seq = di3.stats(europe, SEVEN_SKETCHES)
    if seq.to_json() != want_seq.to_json() or res_seq.to_json() != want_res.to_json():
        raise AssertionError("phase 3i: run_stats on the store path / the resident stats != numpy")
    log(f"phase 3i checks: {len(queries)} queries x (get_count, get_features, store.query) == numpy "
        f"and the DeviceIndex's hits among these rows (hits median {int(np.median([len(r) for _, _, r in out]))}); full table "
        f"{int(big.sum()):,} rows; INTERSECTS {len(inside):,} rows; the line's residual "
        f"{len(in_line):,} rows; options, run_stats (7 sketches) "
        f"equal; in {time.time() - t:.1f} s")

    # -- a DeviceIndex staged from the store ----------------------------------------
    t = time.time()
    sdi = DeviceIndex(ds, "gdelt", z_planes=True, device=dev)
    torch.cuda.synchronize()
    stage_s = time.time() - t
    kernels.reset_counts()
    counts = [sdi.count(ecql) for ecql, _, _ in queries]
    sl = read_launches("DeviceIndex staged from the store", {"filter_scan_count": len(queries)})
    if counts != [n for n, _, _ in out]:
        raise AssertionError("phase 3i: the DeviceIndex staged from the store != the store's counts")
    log(f"phase 3i: a DeviceIndex staged from the store in {stage_s:.1f} s; {len(queries)} exact "
        f"counts == the store's")

    # -- phase 3b's labeled rows in the same store -----------------------------------
    t = time.time()
    lcols = make_columns(STORE_LABELED, SEED + 3)
    lab = np.random.default_rng(SEED + 4).integers(0, len(LABELS), STORE_LABELED)
    data = {k: lcols[k] for k in ("count", "dtg", "geom")}
    data[VIS_COLUMN] = np.array(LABELS, dtype=object)[lab]
    ds.create_schema("labeled", GDELT_SPEC)
    ds.write("labeled", data)
    ds.stats("labeled")
    lflush = time.time() - t
    lx = lcols["geom"][:, 0].astype(np.float32)
    ly = lcols["geom"][:, 1].astype(np.float32)
    lem = np_exact(lx, ly, lcols["dtg"], eb, ew)
    kernels.reset_counts()
    lruns = StoreRuns(ds)
    for auths, verdict in VERDICTS.items():
        res = ds.query("labeled", Query(filter=europe, hints={"auths": auths}))
        lruns.of("labeled", res)
        want = np.nonzero(lem & np.asarray(verdict)[lab])[0]
        if not np.array_equal(np.sort(res.batch.fids), want):
            raise AssertionError(f"phase 3i labeled {auths}: {len(res)} rows != numpy {len(want)}")
        log(f"phase 3i labeled auths={auths}: {len(res)} rows == numpy and the verdict table")
    ll = read_launches("store path, labeled", {"filter_scan_mask": lruns.runs})
    log(f"phase 3i labeled: {STORE_LABELED:,} rows written and flushed in {lflush:.1f} s")
    t = time.time()
    sql = run_sql_path(ds, cols, queries, out[0][0], ores, sdi, lcols, lab)
    log(f"phase 3m: the SQL layer over the memory store in {time.time() - t:.1f} s [{CARD}]")
    ds.remove_schema("labeled")
    del lcols, data, lab, sdi
    torch.cuda.empty_cache()

    answers = [(n, np.sort(res.batch.fids)) for n, _, res in out]
    ais = run_store_ais(dev)
    rss, hwm = _rss_gb()
    summary = {
        "rows": len(x), "flush_s": flush_s, "rss_gb": rss, "peak_rss_gb": hwm,
        "latency": {k: {"p50_ms": pct(v, 50), "p99_ms": pct(v, 99), "n": len(v)} for k, v in runs.lat.items()},
        "runs": runs.runs, "ledger": fields, "staged_index_s": stage_s, "labeled_flush_s": lflush,
        "ais": ais["latency"], "card": CARD,
    }
    log(json.dumps({"store": summary}))
    # phase 4 times the scan on the first 2^23 rows of the z3 index (its
    # largest run), as the store stages them
    head = st.indices["z3"].batch.take(np.arange(STORE_RUN_ROWS[-1]))
    run_rows = {k: head.columns[k] for k in ("count", "dtg", "geom")}
    ds.remove_schema("gdelt")
    launches = {k: launches[k] + sl[k] + ll[k] + sql["launches"][k] + ais["launches"][k]
                for k in launches}
    return {"launches": launches, "run_rows": run_rows, "ecql": europe, "answers": answers}


def run_store_ais(dev) -> dict:
    """The store path of knn, tube_select and proximity_search on 2^22 AIS
    reports (phase 3e's generator, 2^10 vessels), each against the resident
    answer on the same rows; the store queries' mask launches against their
    runs."""
    import torch

    from geomesa_tpu_torch import kernels
    from geomesa_tpu_torch.device_cache import DeviceIndex
    from geomesa_tpu_torch.features.batch import FeatureBatch
    from geomesa_tpu_torch.features.sft import SimpleFeatureType
    from geomesa_tpu_torch.geom import LineString, Polygon
    from geomesa_tpu_torch.process.knn import knn
    from geomesa_tpu_torch.process.proximity import proximity_search
    from geomesa_tpu_torch.process.tube import tube_select
    from geomesa_tpu_torch.store.direct import BatchStore
    from geomesa_tpu_torch.store.memory import MemoryDataStore

    t = time.time()
    cols = make_ais(dev, STORE_AIS_VESSELS, AIS_FIXES)
    data = {k: v for k, v in cols.items() if not k.startswith("_")}
    bstore = BatchStore(FeatureBatch.from_columns(SimpleFeatureType.create("ais", AIS_SPEC), data))
    di = DeviceIndex(bstore, "ais", z_planes=True, device=dev)
    ds = MemoryDataStore()
    ds.create_schema("ais", AIS_SPEC)
    ds.write("ais", data)
    ds.stats("ais")
    n = len(cols["dtg"])
    log(f"phase 3i AIS: {n:,} reports generated, staged and written to the store in {time.time() - t:.1f} s")
    tr = ais_traffic(cols)
    lane, harbour = LineString(tr["lane"]), Polygon(tr["harbour"])
    prox = [(tr["ports8"], 0.1, None), ([lane], 0.05, None), ([harbour], 0.02, None)]
    tubes = tr["tubes"][:2]  # the two 17-fix tracks: a store query per segment

    class Counted:
        """The store, counting the runs of every plan it answers."""

        def __init__(self):
            self.runs = StoreRuns(ds)

        def get_schema(self, name):
            return ds.get_schema(name)

        def query(self, name, q):
            res = ds.query(name, q)
            self.runs.of(name, res)
            return res

    store = Counted()
    calls = Calls()
    kernels.reset_counts()
    s_knn = [calls.run("knn", lambda: knn(store, "ais", *tg, k, base_filter=base)) for tg, k, base in tr["process"]]
    s_tube = [calls.run("tube", lambda: tube_select(store, "ais", xy, tt, buf, dt, base_filter=base))
              for xy, tt, buf, dt, base in tubes]
    s_prox = [calls.run("proximity", lambda: proximity_search(store, "ais", g, d, base_filter=base))
              for g, d, base in prox]
    torch.cuda.synchronize()
    launches = read_launches("store path, AIS processes", {"filter_scan_mask": store.runs.runs})
    calls.log_latency("store ais")
    r_knn = [knn(bstore, "ais", *tg, k, base_filter=base, device_index=di) for tg, k, base in tr["process"]]
    r_tube = [tube_select(bstore, "ais", xy, tt, buf, dt, base_filter=base, device_index=di)
              for xy, tt, buf, dt, base in tubes]
    r_prox = [proximity_search(bstore, "ais", g, d, base_filter=base, device_index=di) for g, d, base in prox]
    x64, y64 = cols["geom"][:, 0], cols["geom"][:, 1]
    for (tg, k, base), a, b in zip(tr["process"], s_knn, r_knn):
        _near_knn(f"phase 3i AIS kNN {tg} k={k} {base}", a, b, x64, y64, *tg)
    for (_, _, buf, dt, base), a, b in zip(tubes, s_tube, r_tube):
        if not np.array_equal(np.sort(a.fids), np.sort(b.fids)):
            raise AssertionError(f"phase 3i AIS tube {buf} {dt} {base}: store {len(a)} != resident {len(b)}")
    for (g, d, base), a, b in zip(prox, s_prox, r_prox):
        oa, ob = np.argsort(a[0].fids), np.argsort(b[0].fids)
        if not (np.array_equal(a[0].fids[oa], b[0].fids[ob]) and np.array_equal(a[1][oa], b[1][ob])):
            raise AssertionError(f"phase 3i AIS proximity {len(g)} inputs at {d}: store != resident")
    log(f"phase 3i AIS: {len(s_knn)} kNN (rows {[len(r[0]) for r in s_knn]}), {len(s_tube)} tubes "
        f"(rows {[len(r) for r in s_tube]}), {len(s_prox)} proximity (rows {[len(r[0]) for r in s_prox]}) "
        f"through the store == the resident answers; {store.runs.runs} store mask launches")
    del di
    torch.cuda.empty_cache()
    return {"launches": launches, "latency": {k: {"p50_ms": pct(v, 50), "p99_ms": pct(v, 99), "n": len(v)}
                                              for k, v in calls.lat.items()}}


def _one_compare(prog, cols):
    """The one PyTorch call computing a program of a single attribute
    compare (``count > 500``), else None."""
    from geomesa_tpu_torch.ops import filter_scan as fs

    if prog.n_instr != 1:
        return None
    op, c0, _, _, _, k, _, flag = prog.instr[0].tolist()
    if op == fs.OP_CMP_I32:
        v = int(prog.consts.view(np.int32)[k])
    elif op == fs.OP_CMP_F32:
        v = float(prog.consts.view(np.float32)[k])
    else:
        return None
    return lambda: fs._cmp_t(fs._CMP_NAMES[flag], cols[prog.cols[c0]], v)


def store_rows(dev, store, launches, errs: Errs) -> list:
    """Phase 4 for the store path's scan: the filter-scan mask over one
    staged run of the z3 index's rows (2^20: one partition; 2^23: eight
    merged, the largest run) for the Europe query, and the full-table
    filter at 2^23, each beside its bound and, for the full-table filter's
    single compare, the one PyTorch call that computes it; each row also
    carries the run's staging time (host slice and upload, best of 3) and
    the wrapper's host time per call (``host_ms``: the host clock over 50
    calls enqueued back to back, no synchronise inside)."""
    import torch

    from geomesa_tpu_torch.features.batch import FeatureBatch
    from geomesa_tpu_torch.features.sft import SimpleFeatureType
    from geomesa_tpu_torch.filter.compile import compile_filter
    from geomesa_tpu_torch.filter.ecql import parse_ecql
    from geomesa_tpu_torch.ops.scan import stage_columns

    sft = SimpleFeatureType.create("gdelt", GDELT_SPEC)
    batch = FeatureBatch.from_columns(sft, store["run_rows"])
    rows = []
    for ecql, n, tag in [(store["ecql"], m, "the Europe query") for m in STORE_RUN_ROWS] + [
            ("count > 500", STORE_RUN_ROWS[-1], "the full-table filter")]:
        cf = compile_filter(parse_ecql(ecql), sft)
        walls = []
        for _ in range(3):
            t = time.perf_counter()
            cols = stage_columns(batch, cf.device_cols, dev, 0, n)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)
        r = _env_row("filter_scan_mask", cf.program, cols, n, f"store run of {n:,} rows, {tag}",
                     launches, errs, library=_one_compare(cf.program, cols))
        r["stage_ms"] = min(walls) * 1e3
        log(f"store run of {n:,} rows ({tag}): staged in {r['stage_ms']:.3f} ms "
            f"({4 * len(cf.program.cols) * n / min(walls) / 1e9:.2f} GB/s); the wrapper's host "
            f"time {r['host_ms']:.4f} ms a call [{CARD}]")
        rows.append(r)
    return rows


# -- phase 3m: the SQL layer (SpatialFrame, st_*, the store path of the join) ---

SQL_DISTRICT_SPEC = "name:String,*geom:Polygon:srid=4326"
#: the join's right filter: REGIONS' africa box. Phase 3's seeded city
#: centres put none in the Europe box, and this one keeps 8 districts.
SQL_RIGHT_BOX = (-18, -35, 52, 38)
SQL_DAY = (T0 + 9 * DAY, T0 + 10 * DAY)  # the joins' one-day left filter
SQL_DWITHIN = 0.05  # degrees
SQL_JOINS = (("within", None), ("intersects", None), ("dwithin", SQL_DWITHIN))


def _star_ring(rng, cx, cy, r, k) -> np.ndarray:
    """A closed, simple star ring of k vertices: jittered-even angles, radii
    r x U(0.8, 1), so the disc of radius 0.64 r lies inside it."""
    th = (np.arange(k) + rng.uniform(-0.3, 0.3, k)) * (2 * np.pi / k)
    rr = r * rng.uniform(0.8, 1.0, k)
    ring = np.stack([cx + rr * np.cos(th), cy + rr * np.sin(th)], axis=1)
    return np.concatenate([ring, ring[:1]])


def district_geoms(centers, seed) -> list:
    """One district a city centre: a star ring of 16-64 vertices, 0.2-2
    degrees across; 8 of them with a hole (an 8-vertex star at a quarter
    of the radius), 4 of the others MultiPolygons (the ring and a
    12-vertex island beyond its radius)."""
    from geomesa_tpu_torch.geom import MultiPolygon, Polygon

    rng = np.random.default_rng(seed)
    kind = np.zeros(len(centers), np.int64)
    pick = rng.permutation(len(centers))
    kind[pick[:8]], kind[pick[8:12]] = 1, 2
    out = []
    for (cx, cy), kd in zip(centers, kind):
        r = rng.uniform(0.125, 1.0)  # 1.6 r to 2 r across
        shell = _star_ring(rng, cx, cy, r, int(rng.integers(16, 65)))
        if kd == 1:
            out.append(Polygon(shell, (_star_ring(rng, cx, cy, 0.25 * r, 8)[::-1],)))
        elif kd == 2:
            a = rng.uniform(0, 2 * np.pi)
            island = _star_ring(rng, cx + 1.5 * r * np.cos(a), cy + 1.5 * r * np.sin(a), 0.25 * r, 12)
            out.append(MultiPolygon((Polygon(shell), Polygon(island))))
        else:
            out.append(Polygon(shell))
    return out


def np_in_geom(px, py, g) -> np.ndarray:
    """numpy's even-odd containment of float64 points in a polygon (all its
    rings' crossings together) or a MultiPolygon (any part)."""
    parts = g.polygons if hasattr(g, "polygons") else (g,)
    out = np.zeros(len(px), bool)
    for p in parts:
        odd = np.zeros(len(px), bool)
        for ring in p.rings():
            odd ^= np_even_odd(px, py, np.asarray(ring, np.float64))
        out |= odd
    return out


def np_edge_dist(px, py, g) -> np.ndarray:
    """numpy's least float64 distance of each point to the geometry's edges
    (every ring of every part), by the clamped projection."""
    parts = g.polygons if hasattr(g, "polygons") else (g,)
    rings = [np.asarray(r, np.float64) for p in parts for r in p.rings()]
    a = np.concatenate([r[:-1] for r in rings])
    d = np.concatenate([r[1:] for r in rings]) - a
    len2 = (d ** 2).sum(1)
    best = np.full(len(px), np.inf)
    for s in range(0, len(px), 1 << 12):
        p = np.stack([px[s: s + (1 << 12)], py[s: s + (1 << 12)]], 1)[:, None, :]
        t = np.clip(((p - a) * d).sum(-1) / np.where(len2 == 0, 1.0, len2), 0.0, 1.0)
        best[s: s + (1 << 12)] = np.sqrt(((p - (a + t[..., None] * d)) ** 2).sum(-1).min(1))
    return best


def _join_pairs(res) -> set:
    left, right, pairs = res
    return set(zip(np.asarray(left.fids)[pairs[:, 0]].tolist(),
                   np.asarray(right.fids)[pairs[:, 1]].tolist()))


def run_sql_path(ds, cols, queries, n_europe, ores, sdi, lcols, lab) -> dict:
    """Phase 3m over phase 3i's memory store (module docstring): frames
    against ds.query / ds.explain of the same Query and phase 3i's answers
    (``n_europe``: its Europe count; ``ores``: its sorted Query),
    with_auths on the labeled type under VERDICTS, the three store-path
    shapes of spatial_join against the resident index ``sdi`` and numpy,
    and a few st_* calls over the Europe batch; the filter-scan masks
    against the runs every plan scans."""
    import torch

    from geomesa_tpu_torch import kernels
    from geomesa_tpu_torch.filter import ast
    from geomesa_tpu_torch.filter.ecql import parse_ecql
    from geomesa_tpu_torch.geom import Point, geohash
    from geomesa_tpu_torch.process.join import spatial_join
    from geomesa_tpu_torch.query.plan import Query
    from geomesa_tpu_torch.sql import SpatialFrame, st_distanceSphere, st_geoHash, st_transform
    from geomesa_tpu_torch.sql.frame import _extent

    t_all = time.time()
    europe, eb, ew = queries[0]
    lat, steps = {}, {}

    def timed(kind, fn):
        t = time.perf_counter()
        r = fn()
        lat.setdefault(kind, []).append(time.perf_counter() - t)
        return r

    def step(name, t0):
        steps[name] = time.time() - t0
        return time.time()

    t = time.time()
    centers = cols["_centers"]
    geoms = district_geoms(centers, SEED + 40)
    ds.create_schema("districts", SQL_DISTRICT_SPEC)
    ds.write("districts", {"name": np.array([f"d{i}" for i in range(len(geoms))], object),
                           "geom": np.array(geoms, dtype=object)}, fids=np.arange(len(geoms)))
    ds.stats("districts")
    envs = np.array([[e.xmin, e.ymin, e.xmax, e.ymax] for e in (g.envelope for g in geoms)])
    shells = [len(getattr(g, "polygons", (g,))[0].shell) - 1 for g in geoms]
    log(f"phase 3m: {len(geoms)} districts ({sum(1 for g in geoms if hasattr(g, 'polygons'))} "
        f"MultiPolygons, {sum(1 for g in geoms if getattr(g, 'holes', ()))} with a hole, shells of "
        f"{min(shells)}-{max(shells)} vertices, {np.min(envs[:, 2] - envs[:, 0]):.2f}-"
        f"{np.max(envs[:, 2] - envs[:, 0]):.2f} degrees across) written and flushed")
    want_runs = 0

    def planned(type_name, query, times=1) -> None:
        nonlocal want_runs
        want_runs += times * plan_runs(ds, type_name, ds.plan(type_name, query))

    t = step("districts", t)
    kernels.reset_counts()
    # -- frames over phase 3i's type, against ds.query / ds.explain --------------
    frame = SpatialFrame(ds, "gdelt").where(europe)
    batch = timed("collect", frame.collect)
    n = timed("count", frame.count)
    text = frame.explain()
    direct = ds.query("gdelt", frame._query())
    planned("gdelt", frame._query(), times=3)
    if not (n == len(batch) == len(direct) == n_europe
            and np.array_equal(batch.fids, direct.batch.fids)
            and text == ds.explain("gdelt", frame._query()) and "Chosen index: z3" in text):
        raise AssertionError(f"phase 3m: the Europe frame {n}/{len(batch)} != ds.query "
                             f"{len(direct)} / phase 3i's count {n_europe}, or its explain differs")
    top = frame.select("count", "dtg").sort("count", True).limit(1000)
    tb = timed("collect_sorted", top.collect)
    planned("gdelt", top._query())
    if not (np.array_equal(tb.fids, ores.batch.fids) and sorted(tb.columns) == ["count", "dtg"]
            and all(np.array_equal(tb.columns[k], ores.batch.columns[k]) for k in ("count", "dtg"))):
        raise AssertionError("phase 3m: select/sort/limit != phase 3i's Query with the same options")
    t = step("frames", t)
    # -- with_auths over the labeled type ---------------------------------------------
    lx, ly = lcols["geom"][:, 0].astype(np.float32), lcols["geom"][:, 1].astype(np.float32)
    lem = np_exact(lx, ly, lcols["dtg"], eb, ew)
    for auths, verdict in VERDICTS.items():
        lf = SpatialFrame(ds, "labeled").where(europe)
        lf = lf.with_auths(*auths) if auths is not None else lf
        got = timed("collect_auths", lf.collect)
        planned("labeled", lf._query())
        want = np.nonzero(lem & np.asarray(verdict)[lab])[0]
        if not np.array_equal(np.sort(got.fids), want):
            raise AssertionError(f"phase 3m with_auths{auths}: {len(got)} rows != numpy {len(want)}")
    t = step("auths", t)
    # -- joins: the store path and the resident index ---------------------------------
    day_q = f"dtg DURING {_iso(SQL_DAY[0])}/{_iso(SQL_DAY[1])}"
    right_q = "BBOX(geom, %s, %s, %s, %s)" % SQL_RIGHT_BOX
    x64, y64, dtg = cols["geom"][:, 0], cols["geom"][:, 1], cols["dtg"]
    drows = np.nonzero((dtg >= SQL_DAY[0]) & (dtg <= SQL_DAY[1]))[0]
    dx, dy = x64[drows], y64[drows]
    right_plan = Query(filter=parse_ecql(right_q))
    joins = {}
    resident_gates = 0
    for on, d in SQL_JOINS:
        kw = {"on": on, "distance": d, "left_filter": day_q, "right_filter": right_q}
        store_res = timed(f"join {on} store", lambda: spatial_join(ds, "gdelt", "districts", **kw))
        rb = store_res[1]
        env = _extent(rb.columns["geom"])
        pad = d or 0.0
        left_q = SpatialFrame(ds, "gdelt").where(day_q).where(ast.BBox(
            "geom", env[0] - pad, env[1] - pad, env[2] + pad, env[3] + pad))._query()
        planned("districts", right_plan, times=2)  # the right side's collect on each path
        planned("gdelt", left_q)
        res_res = timed(f"join {on} resident", lambda: spatial_join(ds, "gdelt", "districts",
                                                                   device_index=sdi, **kw))
        resident_gates += 1  # the day's gate: one mask on the resident index
        if not np.array_equal(rb.fids, res_res[1].fids):
            raise AssertionError(f"phase 3m join {on}: the right sides differ")
        want = set()
        for j in np.asarray(rb.fids).tolist():
            g, e = geoms[j], envs[j]
            c = np.nonzero((dx >= e[0] - pad) & (dx <= e[2] + pad) & (dy >= e[1] - pad)
                           & (dy <= e[3] + pad))[0]
            hit = np_in_geom(dx[c], dy[c], g)
            if on == "dwithin":
                hit |= np_edge_dist(dx[c], dy[c], g) <= d
            want.update((int(r), j) for r in drows[c[hit]])
        got_s, got_r = _join_pairs(store_res), _join_pairs(res_res)
        if not (got_s == got_r == want) or not want:
            raise AssertionError(f"phase 3m join {on}: store path {len(got_s)} / resident {len(got_r)} "
                                 f"pairs != numpy {len(want)}")
        joins[on] = {"pairs": len(want), "right": len(rb), "left_scanned": len(store_res[0])}
        log(f"phase 3m join {on}{'' if d is None else f' {d}'}: {len(want):,} pairs over {len(rb)} "
            f"districts == the resident path == numpy; store path {1e3 * lat[f'join {on} store'][-1]:.1f} ms "
            f"(left scan {len(store_res[0]):,} rows), resident {1e3 * lat[f'join {on} resident'][-1]:.1f} ms "
            f"[{CARD}]")
    t = step("joins", t)
    # the envelope join without a device_index: 64 windows, the day's rows
    store_env = timed("envelope store", lambda: spatial_join(ds, "gdelt", envs, left_filter=day_q))
    res_env = timed("envelope resident", lambda: spatial_join(ds, "gdelt", envs, left_filter=day_q,
                                                              device_index=sdi))
    resident_gates += 1
    day_batch = ds.query("gdelt", Query(filter=parse_ecql(day_q))).batch
    planned("gdelt", Query(filter=parse_ecql(day_q)), times=2)
    a = set(zip(np.asarray(day_batch.fids)[store_env.rows].tolist(), store_env.wins.tolist()))
    b = set(zip(np.asarray(sdi._host_rows().fids)[res_env.rows].tolist(), res_env.wins.tolist()))
    if a != b or not a:
        raise AssertionError(f"phase 3m envelope join: {len(a)} pairs by fid != the resident engine's {len(b)}")
    log(f"phase 3m envelope join, 64 windows, no index: {len(a):,} pairs == the resident engine's "
        f"(engine {store_env.engine}, {store_env.strategy}); {1e3 * lat['envelope store'][0]:.1f} ms "
        f"against {1e3 * lat['envelope resident'][0]:.1f} ms [{CARD}]")
    t = step("envelope", t)
    torch.cuda.synchronize()
    launches = read_launches("the SQL layer (phase 3m)", {"filter_scan_mask": want_runs + resident_gates})
    # -- st_* over the Europe batch ------------------------------------------------------
    pts = batch.columns["geom"]
    cx, cy = (float(v) for v in centers[0])
    gh = timed("st_geoHash", lambda: st_geoHash(pts))
    dist = timed("st_distanceSphere", lambda: st_distanceSphere(pts, Point(cx, cy)))
    merc = timed("st_transform 3857", lambda: st_transform(pts, "EPSG:4326", "EPSG:3857"))
    back = timed("st_transform 4326", lambda: st_transform(merc, "EPSG:3857", "EPSG:4326"))
    lo = np.array([geohash.decode_bbox(h) for h in gh])
    inside = (lo[:, 0, 0] <= pts[:, 0]) & (pts[:, 0] <= lo[:, 0, 1]) & (lo[:, 1, 0] <= pts[:, 1]) \
        & (pts[:, 1] <= lo[:, 1, 1])
    p1, p2 = np.radians(pts[:, 1]), np.radians(cy)
    h = np.sin((p2 - p1) / 2) ** 2 + np.cos(p1) * np.cos(p2) * np.sin(np.radians(cx - pts[:, 0]) / 2) ** 2
    hav = 2 * 6_371_008.8 * np.arcsin(np.sqrt(np.clip(h, 0, 1)))
    err = float(np.abs(back - pts).max()) if len(pts) else 0.0
    if not (inside.all() and len(gh) == len(pts) and np.allclose(dist, hav, rtol=1e-12, atol=0)
            and err <= 1e-9):
        raise AssertionError(f"phase 3m st_*: geohash cells {int(inside.sum())}/{len(pts)}, "
                             f"distances, or the 3857 round trip (max error {err!r} degrees)")
    log(f"phase 3m st_* over the Europe batch ({len(pts):,} points): st_geoHash "
        f"{1e3 * lat['st_geoHash'][0]:.1f} ms (every cell holds its point), st_distanceSphere "
        f"{1e3 * lat['st_distanceSphere'][0]:.3f} ms (== haversine, rtol 1e-12), st_transform to 3857 "
        f"{1e3 * lat['st_transform 3857'][0]:.3f} ms and back {1e3 * lat['st_transform 4326'][0]:.3f} ms "
        f"(max round-trip error {err!r} degrees) [{CARD}]")
    step("st", t)
    ds.remove_schema("districts")
    summary = {"seconds": time.time() - t_all, "steps": steps, "joins": joins,
               "latency_ms": {k: [1e3 * v for v in vs] for k, vs in lat.items()},
               "filter_scan_mask": launches["filter_scan_mask"], "card": CARD}
    log(json.dumps({"sql": summary}))
    return {"launches": launches, "summary": summary}


def run_sql_fs(ds, name, queries, masks) -> "tuple[dict, dict]":
    """Phase 3m over phase 3j's z3 type: SpatialFrame.partitions (one
    filtered batch per surviving partition that holds a hit),
    map_partitions(len, parallelism=4) and count() for the Europe query,
    against numpy; one filter-scan mask per surviving partition a call."""
    import torch

    from geomesa_tpu_torch import kernels
    from geomesa_tpu_torch.sql import SpatialFrame

    t = time.time()
    europe = queries[0][0]
    frame = SpatialFrame(ds, name).where(europe)
    nparts = len(ds._pruned_parts(name, ds.plan(name, frame._query())))
    kernels.reset_counts()
    t0 = time.perf_counter()
    parts = list(frame.partitions())
    parts_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    lens = frame.map_partitions(len, parallelism=4)
    map_s = time.perf_counter() - t0
    n = frame.count()
    torch.cuda.synchronize()
    launches = read_launches(f"the SQL layer over the fs store {name} (phase 3m)",
                             {"filter_scan_mask": 3 * nparts})
    want = np.nonzero(masks[0])[0]
    got = np.sort(np.concatenate([np.asarray(p.fids) for p in parts])) if parts else np.empty(0, np.int64)
    if not (0 < len(parts) <= nparts and all(len(p) for p in parts) and lens == [len(p) for p in parts]
            and sum(lens) == n == len(want) and np.array_equal(got, want)):
        raise AssertionError(f"phase 3m fs {name}: {len(parts)} partitions of {nparts} surviving, "
                             f"map_partitions {sum(lens)}, count {n}, numpy {len(want)}")
    summary = {"partitions": len(parts), "surviving": nparts, "partitions_ms": 1e3 * parts_s,
               "map_partitions_ms": 1e3 * map_s, "seconds": time.time() - t, "card": CARD}
    log(f"phase 3m fs {name}: partitions() {len(parts)} batches of {nparts} surviving partitions in "
        f"{1e3 * parts_s:.1f} ms, map_partitions(len, 4) {1e3 * map_s:.1f} ms, sum {sum(lens):,} == "
        f"count() == numpy [{CARD}]")
    log(json.dumps({"sql_fs": summary}))
    return launches, summary


# -- phase 3j: the file-system store (BASELINE config #1 via geomesa-fs) -------

#: the second type's scheme: the composite partitions.py's docstring names,
#: after geomesa-fs's own examples (":" is how the spec string stores it)
FS_SCHEME = "daily:z2-2bit"
FS_TYPES = (("gdelt_fs", None), ("gdelt_fs_daily_z2", FS_SCHEME))
#: rows of the scheme type: its drive repeats the z3 type's over another
#: layout, so it takes phase 3's first 2^23 rows (a cut of depth, PERF.md
#: section 4)
FS_SCHEME_ROWS = 1 << 23
#: the Count/MinMax spec the stats pushdown answers from chunk partials
PUSH_SPEC = 'Count();MinMax("count");MinMax("dtg")'
FS_ROW_BYTES = 8 + 4 + 8 + 16  # fid, count, dtg and the x/y pair of a row
#: a Europe box on the edges of the store's 64-cell coarse grid (5.625 by
#: 2.8125 degrees a cell): it cuts no cell, so the pushdown's mass is exact
FS_ALIGNED = (-11.25, 33.75, 33.75, 59.0625)
#: degrees: rows this close to a box's edge may fall either side of it
#: (a coarse cell is half-open, the filter's box closed)
FS_EDGE = 1e-5


def _cells(env, grid: int = 64) -> "tuple[np.ndarray, np.ndarray]":
    """(inside, meets), each (grid * grid,) bool: the store's coarse world
    cells that the box ``env`` contains, and that it overlaps with some
    area."""
    cw, ch = 360.0 / grid, 180.0 / grid
    x0 = -180.0 + np.arange(grid) * cw
    y0 = -90.0 + np.arange(grid) * ch
    inside = ((x0 >= env[0]) & (x0 + cw <= env[2]))[None, :] & ((y0 >= env[1]) & (y0 + ch <= env[3]))[:, None]
    meets = ((x0 < env[2]) & (x0 + cw > env[0]))[None, :] & ((y0 < env[3]) & (y0 + ch > env[1]))[:, None]
    return inside.reshape(-1), meets.reshape(-1)


def _cut_cells(env, grid: int = 64) -> np.ndarray:
    """(grid * grid,) bool: the coarse cells that the box ``env`` cuts
    (overlaps with some area but does not contain)."""
    inside, meets = _cells(env, grid)
    return meets & ~inside


def fs_density_calls(queries) -> list:
    """Phase 3j's density drive: phase 3's calls and the Europe 5-day
    window over ``FS_ALIGNED``, the call whose mass must be exact."""
    _, _, ew = queries[0]
    return density_calls(queries) + [
        ("europe aligned", "z3", f"{_bbox(FS_ALIGNED)} AND dtg DURING {_day(ew[0])}/{_day(ew[1])}",
         False, FS_ALIGNED, (256, 288), None, FS_ALIGNED, ew)]


def fs_expected(cols, x, y, dcalls, scalls) -> "tuple[list, list]":
    """numpy's side of phase 3j's aggregates, computed once for both
    types: per density call the rows in its box and window, the rows of
    the coarse cells that its box or raster cuts and the rows on their
    edges (together they bound the pushdown's mass error: it prorates a
    cut cell's rows by area, and a row on an edge may fall either side),
    and for a weighted call the grid; per stats call the Count/MinMax
    JSON. Cells are counted once per window and edges read only the rows
    of the cells along them."""
    from geomesa_tpu_torch.store.chunkstats import world_cells

    dtg = cols["dtg"]
    cell = world_cells(x, y, 64)
    memo = {}

    def once(key, fn):
        if key not in memo:
            memo[key] = fn()
        return memo[key]

    def in_window(window, idx=None):
        d = dtg if idx is None else dtg[idx]
        return (d >= T0 + int(window[0] * DAY)) & (d <= T0 + int(window[1] * DAY))

    def cell_rows(window):
        return np.bincount(cell if window is None else cell[in_window(window)], minlength=64 * 64)

    def edge_rows(b, window):
        # a row within FS_EDGE of an edge lies in a cell that the box grown
        # by twice that meets and the box shrunk by twice that does not hold
        e = FS_EDGE
        _, meets = _cells((b[0] - 2 * e, b[1] - 2 * e, b[2] + 2 * e, b[3] + 2 * e))
        inside, _ = _cells((b[0] + 2 * e, b[1] + 2 * e, b[2] - 2 * e, b[3] - 2 * e))
        idx = np.flatnonzero((meets & ~inside)[cell])
        xs, ys = x[idx], y[idx]
        outer = (xs >= b[0] - e) & (xs <= b[2] + e) & (ys >= b[1] - e) & (ys <= b[3] + e)
        inner = (xs > b[0] + e) & (xs < b[2] - e) & (ys > b[1] + e) & (ys < b[3] - e)
        m = outer & ~inner
        return int((m if window is None else m & in_window(window, idx)).sum())

    dens = []
    for _, _, _, _, env, wh, weight, box, window in dcalls:
        if weight:
            sel = None if box is None else np_exact(x, y, dtg, box, window)
            dens.append((None, None, None, np_density(x, y, sel, env, wh, cols["count"])))
            continue
        boxes = {tuple(env)} | (set() if box is None else {tuple(box)})
        cut = np.zeros(64 * 64, bool)
        for b in boxes:
            cut |= _cut_cells(b)
        exact = len(x) if box is None else once(
            ("rows", tuple(box), window), lambda: int(np_exact(x, y, dtg, box, window).sum()))
        dens.append((exact, int(once(("cells", window), lambda: cell_rows(window))[cut].sum()),
                     sum(once(("edge", b, window), lambda: edge_rows(b, window)) for b in boxes),
                     None))
    stats = []
    for _, _, _, box, window, cmin in scalls:
        sel = None if box is None else np_exact(x, y, dtg, box, window)
        if cmin is not None:
            sel &= cols["count"] > cmin
        stats.append(np_stats(cols, sel)[:3])
    return dens, stats


class FsCalls:
    """Per call kind: latencies, the ledger's fields and the partitions
    each call scanned; and the filter-scan launches the drive must make:
    one per surviving partition of every query plan, one per partition a
    pushdown refines."""

    def __init__(self, ds, name, refines):
        self.ds, self.name, self.refines = ds, name, refines
        self.lat, self.cost, self.parts, self.refined = {}, {}, {}, {}
        self.expected = 0

    def scanned(self, res) -> int:
        n = len(self.ds._pruned_parts(self.name, res.plan)) if res.plan.compiled.device_cols else 0
        self.expected += n
        return n

    def run(self, kind, fn, cold: bool = False):
        from geomesa_tpu_torch import ledger

        if cold:  # drop the decoded partitions: the call reads its files
            self.ds._types[self.name].cache.clear()
        r0 = self.refines["n"]
        with ledger.collect_cost() as cost:
            t = time.perf_counter()
            out = fn()
            dt = time.perf_counter() - t
        self.lat.setdefault(kind, []).append(dt)
        self.refined[kind] = self.refined.get(kind, 0) + self.refines["n"] - r0
        acc = self.cost.setdefault(kind, {})
        for k, v in cost.snapshot_fields().items():
            acc[k] = acc.get(k, 0.0) + v
        return out

    def report(self, tag) -> dict:
        out = {}
        for kind, v in self.lat.items():
            c = self.cost.get(kind, {})
            out[kind] = {"p50_ms": pct(v, 50), "p99_ms": pct(v, 99), "n": len(v),
                         "partitions": self.parts.get(kind, 0), "refined": self.refined.get(kind, 0),
                         **{k: c.get(k, 0.0) for k in (
                             "read_seconds", "decode_seconds", "read_bytes", "chunks_read",
                             "chunks_pruned", "stage_seconds", "device_launches", "device_seconds")}}
            log(f"latency fs {tag} {kind}: p50 {pct(v, 50):.3f} ms  p99 {pct(v, 99):.3f} ms "
                f"({len(v)} calls); partitions scanned {self.parts.get(kind, 0)}, refined "
                f"{self.refined.get(kind, 0)}, chunks read "
                f"{int(c.get('chunks_read', 0))} (pruned {int(c.get('chunks_pruned', 0))}); read "
                f"{c.get('read_seconds', 0):.3f} s ({c.get('read_bytes', 0) / 1e9:.3f} GB), decode "
                f"{c.get('decode_seconds', 0):.3f} s; runner stage {c.get('stage_seconds', 0):.3f} s, "
                f"{int(c.get('device_launches', 0))} launches, device {c.get('device_seconds', 0):.3f} s "
                f"[{CARD}]")
        return out


TRACE_QUERIES = 4  # warm store.query calls under a sampled trace with trace.device.dir set
#: Kineto's event categories of CUDA activity in a Chrome trace
CUDA_CATS = ("kernel", "gpu_memcpy", "gpu_memset", "cuda_runtime", "cuda_driver")


def _trace_blocks(path: str) -> dict:
    """One device_trace block's Chrome trace: its CUDA activity, its
    gm_filter_scan kernel events and their time, and the block's wall time
    (the first event's start to the last event's end)."""
    with open(path) as fh:
        events = [e for e in json.load(fh)["traceEvents"] if e.get("ph") == "X"]
    cuda = [e for e in events if e.get("cat") in CUDA_CATS]
    kern = [e for e in events if e.get("cat") == "kernel" and "gm_filter_scan" in e.get("name", "")]
    t0 = min((e["ts"] for e in events), default=0.0)
    t1 = max((e["ts"] + e.get("dur", 0.0) for e in events), default=0.0)
    return {"cuda_events": len(cuda), "kernels": len(kern), "names": sorted({e["name"] for e in kern}),
            "kernel_us": float(sum(e.get("dur", 0.0) for e in kern)), "wall_us": float(t1 - t0)}


def run_device_trace(ds, name, queries, masks) -> dict:
    """Phase 3j's device trace: TRACE_QUERIES warm store.query calls (the
    ones whose plans keep the fewest partitions, so that each keeps a
    handful of blocks) under a sampled request trace with trace.device.dir
    set to a temporary directory. The runner wraps each partition's launch
    in profiling.device_trace, so each query writes one Chrome trace a
    surviving partition, named by the trace id. Every file must exist and
    hold one CUDA kernel event whose name contains gm_filter_scan (a mask
    launch is one kernel), so that the events equal the query's
    filter_scan_mask launches; no CUDA activity at all fails the phase.
    Prints the kernel's share of each block's wall time and the profiling
    report of the traced queries (query.scan and plan.scan_ranges)."""
    import os
    import shutil
    import tempfile

    import torch

    from geomesa_tpu_torch import kernels, profiling
    from geomesa_tpu_torch.conf import prop_override
    from geomesa_tpu_torch.tracing import TRACER

    nparts = [(len(ds._pruned_parts(name, ds.plan(name, e))), i) for i, (e, _, _) in enumerate(queries)]
    picks = [i for k, i in sorted(nparts) if k and masks[i].any()][:TRACE_QUERIES]
    d = tempfile.mkdtemp(prefix="geomesa-trace-")
    out = []
    try:
        profiling.reset()
        with prop_override("trace.device.dir", d), prop_override("trace.sample", 1.0):
            for i in picks:
                ecql = queries[i][0]
                kernels.reset_counts()
                t0 = time.perf_counter()
                with TRACER.trace(f"phase 3j trace {i}") as tr:
                    res = ds.query(name, ecql)
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
                if not tr.sampled or len(res) != int(masks[i].sum()):
                    raise AssertionError(f"phase 3j trace {ecql}: sampled {tr.sampled}, {len(res)} hits "
                                         f"!= numpy {int(masks[i].sum())}")
                launched = kernels.LAUNCHES["filter_scan_mask"]
                files = sorted(f for f in os.listdir(d) if f.startswith(tr.trace_id + "-"))
                blocks = [_trace_blocks(os.path.join(d, f)) for f in files]
                if not any(b["cuda_events"] for b in blocks):
                    log("phase 3j trace: torch.profiler recorded no CUDA activity on this host (no CUPTI "
                        f"tracing): {len(files)} Chrome traces without a kernel event [{CARD}]")
                    raise AssertionError("phase 3j: torch.profiler recorded no CUDA activity")
                kern = sum(b["kernels"] for b in blocks)
                if not files or len(files) != launched or kern != launched or \
                        any(b["kernels"] != 1 for b in blocks):
                    raise AssertionError(f"phase 3j trace {ecql}: {len(files)} trace files and {kern} "
                                         f"gm_filter_scan kernel events for {launched} filter_scan_mask "
                                         f"launches ({[b['kernels'] for b in blocks]} a file)")
                k_us = sum(b["kernel_us"] for b in blocks)
                b_us = sum(b["wall_us"] for b in blocks)
                shares = [b["kernel_us"] / b["wall_us"] for b in blocks if b["wall_us"] > 0]
                out.append({"query": i, "files": len(files), "kernel_events": kern,
                            "names": sorted({n for b in blocks for n in b["names"]}),
                            "kernel_ms": k_us / 1e3, "blocks_ms": b_us / 1e3, "query_ms": wall_ms,
                            "share": k_us / b_us if b_us else None,
                            "share_min": min(shares) if shares else None,
                            "share_max": max(shares) if shares else None})
                log(f"phase 3j trace {ecql}: {len(files)} Chrome traces ({d}/{tr.trace_id}-*.pt.trace.json), "
                    f"{kern} gm_filter_scan kernel events == {launched} filter_scan_mask launches; kernel "
                    f"{k_us / 1e3:.4f} ms of {b_us / 1e3:.3f} ms of traced blocks "
                    f"({100 * k_us / b_us if b_us else 0:.3f}%; per block {min(shares):.5f}-{max(shares):.5f}), "
                    f"the query {wall_ms:.3f} ms with the profiler on [{CARD}]")
        timings = profiling.timings()
        if "query.scan" not in timings or "plan.scan_ranges" not in timings:
            raise AssertionError(f"phase 3j trace: profiling.report() lacks query.scan or "
                                 f"plan.scan_ranges: {sorted(timings)}")
        log("phase 3j trace: profiling.report() of the traced queries:")
        for line in profiling.report().splitlines():
            log("  " + line)
        log(f"phase 3j trace: kernel names {out[0]['names']}")
        return {"queries": out, "report": timings}
    finally:
        shutil.rmtree(d, ignore_errors=True)


def run_fs_path(dev, cols, queries, mem, base_loose=None) -> dict:
    """Phase 3j, BASELINE config #1 via geomesa-fs: phase 3's 2^26 rows
    written through DataStoreFinder.get_data_store({"fs.path": ...}) into
    a z3 type of 64 partitions of 2^20 and a daily,z2-2bit type (format
    v2, store.fsync on, 2^16-row chunks), each flushed once; on each type
    phase 3's 32 bbox+during queries through store.query (cold: the
    partition cache dropped before each, and warm) and the count pushdown
    (warm and cold), the
    full-table filter,
    phase 3's 9 density calls and one on the coarse grid's edges through
    process.density and 4 stats calls through run_stats (both taking the
    pushdown), explain,
    verify_partitions and verify_chunk_stats; then (the z3 type) the root
    reopened under store.verify=always and the 32 counts read cold from
    disk through the feature source. Every
    answer against numpy over the float32 rows and phase 3i's memory-store
    answers (``mem``); the pushdown's density grids bit for bit against
    the same store scanning on the CPU, and their mass against numpy:
    exact on a box on the coarse grid's edges (``FS_ALIGNED``), else
    within the rows of the coarse cells that the box cuts; the launches against one filter-scan
    mask per surviving partition and per refined partition."""
    import shutil
    import tempfile

    import torch

    from geomesa_tpu_torch import kernels
    from geomesa_tpu_torch.api import DataStoreFinder
    from geomesa_tpu_torch.conf import prop_override, sys_prop
    from geomesa_tpu_torch.device import resolve_device
    from geomesa_tpu_torch.geom import Envelope
    from geomesa_tpu_torch.process.density import density
    from geomesa_tpu_torch.process.statsproc import run_stats
    from geomesa_tpu_torch.query.plan import Query
    from geomesa_tpu_torch.store import pushdown
    from geomesa_tpu_torch.store.fs import FileSystemDataStore

    n = len(cols["count"])
    x = cols["geom"][:, 0].astype(np.float32)
    y = cols["geom"][:, 1].astype(np.float32)
    dtg = cols["dtg"]
    root = tempfile.mkdtemp(prefix="geomesa-fs-")
    need = int(len(FS_TYPES) * n * FS_ROW_BYTES * 1.1)
    free = shutil.disk_usage(root).free
    log(f"phase 3j: root {root} ({free / 1e9:.1f} GB free, {need / 1e9:.1f} GB needed); format "
        f"v{sys_prop('store.format.version')}, fsync {sys_prop('store.fsync')}, "
        f"{sys_prop('store.chunk.rows')}-row chunks, {sys_prop('io.workers')} I/O workers")
    if free < need:
        shutil.rmtree(root, ignore_errors=True)
        raise RuntimeError(f"phase 3j: {free / 1e9:.1f} GB free under {root}, "
                           f"{need / 1e9:.1f} GB needed for {n:,} rows in {len(FS_TYPES)} types")
    t = time.time()
    with ThreadPoolExecutor(max_workers=8) as pool:
        masks = list(pool.map(lambda q: np_exact(x, y, dtg, q[1], q[2]), queries))
    dcalls, scalls = fs_density_calls(queries), stats_calls(queries)
    want_dens, want_stats = fs_expected(cols, x, y, dcalls, scalls)
    log(f"phase 3j: numpy's answers in {time.time() - t:.1f} s")
    refines = {"n": 0}
    real_refine = pushdown._refine_batch

    def counted_refine(*a, **kw):
        refines["n"] += 1  # each refinement scans its chunks through the runner: one mask launch
        return real_refine(*a, **kw)

    pushdown._refine_batch = counted_refine
    summary, totals = {}, {k: 0 for k in kernels.KERNEL_NAMES}
    valid = {k: 0 for k in kernels.KERNEL_NAMES}
    try:
        for name, scheme in FS_TYPES:
            spec = GDELT_SPEC + (f";geomesa.fs.partition-scheme={scheme}" if scheme else "")
            rows_n = n if scheme is None else FS_SCHEME_ROWS
            if rows_n == n:
                tcols, tmasks, tmem, tdens, tstats = cols, masks, mem, want_dens, want_stats
            else:  # the first rows_n rows: numpy's answers over them (no memory-store answers)
                tcols = {k: v if k == "_centers" else v[:rows_n] for k, v in cols.items()}
                tmasks = [m[:rows_n] for m in masks]
                tmem = [(None, None)] * len(queries)
                tdens, tstats = fs_expected(tcols, x[:rows_n], y[:rows_n], dcalls, scalls)
            t = time.time()
            ds = DataStoreFinder.get_data_store({"fs.path": root})
            if resolve_device(ds.device).type != "cuda":
                raise AssertionError("phase 3j: the fs store does not scan on the card")
            ds.create_schema(name, spec)
            ds.write(name, {k: tcols[k] for k in ("count", "dtg", "geom")})
            ds.flush(name)
            flush_s = time.time() - t
            st = ds._types[name]
            nbytes = sum(int(p.checksum["length"]) for p in st.partitions)
            rss, hwm = _rss_gb()
            log(f"phase 3j {name}: wrote and flushed {rows_n:,} rows in {flush_s:.1f} s: "
                f"{len(st.partitions)} partitions, {sum(len(p.chunks) for p in st.partitions)} chunks, "
                f"{nbytes / 1e9:.3f} GB on disk ({nbytes / flush_s / 1e9:.3f} GB/s written); host RSS "
                f"{rss:.1f} GB (peak {hwm:.1f} GB)")
            if sum(p.count for p in st.partitions) != rows_n or st.format_version != 2:
                raise AssertionError(f"phase 3j {name}: the manifest does not hold {rows_n:,} v2 rows")
            src = ds.get_feature_source(name)
            calls = FsCalls(ds, name, refines)
            kernels.reset_counts()
            refines["n"] = 0
            out = []
            # the feature source's get_count and get_features drive the same row
            # scan as store.query, as 3i drives them on the same rows: here
            # store.query alone, and the feature source's get_count under
            # store.verify=always on the z3 type (cuts, PERF.md section 4)
            verified = scheme is None
            for ecql, _, _ in queries:
                cold = calls.run("count_cold", lambda: ds.query(name, ecql), cold=True)
                calls.parts["count_cold"] = calls.parts.get("count_cold", 0) + calls.scanned(cold)
                res = calls.run("query", lambda: ds.query(name, ecql))
                c, f = len(res), res.batch.fids
                calls.parts["query"] = calls.parts.get("query", 0) + calls.scanned(res)
                pc = calls.run("count_pushdown", lambda: ds.count(name, ecql))
                # cold: the boundary chunks' blocks are read alone from the files
                if calls.run("count_pushdown_cold", lambda: ds.count(name, ecql), cold=True) != pc:
                    raise AssertionError(f"phase 3j {name} {ecql}: the cold count pushdown != the warm one")
                out.append((len(cold), c, pc, np.sort(f), np.sort(res.batch.fids)))
            full = calls.run("full_table", lambda: ds.query(name, "count > 500"))
            calls.parts["full_table"] = calls.scanned(full)
            grids, cpu_grids = [], []
            for _, _, ecql, _, env, (w, h), weight, _, _ in dcalls:
                grid = calls.run("density", lambda: density(ds, name, Query(filter=ecql), Envelope(*env),
                                                            w, h, weight_attr=weight))
                if weight:  # the row scan's query: one mask per surviving partition
                    calls.expected += len(ds._pruned_parts(name, ds.plan(name, ecql)))
                grids.append(grid)
            seqs = []
            for _, ecql, _, _, _, _ in scalls:
                seqs.append(calls.run("run_stats", lambda: run_stats(ds, name, Query(filter=ecql), PUSH_SPEC)))
                plan = ds.plan(name, ecql)
                if plan.agg_bounds is None:  # the row scan's query
                    calls.expected += len(ds._pruned_parts(name, plan))
            torch.cuda.synchronize()
            n_weighted = sum(1 for c in dcalls if c[6])
            launches = read_launches(f"fs store {name}", {
                "filter_scan_mask": calls.expected + refines["n"], "density_weighted": n_weighted})
            n_refined = refines["n"]
            if not n_refined:
                raise AssertionError(f"phase 3j {name}: no pushdown refined a boundary chunk")
            for k in totals:
                totals[k] += launches[k]
            log(f"phase 3j {name}: {calls.expected} partition scans and {n_refined} pushdown "
                f"refinements, one filter_scan_mask each; {n_weighted} weighted density launches")
            text = ds.explain(name, queries[0][0])
            if "Chosen index: z3" not in text:
                raise AssertionError(f"phase 3j {name}: explain lacks the z3 index")
            log(f"phase 3j {name} explain: " + " | ".join(s.strip() for s in text.splitlines()[:5]))
            t = time.time()
            bad = ds.verify_partitions(name)
            vp_s = time.time() - t
            t = time.time()
            drift = ds.verify_chunk_stats(name)
            vc_s = time.time() - t
            if bad or drift:
                raise AssertionError(f"phase 3j {name}: verify_partitions {bad[:3]}, "
                                     f"verify_chunk_stats {drift[:3]}")
            log(f"phase 3j {name}: verify_partitions [] in {vp_s:.1f} s, verify_chunk_stats [] in "
                f"{vc_s:.1f} s")

            # -- checks: numpy, phase 3i's memory store, the CPU -------------------
            t = time.time()
            for (ecql, _, _), em, (n_cold, c, pc, f, fq), (mn, mfids) in zip(queries, tmasks, out, tmem):
                want = np.nonzero(em)[0]
                mw = want[want < STORE_ROWS]  # the rows phase 3i's memory store holds
                if not (n_cold == c == pc == len(want)) or mn not in (None, len(mw)):
                    raise AssertionError(f"phase 3j {name} {ecql}: counts {n_cold}/{c}/{pc} != numpy "
                                         f"{len(want)} / the memory store {mn}")
                if not (np.array_equal(f, want) and np.array_equal(fq, want)
                        and (mfids is None or np.array_equal(mfids, mw))):
                    raise AssertionError(f"phase 3j {name} {ecql}: fid sets != numpy / the memory store")
            big = tcols["count"] > 500
            if full.scanned != rows_n or not np.array_equal(np.sort(full.batch.fids), np.nonzero(big)[0]):
                raise AssertionError(f"phase 3j {name}: the full-table filter != numpy")
            cpu = FileSystemDataStore(root, device="cpu")
            for (tag, _, ecql, _, env, wh, weight, _, _), got, (exact, cut, edge, wgrid) in zip(
                    dcalls, grids, tdens):
                if weight:
                    if not same_grid(got, wgrid, True):
                        raise AssertionError(f"phase 3j {name} density {tag}: grid != numpy")
                    continue
                ref = cpu.density_pushdown(name, Query(filter=ecql), Envelope(*env), *wh)
                if ref is None or not np.array_equal(got, ref):
                    raise AssertionError(f"phase 3j {name} density {tag}: the card's pushdown grid != "
                                         "the CPU's")
                # exact but for the cut cells' and the edges' rows, and each
                # cell's float32 rounding (2^-24 of it, twice: the prorated
                # raster and the sum with the refined rows)
                slack = cut + edge + exact * 2.0 ** -22
                mass = float(got.astype(np.float64).sum())
                log(f"phase 3j {name} density {tag}: mass {mass!r}, numpy {exact}, |difference| "
                    f"{abs(mass - exact)!r}; allowed {slack!r} = {cut} cut-cell rows + {edge} edge rows "
                    f"+ float32 rounding")
                if abs(mass - exact) > slack:
                    raise AssertionError(f"phase 3j {name} density {tag}: mass {mass} vs numpy {exact} "
                                         f"(allowed {slack:.1f})")
                if tag == "europe aligned" and cut:
                    raise AssertionError(f"phase 3j: {FS_ALIGNED} cuts {cut} rows' coarse cells")
            for (tag, _, _, _, _, _), got, want in zip(scalls, seqs, tstats):
                if got.to_json() != want:
                    raise AssertionError(f"phase 3j {name} stats {tag}: {got.to_json()} != numpy {want}")
            log(f"phase 3j {name} checks: {len(queries)} queries x (store.query cold and warm, "
                f"the count pushdown) == numpy{' and the memory store' if rows_n == n else ''}; full table; "
                f"{len(dcalls)} density grids (pushdown == the CPU's, mass within the cut cells' and the "
                f"edges' rows, exact on the coarse grid's edges); "
                f"{len(scalls)} stats exact; in {time.time() - t:.1f} s")
            del cpu

            summary[name] = {
                "scheme": scheme, "rows": rows_n, "partitions": len(st.partitions), "flush_s": flush_s, "bytes": nbytes,
                "write_gb_s": nbytes / flush_s / 1e9, "rss_gb": rss, "peak_rss_gb": hwm,
                "verify_partitions_s": vp_s, "verify_chunk_stats_s": vc_s,
                "refinements": n_refined, "calls": calls.report(name)}
            again = vsrc = None

            if verified:  # the device trace on the z3 type (the scheme type repeats it)
                t = time.time()
                summary[name]["device_trace"] = run_device_trace(ds, name, queries, tmasks)
                log(f"phase 3j {name}: the device trace in {time.time() - t:.1f} s [{CARD}]")

            # -- reopened under store.verify=always: cold, verified reads (the z3
            # type's; the scheme type would repeat them: a cut, PERF.md section 4)
            if verified:
                with prop_override("store.verify", "always"):
                    again = DataStoreFinder.get_data_store({"fs.path": root})
                    vsrc = again.get_feature_source(name)
                    vcalls = FsCalls(again, name, refines)
                    kernels.reset_counts()
                    counts = []
                    for ecql, _, _ in queries:
                        counts.append(vcalls.run("count_verified", lambda: vsrc.get_count(ecql), cold=True))
                        vcalls.parts["count_verified"] = vcalls.parts.get("count_verified", 0) + len(
                            again._pruned_parts(name, again.plan(name, ecql)))
                    read_launches(f"fs store {name} reopened", {
                        "filter_scan_mask": vcalls.parts["count_verified"]})
                    totals["filter_scan_mask"] += vcalls.parts["count_verified"]
                if counts != [o[1] for o in out]:
                    raise AssertionError(f"phase 3j {name}: the reopened, verified counts != the first")
                summary[name]["verified"] = vcalls.report(name + " reopened")
            if verified:  # phase 3m's partitioned frame (the scheme type would repeat it)
                sql_launches, summary[name]["sql"] = run_sql_fs(ds, name, queries, tmasks)
                totals["filter_scan_mask"] += sql_launches["filter_scan_mask"]
            if base_loose is not None and scheme is None:  # phase 3k wraps this type in place
                t = time.time()
                live = run_live_path(dev, cols, queries, ds, name, masks, base_loose)
                for k in totals:
                    totals[k] += live["launches"][k]
                valid = live["valid"]
                log(f"phase 3k: the streaming live layer in {time.time() - t:.1f} s")
                st.cache.clear()  # 3l reopens the root with a store of its own
                t = time.time()
                srv = run_server_path(dev, cols, queries, root, name, masks, base_loose, live)
                for k in totals:
                    totals[k] += srv["launches"][k]
                    valid[k] += srv["valid"][k]
                del live
                log(f"phase 3l: the HTTP server in {time.time() - t:.1f} s [{CARD}]")
            del ds, again, src, vsrc, st, out, grids, seqs, full
        log(json.dumps({"fs_store": {"rows": n, "card": CARD, "types": summary}}))
    finally:
        pushdown._refine_batch = real_refine
        shutil.rmtree(root, ignore_errors=True)
    return {"launches": totals, "valid": valid}


# -- phase 3k: the streaming live layer over 3j's z3 type ----------------------

LIVE_BATCH = 1 << 14  # rows an append
LIVE_APPENDS = 64  # acked before the compaction: 2^20 rows
LIVE_TAIL = 15  # appended after it, with the retried shed one: 2^18 rows replayed
LIVE_RUN_ROWS = 1 << 16  # stream.run.rows: four appends coalesce into a run
LIVE_SETTINGS = (("stream.run.rows", LIVE_RUN_ROWS), ("stream.memtable.rows", 1 << 22),
                 ("wal.max.generations", 16))
LIVE_CAPACITY = 1 << 27  # the base plus stream.memtable.rows, to a power of two (3g's rule)


def run_live_path(dev, cols, queries, ds, name, masks, base_loose) -> dict:
    """Phase 3k: 3j's z3 type (2^26 rows, 64 partitions, fsync on) wrapped
    in place (``ds``, 3j's store object) in a StreamingStore, with a
    StreamingDeviceIndex staged from its merged view and fed by its delta
    listener. 64 acked appends of 2^14 fresh GDELT-shaped rows (each
    refresh a delta, no restage), the 32 main queries after 32 and 64
    (layer query fid sets and count, the index's loose and exact counts and
    loose mask, against numpy over the base and the acked rows; the
    filter-scan launches against the surviving partitions, the pushdown's
    refinements and the runs the plans touch; the index's launches all
    reading the validity plane), one shed append at 16 runs, density and
    stats with runs live (the pushdowns decline), compact_now beside a
    thread repeating the counts, the queries and counts after it (one
    launch a surviving partition or refinement), the shed append retried
    and 15 more, then
    close(compact=False) and a reopen that replays exactly those 2^18 rows,
    the queries against numpy again. ``masks`` are numpy's base answers,
    ``base_loose`` phase 3's loose counts (numpy-checked) over the same
    rows."""
    import os
    import threading

    import torch

    from geomesa_tpu_torch import kernels, metrics
    from geomesa_tpu_torch.api import DataStoreFinder
    from geomesa_tpu_torch.conf import prop_override
    from geomesa_tpu_torch.device_cache import Z_BT, StreamingDeviceIndex
    from geomesa_tpu_torch.filter.ecql import parse_ecql
    from geomesa_tpu_torch.geom import Envelope
    from geomesa_tpu_torch.process.density import density
    from geomesa_tpu_torch.process.statsproc import run_stats
    from geomesa_tpu_torch.query.plan import Query
    from geomesa_tpu_torch.store import pushdown
    from geomesa_tpu_torch.store.stream import IngestBackpressureError, StreamingStore

    n = len(cols["count"])
    m_all = LIVE_BATCH * (LIVE_APPENDS + 1 + LIVE_TAIL)
    marks = [("start", time.time())]

    def mark(tag):
        marks.append((tag, time.time()))

    new = make_columns(m_all, SEED + 17, cols["_centers"])
    nx = new["geom"][:, 0].astype(np.float32)
    ny = new["geom"][:, 1].astype(np.float32)
    nfids = np.arange(n, n + m_all, dtype=np.int64)
    x = cols["geom"][:, 0].astype(np.float32)
    y = cols["geom"][:, 1].astype(np.float32)
    with ThreadPoolExecutor(max_workers=8) as pool:
        base_hits = list(pool.map(lambda m: np.nonzero(m)[0], masks))
    new_masks = [np_exact(nx, ny, new["dtg"], b, w) for _, b, w in queries]
    mark("numpy")

    def batch(i):
        a, b = i * LIVE_BATCH, (i + 1) * LIVE_BATCH
        return {k: new[k][a:b] for k in ("count", "dtg", "geom")}, nfids[a:b]

    def want(i, m):  # sorted fids matching query i over the base and the first m streamed rows
        return np.concatenate([base_hits[i], n + np.nonzero(new_masks[i][:m])[0]])

    refines = {"n": 0}
    real_refine = pushdown._refine_batch

    def counted_refine(*a, **kw):
        refines["n"] += 1
        return real_refine(*a, **kw)

    out = {"launches": {k: 0 for k in kernels.KERNEL_NAMES}, "valid": {k: 0 for k in kernels.KERNEL_NAMES}}

    def tally():
        for k in kernels.KERNEL_NAMES:
            out["launches"][k] += kernels.LAUNCHES[k]
            out["valid"][k] += kernels.VALID_LAUNCHES[k]

    lat = {}

    def timed(kind, fn):
        t0 = time.perf_counter()
        r = fn()
        lat.setdefault(kind, []).append(time.perf_counter() - t0)
        return r

    pushdown._refine_batch = counted_refine
    settings = [prop_override(k, v) for k, v in LIVE_SETTINGS]
    for cm in settings:
        cm.__enter__()
    layer = None
    try:
        layer = StreamingStore(ds)
        # the daemon's due test also counts runs (16 live runs at
        # wal.max.generations 16 are due), so it is held off here: the
        # compaction's instant is this script's (compact_now below)
        layer._compact_due = lambda ts: False
        t = time.time()
        di = StreamingDeviceIndex(layer, name, z_planes=True, capacity=LIVE_CAPACITY, device=dev)
        torch.cuda.synchronize()
        stage_s = time.time() - t
        if not (di._z_kind == "z3" and Z_BT in di._cols and len(di) == n and di._cap == LIVE_CAPACITY):
            raise AssertionError(f"phase 3k: the index staged {len(di)} rows, kind {di._z_kind}, "
                                 f"capacity {di._cap}")
        new_planes = host_z3_planes(new, base=di._bt_base)
        log(f"phase 3k: StreamingDeviceIndex staged from the layer's merged view in {stage_s:.1f} s "
            f"({len(di):,} rows, capacity {di._cap:,}, {di.nbytes / 1e9:.3f} GB resident)")
        mark("stage")
        modes = []

        def listener(type_name, b):
            t0 = time.perf_counter()
            mode = di.refresh_delta(b)
            torch.cuda.synchronize()
            lat.setdefault("refresh", []).append(time.perf_counter() - t0)
            modes.append(mode)

        layer.add_delta_listener(listener)
        w0 = (metrics.stream_wal_bytes.value(), metrics.stream_wal_fsyncs.value())

        def append(i):
            cols_i, fids_i = batch(i)
            t0 = time.perf_counter()
            r = layer.append(name, cols_i, fids=fids_i)
            call = time.perf_counter() - t0
            lat.setdefault("append_call", []).append(call)
            lat.setdefault("ack", []).append(call - lat["refresh"][-1])
            return r

        def check(tag, m, runs_live, index=True, count=True):
            """The 32 queries through the layer (and the index), each answer
            against numpy over the base and the first m streamed rows, and
            the launches against the plans."""
            runs = layer._runs_snapshot(name)
            if len(runs) != runs_live:
                raise AssertionError(f"phase 3k {tag}: {len(runs)} runs live, {runs_live} expected")
            kernels.reset_counts()
            expect = {"filter_scan_mask": 0}
            for i, (ecql, _, _) in enumerate(queries):
                w = want(i, m)
                res = timed(f"query {tag}", lambda: layer.query(name, ecql))
                parts = layer.store._pruned_parts(name, res.plan)
                touched = sum(1 for r in runs if r.built.prune(res.plan.ranges))
                expect["filter_scan_mask"] += len(parts) + touched
                if len(res) != len(w) or not np.array_equal(np.sort(res.batch.fids), w) or \
                        res.scanned != sum(p.count for p in parts) + sum(r.rows for r in runs):
                    raise AssertionError(f"phase 3k {tag} {ecql}: query {len(res)} rows (scanned "
                                         f"{res.scanned}) != numpy {len(w)} (or the fid sets differ)")
                if count:  # the same plan: the pushdown's refinements and the same runs
                    r0 = refines["n"]
                    c = timed(f"count {tag}", lambda: layer.count(name, ecql))
                    expect["filter_scan_mask"] += refines["n"] - r0 + touched
                    if c != len(w):
                        raise AssertionError(f"phase 3k {tag} {ecql}: count {c} != numpy {len(w)}")
                if index:
                    ce = di.count(ecql, loose=False)
                    cl = di.count(ecql, loose=True)
                    lm = di.mask(ecql, loose=True)
                    lb = di._loose_bounds(parse_ecql(ecql))
                    wl = base_loose[i] + int(np_loose(lb[1], tuple(p[:m] for p in new_planes)).sum())
                    if ce != len(w) or cl != wl or int(lm.sum()) != wl or cl < ce:
                        raise AssertionError(f"phase 3k {tag} {ecql}: index exact {ce} / loose {cl} / "
                                             f"mask {int(lm.sum())} != numpy {len(w)} / {wl}")
            torch.cuda.synchronize()
            if index:
                q = len(queries)
                expect.update({"filter_scan_count": q, "dimscan_z3_count": q, "dimscan_z3_mask": q})
                for k in ("filter_scan_count", "dimscan_z3_count", "dimscan_z3_mask"):
                    if kernels.VALID_LAUNCHES[k] != kernels.LAUNCHES[k]:
                        raise AssertionError(f"phase 3k {tag}: {k} launched without the validity plane")
            launches = read_launches(f"phase 3k {tag}", expect)
            tally()
            log(f"phase 3k {tag}: {len(queries)} queries == numpy over {n:,} + {m:,} rows with "
                f"{len(runs)} runs live; filter_scan_mask {launches['filter_scan_mask']} = the surviving "
                f"partitions + the pushdown's refinements + the runs the plans touch")
            mark(tag)

        # one check, at 16 runs live: a check after 32 appends, at 8 runs,
        # repeated it (a cut, PERF.md section 4)
        t_ingest = time.perf_counter()
        for i in range(LIVE_APPENDS):
            append(i)
        ingest_s = time.perf_counter() - t_ingest
        if modes != ["delta"] * LIVE_APPENDS or di.restages != 1:
            raise AssertionError(f"phase 3k: refresh modes {sorted(set(modes))} ({len(modes)}), "
                                 f"restages {di.restages}")
        m_acked = LIVE_APPENDS * LIVE_BATCH
        check("64 appends", m_acked, m_acked // LIVE_RUN_ROWS)

        # -- backpressure: 16 runs live, an append that needs a new run --------------
        seq0 = layer._streams[name].wal.next_seq
        cols_i, fids_i = batch(LIVE_APPENDS)
        try:
            layer.append(name, cols_i, fids=fids_i)
        except IngestBackpressureError as e:
            shed = e
        else:
            raise AssertionError("phase 3k: the append at 16 runs was acked")
        if layer._streams[name].wal.next_seq != seq0 or layer.count(
                name, "INCLUDE") != n + m_acked or len(modes) != LIVE_APPENDS:
            raise AssertionError("phase 3k: the shed append left a WAL record or a visible row")
        log(f"phase 3k: the append at 16 runs shed ({shed}); next_seq {seq0} unchanged, none of "
            f"its rows visible")

        # -- density and stats while runs are live: the pushdown declines -------------
        europe, eb, ew = queries[0]
        kernels.reset_counts()
        sel_n = np_exact(nx[:m_acked], ny[:m_acked], new["dtg"][:m_acked], eb, ew)
        dens = [("world include", "INCLUDE", WORLD, (512, 256), None, None),
                ("europe exact", europe, EUROPE, (256, 256), masks[0], sel_n)]
        expect_mask = 0
        for tag, ecql, env, (w, h), sel, sel_new in dens:
            if layer.density_pushdown(name, Query(filter=ecql), Envelope(*env), w, h) is not None:
                raise AssertionError("phase 3k: the density pushdown answered with runs live")
            grid = timed("density", lambda: density(layer, name, Query(filter=ecql), Envelope(*env), w, h))
            plan = ds.plan(name, ecql)
            if plan.compiled.device_cols:
                expect_mask += len(ds._pruned_parts(name, plan)) + sum(
                    1 for r in layer._runs_snapshot(name) if r.built.prune(plan.ranges))
            want_grid = np_density(x, y, sel, env, (w, h)) + np_density(
                nx[:m_acked], ny[:m_acked], sel_new, env, (w, h))  # counts: exact in float32
            if not same_grid(grid, want_grid, False):
                raise AssertionError(f"phase 3k density {tag}: grid != numpy")
        if layer.stats_pushdown(name, Query(filter=europe), PUSH_SPEC) is not None:
            raise AssertionError("phase 3k: the stats pushdown answered with runs live")
        seq = timed("run_stats", lambda: run_stats(layer, name, Query(filter=europe), PUSH_SPEC))
        plan = ds.plan(name, europe)
        expect_mask += len(ds._pruned_parts(name, plan)) + sum(
            1 for r in layer._runs_snapshot(name) if r.built.prune(plan.ranges))
        sel = {"count": np.concatenate([cols["count"][masks[0]], new["count"][:m_acked][sel_n]]),
               "dtg": np.concatenate([cols["dtg"][masks[0]], new["dtg"][:m_acked][sel_n]])}
        if seq.to_json() != np_stats(sel, None)[:3]:
            raise AssertionError(f"phase 3k run_stats: {seq.to_json()} != numpy")
        torch.cuda.synchronize()
        read_launches("phase 3k density/stats", {"filter_scan_mask": expect_mask, "density_count": 2})
        tally()
        log("phase 3k: 2 density grids and run_stats with 16 runs live (pushdown declined) == numpy")
        mark("shed, density, stats")

        # -- compaction beside a thread repeating the counts ---------------------------
        stop, bad, calls = threading.Event(), [], []

        def reader():
            while not stop.is_set():
                for i, (ecql, _, _) in enumerate(queries):
                    if stop.is_set():
                        break
                    t0 = time.monotonic()
                    c = layer.count(name, ecql)
                    calls.append((t0, time.monotonic()))
                    if c != len(want(i, m_acked)):
                        bad.append((ecql, c, len(want(i, m_acked))))

        th = threading.Thread(target=reader, name="stream-reader", daemon=True)
        th.start()
        while not calls and th.is_alive():
            time.sleep(0.01)
        c0 = time.monotonic()
        layer.compact_now(name)
        c1 = time.monotonic()
        compact_s = c1 - c0
        n_before = len(calls)
        while len(calls) < n_before + 2 and th.is_alive():
            time.sleep(0.01)
        stop.set()
        th.join(timeout=120)
        during = sum(1 for a, b in calls if a < c1 and b > c0)
        if bad or th.is_alive() or not during:
            raise AssertionError(f"phase 3k: {len(bad)} answers wrong around the compaction {bad[:3]}; "
                                 f"{len(calls)} calls, {during} across it, reader alive {th.is_alive()}")
        ts = layer._streams[name]
        with open(os.path.join(ds.root, name, "schema.json")) as fh:
            wm = json.load(fh)["wal_watermark"]
        if layer._runs_snapshot(name) or wm != seq0 - 1 or ts.wal._sealed or len(ts.wal.segments()) != 1:
            raise AssertionError(f"phase 3k: after compact_now runs {len(layer._runs_snapshot(name))}, "
                                 f"watermark {wm} (last acked {seq0 - 1}), WAL {ts.wal.stats()}")
        log(f"phase 3k: compact_now in {compact_s:.1f} s; {len(calls)} reader counts, {during} across "
            f"it, all == numpy; watermark {wm} == the last acked seq, WAL {ts.wal.stats()['segments']} "
            f"segment left (the active one)")
        mark("compaction")
        check("compacted", m_acked, 0, index=False)

        # -- the shed append retried, 15 more, then a replay ------------------------------
        layer.append(name, cols_i, fids=fids_i)
        for i in range(LIVE_APPENDS + 1, LIVE_APPENDS + 1 + LIVE_TAIL):
            append(i)
        if len(modes) != LIVE_APPENDS + 1 + LIVE_TAIL or set(modes) != {"delta"} or di.restages != 1:
            raise AssertionError(f"phase 3k: refresh modes {modes[-16:]}, restages {di.restages}")
        wal_bytes = metrics.stream_wal_bytes.value() - w0[0]
        fsyncs = metrics.stream_wal_fsyncs.value() - w0[1]
        layer.close(compact=False)
        layer = None
        del di
        replay0 = metrics.stream_wal_replay_rows.value()
        t = time.time()
        layer = StreamingStore(DataStoreFinder.get_data_store({"fs.path": ds.root}))
        replay_s = time.time() - t
        replayed = int(metrics.stream_wal_replay_rows.value() - replay0)
        tail = (LIVE_TAIL + 1) * LIVE_BATCH
        if replayed != tail or layer.stream_stats()["types"][name]["memtable_rows"] != tail:
            raise AssertionError(f"phase 3k: the replay recovered {replayed} rows, not {tail}")
        mark("tail, close, reopen")
        check("replayed", m_all, tail // LIVE_RUN_ROWS, index=False, count=False)
        log(f"phase 3k: reopened; the replay recovered exactly the {tail:,} acked rows in "
            f"{replay_s:.2f} s ({tail / replay_s:,.0f} rows/s, the store's open included); "
            f"32 queries == numpy")
        summary = {"rows": n, "streamed": m_all, "card": CARD, "stage_s": stage_s,
                   "compact_s": compact_s, "replay_s": replay_s, "replay_rows_s": tail / replay_s,
                   "wal_bytes": wal_bytes, "wal_fsyncs": fsyncs,
                   "ingest_rows_s": LIVE_APPENDS * LIVE_BATCH / ingest_s,
                   "steps_s": {tag: b - a for (_, a), (tag, b) in zip(marks, marks[1:])},
                   "latency": {k: {"p50_ms": pct(v, 50), "p99_ms": pct(v, 99), "n": len(v)}
                               for k, v in lat.items()}}
        for k, v in lat.items():
            log(f"latency stream {k}: p50 {pct(v, 50):.3f} ms  p99 {pct(v, 99):.3f} ms ({len(v)} calls) [{CARD}]")
        log(f"phase 3k: ingest {summary['ingest_rows_s']:,.0f} rows/s over {LIVE_APPENDS} appends; WAL "
            f"{wal_bytes / 1e6:.1f} MB, {int(fsyncs)} fsyncs; compaction {compact_s:.1f} s; replay "
            f"{replay_s:.2f} s; steps " + ", ".join(f"{k} {v:.1f} s" for k, v in summary["steps_s"].items())
            + f" [{CARD}]")
        log(json.dumps({"stream_layer": summary}))
        out["new"], out["new_masks"] = new, new_masks  # phase 3l's truth over the streamed rows
        return out
    finally:
        pushdown._refine_batch = real_refine
        if layer is not None:
            layer.close(compact=False)
        for cm in reversed(settings):
            cm.__exit__(None, None, None)


# -- phase 3l: the HTTP serving bridge over 3j/3k's root ------------------------

SERVE_APPENDS = 16  # POST /append batches of LIVE_BATCH rows
SERVE_BURST = (64, 16)  # client threads x loose counts each
SERVE_SHED = (64, 4)  # client threads x exact counts each, against sched.max.queue 2
SERVE_FEATURES = 50  # maxFeatures of the GeoJSON requests
SERVE_KNN = [((2.3515625, 48.859375), 100), ((-73.96875, 40.78125), 500)]


#: phase 3l's standing subscriptions on the z3 type, sub.max.per.type in all:
#: bbox geofences of 0.01-2 degrees around the 64 city centres, dwithin
#: circles of 1-50 km, bbox AND cql, and more bbox (the type carries no
#: visibility labels, so none of them holds auths)
PUSH_SUBS = (("bbox", 3072), ("dwithin", 512), ("bbox+cql", 384), ("bbox", 128))
PUSH_CQL = "count > 500"
PUSH_SSE = 4  # open SSE streams; one f=bin stream besides
PUSH_RESUME_AT = 8  # events the dropped SSE stream reads before its Last-Event-ID reconnect
PUSH_HEARTBEAT_S = 0.5  # sub.heartbeat.s while 3l's streams are open
KM_PER_DEG = 111.32


def push_docs(centers, seed) -> list:
    """(kind, subscription body) of phase 3l's subscriptions, from a seed."""
    rng = np.random.default_rng(seed)
    out = []
    for kind, n in PUSH_SUBS:
        for k in range(n):
            cx, cy = centers[k % len(centers)] + rng.uniform(-0.5, 0.5, 2)
            if kind == "dwithin":
                out.append((kind, {"dwithin": {"x": float(cx), "y": float(cy),
                                               "distance": float(rng.uniform(1, 50) / KM_PER_DEG)}}))
                continue
            w, h = rng.uniform(0.01, 2.0, 2)
            doc = {"bbox": [float(cx - w / 2), float(cy - h / 2), float(cx + w / 2), float(cy + h / 2)]}
            if kind == "bbox+cql":
                doc["cql"] = PUSH_CQL
            out.append((kind, doc))
    return out


def np_push_match(docs, x, y, cnt) -> dict:
    """numpy's match of one append: subscription index -> the batch's rows
    (ascending) for every subscription with a match. The coarse test is
    the subscription's envelope (its bbox, or its circle's box, clipped to
    the world) against each point, inclusive in float64, as the join
    compares; then the exact residuals (the distance, the cql)."""
    order = np.argsort(x, kind="stable")
    xs = x[order]
    out = {}
    for i, (kind, doc) in enumerate(docs):
        if kind == "dwithin":
            d = doc["dwithin"]
            cx, cy, r = d["x"], d["y"], d["distance"]
            env = (max(-180.0, cx - r), max(-90.0, cy - r), min(180.0, cx + r), min(90.0, cy + r))
        else:
            b = doc["bbox"]
            env = (max(-180.0, b[0]), max(-90.0, b[1]), min(180.0, b[2]), min(90.0, b[3]))
        lo, hi = np.searchsorted(xs, env[0], "left"), np.searchsorted(xs, env[2], "right")
        rows = order[lo:hi]
        rows = rows[(y[rows] >= env[1]) & (y[rows] <= env[3])]
        if kind == "dwithin":
            rows = rows[np.hypot(np.abs(x[rows] - cx), np.abs(y[rows] - cy)) <= r]
        elif kind == "bbox+cql":
            rows = rows[cnt[rows] > 500]
        if len(rows):
            out[i] = np.sort(rows)
    return out


class _PushReader:
    """One push stream read on a thread: SSE match events as (seq, fids,
    receive time), or the raw BIN bytes. ``stop_after`` closes an SSE
    stream after that many match events (the resume check's drop)."""

    def __init__(self, url, headers=None, bin_bytes=None, stop_after=None):
        import threading
        import urllib.request

        self.events, self.raw, self.ends, self.error = [], b"", [], None
        self.bin_bytes, self.stop_after, self._stop = bin_bytes, stop_after, False
        self._req = urllib.request.Request(url, headers=headers or {})
        self.done = threading.Event()
        self._thread = threading.Thread(target=self._run, name="push-reader", daemon=True)
        self._thread.start()

    def _run(self):
        import urllib.request

        try:
            with urllib.request.urlopen(self._req, timeout=600) as resp:
                self.ctype = resp.headers["Content-Type"]
                buf = b""
                while not self._stop:
                    chunk = resp.read1(1 << 16)
                    if not chunk:
                        break
                    t = time.perf_counter()
                    if self.bin_bytes is not None:
                        self.raw += chunk
                        if len(self.raw) >= self.bin_bytes():
                            break
                        continue
                    buf += chunk
                    while b"\n\n" in buf:
                        frame, buf = buf.split(b"\n\n", 1)
                        self._frame(frame, t)
                    if self.stop_after is not None and len(self.events) >= self.stop_after:
                        break
        except Exception as e:  # surfaced through .error
            self.error = e
        finally:
            self.done.set()

    def _frame(self, frame, t):
        if b"event: end" in frame:
            self.ends.append(frame)
        elif b"event: match" in frame:
            seq, fids = None, None
            for ln in frame.split(b"\n"):
                if ln.startswith(b"id: "):
                    seq = int(ln[4:])
                elif ln.startswith(b"data: "):
                    doc = json.loads(ln[6:])
                    fids = np.array([int(f["id"]) for f in doc["features"]], np.int64)
                    if doc["seq"] != seq:
                        raise AssertionError(f"an SSE event's body seq {doc['seq']} != its id {seq}")
            self.events.append((seq, fids, t))

    def stop(self, timeout=30.0):
        self._stop = True
        self.done.wait(timeout)


def check_push_tier(base, name, get, hub, docs, ids, index, truth, want, streamed, bin_sub, bin_want,
                    readers, sent, live_calls, launches0, faults0, app_fids) -> dict:
    """Phase 3l's push-tier checks after the 16 appends: every fused match
    (all 4,096 subscriptions) equal to numpy's, one fused join an append,
    the layout on the card, no match fault; each open stream's events (and
    the BIN bytes) equal to numpy's rows of the appends its subscription
    matches, seqs strictly increasing; the dropped stream resumed by
    Last-Event-ID exactly once through the WAL replay; f=arrow 406; one
    cancel dropping out of /stats/pubsub. Returns the push figures."""
    import urllib.request

    from geomesa_tpu_torch import metrics

    n_app = len(sent)
    seq_of = [s_ for s_, _, _ in sent]
    # every fused match of the appends, all subscriptions, against numpy
    if len(live_calls) != n_app:
        raise AssertionError(f"phase 3l push: {len(live_calls)} live matches for {n_app} appends")
    pairs = 0
    # the registry's order (the registering clients raced): the matcher
    # answers in it
    reg_pos = {sub.sub_id: p for p, sub in enumerate(hub.registry.for_type(name))}
    for j, (_, fids, res) in enumerate(live_calls):
        if not np.array_equal(fids, app_fids[j * LIVE_BATCH:(j + 1) * LIVE_BATCH]):
            raise AssertionError(f"phase 3l push: live match {j} saw another batch")
        got = {index[sub.sub_id]: rows for sub, rows in res}
        pos = [reg_pos[sub.sub_id] for sub, _ in res]
        if sorted(got) != sorted(truth[j]) or pos != sorted(pos) or \
                any(not np.array_equal(rows, truth[j][k]) for k, rows in got.items()):
            bad = sorted(set(got) ^ set(truth[j]))[:5] or \
                [(k, docs[k], len(rows), len(truth[j][k])) for k, rows in got.items()
                 if not np.array_equal(rows, truth[j][k])][:3]
            raise AssertionError(f"phase 3l push: append {j}: the fused match of {len(got)} subscriptions "
                                 f"!= numpy's {len(truth[j])} (differing subscriptions {bad}; in "
                                 f"registration order: {pos == sorted(pos)})")
        pairs += sum(len(r) for r in got.values())
    launched = hub.matcher.launches - launches0
    dev_ = hub.matcher.layout_device(name)
    if launched != n_app or str(dev_) != "cuda:0" or hub.match_faults != faults0:
        raise AssertionError(f"phase 3l push: {launched} fused joins for {n_app} appends, the layout on "
                             f"{dev_}, {hub.match_faults - faults0} match faults")
    # the streams
    deadline = time.time() + 120
    for r, k in zip(readers, streamed + [bin_sub]):
        n_want = PUSH_RESUME_AT if r is readers[0] else len(want[k])
        while (len(r.raw) < len(bin_want) if r.bin_bytes is not None else len(r.events) < n_want):
            if time.time() > deadline or r.error is not None:
                raise AssertionError(f"phase 3l push: a stream got {len(r.events)} events / {len(r.raw)} "
                                     f"bytes of {n_want} ({r.error})")
            time.sleep(0.05)
    for r, k in zip(readers[:-1], streamed):
        exp = [(seq_of[j], app_fids[j * LIVE_BATCH + rows]) for j, rows in want[k]]
        got = r.events[:PUSH_RESUME_AT] if r is readers[0] else r.events
        exp = exp[:len(got)]
        if [s_ for s_, _, _ in got] != [s_ for s_, _ in exp] or \
                any(not np.array_equal(np.sort(f), e) for (_, f, _), (_, e) in zip(got, exp)):
            raise AssertionError(f"phase 3l push: subscription {k} ({docs[k][0]}): SSE events "
                                 f"{[s_ for s_, _, _ in got]} != numpy's {[s_ for s_, _ in exp]}")
    if readers[-1].raw[:len(bin_want)] != bin_want or readers[-1].ctype != "application/vnd.geomesa.bin":
        raise AssertionError(f"phase 3l push: the f=bin stream's {len(readers[-1].raw)} bytes != numpy's "
                             f"{len(bin_want)} ({readers[-1].ctype})")
    for r in readers[1:]:
        r.stop()
    # first-event latency: the POST sent to the first SSE event of its seq
    first = {}
    for r in readers[:-1]:
        for s_, _, t in r.events:
            first[s_] = min(first.get(s_, t), t)
    lat_first = [first[s_] - t_sent for s_, t_sent, _ in sent if s_ in first]
    lat_ack = [t_ack - t_sent for _, t_sent, t_ack in sent]
    match_s = [dt for dt, _, _ in live_calls]
    # the resume: the first stream stopped after PUSH_RESUME_AT events
    r0 = readers[0]
    r0.stop()
    last = r0.events[-1][0]
    rest = [(seq_of[j], app_fids[j * LIVE_BATCH + rows]) for j, rows in want[streamed[0]]
            if seq_of[j] > last]
    replay0, l0 = metrics.pubsub_replay_records.value(), hub.matcher.launches
    again = _PushReader(f"{base}/subscribe/{name}?id={ids[streamed[0]]}", headers={"Last-Event-ID": str(last)})
    readers.append(again)
    deadline = time.time() + 120
    while len(again.events) < len(rest):
        if time.time() > deadline or again.error is not None:
            raise AssertionError(f"phase 3l push: the resumed stream got {len(again.events)} of "
                                 f"{len(rest)} events ({again.error})")
        time.sleep(0.05)
    time.sleep(3 * PUSH_HEARTBEAT_S)  # a duplicate would arrive by now
    again.stop()
    replayed = int(metrics.pubsub_replay_records.value() - replay0)
    union = [s_ for s_, _, _ in r0.events] + [s_ for s_, _, _ in again.events]
    expect_all = [seq_of[j] for j, _ in want[streamed[0]]]
    if union != expect_all or any(not np.array_equal(np.sort(f), e) for (_, f, _), (_, e) in
                                  zip(again.events, rest)):
        raise AssertionError(f"phase 3l push: resumed stream {union} != each matched append once "
                             f"{expect_all}")
    n_after = sum(1 for s_ in seq_of if s_ > last)
    if replayed != n_after or hub.matcher.launches - l0 != n_after:
        raise AssertionError(f"phase 3l push: the resume replayed {replayed} WAL records with "
                             f"{hub.matcher.launches - l0} fused joins, not the {n_after} appends above "
                             f"cursor {last}")
    # arrow 406, a cancel
    st, _, body = get(f"/subscribe/{name}?id={ids[streamed[1]]}&f=arrow")
    gone = ids[7]
    st2, _, body2 = get(f"/subscribe/{name}?id={gone}", method="DELETE")
    stats = json.loads(get("/stats/pubsub")[2])
    left = [d["id"] for d in stats["subscriptions"]]
    if st != 406 or st2 != 200 or json.loads(body2) != {"cancelled": gone} or gone in left or \
            len(left) != len(docs) - 1 or stats["match_faults"] or hub.registry.count(name) != len(docs) - 1:
        raise AssertionError(f"phase 3l push: f=arrow {st}, DELETE {st2} {body2[:100]!r}, "
                             f"{len(left)} subscriptions left, match faults {stats['match_faults']}")
    hist = metrics.pubsub_match_seconds
    out = {"subscriptions": len(docs), "appends": n_app, "fused_joins": launched, "pairs": pairs,
           "layout_device": str(dev_), "replayed": replayed, "resume_cursor": last,
           "match_p50_ms": pct(match_s, 50), "match_p99_ms": pct(match_s, 99),
           "first_event_p50_ms": pct(lat_first, 50), "first_event_p99_ms": pct(lat_first, 99),
           "ack_p50_ms": pct(lat_ack, 50), "ack_p99_ms": pct(lat_ack, 99),
           "events": [len(r.events) for r in readers[:PUSH_SSE]], "bin_bytes": len(bin_want)}
    log(f"phase 3l push: {n_app} appends x {len(docs):,} subscriptions: every fused match == numpy "
        f"({pairs:,} pairs), {launched} fused joins (one an append) on a layout on {dev_}, no match "
        f"fault; {PUSH_SSE} SSE streams' events ({out['events']}) and the f=bin stream's "
        f"{len(bin_want):,} bytes == numpy, ids strictly increasing; a stream dropped after "
        f"{PUSH_RESUME_AT} events and resumed by Last-Event-ID {last}: {replayed} WAL records replayed "
        f"through the fused matcher, every matched append once; f=arrow 406; a DELETE leaves "
        f"{len(left):,} [{CARD}]")
    log(f"latency push match: p50 {out['match_p50_ms']:.3f} ms  p99 {out['match_p99_ms']:.3f} ms per "
        f"append of {LIVE_BATCH:,} rows against {len(docs):,} subscriptions (pubsub_match_seconds: "
        f"{hist.stats()['n']} observations, {hist.stats()['sum']:.4f} s in all) [{CARD}]")
    log(f"latency push first event: p50 {out['first_event_p50_ms']:.3f} ms  p99 "
        f"{out['first_event_p99_ms']:.3f} ms from POST /append sent to the first SSE event of its seq "
        f"(the ack alone: p50 {out['ack_p50_ms']:.3f} ms  p99 {out['ack_p99_ms']:.3f} ms) [{CARD}]")
    return out


def run_server_path(dev, cols, queries, root, name, masks, base_loose, live) -> dict:
    """Phase 3l: 3j/3k's root reopened (the z3 type: 2^26 rows, 3k's 2^20
    compacted rows and its 2^18 rows in the WAL) and served by
    ``serve_background(store, resident=True, sched=True, stream=True)`` on
    127.0.0.1:0, driven by a stdlib urllib client. The first request
    stages the resident StreamingDeviceIndex from the merged view on the
    card. Every answer against numpy over the same float32 rows: the 32
    main queries through /count exact and loose=1; 8 GeoJSON /features
    with maxFeatures and 2 f=bin (byte-equal to the index's bin_export); 4
    /density grids, 2 /stats, 2 /knn, 1 /explain; the push tier: 4,096
    subscriptions (sub.max.per.type) registered over HTTP, 4 SSE streams
    and one f=bin stream held open; 16 POST /append batches
    of 2^14 rows, each counted at once (delta refreshes, no restage), each
    matched against every subscription by one fused join on the card (the
    matches of all 4,096 equal numpy's, the streams' events and BIN bytes
    too), one SSE stream dropped after 8 events and resumed exactly once by
    Last-Event-ID through the WAL replay, f=arrow 406, a cancel; a
    burst of 64 threads x 16 loose counts (fusion factor > 1 on
    /stats/sched) and one against sched.max.queue 2 (429s with
    Retry-After); fail.resident.launch over 8 requests (right answers from
    the store rung's filter-scan launches on the card, X-Degraded
    device-launch-failed then device-breaker-open, /readyz open), disarmed (the half-open probe closes it); /metrics parsed,
    /stats/ledger's tenant, a Perfetto trace; POST /admin/shutdown, and a
    reopen that replays the appended rows. The launch counters show which
    kernels carried the requests; each endpoint's client-side p50/p99."""
    import dataclasses
    import threading
    import urllib.error
    import urllib.request

    import torch

    from geomesa_tpu_torch import failpoints, kernels, metrics
    from geomesa_tpu_torch.api import DataStoreFinder
    from geomesa_tpu_torch.conf import prop_override
    from geomesa_tpu_torch.filter.ecql import parse_ecql
    from geomesa_tpu_torch.server import serve_background
    from geomesa_tpu_torch.store.stream import StreamingStore

    t_phase = time.time()
    n = len(cols["count"])
    new, new_masks = live["new"], live["new_masks"]
    m_all = len(new["count"])
    m_app = SERVE_APPENDS * LIVE_BATCH
    app = make_columns(m_app, SEED + 29, cols["_centers"])
    app_fids = np.arange(n + m_all, n + m_all + m_app, dtype=np.int64)
    x = np.concatenate([cols["geom"][:, 0], new["geom"][:, 0], app["geom"][:, 0]]).astype(np.float32)
    y = np.concatenate([cols["geom"][:, 1], new["geom"][:, 1], app["geom"][:, 1]]).astype(np.float32)
    dtg = np.concatenate([cols["dtg"], new["dtg"], app["dtg"]])
    cnt = np.concatenate([cols["count"], new["count"], app["count"]])
    app_masks = [np_exact(x[n + m_all:], y[n + m_all:], app["dtg"], b, w) for _, b, w in queries]

    def exact_hits(i, m_streamed):
        """Sorted row ids (= fids) matching query i over the base, 3k's rows
        and the first m_streamed appended rows."""
        return np.concatenate([np.nonzero(masks[i])[0], n + np.nonzero(new_masks[i])[0],
                               n + m_all + np.nonzero(app_masks[i][:m_streamed])[0]])

    lat: dict = {}
    stats_lock = threading.Lock()

    def get(path, headers=None, method="GET", body=None, kind=None):
        data = None if body is None else json.dumps(body).encode()
        req = urllib.request.Request(base + path, data=data, headers=headers or {}, method=method)
        t0 = time.perf_counter()
        try:
            with urllib.request.urlopen(req, timeout=120) as r:
                out = (r.status, r.headers, r.read())
        except urllib.error.HTTPError as e:
            with e:
                out = (e.code, e.headers, e.read())
        if kind is not None:
            with stats_lock:
                lat.setdefault(kind, []).append(time.perf_counter() - t0)
        return out

    def ok_json(path, kind, headers=None):
        st, h, b = get(path, headers, kind=kind)
        if st != 200:
            raise AssertionError(f"phase 3l {path}: HTTP {st} {b[:300]!r}")
        return json.loads(b), h

    def q(s):
        return urllib.request.quote(s)

    def tally(into):
        for k in kernels.KERNEL_NAMES:
            into["launches"][k] += kernels.LAUNCHES[k]
            into["valid"][k] += kernels.VALID_LAUNCHES[k]

    out = {"launches": {k: 0 for k in kernels.KERNEL_NAMES}, "valid": {k: 0 for k in kernels.KERNEL_NAMES}}
    settings = [prop_override(k, v) for k, v in LIVE_SETTINGS + (("sub.heartbeat.s", PUSH_HEARTBEAT_S),)]
    for cm in settings:
        cm.__enter__()
    server = None
    readers = []
    try:
        store = DataStoreFinder.get_data_store({"fs.path": root})
        server, thread = serve_background(store, resident=True, sched=True, stream=True)
        layer = server.stream_layer
        layer._compact_due = lambda ts: False  # the tail stays in runs, as in 3k
        base = "http://%s:%d" % server.server_address[:2]
        handler = server.RequestHandlerClass
        kernels.reset_counts()
        t = time.time()
        first, _ = ok_json(f"/count/{name}", "first touch (staging)")
        torch.cuda.synchronize()
        stage_s = time.time() - t
        di = handler._resident_cache[name]
        if first["count"] != n + m_all or len(di) != n + m_all or di.device.type != "cuda":
            raise AssertionError(f"phase 3l: first touch counted {first['count']}, staged {len(di)} rows "
                                 f"on {di.device}, not {n + m_all:,} on the card")
        log(f"phase 3l: serving {root} on {base}; the first request staged the resident index from "
            f"the merged view in {stage_s:.1f} s ({len(di):,} rows, capacity {di._cap:,}, "
            f"{len(layer._runs_snapshot(name))} replayed runs live) [{CARD}]")
        new_planes = host_z3_planes({"geom": np.concatenate([new["geom"], app["geom"]]),
                                     "dtg": np.concatenate([new["dtg"], app["dtg"]])}, base=di._bt_base)
        lbs = [di._loose_bounds(parse_ecql(e))[1] for e, _, _ in queries]

        def loose_want(i, m_streamed):
            return base_loose[i] + int(np_loose(lbs[i], tuple(p[:m_all + m_streamed] for p in new_planes)).sum())

        # -- the 32 main queries, exact and loose ----------------------------------
        kernels.reset_counts()
        for i, (ecql, _, _) in enumerate(queries):
            got, _ = ok_json(f"/count/{name}?cql={q(ecql)}&tenant=smoke", "count")
            gl, _ = ok_json(f"/count/{name}?cql={q(ecql)}&loose=1&tenant=smoke", "count loose")
            want, wl = len(exact_hits(i, 0)), loose_want(i, 0)
            if got["count"] != want or gl["count"] != wl:
                raise AssertionError(f"phase 3l {ecql}: /count {got['count']} / loose {gl['count']} != "
                                     f"numpy {want} / {wl}")
        torch.cuda.synchronize()
        counts = dict(kernels.LAUNCHES)
        for k in ("filter_scan_count", "dimscan_z3_count"):
            if counts[k] < len(queries) or kernels.VALID_LAUNCHES[k] != counts[k]:
                raise AssertionError(f"phase 3l /count: {k} launched {counts[k]} times, "
                                     f"{kernels.VALID_LAUNCHES[k]} with the validity plane")
        log(f"phase 3l: 32 /count exact and 32 loose == numpy; launches "
            f"filter_scan_count {counts['filter_scan_count']}, dimscan_z3_count {counts['dimscan_z3_count']}, "
            f"all with the validity plane")
        tally(out)

        # -- features, BIN, density, stats, kNN, explain ------------------------------
        # the twin's BIN bytes, made before the count starts: its scans
        # compare, they carry no request
        bin_ref = {i: di.bin_export(queries[i][0], "count") for i in (0, 12)}
        kernels.reset_counts()
        by_kind: dict = {}  # request kind -> the launches its requests made

        def counted(kind, fn):
            """fn(), with the launches it made added to by_kind[kind]."""
            before = dict(kernels.LAUNCHES)
            r = fn()
            acc = by_kind.setdefault(kind, {k: 0 for k in kernels.KERNEL_NAMES})
            for k in kernels.KERNEL_NAMES:
                acc[k] += kernels.LAUNCHES[k] - before[k]
            return r

        geom_of = np.stack([x, y], axis=1).astype(np.float64)
        for i in range(8):
            ecql = queries[i * 4][0]
            doc, _ = counted("features", lambda: ok_json(
                f"/features/{name}?cql={q(ecql)}&maxFeatures={SERVE_FEATURES}", "features"))
            want = exact_hits(i * 4, 0)
            ids = np.array([int(f["id"]) for f in doc["features"]], dtype=np.int64)
            coords = np.array([f["geometry"]["coordinates"] for f in doc["features"]]).reshape(-1, 2)
            if len(ids) != min(SERVE_FEATURES, len(want)) or not np.isin(ids, want).all() or \
                    not np.array_equal(coords, geom_of[ids]) or \
                    [f["properties"]["count"] for f in doc["features"]] != cnt[ids].tolist():
                raise AssertionError(f"phase 3l /features {ecql}: {len(ids)} features, not "
                                     f"{min(SERVE_FEATURES, len(want))} of numpy's rows with their values")
        for i in (0, 12):
            ecql = queries[i][0]
            st, h, data = counted("bin", lambda: get(f"/features/{name}?cql={q(ecql)}&f=bin&track=count",
                                                      kind="features bin"))
            ref = bin_ref[i]
            if st != 200 or h["Content-Type"] != "application/vnd.geomesa.bin" or data != ref or \
                    len(data) != 16 * len(exact_hits(i, 0)):
                raise AssertionError(f"phase 3l f=bin {ecql}: {len(data)} bytes != bin_export's {len(ref)}")
        dens = [("INCLUDE", WORLD, (512, 256), None), (queries[0][0], EUROPE, (256, 256), 0),
                (queries[12][0], queries[12][1], (128, 128), 12),
                (_bbox(REGIONS[1][1]), REGIONS[1][1], (256, 128), "box")]
        for ecql, env, (w, hh), sel in dens:
            doc, _ = counted("density", lambda: ok_json(
                f"/density/{name}?cql={q(ecql)}&bbox={','.join(str(v) for v in env)}&width={w}&height={hh}",
                "density"))
            if sel is None:
                rows_ = np.arange(n + m_all)
            elif sel == "box":
                rows_ = np.nonzero(np_exact(x[:n + m_all], y[:n + m_all], None, REGIONS[1][1]))[0]
            else:
                rows_ = exact_hits(sel, 0)
            keep = np.zeros(len(x), bool)
            keep[rows_] = True
            want = np_density(x, y, keep, env, (w, hh))
            if not same_grid(np.asarray(doc["counts"], np.float32), want, False):
                raise AssertionError(f"phase 3l /density {ecql}: grid != numpy")
        for i in (0, 4):
            ecql = queries[i][0]
            doc, _ = counted("stats", lambda: ok_json(f"/stats/{name}?cql={q(ecql)}&stats={q(PUSH_SPEC)}",
                                                       "stats"))
            hit = exact_hits(i, 0)
            if doc != np_stats({"count": cnt[hit], "dtg": dtg[hit]}, None)[:3]:
                raise AssertionError(f"phase 3l /stats {ecql}: {doc} != numpy")
        for (px, py), k in SERVE_KNN:
            doc, _ = ok_json(f"/knn/{name}?x={px}&y={py}&k={k}&maxRadius=2", "knn")
            rows_, d2 = np_knn(x[:n + m_all], y[:n + m_all], px, py, 2.0, k)
            ids = np.array([int(f["id"]) for f in doc["features"]], dtype=np.int64)
            dist = np.array([f["properties"]["knn_distance_deg"] for f in doc["features"]])
            if not np.array_equal(ids, rows_) or not np.array_equal(dist, np.sqrt(d2.astype(np.float64))):
                raise AssertionError(f"phase 3l /knn ({px}, {py}) k={k}: != the numpy oracle")
        st, h, text = get(f"/explain/{name}?cql={q(queries[0][0])}", kind="explain")
        if st != 200 or b"Chosen index: z3" not in text:
            raise AssertionError(f"phase 3l /explain: HTTP {st} {text[:200]!r}")
        torch.cuda.synchronize()
        counts = dict(kernels.LAUNCHES)
        # each exact /features, f=bin, filtered /density (3 of the 4: one is
        # INCLUDE) and /stats request launches the resident exact mask once,
        # with the validity plane; each /density launches the density kernel
        # once (it takes the plane as its row mask, not as a counted operand)
        want_masks = {"features": 8, "bin": 2, "density": 3, "stats": 2}
        got_masks = {k: by_kind[k]["filter_scan_mask"] for k in want_masks}
        others = {kind: {k: v for k, v in acc.items() if v and k not in ("filter_scan_mask", "density_count")}
                  for kind, acc in by_kind.items()}
        if got_masks != want_masks or by_kind["density"]["density_count"] != 4 or \
                counts["density_count"] != 4 or counts["filter_scan_mask"] != sum(want_masks.values()) or \
                kernels.VALID_LAUNCHES["filter_scan_mask"] != counts["filter_scan_mask"] or any(others.values()):
            raise AssertionError(f"phase 3l features/density: filter_scan_mask per request kind {got_masks} "
                                 f"(want {want_masks}), density_count {counts['density_count']} (want 4), "
                                 f"{kernels.VALID_LAUNCHES['filter_scan_mask']} masks with the plane, "
                                 f"other launches {others}")
        log(f"phase 3l: 8 /features (GeoJSON, maxFeatures {SERVE_FEATURES}), 2 f=bin (== bin_export), "
            f"4 /density, 2 /stats, 2 /knn == numpy, /explain; launches filter_scan_mask {got_masks} "
            f"(all with the validity plane), density_count {counts['density_count']}")
        tally(out)

        # -- the push tier: 4,096 subscriptions, 4 SSE streams and a BIN one -----------
        kernels.reset_counts()
        hub = server.pubsub
        docs = push_docs(cols["_centers"], SEED + 31)
        truth = [np_push_match(docs, app["geom"][j * LIVE_BATCH:(j + 1) * LIVE_BATCH, 0],
                               app["geom"][j * LIVE_BATCH:(j + 1) * LIVE_BATCH, 1],
                               app["count"][j * LIVE_BATCH:(j + 1) * LIVE_BATCH])
                 for j in range(SERVE_APPENDS)]
        ids: list = [None] * len(docs)
        reg_errs: list = []

        def register(k0):
            for k in range(k0, len(docs), 16):
                st, _, b = get(f"/subscribe/{name}?tenant=push{k % 16}", method="POST", body=docs[k][1],
                               kind="subscribe")
                if st != 200:
                    reg_errs.append((k, st, b[:200]))
                    return
                ids[k] = json.loads(b)["id"]

        t = time.time()
        with ThreadPoolExecutor(max_workers=16) as pool:
            list(pool.map(register, range(16)))
        reg_s = time.time() - t
        st, _, capped = get(f"/subscribe/{name}", method="POST", body={"bbox": [0, 0, 1, 1]})
        if reg_errs or None in ids or hub.registry.count(name) != len(docs) or st != 400 or \
                b"sub.max.per.type" not in capped:
            raise AssertionError(f"phase 3l push: {len(reg_errs)} failed registrations {reg_errs[:2]}, "
                                 f"{hub.registry.count(name)} registered; one more answered {st} {capped[:120]!r}")
        index = {sid: k for k, sid in enumerate(ids)}

        def area(k):
            d = docs[k][1]
            if "dwithin" in d:
                return d["dwithin"]["distance"] ** 2
            return (d["bbox"][2] - d["bbox"][0]) * (d["bbox"][3] - d["bbox"][1])

        def largest(kind, start, stop, skip=()):
            return max((k for k in range(start, stop) if docs[k][0] == kind and k not in skip), key=area)

        n0, n1, n2 = PUSH_SUBS[0][1], PUSH_SUBS[0][1] + PUSH_SUBS[1][1], len(docs) - PUSH_SUBS[3][1]
        streamed = [largest("bbox", 0, n0), largest("dwithin", n0, n1), largest("bbox+cql", n1, n2),
                    largest("bbox", n2, len(docs))]
        bin_sub = largest("bbox", 0, n0, skip=streamed)
        want = {k: [(j, truth[j][k]) for j in range(SERVE_APPENDS) if k in truth[j]]
                for k in streamed + [bin_sub]}
        if len(want[streamed[0]]) <= PUSH_RESUME_AT or any(not want[k] for k in want):
            raise AssertionError(f"phase 3l push: the streamed subscriptions match in "
                                 f"{[len(w) for w in want.values()]} of {SERVE_APPENDS} appends")
        bin_want = b"".join(np_bin(app["count"][j * LIVE_BATCH:(j + 1) * LIVE_BATCH],
                                   app["dtg"][j * LIVE_BATCH:(j + 1) * LIVE_BATCH],
                                   app["geom"][j * LIVE_BATCH:(j + 1) * LIVE_BATCH], rows)
                            for j, rows in want[bin_sub])
        readers = [_PushReader(f"{base}/subscribe/{name}?id={ids[k]}",
                               stop_after=PUSH_RESUME_AT if r == 0 else None)
                   for r, k in enumerate(streamed)]
        readers.append(_PushReader(f"{base}/subscribe/{name}?id={ids[bin_sub]}&f=bin&track=count",
                                   bin_bytes=lambda: len(bin_want)))

        def connected():
            with hub._lock:
                return sum(len(c) for c in hub._conns.values())

        deadline = time.time() + 60
        while connected() < len(readers):
            if time.time() > deadline:
                raise AssertionError(f"phase 3l push: {connected()} of {len(readers)} streams connected")
            time.sleep(0.05)
        real_match, live_calls = hub.matcher.match, []

        def spy(type_name, batch, sft):
            t0 = time.perf_counter()
            res = real_match(type_name, batch, sft)
            live_calls.append((time.perf_counter() - t0, batch.fids.copy(), res))
            return res

        hub.matcher.match = spy
        launches0, faults0 = hub.matcher.launches, hub.match_faults
        log(f"phase 3l push: {len(docs):,} subscriptions registered over HTTP in {reg_s:.1f} s "
            f"({', '.join(f'{n} {k}' for k, n in PUSH_SUBS)}; the next one refused at sub.max.per.type); "
            f"{len(readers) - 1} SSE streams and 1 f=bin stream open [{CARD}]")

        # -- 16 POST /append, each counted at once and matched -------------------------
        kernels.reset_counts()
        delta0 = metrics.stream_delta_refreshes.value(mode="delta")
        restages0 = di.restages
        sent = []  # (seq, POST sent, ack received)
        for j in range(SERVE_APPENDS):
            a, b = j * LIVE_BATCH, (j + 1) * LIVE_BATCH
            body = {"columns": {"count": app["count"][a:b].tolist(), "dtg": app["dtg"][a:b].tolist(),
                                "geom": app["geom"][a:b].tolist()}, "fids": app_fids[a:b].tolist()}
            t_sent = time.perf_counter()
            st, h, ack = get(f"/append/{name}?tenant=smoke", method="POST", body=body, kind="append")
            sent.append((json.loads(ack)["seq"] if st == 200 else None, t_sent, time.perf_counter()))
            if st != 200 or json.loads(ack)["acked"] != LIVE_BATCH:
                raise AssertionError(f"phase 3l /append {j}: HTTP {st} {ack[:200]!r}")
            i = j % len(queries)
            got, _ = ok_json(f"/count/{name}?cql={q(queries[i][0])}", "count after append")
            if got["count"] != len(exact_hits(i, b)):
                raise AssertionError(f"phase 3l append {j}: /count {got['count']} != numpy "
                                     f"{len(exact_hits(i, b))}")
        deltas = metrics.stream_delta_refreshes.value(mode="delta") - delta0
        if deltas != SERVE_APPENDS or di.restages != restages0 or handler._resident_cache[name] is not di:
            raise AssertionError(f"phase 3l: {deltas} delta refreshes for {SERVE_APPENDS} appends, "
                                 f"restages {restages0} -> {di.restages}")
        log(f"phase 3l: {SERVE_APPENDS} POST /append of {LIVE_BATCH:,} rows each visible at once to "
            f"/count (== numpy); {int(deltas)} refresh_delta 'delta', no restage")
        tally(out)
        push = check_push_tier(base, name, get, hub, docs, ids, index, truth, want, streamed, bin_sub,
                               bin_want, readers, sent, live_calls, launches0, faults0, app_fids)
        hub.matcher.match = real_match

        # -- burst: fused loose counts --------------------------------------------------
        kernels.reset_counts()
        snap0 = json.loads(get("/stats/sched")[2])
        nthreads, per = SERVE_BURST
        tiles = list(range(per))
        tile_want = [loose_want(i, m_app) for i in tiles]
        bad, codes = [], []

        def burst_client(tid):
            for j in range(per):
                i = tiles[(tid + j) % per]
                st, _, b = get(f"/count/{name}?cql={q(queries[i][0])}&loose=1&tenant=burst{tid % 8}",
                               kind="burst count loose")
                codes.append(st)
                if st != 200 or json.loads(b)["count"] != tile_want[i]:
                    bad.append((i, st, b[:100]))

        threads = [threading.Thread(target=burst_client, args=(t_,), name=f"burst-{t_}")
                   for t_ in range(nthreads)]
        t = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
        burst_s = time.perf_counter() - t
        snap1 = json.loads(get("/stats/sched")[2])
        fused = (snap1["queries"] - snap0["queries"]) / max(snap1["launches"] - snap0["launches"], 1)
        torch.cuda.synchronize()
        counts = dict(kernels.LAUNCHES)
        if bad or any(th.is_alive() for th in threads) or fused <= 1.0 or \
                not counts["dimscan_batched_z3_count"] or snap1["fusion_factor"] <= 1.0:
            raise AssertionError(f"phase 3l burst: {len(bad)} wrong {bad[:3]}, fusion {fused:.2f} "
                                 f"(cumulative {snap1['fusion_factor']}), batched launches "
                                 f"{counts['dimscan_batched_z3_count']}")
        burst_rps = nthreads * per / burst_s
        log(f"phase 3l: burst of {nthreads} threads x {per} loose counts in {burst_s:.3f} s "
            f"({burst_rps:.1f} requests/s), all == numpy; fusion factor {fused:.2f} this burst, "
            f"{snap1['fusion_factor']} cumulative; dimscan_batched_z3_count "
            f"{counts['dimscan_batched_z3_count']} (widths {kernels.BATCH_WIDTHS['dimscan_batched_z3_count']}) "
            f"[{CARD}]")
        tally(out)

        # -- shed: the same clients against sched.max.queue 2 ------------------------------
        kernels.reset_counts()
        sched = server.scheduler
        cfg0 = sched.config
        sched.config = dataclasses.replace(cfg0, max_queue=2)
        shed, wrong, retry_after = [], [], []
        try:
            nthreads, per = SERVE_SHED

            def shed_client(tid):
                for j in range(per):
                    i = (tid + j) % len(queries)
                    st, h, b = get(f"/count/{name}?cql={q(queries[i][0])}", kind="shed burst")
                    if st == 429:
                        shed.append(i)
                        retry_after.append(h.get("Retry-After"))
                    elif st != 200 or json.loads(b)["count"] != len(exact_hits(i, m_app)):
                        wrong.append((i, st))

            threads = [threading.Thread(target=shed_client, args=(t_,)) for t_ in range(nthreads)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=300)
        finally:
            sched.config = cfg0
        if wrong or not shed or not all(r is not None and r.isdigit() and int(r) >= 1 for r in retry_after):
            raise AssertionError(f"phase 3l shed burst: {len(shed)} 429s (Retry-After "
                                 f"{sorted(set(retry_after))}), {len(wrong)} wrong {wrong[:3]}")
        log(f"phase 3l: {nthreads} x {per} exact counts against sched.max.queue 2: {len(shed)} answered "
            f"429 with Retry-After {sorted(set(retry_after))}, the rest == numpy")
        tally(out)

        # -- the degradation ladder ----------------------------------------------------------
        # fail.resident.launch fails the resident rung alone: the store rung
        # must answer on the card, through the filter-scan kernel (a store on
        # the card has no host rung; its launches read no validity plane)
        kernels.reset_counts()
        ladder, rung = [], []
        with prop_override("resilience.backoff.ms", 0.0), prop_override("resilience.breaker.failures", 3), \
                prop_override("resilience.breaker.cooldown.s", 600.0):
            with failpoints.failpoint_override("fail.resident.launch", "raise"):
                for i in range(8):
                    before = dict(kernels.LAUNCHES)
                    got, h = ok_json(f"/count/{name}?cql={q(queries[i][0])}", "count degraded")
                    if got["count"] != len(exact_hits(i, m_app)):
                        raise AssertionError(f"phase 3l degraded /count {i}: {got['count']} != numpy")
                    ladder.append(h.get("X-Degraded") or "")
                    rung.append({k: kernels.LAUNCHES[k] - before[k] for k in kernels.KERNEL_NAMES
                                 if kernels.LAUNCHES[k] != before[k]})
                ready, _ = ok_json("/readyz", None)
            store_masks = [r.get("filter_scan_mask", 0) for r in rung]
            if not ladder[0].startswith("device-launch-failed") or \
                    not any(r.startswith("device-breaker-open") for r in ladder) or \
                    ready["breakers"]["device"]["state"] != "open" or "device" not in ready["degraded_domains"]:
                raise AssertionError(f"phase 3l ladder: X-Degraded {ladder}, /readyz {ready}")
            if any(set(r) - {"filter_scan_mask"} for r in rung) or sum(store_masks) < len(rung) or \
                    kernels.VALID_LAUNCHES["filter_scan_mask"]:
                raise AssertionError(f"phase 3l ladder: launches per degraded request {rung}, "
                                     f"{kernels.VALID_LAUNCHES['filter_scan_mask']} with a validity plane; "
                                     f"the store rung's filter-scan launches only, at least one a request")
            # the breaker reads its cooldown on every use: at 0 the next
            # request is the half-open probe
            with prop_override("resilience.breaker.cooldown.s", 0.0):
                got, h = ok_json(f"/count/{name}?cql={q(queries[9][0])}", "count probe")
            ready2, _ = ok_json("/readyz", None)
            if got["count"] != len(exact_hits(9, m_app)) or h.get("X-Degraded") or \
                    ready2["breakers"]["device"]["state"] != "closed" or ready2["degraded_domains"]:
                raise AssertionError(f"phase 3l: the probe after the disarm: {h.get('X-Degraded')}, "
                                     f"/readyz {ready2}")
        log(f"phase 3l: fail.resident.launch over 8 /count: answers == numpy from the store rung on the "
            f"card (filter_scan_mask per request {store_masks}, no resident launch), X-Degraded {ladder}; "
            f"/readyz device open; disarmed, the half-open probe closed it (/readyz ready, no domain "
            f"degraded)")
        tally(out)

        # -- metrics, ledger, a trace ------------------------------------------------------
        st, h, text = get("/metrics")
        fams = set()
        for line in text.decode().splitlines():
            if line.startswith("# TYPE "):
                fams.add(line.split()[2])
            elif line and not line.startswith("#"):
                float(line.rsplit(" ", 1)[1])
        if st != 200 or not {"geomesa_slo_latency_seconds", "geomesa_sched_queries_total",
                             "geomesa_stream_appends_total"} <= fams:
            raise AssertionError(f"phase 3l /metrics: HTTP {st}, families {sorted(fams)[:10]}")
        led, _ = ok_json("/stats/ledger?limit=5", None)
        smoke = led["tenants"].get("smoke", {}).get("cost", {})
        if not (smoke.get("device_launches", 0) > 0 and smoke.get("device_seconds", 0) > 0):
            raise AssertionError(f"phase 3l /stats/ledger: tenant smoke {smoke}")
        rid = "phase-3l-trace"
        ok_json(f"/count/{name}?cql={q(queries[0][0])}", None, {"X-Request-Id": rid})
        perf, _ = ok_json(f"/debug/traces/{rid}?format=perfetto", None)
        names = {e["name"] for e in perf["traceEvents"] if e["ph"] == "X"}
        if perf["otherData"]["trace_id"] != rid or f"GET /count/{name}" not in names:
            raise AssertionError(f"phase 3l perfetto trace: {sorted(names)}")
        log(f"phase 3l: /metrics {len(fams)} families parsed; /stats/ledger tenant smoke "
            f"{int(smoke['device_launches'])} device launches, {smoke['device_seconds']:.4f} s; the "
            f"trace {rid} loads as Perfetto ({len(perf['traceEvents'])} events: {sorted(names)})")

        # -- drain, then a reopen that replays ------------------------------------------------
        st, _, b = get("/admin/shutdown", method="POST", body={})
        if st != 200 or json.loads(b) != {"draining": True}:
            raise AssertionError(f"phase 3l /admin/shutdown: HTTP {st} {b!r}")
        thread.join(timeout=60)
        if thread.is_alive() or not server.draining.is_set():
            raise AssertionError("phase 3l: the server did not drain")
        server.server_close()
        server = None
        del di
        handler._resident_cache.clear()
        replay0 = metrics.stream_wal_replay_rows.value()
        again = StreamingStore(DataStoreFinder.get_data_store({"fs.path": root}))
        again._compact_due = lambda ts: False
        replayed = int(metrics.stream_wal_replay_rows.value() - replay0)
        total = again.count(name, "INCLUDE")
        c0 = again.count(name, queries[0][0])
        again.close(compact=False)
        tail = (LIVE_TAIL + 1) * LIVE_BATCH
        if replayed != tail + m_app or total != n + m_all + m_app or c0 != len(exact_hits(0, m_app)):
            raise AssertionError(f"phase 3l reopen: replayed {replayed} rows (want {tail + m_app}), "
                                 f"INCLUDE {total} (want {n + m_all + m_app}), query 0 {c0}")
        log(f"phase 3l: POST /admin/shutdown drained; a reopen replayed {replayed:,} rows (3k's tail and "
            f"the {m_app:,} appended), {total:,} rows, query 0 == numpy")
        summary = {"rows": n + m_all + m_app, "card": CARD, "stage_s": stage_s, "burst_rps": burst_rps,
                   "push": push,
                   "burst": SERVE_BURST, "shed_429": len(shed), "ladder": ladder,
                   "seconds": time.time() - t_phase,
                   "latency": {k: {"p50_ms": pct(v, 50), "p99_ms": pct(v, 99), "n": len(v)}
                               for k, v in lat.items()}}
        for k, v in lat.items():
            log(f"latency serve {k}: p50 {pct(v, 50):.3f} ms  p99 {pct(v, 99):.3f} ms ({len(v)} requests) "
                f"[{CARD}]")
        log(json.dumps({"server": summary}))
        return out
    finally:
        for r in readers:
            r.stop(timeout=5.0)
        if server is not None:
            server.shutdown()
            server.server_close()
        for cm in reversed(settings):
            cm.__exit__(None, None, None)


# -- phase 3b: per-request visibility -----------------------------------------

LABELS = ["", "A", "B", "A&B", "A|C", "(A|B)&C"]
VERDICTS = {  # auths -> whether each of LABELS is visible, written out by hand
    None: [True, False, False, False, False, False],
    ("A",): [True, True, False, False, True, False],
    ("A", "B", "C"): [True, True, True, True, True, True],
}
N_LABELED = 1 << 22  # phase 3i writes as many labeled rows through the store
# kNN on the labeled index, (target, k, base filter): phase 3's city centres
LABELED_KNN = [((2.3515625, 48.859375), 100, None), ((-73.96875, 40.78125), 1000, "count > 500")]


def run_labeled_path(dev, queries):
    """Stage a labeled Z3 index and drive count, query, density, a Count()
    stat, kNN and a BIN request (``resident_bin``: the rider declines a
    labeled staging, the twin answers) under each auth set of VERDICTS;
    check with numpy."""
    import torch

    from geomesa_tpu_torch import kernels
    from geomesa_tpu_torch.device_cache import VIS_ID, DeviceIndex
    from geomesa_tpu_torch.features.batch import VIS_COLUMN, FeatureBatch
    from geomesa_tpu_torch.features.sft import SimpleFeatureType
    from geomesa_tpu_torch.filter.ecql import parse_ecql
    from geomesa_tpu_torch.geom import Envelope
    from geomesa_tpu_torch.results.binrider import resident_bin
    from geomesa_tpu_torch.store.direct import BatchStore

    t = time.time()
    cols = make_columns(N_LABELED, SEED + 3)
    lab = np.random.default_rng(SEED + 4).integers(0, len(LABELS), N_LABELED)
    data = {k: cols[k] for k in ("count", "dtg", "geom")}
    data[VIS_COLUMN] = np.array(LABELS, dtype=object)[lab]
    batch = FeatureBatch.from_columns(SimpleFeatureType.create("gdelt", GDELT_SPEC), data)
    gen = time.time() - t
    t = time.time()
    di = DeviceIndex(BatchStore(batch), "gdelt", z_planes=True, device=dev)
    torch.cuda.synchronize()
    log(f"phase 3b: generated {N_LABELED:,} labeled rows in {gen:.1f} s; staged in "
        f"{time.time() - t:.1f} s (label vocabulary {len(di._vis_vocab)}, "
        f"{di.nbytes / 1e9:.3f} GB resident)")
    if VIS_ID not in di._cols:
        raise AssertionError("the labeled index staged no label-id plane")
    europe, eb, ew = queries[0]
    kernels.reset_counts()
    res = {}
    for auths in VERDICTS:
        res[auths] = (
            di.count(europe, loose=True, auths=auths),
            di.count(europe, auths=auths),
            di.query(europe, auths=auths).fids,
            di.query(europe, loose=True, auths=auths).fids,
            di.density(europe, Envelope(*EUROPE), 256, 256, auths=auths),
            di.density("INCLUDE", Envelope(*WORLD), 512, 256, auths=auths),
            di.stats(europe, "Count()", auths=auths).to_json()[0]["count"],
            [di.knn(*target, kk, query=base, auths=auths) for target, kk, base in LABELED_KNN],
            resident_bin(di, europe, "count", auths=auths),  # labeled: the host twin
        )
    k = len(VERDICTS)
    launches = read_launches("labeled path", {
        "dimscan_z3_mask": 2 * k, "density_count": 2 * k,
        "filter_scan_mask": (5 + sum(b is not None for _, _, b in LABELED_KNN)) * k,
    })
    if di.bin_rider(europe, "count") is not None:
        raise AssertionError("the BIN rider served a labeled staging")
    t = time.time()
    x = cols["geom"][:, 0].astype(np.float32)
    y = cols["geom"][:, 1].astype(np.float32)
    em = np_exact(x, y, cols["dtg"], eb, ew)
    lm = np_loose(di._loose_bounds(parse_ecql(europe))[1], host_z3_planes(cols))
    for auths, (c_loose, c_exact, f_exact, f_loose, g_eu, g_all, n_stat, nn, bins) in res.items():
        seen = np.asarray(VERDICTS[auths])[lab]
        if bins != np_bin(cols["count"], cols["dtg"], cols["geom"], em & seen):
            raise AssertionError(f"labeled {auths}: resident_bin (the twin) != numpy")
        for (target, kk, base), got in zip(LABELED_KNN, nn):
            keep = seen if base is None else seen & (cols["count"] > 500)
            check_knn(f"labeled kNN {auths} {target} k={kk} {base}", got,
                      np_knn(x, y, *target, 45.0, kk, keep))
        ex, lo = em & seen, lm & seen
        if c_exact != int(ex.sum()) or n_stat != c_exact or c_loose != int(lo.sum()):
            raise AssertionError(f"labeled {auths}: counts {c_exact}/{n_stat}/{c_loose} != numpy")
        if not (np.array_equal(np.sort(f_exact), np.nonzero(ex)[0])
                and np.array_equal(np.sort(f_loose), np.nonzero(lo)[0])):
            raise AssertionError(f"labeled {auths}: fid sets != numpy")
        if not (same_grid(g_eu, np_density(x, y, ex, EUROPE, (256, 256)), False)
                and same_grid(g_all, np_density(x, y, seen, WORLD, (512, 256)), False)):
            raise AssertionError(f"labeled {auths}: density grid != numpy")
        log(f"labeled auths={auths}: exact {c_exact}, loose {c_loose}, "
            f"visible rows {int(seen.sum())}, kNN rows {[len(r[0]) for r in nn]}")
    log(f"checked the labeled path against numpy in {time.time() - t:.1f} s")
    return launches


# -- phase 3d: the xz path (non-point footprints) ------------------------------

XZ2_SPEC = "name:String,count:Int,*geom:Polygon:srid=4326"
XZ3_SPEC = "name:String,count:Int,dtg:Date,*geom:Polygon:srid=4326"
XZ_N2 = 1 << 21  # xz2 footprints: about the OSM buildings of one large metro region
XZ_N3 = 1 << 20  # xz3: the first 2^20 of them, with dates
XZ_LABELED = 1 << 20
M_PER_DEG = 111_320.0
WORLD_DAYS = 60


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _f32(a) -> np.ndarray:
    return np.asarray(a, np.float64).astype(np.float32).astype(np.float64)


def _q(v: float) -> float:
    """A query constant on a 2^-12 grid: exact in float32."""
    return round(v * 4096.0) / 4096.0


def make_footprints(n: int, seed: int) -> np.ndarray:
    """n OSM-building-shaped footprints as an object array of geometries:
    85% closed 4-to-12-vertex polygons, 10% polygons with one hole, 5%
    two-part MultiPolygons, 5-60 m across; 90% in the 64 city clusters of
    phase 3 (sigma 0.2 deg), the rest uniform over land latitudes
    (-56 .. 72); coordinates exact in float32."""
    from geomesa_tpu_torch.geom import MultiPolygon, Polygon

    rng = np.random.default_rng(seed)
    crng = np.random.default_rng(SEED)  # phase 3's city centres
    cx, cy = crng.uniform(-170.0, 170.0, 64), crng.uniform(-60.0, 70.0, 64)
    cid = rng.integers(0, 64, n)
    x = cx[cid] + rng.normal(0.0, 0.2, n)
    y = cy[cid] + rng.normal(0.0, 0.2, n)
    uni = rng.random(n) >= 0.9
    x[uni] = rng.uniform(-180.0, 180.0, int(uni.sum()))
    y[uni] = rng.uniform(-56.0, 72.0, int(uni.sum()))
    x, y = np.clip(x, -179.99, 179.99), np.clip(y, -89.99, 89.99)
    half = rng.uniform(5.0, 60.0, n) / M_PER_DEG / 2  # half the width, degrees
    kind = rng.choice(3, n, p=[0.85, 0.10, 0.05])
    nv = np.where(kind == 2, 4, rng.integers(4, 13, n))
    out = np.empty(n, dtype=object)
    for k in range(4, 13):
        idx = np.nonzero(nv == k)[0]
        if not len(idx):
            continue
        a = np.sort(rng.uniform(0.0, 2 * np.pi, (len(idx), k)), axis=1)
        r = half[idx, None] * rng.uniform(0.7, 1.0, (len(idx), k))
        ring = np.empty((len(idx), k + 1, 2))
        ring[:, :k, 0] = _f32(x[idx, None] + r * np.cos(a))
        ring[:, :k, 1] = _f32(y[idx, None] + r * np.sin(a))
        ring[:, k] = ring[:, 0]
        for j, i in enumerate(idx.tolist()):
            if kind[i] == 0:
                out[i] = Polygon(ring[j])
            elif kind[i] == 1:
                h = half[i] * 0.2
                hole = _f32([[x[i] - h, y[i] - h], [x[i] + h, y[i] - h], [x[i] + h, y[i] + h],
                             [x[i] - h, y[i] + h], [x[i] - h, y[i] - h]])
                out[i] = Polygon(ring[j], (hole,))
            else:
                second = ring[j].copy()
                second[:, 0] = _f32(second[:, 0] + 3 * half[i])
                out[i] = MultiPolygon((Polygon(ring[j]), Polygon(second)))
    return out


def _wkt_ring(pts) -> str:
    return "(" + ", ".join(f"{float(a)!r} {float(b)!r}" for a, b in pts) + ")"


def xz_traffic(geoms) -> dict:
    """The requests of a map client over a footprint layer: 16 BBOX windows
    from a city block (0.005 deg) to a country (10 deg), the same windows
    AND DURING of 1 to 21 days for xz3, 4 INTERSECTS with a district ring
    of 32-64 vertices, 2 DWITHIN (around a point and around a polygon),
    2 BBOX AND TOUCHES and 1 BBOX AND RELATE."""
    crng = np.random.default_rng(SEED)
    cx, cy = crng.uniform(-170.0, 170.0, 64), crng.uniform(-60.0, 70.0, 64)
    boxes = []
    for i, s in enumerate(np.geomspace(0.005, 10.0, 16)):
        c = (cx[i % 64], cy[i % 64])
        boxes.append(tuple(_q(v) for v in (max(c[0] - s / 2, -180), max(c[1] - s / 2, -90),
                                            min(c[0] + s / 2, 180), min(c[1] + s / 2, 90))))
    days = [1, 2, 3, 5, 7, 10, 14, 21]
    starts = [(3 * i) % (WORLD_DAYS - 22) for i in range(16)]
    windows = [(s, s + days[i % len(days)]) for i, s in enumerate(starts)]
    bbox = [f"BBOX(geom, {b[0]!r}, {b[1]!r}, {b[2]!r}, {b[3]!r})" for b in boxes]
    during = [f"{q} AND dtg DURING {_day(w[0])}/{_day(w[1])}" for q, w in zip(bbox, windows)]
    rings = []
    for i in range(4):
        k = 32 + 10 * i
        a = np.linspace(0.0, 2 * np.pi, k, endpoint=False)
        r = (0.01 + 0.007 * i) * (1.0 + 0.25 * np.sin(3 * a))
        pts = np.stack([cx[i] + r * np.cos(a), cy[i] + r * np.sin(a)], axis=1)
        rings.append("POLYGON (" + _wkt_ring(np.vstack([pts, pts[:1]])) + ")")
    intersects = [f"INTERSECTS(geom, {r})" for r in rings]
    dwithin = [f"DWITHIN(geom, POINT({float(cx[5])!r} {float(cy[5])!r}), 2, kilometers)",
               f"DWITHIN(geom, {rings[1]}, 300, meters)"]
    from geomesa_tpu_torch.geom import Polygon

    relations = []
    plain = [g for g in geoms[:64] if isinstance(g, Polygon) and not g.holes][:2]
    for g in plain:  # a triangle sharing the footprint's eastmost vertex, outside it
        v = g.shell[np.argmax(g.shell[:, 0])]
        d = 1e-3
        tri = [v, (v[0] + d, v[1] + d / 2), (v[0] + d, v[1] - d / 2), v]
        box = (_q(v[0] - 0.01), _q(v[1] - 0.01), _q(v[0] + 0.01), _q(v[1] + 0.01))
        relations.append(f"BBOX(geom, {box[0]!r}, {box[1]!r}, {box[2]!r}, {box[3]!r}) AND "
                         f"TOUCHES(geom, POLYGON ({_wkt_ring(tri)}))")
    relations.append(f"{bbox[3]} AND RELATE(geom, {rings[0]}, 'T*T***T**')")
    return {"boxes": boxes, "windows": windows, "bbox": bbox, "during": during,
            "intersects": intersects, "dwithin": dwithin, "relations": relations}


def np_env_bbox(planes, b):
    """numpy envelope overlap over float32 envelope planes, the bounds
    rounded to float32 as the filter compiles them."""
    x0, y0, x1, y1 = planes
    return ((x1 >= np.float32(b[0])) & (x0 <= np.float32(b[2]))
            & (y1 >= np.float32(b[1])) & (y0 <= np.float32(b[3])))


def np_xz_loose(codes, bins, lb) -> np.ndarray:
    """numpy range cover of host-encoded xz codes for a loose bounds entry
    ("xz", bounds, ids, fns): a row matches when its bin has an entry (ids
    >= 0; None for xz2) and its code lies in one of that entry's ranges."""
    _, bounds, ids, _ = lb

    def cover(c, b):
        b = np.asarray(b, np.uint64).reshape(-1, 4)
        lo = (b[:, 0] << np.uint64(32)) | b[:, 1]
        hi = (b[:, 2] << np.uint64(32)) | b[:, 3]
        m = np.zeros(len(c), bool)
        for a, z in zip(lo[lo <= hi], hi[lo <= hi]):
            m |= (c >= a) & (c <= z)
        return m

    if ids is None:
        return cover(codes, bounds)
    m = np.zeros(len(codes), bool)
    for e, b in enumerate(ids.tolist()):
        if b >= 0:
            sel = bins == b
            m[sel] = cover(codes[sel], bounds[e])
    return m


class Calls:
    """Latencies per call kind, and the launches each call must cause, by
    kernel (xz path: a count with no host residual, one count kernel;
    every other exact count, mask, query or stats call, one mask kernel; a
    loose call on xz keys, none: the range masks are torch ops)."""

    def __init__(self):
        self.lat: dict = {}
        self.want: dict = {}

    def run(self, kind, fn, *launches):
        t = time.perf_counter()
        out = fn()
        self.lat.setdefault(kind, []).append(time.perf_counter() - t)
        for name in filter(None, launches):
            self.want[name] = self.want.get(name, 0) + 1
        return out

    def log_latency(self, tag: str) -> None:
        for kind, v in self.lat.items():
            log(f"latency {tag} {kind}: p50 {pct(v, 50):.3f} ms  p99 {pct(v, 99):.3f} ms "
                f"({len(v)} calls) [{CARD}]")


def _drive_xz(di, queries, calls: Calls, tag: str) -> dict:
    """count/mask/query, loose and exact, for bbox(+during) filters the
    key planes answer; every loose one must take the xz range masks."""
    from geomesa_tpu_torch.filter.ecql import parse_ecql

    out = {}
    for q in queries:
        lb = di._loose_bounds(parse_ecql(q))
        if lb is None or lb[0] != "xz":
            raise AssertionError(f"{tag} {q}: the xz key planes did not answer loose")
        out[q] = {
            "count_loose": calls.run("count_loose", lambda: di.count(q, loose=True)),
            "count_exact": calls.run("count_exact", lambda: di.count(q), "filter_scan_count"),
            "mask_loose": calls.run("mask_loose", lambda: di.mask(q, loose=True)),
            "mask_exact": calls.run("mask_exact", lambda: di.mask(q), "filter_scan_mask"),
            "query_loose": calls.run("query_loose", lambda: di.query(q, loose=True).fids),
            "query_exact": calls.run("query_exact", lambda: di.query(q).fids, "filter_scan_mask"),
            "lb": lb,
        }
    return out


def _check_xz(tag, di, res, planes, codes, bins, dtg=None) -> list:
    """Loose answers against the numpy range cover of host codes, exact
    ones against numpy over the float32 envelope planes; loose covers
    exact. Returns (exact, loose) hit counts."""
    from geomesa_tpu_torch.filter import ast
    from geomesa_tpu_torch.filter.ecql import parse_ecql

    hits = []
    for q, r in res.items():
        f = parse_ecql(q)
        parts = f.children if isinstance(f, ast.And) else (f,)
        b = next(p for p in parts if isinstance(p, ast.BBox))
        em = np_env_bbox(planes, (b.xmin, b.ymin, b.xmax, b.ymax))
        d = next((p for p in parts if isinstance(p, ast.During)), None)
        if d is not None:
            em &= (dtg >= d.t0) & (dtg <= d.t1)
        lm = np_xz_loose(codes, bins, r["lb"])
        if r["count_exact"] != int(em.sum()) or not np.array_equal(r["mask_exact"], em):
            raise AssertionError(f"{tag} {q}: exact answer != numpy over the envelope planes")
        if not np.array_equal(np.sort(r["query_exact"]), np.nonzero(em)[0]):
            raise AssertionError(f"{tag} {q}: exact fid set != numpy")
        if r["count_loose"] != int(lm.sum()) or not np.array_equal(r["mask_loose"], lm):
            raise AssertionError(f"{tag} {q}: loose answer != numpy over host codes")
        if not np.array_equal(np.sort(r["query_loose"]), np.nonzero(lm)[0]):
            raise AssertionError(f"{tag} {q}: loose fid set != numpy")
        if np.any(em & ~lm):
            raise AssertionError(f"{tag} {q}: loose does not cover exact")
        hits.append((int(em.sum()), int(lm.sum())))
    return hits


def _host_keys(di, batch, tag):
    """The staged xz keys against the port's numpy XZ2SFC/XZ3SFC.index
    over the float64 envelopes; returns the host codes (uint64) and bins."""
    import torch

    from geomesa_tpu_torch.device_cache import Z_BIN, Z_HI, Z_LO, _z_planes_np

    kind, host, bins = _z_planes_np(batch, di.sft)
    if kind != di._z_kind:
        raise AssertionError(f"{tag}: staged kind {di._z_kind} != {kind}")
    for name, want in host.items():
        got = di._cols[name].view(torch.int32).cpu().numpy().view(want.dtype)
        if not np.array_equal(got, want):
            raise AssertionError(f"{tag}: staged {name} != the host XZ index")
    codes = (host[Z_HI].astype(np.uint64) << np.uint64(32)) | host[Z_LO].astype(np.uint64)
    return codes, (None if Z_BIN not in host else host[Z_BIN])


def _env_planes_np(di):
    return tuple(di._cols[f"geom__{s}"].cpu().numpy() for s in ("x0", "y0", "x1", "y1"))


def run_xz_path(dev, n2: int = XZ_N2, n3: int = XZ_N3, n_lab: int = XZ_LABELED) -> dict:
    """Phase 3d: stage footprints as xz2 and xz3, drive the map-client
    traffic through the public entry points, check every answer, and
    return what phase 4 times."""
    from geomesa_tpu_torch import kernels
    from geomesa_tpu_torch.device_cache import VIS_ID, DeviceIndex
    from geomesa_tpu_torch.features.batch import VIS_COLUMN, FeatureBatch
    from geomesa_tpu_torch.features.sft import SimpleFeatureType
    from geomesa_tpu_torch.filter import ast
    from geomesa_tpu_torch.filter.compile import evaluate_host
    from geomesa_tpu_torch.filter.ecql import parse_ecql
    from geomesa_tpu_torch.store.direct import BatchStore

    t = time.time()
    geoms = make_footprints(n2, SEED + 7)
    t_build = time.time() - t
    rng = np.random.default_rng(SEED + 8)
    count = rng.integers(0, 1000, n2).astype(np.int32)
    dtg = rng.integers(T0, T0 + WORLD_DAYS * DAY, n3)
    names = np.array(["building"] * n2, dtype=object)
    sft2, sft3 = SimpleFeatureType.create("osm", XZ2_SPEC), SimpleFeatureType.create("osm3", XZ3_SPEC)
    b2 = FeatureBatch.from_columns(sft2, {"name": names, "count": count, "geom": geoms})
    b3 = FeatureBatch.from_columns(sft3, {"name": names[:n3], "count": count[:n3], "dtg": dtg,
                                          "geom": geoms[:n3]})
    t = time.time()
    b2.bboxes()
    b3.bboxes()
    t_env = time.time() - t
    t = time.time()
    di2 = DeviceIndex(BatchStore(b2), "osm", z_planes=True, device=dev)
    _sync(dev)
    t_stage2 = time.time() - t
    t = time.time()
    di3 = DeviceIndex(BatchStore(b3), "osm3", z_planes=True, device=dev)
    _sync(dev)
    t_stage3 = time.time() - t
    if di2._z_kind != "xz2" or di3._z_kind != "xz3":
        raise AssertionError(f"staged kinds {di2._z_kind}/{di3._z_kind}, not xz2/xz3")
    log(f"phase 3d: built {n2:,} footprint geometries in {t_build:.1f} s; envelopes of "
        f"{n2 + n3:,} rows in {t_env:.1f} s; staged (upload + card key encode) xz2 in "
        f"{t_stage2:.2f} s ({di2.nbytes / 1e9:.3f} GB resident), xz3 ({n3:,} rows) in "
        f"{t_stage3:.2f} s ({di3.nbytes / 1e9:.3f} GB resident)")

    traffic = xz_traffic(geoms)
    calls = Calls()
    kernels.reset_counts()
    res2 = _drive_xz(di2, traffic["bbox"], calls, "xz2")
    res3 = _drive_xz(di3, traffic["during"], calls, "xz3")
    residual = {}
    for q in traffic["intersects"] + traffic["relations"]:
        residual[q] = (calls.run("residual_count", lambda: di2.count(q), "filter_scan_mask"),
                       calls.run("residual_query", lambda: di2.query(q).fids, "filter_scan_mask"))
    dw = {q: (calls.run("count_exact", lambda: di2.count(q), "filter_scan_count"),
              calls.run("mask_exact", lambda: di2.mask(q), "filter_scan_mask"),
              calls.run("query_exact", lambda: di2.query(q).fids, "filter_scan_mask"))
          for q in traffic["dwithin"]}
    spec = 'Count();MinMax("count")'
    stat_q = traffic["bbox"][8]
    stats = {}
    for loose in (True, False):
        for di, q in ((di2, stat_q), (di3, traffic["during"][8])):
            stats[(di._z_kind, loose)] = calls.run(
                "stats", lambda: di.stats(q, spec, loose=loose).to_json(),
                None if loose else "filter_scan_mask")
    launches = read_launches("xz path", calls.want)
    calls.log_latency("xz")

    # -- checks ---------------------------------------------------------------
    t = time.time()
    codes2, _ = _host_keys(di2, b2, "xz2")
    codes3, bins3 = _host_keys(di3, b3, "xz3")
    p2, p3 = _env_planes_np(di2), _env_planes_np(di3)
    h2 = _check_xz("xz2", di2, res2, p2, codes2, None)
    h3 = _check_xz("xz3", di3, res3, p3, codes3, bins3, dtg)
    for q, (c, fids) in residual.items():
        f = parse_ecql(q)
        if isinstance(f, ast.And):  # BBOX AND relation: the host runs on the bbox rows
            cand = np.nonzero(evaluate_host(f.children[0], b2))[0]
            want = cand[evaluate_host(f, b2.take(cand))]
        else:
            want = np.nonzero(evaluate_host(f, b2))[0]
        if c != len(want) or not np.array_equal(np.sort(fids), want):
            raise AssertionError(f"xz2 {q[:60]}: residual answer != evaluate_host")
        log(f"xz2 residual {q[:48]}...: {c} rows")
    for q, (c, m, fids) in dw.items():
        f = parse_ecql(q)
        e, d = f.geometry.envelope, f.distance
        em = np_env_bbox(p2, (e.xmin - d, e.ymin - d, e.xmax + d, e.ymax + d))
        if c != int(em.sum()) or not np.array_equal(m, em) or not np.array_equal(np.sort(fids), np.nonzero(em)[0]):
            raise AssertionError(f"xz2 {q[:60]}: dwithin != numpy over the envelope planes")
        log(f"xz2 {q[:40]}...: {c} rows")
    for (kind, loose), js in stats.items():
        di, res, planes = (di2, res2, p2) if kind == "xz2" else (di3, res3, p3)
        q = stat_q if kind == "xz2" else traffic["during"][8]
        m = res[q]["mask_loose" if loose else "mask_exact"]
        cnt = di._cols["count"].cpu().numpy()[m]
        want = (int(m.sum()), int(cnt.min()) if len(cnt) else None,
                int(cnt.max()) if len(cnt) else None)
        if (js[0]["count"], js[1]["min"], js[1]["max"]) != want:
            raise AssertionError(f"{kind} stats loose={loose}: {js} != numpy {want}")
    # from_planes over the same resident state
    for di, b, qs in ((di2, b2, traffic["bbox"][:4]), (di3, b3, traffic["during"][:4])):
        fdi = DeviceIndex.from_planes(di.sft, b, dict(di._cols), None, di._bin_range, device=dev)
        for q in qs:
            for loose in (True, False):
                if not np.array_equal(fdi.mask(q, loose=loose), di.mask(q, loose=loose)):
                    raise AssertionError(f"from_planes {di._z_kind} {q}: answers differ")
    ex2 = [h[0] for h in h2]
    log(f"checked the xz path in {time.time() - t:.1f} s: xz2 exact hits "
        f"min/median/max {min(ex2)}/{int(np.median(ex2))}/{max(ex2)}, loose/exact overscan "
        f"median xz2 {np.median([lo / max(e, 1) for e, lo in h2]):.3f}, xz3 "
        f"{np.median([lo / max(e, 1) for e, lo in h3]):.3f}")

    # -- a labeled xz2 index under the auth sets of phase 3b -------------------
    t = time.time()
    lab = np.random.default_rng(SEED + 9).integers(0, len(LABELS), n_lab)
    lb_batch = FeatureBatch.from_columns(sft2, {
        "name": names[:n_lab], "count": count[:n_lab], "geom": geoms[:n_lab],
        VIS_COLUMN: np.array(LABELS, dtype=object)[lab]})
    ldi = DeviceIndex(BatchStore(lb_batch), "osm", z_planes=True, device=dev)
    _sync(dev)
    if VIS_ID not in ldi._cols:
        raise AssertionError("the labeled xz2 index staged no label-id plane")
    q = traffic["bbox"][9]
    lf = parse_ecql(q)
    lcalls = Calls()
    kernels.reset_counts()
    lres = {a: (lcalls.run("count_loose", lambda: ldi.count(q, loose=True, auths=a)),
                lcalls.run("count_exact", lambda: ldi.count(q, auths=a), "filter_scan_mask"),
                lcalls.run("query_exact", lambda: ldi.query(q, auths=a).fids, "filter_scan_mask"),
                lcalls.run("stats", lambda: ldi.stats(q, "Count()", auths=a).to_json()[0]["count"],
                           "filter_scan_mask"))
            for a in VERDICTS}
    lab_launches = read_launches("labeled xz path", lcalls.want)
    _, lmf, lops = ldi._loose_args(ldi._loose_bounds(lf))
    lm = lmf(*lops).cpu().numpy()
    em = np_env_bbox(_env_planes_np(ldi), (lf.xmin, lf.ymin, lf.xmax, lf.ymax))
    for a, (c_loose, c_exact, fids, n_stat) in lres.items():
        seen = np.asarray(VERDICTS[a])[lab]
        if (c_loose, c_exact, n_stat) != (int((lm & seen).sum()), int((em & seen).sum()),
                                          int((em & seen).sum())):
            raise AssertionError(f"labeled xz2 {a}: counts != numpy")
        if not np.array_equal(np.sort(fids), np.nonzero(em & seen)[0]):
            raise AssertionError(f"labeled xz2 {a}: fid set != numpy")
        log(f"labeled xz2 auths={a}: exact {c_exact}, loose {c_loose}")
    log(f"phase 3d labeled: {n_lab:,} rows staged, driven and checked in {time.time() - t:.1f} s")
    total = {k: launches[k] + lab_launches[k] for k in launches}
    return {"di2": di2, "di3": di3, "traffic": traffic, "launches": total}


# -- phase 3e: the AIS processes (BASELINE config #4) --------------------------

AIS_SPEC = "mmsi:Int,vessel_type:Int,sog:Float,cog:Float,dtg:Date,*geom:Point:srid=4326"
AIS_VESSELS = 1 << 14
AIS_FIXES = 1 << 12  # 3-minute reports: 8.5 days a vessel
AIS_REPORT_MS = 180_000
AIS_DAYS = 30  # start times spread over 30 days from 2020-01-01
VESSEL_TYPES = np.array([30, 31, 36, 52, 60, 70, 80, 90], np.int32)
KNN_K = (1, 10, 100, 1000, 8192)


def ais_ports() -> np.ndarray:
    """Phase 3's 64 city centres, used as ports."""
    crng = np.random.default_rng(SEED)
    return np.stack([crng.uniform(-170.0, 170.0, 64), crng.uniform(-60.0, 70.0, 64)], axis=1)


def make_ais(dev, nv: int, nf: int, seed: int = SEED + 20) -> dict:
    """AIS position reports shaped like NOAA MarineCadastre's (MMSI,
    BaseDateTime, LAT, LON, SOG, COG, VesselType): nv vessels of nf fixes
    each, every 3 minutes. Each vessel shuttles between two of the 64 ports
    along a straight lane at its speed (SOG 0-25 kn) with a cross-track
    random walk; 10% are moored at their first port (SOG < 0.5). Rows are in
    report-time order (sorted on the card), coordinates exact in float32.
    Returns the columns plus ``_vid`` (vessel of each row), ``_lanes``
    (ports a, b per vessel), ``_moored`` and ``_ports``."""
    import torch

    rng = np.random.default_rng(seed)
    ports = ais_ports()
    a = rng.integers(0, 64, nv)
    b = (a + rng.integers(1, 64, nv)) % 64
    moored = rng.random(nv) < 0.1
    vtype = VESSEL_TYPES[rng.integers(0, len(VESSEL_TYPES), nv)]
    sog = np.clip(rng.uniform(6.0, 22.0, nv)[:, None] + rng.normal(0.0, 1.5, (nv, nf)), 0.0, 25.0)
    sog[moored] = rng.uniform(0.0, 0.5, (int(moored.sum()), nf))
    sog = sog.astype(np.float32)
    d = ports[b] - ports[a]
    length = np.hypot(d[:, 0], d[:, 1])[:, None]
    # degrees run along the lane: a knot is a sixtieth of a degree an hour
    leg = np.cumsum(sog * np.float32(AIS_REPORT_MS / 3.6e6 / 60.0), axis=1, dtype=np.float64)
    leg += rng.uniform(0.0, 2.0, (nv, 1)) * length
    leg = np.mod(leg, 2.0 * length)
    back = leg > length  # on the way back to port a
    frac = np.where(back, 2.0 * length - leg, leg) / length
    frac[moored] = 0.0
    del leg
    drift = np.cumsum(rng.normal(0.0, 0.002, (nv, nf)), axis=1)
    drift[moored] *= 0.05
    nx, ny = (-d[:, 1:2] / length), (d[:, 0:1] / length)
    x = _f32(np.clip(ports[a, 0:1] + frac * d[:, 0:1] + drift * nx, -180.0, 180.0))
    y = _f32(np.clip(ports[a, 1:2] + frac * d[:, 1:2] + drift * ny, -90.0, 90.0))
    del frac, drift
    cog = np.mod(np.degrees(np.arctan2(d[:, 0:1], d[:, 1:2])) + np.where(back, 180.0, 0.0)
                 + rng.normal(0.0, 3.0, (nv, nf)), 360.0).astype(np.float32)
    del back
    start = T0 + rng.integers(0, AIS_DAYS * DAY, nv)
    dtg = start[:, None] + np.arange(nf) * AIS_REPORT_MS + rng.integers(0, 10_000, (nv, nf))
    dtg = dtg.ravel()
    order = torch.from_numpy(dtg).to(dev).sort(stable=True).indices.cpu().numpy()
    vid = np.repeat(np.arange(nv, dtype=np.int32), nf)[order]
    geom = np.empty((nv * nf, 2))
    geom[:, 0], geom[:, 1] = x.ravel()[order], y.ravel()[order]
    return {
        "mmsi": (366_000_000 + vid).astype(np.int32),
        "vessel_type": vtype[vid],
        "sog": sog.ravel()[order],
        "cog": cog.ravel()[order],
        "dtg": dtg[order],
        "geom": geom,
        "_vid": vid, "_lanes": np.stack([a, b], axis=1), "_moored": moored, "_ports": ports,
    }


def _remote_points(ports, lanes, k: int) -> list:
    """k points of a 5-degree grid farthest from every lane: open ocean."""
    gx, gy = np.meshgrid(np.arange(-170.0, 171.0, 5.0), np.arange(-55.0, 66.0, 5.0))
    pts = np.stack([gx.ravel(), gy.ravel()], axis=1)
    segs = np.concatenate([ports[lanes[:, 0]], ports[lanes[:, 1]]], axis=1)
    best = np.full(len(pts), np.inf)
    for s in range(0, len(segs), 1024):
        best = np.minimum(best, np_pt_seg_dist2(pts, segs[s: s + 1024]).min(axis=1))
    return [tuple(pts[i]) for i in np.argsort(-best, kind="stable")[:k]]


def np_pt_seg_dist2(pts, segs) -> np.ndarray:
    """(n, m) squared distances of points to segments [x0, y0, x1, y1]: the
    clamped projection, in the order of operations of the reference's
    ``pt_seg_project``."""
    p = pts[:, None, :]
    a = segs[None, :, 0:2]
    d = segs[None, :, 2:4] - a
    len2 = (d**2).sum(-1)
    t = ((p - a) * d).sum(-1) / np.where(len2 == 0, 1.0, len2)
    t = np.clip(np.where(len2 == 0, 0.0, t), 0.0, 1.0)
    near = a + t[..., None] * d
    return ((p - near) ** 2).sum(-1)


def np_knn(x, y, px, py, r, k, keep=None):
    """numpy kNN oracle: the float32 radius box and distance of ops/knn.py
    (longitude factor rounded once from float64), a stable argsort over the
    candidates (partitioned to the k-th distance first). (rows, d2)."""
    import math

    q = np.array([px, py, r], np.float32)
    c = np.float32(math.cos(math.radians(float(q[1]))))
    box = (np.abs(x - q[0]) <= q[2]) & (np.abs(y - q[1]) <= q[2])
    if keep is not None:
        box &= keep
    idx = np.nonzero(box)[0]
    dx = ((x[idx] - q[0]) * c).astype(np.float64)
    dy = y[idx] - q[1]
    d2 = (dx * dx + (dy * dy).astype(np.float64)).astype(np.float32)
    fin = np.isfinite(d2)
    idx, d2 = idx[fin], d2[fin]
    if 0 < k < len(idx):
        sel = np.nonzero(d2 <= np.partition(d2, k - 1)[k - 1])[0]
        idx, d2 = idx[sel], d2[sel]
    order = np.argsort(d2, kind="stable")[: max(k, 0)]
    return idx[order], d2[order]


def check_knn(tag, got, want) -> None:
    """A kNN answer (batch, distances) against the oracle's (rows, d2), bit
    for bit; fids are row ids."""
    rows, d2 = want
    if not np.array_equal(got[0].fids, rows):
        raise AssertionError(f"{tag}: fids != the numpy oracle ({len(got[0])} vs {len(rows)} rows)")
    if not np.array_equal(got[1], np.sqrt(d2.astype(np.float64))):
        raise AssertionError(f"{tag}: distances != the numpy oracle")


def np_union(x, y, envs, t=None, times=None) -> np.ndarray:
    """Rows inside any window widened one float32 ulp outward (and inside
    its time range): the union envelope first, then a loop over windows."""
    e = _f32(envs).astype(np.float32)
    e[:, :2] = np.nextafter(e[:, :2], np.float32(-np.inf))
    e[:, 2:] = np.nextafter(e[:, 2:], np.float32(np.inf))
    lo, hi = np.fmin.reduce(e[:, :2], axis=0), np.fmax.reduce(e[:, 2:], axis=0)
    cand = np.nonzero((x >= lo[0]) & (x <= hi[0]) & (y >= lo[1]) & (y <= hi[1]))[0]
    xc, yc = x[cand], y[cand]
    hit = np.zeros(len(cand), bool)
    for i, (x0, y0, x1, y1) in enumerate(e):
        m = (xc >= x0) & (xc <= x1) & (yc >= y0) & (yc <= y1)
        if times is not None:
            m &= (t[cand] >= times[i, 0]) & (t[cand] <= times[i, 1])
        hit |= m
    out = np.zeros(len(x), bool)
    out[cand[hit]] = True
    return out


def np_tube(cols, x, y, track_xy, track_t, buf, max_dt, keep=None) -> np.ndarray:
    """Tube select in numpy: the union of the segments' bbox+time windows,
    then the reference's fine pass (distance to the nearest segment within
    the buffer, time at the closest approach within max_dt). Row ids."""
    a, b = track_xy[:-1], track_xy[1:]
    envs = np.stack([np.minimum(a[:, 0], b[:, 0]) - buf, np.minimum(a[:, 1], b[:, 1]) - buf,
                     np.maximum(a[:, 0], b[:, 0]) + buf, np.maximum(a[:, 1], b[:, 1]) + buf], axis=1)
    ta, tb = track_t[:-1], track_t[1:]
    times = np.stack([np.minimum(ta, tb) - max_dt, np.maximum(ta, tb) + max_dt], axis=1)
    m = np_union(x, y, envs, cols["dtg"], times)
    if keep is not None:
        m &= keep
    cand = np.nonzero(m)[0]
    px, py, t = cols["geom"][cand, 0], cols["geom"][cand, 1], cols["dtg"][cand]
    ok = np.zeros(len(cand), bool)
    best = np.full(len(cand), np.inf)
    for i in range(len(track_xy) - 1):
        (x0, y0), (x1, y1) = track_xy[i], track_xy[i + 1]
        dx, dy = x1 - x0, y1 - y0
        L2 = dx * dx + dy * dy
        if L2 == 0:
            d, frac = np.sqrt((px - x0) ** 2 + (py - y0) ** 2), np.zeros_like(px)
        else:
            frac = np.clip(((px - x0) * dx + (py - y0) * dy) / L2, 0.0, 1.0)
            d = np.sqrt((px - (x0 + frac * dx)) ** 2 + (py - (y0 + frac * dy)) ** 2)
        seg_t = track_t[i] + frac * (track_t[i + 1] - track_t[i])
        c = (d <= buf) & (np.abs(t - seg_t) <= max_dt) & (d < best)
        ok |= c
        best = np.where(c, d, best)
    return cand[ok]


def np_proximity(cols, x, y, envs, segs, dist, keep=None):
    """Proximity in numpy: the union of the inputs' expanded envelopes,
    then the exact distance to the nearest input segment. (rows, dist)."""
    m = np_union(x, y, envs)
    if keep is not None:
        m &= keep
    cand = np.nonzero(m)[0]
    d = np.sqrt(np_pt_seg_dist2(cols["geom"][cand], segs).min(axis=1))
    ok = d <= dist
    return cand[ok], d[ok]


def ais_traffic(cols) -> dict:
    """The kNN targets and calls, tube tracks, proximity inputs and density
    calls of phase 3e (module docstring)."""
    ports, lanes, moored, vid = cols["_ports"], cols["_lanes"], cols["_moored"], cols["_vid"]
    sailing = np.nonzero(~moored)[0]
    busy_lane = np.bincount(lanes[sailing, 0], minlength=64).argmax()
    v0, v1, v2 = sailing[:3]
    r3 = np.nonzero(vid == sailing[3])[0]
    busy = [tuple(ports[busy_lane]), tuple(ports[lanes[v0, 1]]),
            tuple((ports[lanes[v1, 0]] + ports[lanes[v1, 1]]) / 2), tuple(cols["geom"][r3[2000]])]
    ocean = _remote_points(ports, lanes[sailing], 2)
    east = ports[np.argmax(ports[:, 0])]
    targets = busy + ocean + [(20.0, 75.0), (179.97, float(east[1]))]
    day = (T0 + 12 * DAY, T0 + 13 * DAY)
    during = f"dtg DURING {_day(12)}/{_day(13)}"
    f70 = f"vessel_type = 70 AND sog > 5 AND {during}"
    knn_calls = [(targets[i], KNN_K[i % 5], 45.0, None) for i in range(8)]
    knn_calls += [(targets[i], KNN_K[(i + 2) % 5], 45.0, None) for i in range(4)]
    # sparse water at radius 0.5: open ocean, the Arctic, the antimeridian,
    # and 0.3 degrees off a lane's midpoint (its traffic, fewer than k)
    off_lane = (busy[2][0] + 0.3, busy[2][1] + 0.3)
    knn_calls += [(targets[4], 1000, 0.5, None), (off_lane, 8192, 0.5, None),
                  (targets[6], 100, 0.5, None), (targets[7], 8192, 0.5, None)]
    knn_calls += [(targets[i], (10, 100, 1000, 8192)[i], 45.0, f70) for i in range(4)]
    knn_calls += [(busy[0], 100, 45.0, "sog < 0.5"), (busy[1], 1000, 45.0, "sog < 0.5"),
                  (targets[4], 10, 45.0, "vessel_type = 60 OR vessel_type = 80"),
                  (targets[7], 100, 45.0, f"cog > 180 AND dtg DURING {_day(10)}/{_day(13)}")]
    process_calls = [(busy[0], 10, None), (busy[1], 1000, None), (busy[2], 100, f70),
                     (busy[0], 8192, "sog < 0.5")]
    tubes = []
    for i, (nfix, buf, dt, base) in enumerate([(17, 0.02, 900_000, None),
                                               (17, 0.2, 7_200_000, "vessel_type <> 70"),
                                               (65, 0.02, 1_800_000, None), (65, 0.2, 3_600_000, None),
                                               (257, 0.02, 7_200_000, "vessel_type <> 70"),
                                               (257, 0.2, 2_700_000, None)]):
        rows = np.nonzero(vid == (v0, v1, v2)[i % 3])[0][1000: 1000 + nfix]
        tubes.append((cols["geom"][rows], cols["dtg"][rows], buf, dt, base))
    # 1.5 degrees of a lane's middle as 128 vertices with a gentle swing
    # (the exact pass is candidates x segments on the host: a whole lane's
    # envelope would hold millions of rows), and a harbour octagon
    pa, pb = ports[lanes[v0, 0]], ports[lanes[v0, 1]]
    along = (pb - pa) / np.hypot(*(pb - pa))
    normal = np.array([-along[1], along[0]])
    s = np.linspace(-0.75, 0.75, 128)[:, None]
    lane = (pa + pb) / 2 + s * along + 0.05 * np.sin(4 * np.pi * s) * normal
    ang = np.linspace(0.0, 2 * np.pi, 9)[:, None]
    harbour = ports[busy_lane] + 0.08 * np.concatenate([np.cos(ang), np.sin(ang)], axis=1)
    harbour[-1] = harbour[0]
    viewport = tuple(_q(v) for v in (busy[0][0] - 2, busy[0][1] - 2, busy[0][0] + 2, busy[0][1] + 2))
    vb = f"BBOX(geom, {viewport[0]}, {viewport[1]}, {viewport[2]}, {viewport[3]})"
    return {
        "knn": knn_calls, "process": process_calls, "tubes": tubes,
        "ports8": [tuple(p) for p in ports[:8]], "lane": lane, "harbour": harbour,
        "viewport": viewport, "day": day,
        "density": [(f"{vb} AND {during}", False, None), (f"{vb} AND {during}", True, None),
                    (f"{vb} AND {during}", False, "sog"), (f"vessel_type = 70 AND {during}", False, None)],
    }


def ais_keep(cols, base, day):
    """numpy of the phase's base filters (None: every row)."""
    if base is None:
        return None
    vt, sog, cog, t = cols["vessel_type"], cols["sog"], cols["cog"], cols["dtg"]
    in_day = (t >= day[0]) & (t <= day[1])
    return {
        f"vessel_type = 70 AND sog > 5 AND dtg DURING {_day(12)}/{_day(13)}":
            (vt == 70) & (sog > np.float32(5)) & in_day,
        "sog < 0.5": sog < np.float32(0.5),
        "vessel_type = 60 OR vessel_type = 80": (vt == 60) | (vt == 80),
        f"cog > 180 AND dtg DURING {_day(10)}/{_day(13)}":
            (cog > np.float32(180)) & (t >= T0 + 10 * DAY) & (t <= day[1]),
        "vessel_type <> 70": vt != 70,
        f"vessel_type = 70 AND dtg DURING {_day(12)}/{_day(13)}": (vt == 70) & in_day,
    }[base]


def run_ais_path(dev) -> dict:
    """Phase 3e, BASELINE config #4: stage 2^26 AIS fixes, drive kNN, tube
    select, proximity and spatio-temporal density through the public entry
    points with the launch counts reset just before, check every answer
    with numpy, and return what phase 4 times."""
    import torch

    from geomesa_tpu_torch import kernels
    from geomesa_tpu_torch.device_cache import DeviceIndex
    from geomesa_tpu_torch.features.batch import FeatureBatch
    from geomesa_tpu_torch.features.sft import SimpleFeatureType
    from geomesa_tpu_torch.filter.ecql import parse_ecql
    from geomesa_tpu_torch.geom import Envelope, LineString, Polygon
    from geomesa_tpu_torch.process.knn import knn
    from geomesa_tpu_torch.process.proximity import proximity_search
    from geomesa_tpu_torch.process.tube import tube_select
    from geomesa_tpu_torch.store.direct import BatchStore

    t = time.time()
    cols = make_ais(dev, AIS_VESSELS, AIS_FIXES)
    n = len(cols["dtg"])
    gen = time.time() - t
    t = time.time()
    batch = FeatureBatch.from_columns(SimpleFeatureType.create("ais", AIS_SPEC),
                                      {k: v for k, v in cols.items() if not k.startswith("_")})
    store = BatchStore(batch)
    t_batch = time.time() - t
    t = time.time()
    di = DeviceIndex(store, "ais", z_planes=True, device=dev)
    torch.cuda.synchronize()
    t_stage = time.time() - t
    log(f"phase 3e: generated {n:,} AIS fixes ({AIS_VESSELS:,} vessels x {AIS_FIXES:,}) in "
        f"{gen:.1f} s; FeatureBatch {t_batch:.1f} s; staged in {t_stage:.2f} s "
        f"({di.nbytes / 1e9:.3f} GB resident, {di.nbytes / n:.1f} B/row)")
    tr = ais_traffic(cols)
    calls = Calls()
    f32 = "filter_scan_mask"
    kernels.reset_counts()
    res_knn = [calls.run("knn_filtered" if base else "knn",
                         lambda: di.knn(*tg, k, query=base, max_radius_deg=r), base and f32)
               for tg, k, r, base in tr["knn"]]
    res_proc = [calls.run("knn_process", lambda: knn(store, "ais", *tg, k, base_filter=base,
                                                     device_index=di), base and f32)
                for tg, k, base in tr["process"]]
    res_tube = [calls.run("tube", lambda: tube_select(store, "ais", xy, tt, buf, dt, base_filter=base,
                                                      device_index=di), base and f32)
                for xy, tt, buf, dt, base in tr["tubes"]]
    lane, harbour = LineString(tr["lane"]), Polygon(tr["harbour"])
    prox_calls = [(tr["ports8"], 0.1, None), ([lane], 0.05, None), ([harbour], 0.02, None),
                  (tr["ports8"], 0.1, "sog < 0.5")]
    res_prox = [calls.run("proximity", lambda: proximity_search(store, "ais", g, d, base_filter=base,
                                                                device_index=di), base and f32)
                for g, d, base in prox_calls]
    env = Envelope(*tr["viewport"])
    res_dens = [calls.run("density", lambda: di.density(q, env, 512, 512, weight_attr=w, loose=loose),
                          "dimscan_z3_mask" if loose else f32,
                          "density_weighted" if w else "density_count")
                for q, loose, w in tr["density"]]
    torch.cuda.synchronize()
    launches = read_launches("AIS path", calls.want)
    calls.log_latency("ais")

    # -- checks ---------------------------------------------------------------
    t = time.time()
    x = cols["geom"][:, 0].astype(np.float32)
    y = cols["geom"][:, 1].astype(np.float32)
    day = tr["day"]
    with ThreadPoolExecutor(max_workers=8) as pool:
        want_knn = list(pool.map(lambda c: np_knn(x, y, *c[0], c[2], c[1], ais_keep(cols, c[3], day)),
                                 tr["knn"]))
        want_proc = list(pool.map(lambda c: np_knn(x, y, *c[0], 45.0, c[1], ais_keep(cols, c[2], day)),
                                  tr["process"]))
        want_tube = list(pool.map(lambda c: np_tube(cols, x, y, c[0], c[1], c[2], c[3],
                                                    ais_keep(cols, c[4], day)), tr["tubes"]))
    for (tg, k, r, base), got, want in zip(tr["knn"], res_knn, want_knn):
        check_knn(f"kNN {tg} k={k} r={r} {base}", got, want)
        if r == 0.5 and len(got[0]) >= k:
            raise AssertionError(f"kNN {tg} in sparse water: {len(got[0])} rows, not fewer than k={k}")
    for (tg, k, base), got, want in zip(tr["process"], res_proc, want_proc):
        check_knn(f"process kNN {tg} k={k} {base}", got, want)
    for (_, _, buf, dt, base), got, want in zip(tr["tubes"], res_tube, want_tube):
        if not np.array_equal(got.fids, want):
            raise AssertionError(f"tube buffer={buf} dt={dt} {base}: fids != numpy "
                                 f"({len(got)} vs {len(want)})")
    for (geoms, d, base), got in zip(prox_calls, res_prox):
        if isinstance(geoms[0], tuple):
            pts = np.array(geoms)
            segs = np.concatenate([pts, pts], axis=1)
            envs = np.concatenate([pts - d, pts + d], axis=1)
        else:
            c = geoms[0].coords if isinstance(geoms[0], LineString) else geoms[0].shell
            segs = np.concatenate([c[:-1], c[1:]], axis=1)
            envs = np.array([[c[:, 0].min() - d, c[:, 1].min() - d, c[:, 0].max() + d, c[:, 1].max() + d]])
        rows, dist = np_proximity(cols, x, y, envs, segs, d, ais_keep(cols, base, day))
        if not (np.array_equal(got[0].fids, rows) and np.array_equal(got[1], dist)):
            raise AssertionError(f"proximity {len(geoms)} inputs at {d} {base}: != numpy "
                                 f"({len(got[0])} vs {len(rows)} rows)")
    planes = host_z3_planes(cols)
    vp = tr["viewport"]
    in_vp = (x >= np.float32(vp[0])) & (x <= np.float32(vp[2])) & (y >= np.float32(vp[1])) & (y <= np.float32(vp[3]))
    in_day = (cols["dtg"] >= day[0]) & (cols["dtg"] <= day[1])
    for (q, loose, w), got in zip(tr["density"], res_dens):
        if loose:
            sel = np_loose(di._loose_bounds(parse_ecql(q))[1], planes)
        elif q.startswith("BBOX"):
            sel = in_vp & in_day
        else:
            sel = ais_keep(cols, q, day)
        want = np_density(x, y, sel, vp, (512, 512), None if w is None else cols[w])
        if not same_grid(got, want, w is not None):
            raise AssertionError(f"AIS density {q} loose={loose} weight={w}: grid != numpy")
    log(f"phase 3e checks: {len(res_knn)} kNN (rows per call "
        f"{[len(r[0]) for r in res_knn]}), {len(res_proc)} process kNN, {len(res_tube)} tubes "
        f"(rows {[len(r) for r in res_tube]}), {len(res_prox)} proximity (rows "
        f"{[len(r[0]) for r in res_prox]}), {len(res_dens)} density grids (mass "
        f"{[float(g.sum()) for g in res_dens]}): all equal to numpy, in {time.time() - t:.1f} s")
    bin_launches, bin_reqs = run_ais_bin(di, cols, tr, planes)
    launches = {k: launches[k] + bin_launches[k] for k in launches}
    return {"launches": launches, "di": di, "traffic": tr, "bin_requests": bin_reqs}


BIN16 = np.dtype([("track", "<i4"), ("dtg", "<i4"), ("lat", "<f4"), ("lon", "<f4")])
BIN24 = np.dtype([("track", "<i4"), ("dtg", "<i4"), ("lat", "<f4"), ("lon", "<f4"), ("label", "<i8")])
BIN_REPEATS = 3  # timed calls of each engine per BIN request


def np_bin(track, dtg, geom, sel, label=None, sort=False) -> bytes:
    """BIN records of the rows ``sel`` (a mask or row ids) in numpy:
    track int32, dtg seconds, lat and lon float32 (+ the label: the first
    8 bytes of the value's string as a little-endian int64, one value at a
    time), in row order or sorted stably by dtg seconds."""
    rows = np.nonzero(sel)[0] if sel.dtype == bool else sel
    rec = np.empty(len(rows), BIN24 if label is not None else BIN16)
    rec["track"] = track[rows].astype(np.int64).astype(np.int32)
    rec["dtg"] = (dtg[rows] // 1000).astype(np.int32)
    rec["lat"] = geom[rows, 1].astype(np.float32)
    rec["lon"] = geom[rows, 0].astype(np.float32)
    if label is not None:
        vals, inv = np.unique(label[rows], return_inverse=True)
        packed = [int.from_bytes(str(v).encode()[:8].ljust(8, b"\0"), "little", signed=True)
                  for v in vals]
        rec["label"] = np.array(packed, np.int64)[inv.reshape(-1)]
    if sort:
        rec = rec[np.argsort(rec["dtg"], kind="stable")]
    return rec.tobytes()


def run_ais_bin(di, cols, tr, planes) -> dict:
    """Phase 3e's BIN requests on the AIS index (track ``mmsi``): 4 exact
    one-day bbox windows over busy lanes, 2 loose ones, 1 labeled
    (``vessel_type``) and sorted, and INCLUDE over every row. Each through
    the device rider, ``resident_bin`` (auto: the rider on the card) and
    the host twin ``bin_export``, BIN_REPEATS times each (INCLUDE's rider
    twice, its twin once); every answer equals the twin's and numpy's byte for byte, the
    launch counts show the scan kernel under every mask, and the rider
    metric counts every rider call."""
    import torch

    from geomesa_tpu_torch import kernels, metrics
    from geomesa_tpu_torch.filter.ecql import parse_ecql
    from geomesa_tpu_torch.results.binrider import resident_bin

    day = f"dtg DURING {_day(12)}/{_day(13)}"
    # fixes of sailing vessels on that day, at the targets of phase 3e's lanes
    in_day = np.nonzero((cols["dtg"] >= T0 + 12 * DAY) & (cols["dtg"] <= T0 + 13 * DAY)
                        & ~cols["_moored"][cols["_vid"]])[0]
    centres = [tuple(cols["geom"][in_day[len(in_day) * (2 * i + 1) // 12]]) for i in range(6)]
    boxes = [tuple(_q(v) for v in (cx - 1.0, cy - 1.0, cx + 1.0, cy + 1.0)) for cx, cy in centres]
    reqs = [(f"exact {i}", f"BBOX(geom, {b[0]}, {b[1]}, {b[2]}, {b[3]}) AND {day}", False, None, False)
            for i, b in enumerate(boxes[:4])]
    reqs += [(f"loose {i}", f"BBOX(geom, {b[0]}, {b[1]}, {b[2]}, {b[3]}) AND {day}", True, None, False)
             for i, b in enumerate(boxes[4:])]
    # INCLUDE before the labeled request: it reuses the 4-lane matrix, which
    # the labeled one's 6 lanes replace (one matrix is kept)
    reqs.append(("INCLUDE", "INCLUDE", False, None, False))
    b = boxes[0]
    reqs.append(("labeled sorted", f"BBOX(geom, {b[0]}, {b[1]}, {b[2]}, {b[3]}) AND {day}", False,
                 "vessel_type", True))
    calls = Calls()
    metric0 = metrics.results_bin_device_launches.value()
    kernels.reset_counts()
    out = []
    for tag, q, loose, label, sort in reqs:
        scan = None if q == "INCLUDE" else ("dimscan_z3_mask" if loose else "filter_scan_mask")
        kw = dict(label_attr=label, sort=sort, loose=loose)
        big = q == "INCLUDE"  # 1.07 GB a call: fewer repeats
        rider = [calls.run(f"bin rider {tag}", lambda: di.bin_rider(q, "mmsi", **kw), scan)
                 for _ in range(2 if big else BIN_REPEATS)]
        res = calls.run(f"bin resident {tag}", lambda: resident_bin(di, q, "mmsi", **kw), scan)
        twin = [calls.run(f"bin twin {tag}", lambda: di.bin_export(q, "mmsi", **kw), scan)
                for _ in range(1 if big else BIN_REPEATS)]
        out.append((rider, res, twin))
    torch.cuda.synchronize()
    launches = read_launches("AIS BIN", calls.want)
    riders = sum(len(a) > 0 for rider, res, _ in out for a in rider + [res])  # b"": no pack
    if metrics.results_bin_device_launches.value() - metric0 != riders:
        raise AssertionError(f"results_bin_device_launches counted "
                             f"{metrics.results_bin_device_launches.value() - metric0}, not {riders}")
    t = time.time()
    x = cols["geom"][:, 0].astype(np.float32)
    y = cols["geom"][:, 1].astype(np.float32)
    in_day = (cols["dtg"] >= T0 + 12 * DAY) & (cols["dtg"] <= T0 + 13 * DAY)
    for (tag, q, loose, label, sort), (rider, res, twin) in zip(reqs, out):
        if q == "INCLUDE":
            sel = np.ones(len(x), bool)
        elif loose:
            sel = np_loose(di._loose_bounds(parse_ecql(q))[1], planes)
        else:
            bb = boxes[0] if tag == "labeled sorted" else boxes[int(tag.split()[-1])]
            sel = (in_day & (x >= np.float32(bb[0])) & (x <= np.float32(bb[2]))
                   & (y >= np.float32(bb[1])) & (y <= np.float32(bb[3])))
        want = np_bin(cols["mmsi"], cols["dtg"], cols["geom"], sel,
                      None if label is None else cols[label], sort)
        if not all(a == want for a in rider + twin + [res]):
            raise AssertionError(f"AIS BIN {tag}: rider / resident_bin / twin != numpy")
        size = 24 if label else 16
        log(f"phase 3e BIN {tag}: {len(want) // size:,} records ({len(want) / 1e9:.4f} GB) "
            f"rider p50 {pct(calls.lat[f'bin rider {tag}'], 50):.3f} ms, resident_bin "
            f"{pct(calls.lat[f'bin resident {tag}'], 50):.3f} ms, twin p50 "
            f"{pct(calls.lat[f'bin twin {tag}'], 50):.3f} ms [{CARD}]")
    log(f"phase 3e BIN: {len(reqs)} requests x (rider, resident_bin, twin) == numpy byte for "
        f"byte ({riders} rider calls counted), checked in {time.time() - t:.1f} s")
    return launches, reqs


# -- phase 3f: the device query scheduler ---------------------------------------

SCHED_PANS = 64  # map-client threads, one pan of 16 tile counts each
SCHED_TILES = 16
SCHED_FEATURES = 16  # threads with one loose feature request each
SCHED_MAX_QUEUE = 2048  # admits the whole burst (1,040 requests)
SCHED_INDEXES = ("z3", "z2", "z3i", "z2i")  # dim planes, then the interleaved key
SCHED_KERNELS = {  # (index, op) -> (batched kernel, single-query kernel)
    ("z3", "count"): ("dimscan_batched_z3_count", "dimscan_z3_count"),
    ("z3", "query"): ("dimscan_batched_z3_mask", "dimscan_z3_mask"),
    ("z2", "count"): ("dimscan_batched_z2_count", "dimscan_z2_count"),
    ("z2", "query"): ("dimscan_batched_z2_mask", "dimscan_z2_mask"),
    ("z3i", "count"): ("zscan_batched_z3_count", "zscan_z3_count"),
    ("z3i", "query"): ("zscan_batched_z3_mask", "zscan_z3_mask"),
    ("z2i", "count"): ("zscan_batched_z2_count", "zscan_z2_count"),
    ("z2i", "query"): ("zscan_batched_z2_mask", "zscan_z2_mask"),
}


def sched_traffic(centers) -> "tuple[list, list]":
    """A fleet of map clients: 64 pans of 16 loose tile counts (a 4x4 grid
    of 0.5-4 degree tiles around one of phase 3's city centres; over one
    day on the z3 indexes, bbox only on the z2 ones), and 16 loose feature
    requests (a 0.5 degree tile, over one day on z3), spread over the four
    indexes in turn. Items are (index, ECQL)."""
    pans = []
    for i in range(SCHED_PANS):
        key = SCHED_INDEXES[i % len(SCHED_INDEXES)]
        cx, cy = centers[i % len(centers)]
        sz = (0.5, 1.0, 2.0, 4.0)[i % 4]
        d = i % 59
        pan = []
        for j in range(SCHED_TILES):
            x0, y0 = cx + (j % 4 - 2) * sz, cy + (j // 4 - 2) * sz
            q = f"BBOX(geom, {x0:.3f}, {y0:.3f}, {x0 + sz:.3f}, {y0 + sz:.3f})"
            if key.startswith("z3"):
                q += f" AND dtg DURING {_day(d)}/{_day(d + 1)}"
            pan.append((key, q))
        pans.append(pan)
    feats = []
    for j in range(SCHED_FEATURES):
        cx, cy = centers[(7 * j) % len(centers)]
        d = (3 * j) % 59
        key = SCHED_INDEXES[j % len(SCHED_INDEXES)]
        q = f"BBOX(geom, {cx - 0.25:.3f}, {cy - 0.25:.3f}, {cx + 0.25:.3f}, {cy + 0.25:.3f})"
        if key.startswith("z3"):
            q += f" AND dtg DURING {_day(d)}/{_day(d + 1)}"
        feats.append([(key, q)])
    return pans, feats


def drive_sched(idx, pans, feats, cfg) -> dict:
    """Every client on a thread of its own, started together; each submits
    its requests (each in a trace of its own, a tenant per client) and
    waits for them in order. Returns the answers, per-request latency from
    submit to the scheduler completing that request (its own finish time,
    not the client's in-order wait), each request's launch id, fused width
    and fallback reason (its sched.execute span), the wall time and the
    scheduler's snapshot."""
    import threading

    from geomesa_tpu_torch import tracing
    from geomesa_tpu_torch.sched import FusableQuery, QueryScheduler

    sched = QueryScheduler(cfg)
    clients = [(pan, "count") for pan in pans] + [(f, "query") for f in feats]
    barrier = threading.Barrier(len(clients) + 1)

    def client(c):
        items, op = clients[c]
        barrier.wait()
        mine = []
        for key, q in items:
            t0 = time.perf_counter()
            with tracing.TRACER.trace("tile") as tr:
                r = sched.submit(fuse=FusableQuery(idx[key], q, op, loose=True), tenant=f"c{c}")
            mine.append((key, op, q, r, tr, t0))
        out = []
        for key, op, q, r, tr, t0 in mine:
            v = sched.wait(r)
            lat = r.t_done - t0
            ex = [sp for sp in tr.root.children if sp.name == "sched.execute"]
            if len(ex) != 1:
                raise AssertionError(f"{key} {op} {q}: {len(ex)} sched.execute spans")
            if "fallback" in ex[0].attrs:
                raise AssertionError(f"{key} {op} {q}: its group fell back to serial "
                                     f"({ex[0].attrs['fallback']})")
            out.append((key, op, q, v, lat, ex[0].attrs["launch"], ex[0].attrs["fused"]))
        return out

    try:
        with ThreadPoolExecutor(max_workers=len(clients)) as pool:
            futs = [pool.submit(client, c) for c in range(len(clients))]
            barrier.wait()
            t0 = time.perf_counter()
            done = [x for f in futs for x in f.result()]
            wall = time.perf_counter() - t0
        snap = sched.snapshot()
    finally:
        sched.close(timeout=10.0)
    return {"done": done, "wall": wall, "snap": snap, "sched": sched}


def check_sched(tag, run, serial) -> dict:
    """Every answer equals the serial one; the launches the drive made
    equal, kernel by kernel, the launches its spans show (one batched
    launch per fused group, one single-query launch per request served
    alone); each batched launch carried its group's queries (the widths
    the kernels saw, ``kernels.BATCH_WIDTHS``, equal the groups'); no group
    of two or more fell back to serial (a failed or declined fused launch);
    nothing rejected or expired. Returns the launch counts, and the widths
    under "widths"."""
    from geomesa_tpu_torch import kernels

    done, sched = run["done"], run["sched"]
    for key, op, q, v, _, _, _ in done:
        want = serial[(key, op, q)]
        if op == "count" and v != want:
            raise AssertionError(f"{tag} {key} {q}: count {v} != serial {want}")
        if op == "query" and not np.array_equal(v.fids, want):
            raise AssertionError(f"{tag} {key} {q}: fid set != serial ({len(v)} vs {len(want)})")
    calls: dict = {}
    groups = {(key, op, launch) for key, op, _, _, _, launch, fused in done if fused > 1}
    for key, op, _ in groups:
        name = SCHED_KERNELS[(key, op)][0]
        calls[name] = calls.get(name, 0) + 1
    alone = [(key, op) for key, op, _, _, _, _, fused in done if fused == 1]
    for key, op in alone:
        name = SCHED_KERNELS[(key, op)][1]
        calls[name] = calls.get(name, 0) + 1
    launches = read_launches(f"scheduler ({tag})", calls)
    # each batched launch carries its group's queries and no padding: the
    # widths the kernels saw equal the fused groups' widths in the spans
    spans: dict = {}
    for key, op, _, _, _, launch, fused in done:
        if fused > 1:
            spans[(key, op, launch)] = fused
    want_widths: dict = {}
    for (key, op, _), fused in spans.items():
        w = want_widths.setdefault(SCHED_KERNELS[(key, op)][0], {})
        w[fused] = w.get(fused, 0) + 1
    widths = {k: dict(sorted(v.items())) for k, v in kernels.BATCH_WIDTHS.items() if v}
    if widths != {k: dict(sorted(v.items())) for k, v in want_widths.items()}:
        raise AssertionError(f"{tag}: batched launch widths {widths} != the spans' {want_widths}")
    launches["widths"] = widths
    riders = sum(1 for *_, fused in done if fused > 1)
    if sched.fused_queries != riders or sched.launches != len(groups) + len(alone):
        raise AssertionError(f"{tag}: fused_queries {sched.fused_queries} / launches "
                             f"{sched.launches} != the spans' {riders} / {len(groups) + len(alone)}")
    if sched.fusion_fallbacks:
        raise AssertionError(f"{tag}: {sched.fusion_fallbacks} groups fell back to serial")
    if sched.rejected or sched.expired or sched.queries != len(done):
        raise AssertionError(f"{tag}: rejected {sched.rejected}, expired {sched.expired}, "
                             f"queries {sched.queries} of {len(done)}")
    return launches


def run_sched_path(dev, cols, di3, di2, di3i, di2i) -> dict:
    """Phase 3f: the device query scheduler over phase 3's resident 2^26-row
    indexes (z3 and z2 dim planes, the interleaved z3 and z2 of phase 3c): the
    map-client burst with the default SchedConfig (max_queue raised to
    admit it), then again with max_fusion=1, the unfused comparison. Every
    answer equals the serial one through the single-query kernel; the
    batched launch counts equal the fused groups the spans show."""
    import torch

    from geomesa_tpu_torch import kernels
    from geomesa_tpu_torch.sched import SchedConfig

    idx = {"z3": di3, "z2": di2, "z3i": di3i, "z2i": di2i}
    pans, feats = sched_traffic(cols["_centers"])
    t = time.time()
    serial = {}
    for items, op in [(p, "count") for p in pans] + [(f, "query") for f in feats]:
        for key, q in items:
            di = idx[key]
            serial[(key, op, q)] = di.count(q, loose=True) if op == "count" else \
                di.query(q, loose=True).fids
    log(f"phase 3f: {len(serial)} serial answers in {time.time() - t:.1f} s")
    n_req = SCHED_PANS * SCHED_TILES + SCHED_FEATURES
    out = {"launches": {k: 0 for k in kernels.KERNEL_NAMES}}
    for tag, cfg in (("fused", SchedConfig(max_queue=SCHED_MAX_QUEUE)),
                     ("unfused", SchedConfig(max_queue=SCHED_MAX_QUEUE, max_fusion=1))):
        kernels.reset_counts()
        run = drive_sched(idx, pans, feats, cfg)
        torch.cuda.synchronize()
        launches = check_sched(tag, run, serial)
        widths = launches.pop("widths")
        for k, v in launches.items():
            out["launches"][k] += v
        snap, done = run["snap"], run["done"]
        lat = [x[4] for x in done]
        log(f"phase 3f {tag}: {n_req} requests in {run['wall'] * 1e3:.1f} ms "
            f"({n_req / run['wall']:.1f} requests/s), {snap['launches']} launches, fusion factor "
            f"{snap['fusion_factor']}, {snap['fused_queries']} fused queries; latency submit to completion p50 {pct(lat, 50):.3f} ms p99 {pct(lat, 99):.3f} ms "
            f"(counts p50 {pct([x[4] for x in done if x[1] == 'count'], 50):.3f} ms, features p50 "
            f"{pct([x[4] for x in done if x[1] == 'query'], 50):.3f} ms) [{CARD}]")
        log(f"phase 3f {tag}: Q of every batched launch, as {{Q: launches}} per kernel: {widths}")
        out[tag] = {"requests": n_req, "wall_s": run["wall"], "launches": snap["launches"],
                    "fusion_factor": snap["fusion_factor"], "fused_queries": snap["fused_queries"],
                    "p50_ms": pct(lat, 50), "p99_ms": pct(lat, 99), "widths": widths}
    if not (out["fused"]["launches"] < n_req and out["fused"]["fused_queries"] > 0):
        raise AssertionError(f"phase 3f: the fused run launched {out['fused']['launches']} times "
                             f"for {n_req} requests, {out['fused']['fused_queries']} fused")
    if out["unfused"]["launches"] != n_req:
        raise AssertionError("phase 3f: the unfused run fused a group")
    log(json.dumps({"sched": {k: out[k] for k in ("fused", "unfused")}, "card": CARD}))
    out["traffic"] = (pans, feats)
    return out


# -- phase 3g: the streaming index ----------------------------------------------

STREAM_ROWS = 1 << 22  # phase 3's first 2^22 rows: phase 3 and 3c drive all 2^26 resident, 3k a fed index at 2^26
STREAM_APPENDS = 64  # Put messages of 2^14 new rows each
STREAM_APPEND_ROWS = 1 << 14
STREAM_EVICTED = 1 << 20  # random held fids, evicted through 64 Remove messages
STREAM_UPSERTS = 16  # Put messages moving 2^12 held rows to another city
STREAM_UPSERT_ROWS = 1 << 12
STREAM_SMALL = 1 << 22  # the interleaved z3 and the z2 streaming indexes (the main feed repeats them on dim planes)
STREAM_GROW = 1 << 22  # rows of the growth and the compaction restages
STREAM_BURST = 256  # fused loose counts through the scheduler beside a writer
CORNER = (-179.9, -89.9, -179.5, -89.5)  # no tile reaches it: the burst's writer writes here


class LiveFeed:
    """A live layer's listener registry, what ``attach_live`` attaches to:
    ``emit`` hands a Put, Remove or Clear message to every listener."""

    def __init__(self):
        self.listeners = []

    def add_listener(self, fn):
        self.listeners.append(fn)

    def remove_listener(self, fn):
        self.listeners.remove(fn)

    def emit(self, msg):
        for fn in list(self.listeners):
            fn(msg)


def delta_columns(n, seed, centers, box=None) -> dict:
    """New rows shaped like make_columns at phase 3's city centres (90%
    clustered, sigma 0.2 deg), or uniform inside ``box``; dtg over the same
    60 days."""
    rng = np.random.default_rng(seed)
    if box is None:
        c = centers[rng.integers(0, len(centers), n)]
        xy = c + rng.normal(0.0, 0.2, (n, 2))
        uni = rng.random(n) >= 0.9
        xy[uni] = rng.uniform([-180.0, -90.0], [180.0, 90.0], (int(uni.sum()), 2))
    else:
        xy = rng.uniform(box[:2], box[2:], (n, 2))
    xy = np.clip(xy, [-180.0, -90.0], [180.0, 90.0]).astype(np.float32).astype(np.float64)
    return {"count": rng.integers(0, 1000, n).astype(np.int32),
            "dtg": rng.integers(T0, T0 + 60 * DAY, n), "geom": xy}


class Truth:
    """The live rows kept in numpy from the messages alone, the oracle of a
    streaming index: rows in arrival order (the index's staged order while
    it does not restage), a live flag and fid -> row."""

    def __init__(self, cols, fids, max_fid):
        self.parts = [(fids, cols)]
        self.n = len(fids)
        self.alive = np.zeros(self.n + (1 << 21), bool)
        self.alive[: self.n] = True
        self.row_of = np.full(max_fid, -1, np.int64)
        self.row_of[fids] = np.arange(self.n)

    def put(self, cols, fids):
        held = self.row_of[fids]
        self.alive[held[held >= 0]] = False
        self.parts.append((fids, cols))
        self.row_of[fids] = np.arange(self.n, self.n + len(fids))
        self.alive[self.n: self.n + len(fids)] = True
        self.n += len(fids)

    def remove(self, fids):
        held = self.row_of[fids]
        self.alive[held[held >= 0]] = False
        self.row_of[fids] = -1

    def live(self) -> dict:
        """The live rows' columns, fids and float32 coordinates."""
        keep = self.alive[: self.n]
        cols = {k: np.concatenate([c[k] for _, c in self.parts])[keep]
                for k in ("count", "dtg", "geom")}
        cols["fid"] = np.concatenate([f for f, _ in self.parts])[keep]
        cols["x"] = cols["geom"][:, 0].astype(np.float32)
        cols["y"] = cols["geom"][:, 1].astype(np.float32)
        return cols


def feed_messages(rng, centers, n_base, appends, evicted, upserts, fid0, seed):
    """The message plan: ``appends`` Puts of 2^14 new rows (fids from
    ``fid0``), ``evicted`` random base fids in as many Removes as appends,
    ``upserts`` Puts moving 2^12 held base rows each to another city; in
    turn append, remove, and every ``appends // upserts``-th step an upsert.
    Items are (kind, fids, columns)."""
    perm = rng.permutation(n_base)
    out = []
    step = max(1, appends // max(upserts, 1))
    per = evicted // appends
    for i in range(appends):
        fids = np.arange(fid0 + i * STREAM_APPEND_ROWS, fid0 + (i + 1) * STREAM_APPEND_ROWS)
        out.append(("append", fids, delta_columns(STREAM_APPEND_ROWS, seed + i, centers)))
        out.append(("evict", perm[i * per: (i + 1) * per], None))
        if i % step == 0 and i // step < upserts:
            u = i // step
            moved = perm[evicted + u * STREAM_UPSERT_ROWS: evicted + (u + 1) * STREAM_UPSERT_ROWS]
            city = centers[(u * 7 + 3) % len(centers)]
            cols = delta_columns(STREAM_UPSERT_ROWS, seed + 1000 + u, city[None, :])
            out.append(("upsert", moved, cols))
    return out


def apply_feed(feed, plan, truth) -> dict:
    """Emit the plan's messages (Put for appends and upserts, Remove for
    evictions), synchronising after each; the per-kind host latencies."""
    import torch

    from geomesa_tpu_torch.stream.log import Put, Remove

    lat = {"append": [], "evict": [], "upsert": []}
    for kind, fids, cols in plan:
        t = time.perf_counter()
        feed.emit(Remove(fids) if kind == "evict" else Put(cols, fids))
        torch.cuda.synchronize()
        lat[kind].append(time.perf_counter() - t)
        if kind == "evict":
            truth.remove(fids)
        else:
            truth.put(cols, fids)
    return lat


def _fresh(dev, live, spec, name, **kw):
    """A DeviceIndex staged anew from the live rows (fids kept)."""
    from geomesa_tpu_torch.device_cache import DeviceIndex
    from geomesa_tpu_torch.features.batch import FeatureBatch
    from geomesa_tpu_torch.features.sft import SimpleFeatureType
    from geomesa_tpu_torch.store.direct import BatchStore

    sft = SimpleFeatureType.create(name, spec)
    keys = [a.name for a in sft.attributes]
    b = FeatureBatch.from_columns(sft, {k: live[k] for k in keys}, live["fid"])
    return DeviceIndex(BatchStore(b), name, z_planes=True, device=dev, **kw)


def _stream(dev, cols, fids, spec, name, capacity, **kw):
    from geomesa_tpu_torch.device_cache import StreamingDeviceIndex
    from geomesa_tpu_torch.features.batch import FeatureBatch
    from geomesa_tpu_torch.features.sft import SimpleFeatureType
    from geomesa_tpu_torch.store.direct import BatchStore

    sft = SimpleFeatureType.create(name, spec)
    keys = [a.name for a in sft.attributes]
    b = FeatureBatch.from_columns(sft, {k: cols[k] for k in keys}, fids)
    return StreamingDeviceIndex(BatchStore(b), name, z_planes=True, capacity=capacity,
                                device=dev, **kw)


def drive_stream_queries(di, queries) -> "tuple[list, dict]":
    """count (loose and exact) and query (exact and loose) of ``queries``
    (ECQL, box, window or None) on a streaming index: (answers, per-call
    host latencies)."""
    lat = {k: [] for k in ("count_loose", "count_exact", "query_exact", "query_loose")}
    res = []
    for ecql, _, _ in queries:
        out = {}
        for key, fn in (("count_loose", lambda: di.count(ecql, loose=True)),
                        ("count_exact", lambda: di.count(ecql, loose=False)),
                        ("query_exact", lambda: di.query(ecql)),
                        ("query_loose", lambda: di.query(ecql, loose=True))):
            t = time.perf_counter()
            out[key] = fn()
            lat[key].append(time.perf_counter() - t)
        res.append(out)
    return res, lat


def check_stream_queries(tag, di, fresh, live, queries, res, planes=None) -> None:
    """The answers of :func:`drive_stream_queries`: exact ones against numpy
    over the live rows, loose ones against numpy over the live rows' host
    dim planes (``planes``; else covering the exact ones), every count
    against ``fresh``, the index staged anew from the live rows."""
    from geomesa_tpu_torch.filter.ecql import parse_ecql

    def verify(a):
        (ecql, b, w), out = a
        em = np_exact(live["x"], live["y"], live["dtg"], b, w)
        if out["count_exact"] != int(em.sum()) or not np.array_equal(
                np.sort(out["query_exact"].fids), np.sort(live["fid"][em])):
            raise AssertionError(f"{tag} {ecql}: exact answer != numpy over the live rows")
        got_l = np.sort(out["query_loose"].fids)
        if planes is not None:
            lm = np_loose(di._loose_bounds(parse_ecql(ecql))[1], planes)
            if not np.array_equal(got_l, np.sort(live["fid"][lm])):
                raise AssertionError(f"{tag} {ecql}: loose fid set != numpy over the live rows")
        if out["count_loose"] != len(got_l) or not np.isin(live["fid"][em], got_l).all():
            raise AssertionError(f"{tag} {ecql}: the loose answer does not cover the exact one")
        for loose, key in ((True, "count_loose"), (False, "count_exact")):
            if fresh.count(ecql, loose=loose) != out[key]:
                raise AssertionError(f"{tag} {ecql}: {key} != the restaged index's")
        return int(em.sum())

    with ThreadPoolExecutor(max_workers=8) as pool:
        hits = list(pool.map(verify, list(zip(queries, res))))
    log(f"phase 3g {tag}: {len(queries)} queries == numpy over the live rows and the "
        f"restaged index (exact hits median {int(np.median(hits))})")


def check_fused(tag, di, fresh, tiles, counts, feats) -> None:
    """Fused loose counts of ``tiles`` (at most 64) and the fused loose
    query of the first 4 (the batched kernels with the plane) against the
    serial loose answers and the restaged index's."""
    serial = [di.count(q, loose=True) for q in tiles]
    if counts is None or counts != serial or counts != fresh.fused_loose_counts(tiles, loose=True):
        raise AssertionError(f"{tag}: fused loose counts != serial / restaged")
    for q, b in zip(tiles[:4], feats):
        if not np.array_equal(np.sort(b.fids), np.sort(fresh.query(q, loose=True).fids)):
            raise AssertionError(f"{tag}: fused loose query != the restaged index's")


def _valid_only(tag, launches, valid) -> None:
    """Every scan launch of a streaming drive read the validity plane."""
    bad = {k: (v, valid[k]) for k, v in launches.items()
           if v and not k.startswith("density") and valid[k] != v}
    if bad:
        raise AssertionError(f"{tag}: launches without the validity plane: {bad}")


STREAM_JOIN_HALF = 0.25  # half-width in degrees of the city windows joined on phase 3g's index
STREAM_JOIN_WINDOWS = 16  # phase 3h joins 2^26 rows at full depth; 3g checks the rebuilt layout


def _np_window_rows(xs, order, ys, env, alive) -> np.ndarray:
    """Rows inside one window (inclusive float64), alive (None: every row),
    ascending: a searchsorted interval of the x-sorted rows, then the y
    test. ``ys`` and ``alive`` are in the x-sorted order too, so the
    interval is read contiguously."""
    lo = np.searchsorted(xs, env[0], side="left")
    hi = np.searchsorted(xs, env[2], side="right")
    yc = ys[lo:hi]
    keep = (yc >= env[1]) & (yc <= env[3])
    if alive is not None:
        keep &= alive[lo:hi]
    return np.sort(order[lo:hi][keep])


def stream_joins(di, truth, centers) -> dict:
    """Phase 3g's joins and BIN call on the fed 2^22-row index: an envelope
    join of 16 city windows, then again after one more append of 2^14 rows
    and after one more eviction of 2^14 fids; each join's pairs equal numpy
    over the staged rows that are live (row ids in staged order), and each
    mutation bumped the staged generation and rebuilt the join layout. Then
    one BIN rider call (exact bbox + during, the filter scan with the
    plane) against numpy over the live rows."""
    import torch

    from geomesa_tpu_torch.conf import prop_override
    from geomesa_tpu_torch.features.batch import FeatureBatch
    from geomesa_tpu_torch.join import JoinEngine

    c16 = centers[:STREAM_JOIN_WINDOWS]
    wins = np.concatenate([c16 - STREAM_JOIN_HALF, c16 + STREAM_JOIN_HALF], axis=1)
    t = time.time()
    geom = np.concatenate([c["geom"] for _, c in truth.parts])
    order = np.argsort(geom[:, 0])  # any order among equal x: each window's rows are sorted
    xs = geom[order, 0]
    log(f"phase 3g joins: x-sorted {len(geom):,} staged rows for the oracle in {time.time() - t:.1f} s")
    out = {}

    def join_check(tag):
        gen = di._gen
        t = time.perf_counter()
        res = JoinEngine(di).join(wins)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        if di._join_index is None or di._join_index.gen != gen or res.engine != "device":
            raise AssertionError(f"phase 3g join {tag}: layout gen / engine {res.engine}")
        alive = truth.alive[: truth.n][order]
        ys = geom[order, 1]
        starts = np.searchsorted(res.wins, np.arange(len(wins)))
        ends = np.searchsorted(res.wins, np.arange(len(wins)), side="right")
        for j, env in enumerate(wins):
            want = _np_window_rows(xs, order, ys, env, alive)
            if not np.array_equal(res.rows[starts[j]: ends[j]], want):
                raise AssertionError(f"phase 3g join {tag} window {j}: pairs != numpy over the live rows")
        log(f"phase 3g join {tag}: {res.pairs:,} pairs over {len(wins)} city windows == numpy "
            f"(gen {gen}, {res.strategy} level {res.level}, {res.launches} launches, "
            f"{wall * 1e3:.1f} ms, plan {res.plan_s * 1e3:.1f} ms, refine {res.refine_s * 1e3:.1f} ms) "
            f"[{CARD}]")
        out[tag] = {"pairs": res.pairs, "ms": wall * 1e3, "gen": gen}
        return res

    bcast = prop_override("join.broadcast.windows", JOIN_BROADCAST)  # the windows plan their runs
    bcast.__enter__()
    join_check("fed")
    layout = di._join_index
    fids = np.arange(truth.row_of.shape[0] - STREAM_APPEND_ROWS, truth.row_of.shape[0])
    c = delta_columns(STREAM_APPEND_ROWS, SEED + 80, centers)
    di.append(FeatureBatch.from_columns(di.sft, c, fids))
    truth.put(c, fids)
    # the new rows go into the x-sorted oracle arrays where they belong
    new = np.argsort(c["geom"][:, 0])
    pos = np.searchsorted(xs, c["geom"][new, 0])
    order = np.insert(order, pos, len(geom) + new)
    xs = np.insert(xs, pos, c["geom"][new, 0])
    geom = np.concatenate([geom, c["geom"]])
    join_check("after append")
    if di._join_index is layout:
        raise AssertionError("phase 3g: the join layout was not rebuilt after an append")
    layout = di._join_index
    gone = np.nonzero(truth.alive[: truth.n])[0][:: 997][:STREAM_APPEND_ROWS]
    gone_fids = np.concatenate([f for f, _ in truth.parts])[gone]
    di.evict(gone_fids)
    truth.remove(gone_fids)
    join_check("after evict")
    if di._join_index is layout:
        raise AssertionError("phase 3g: the join layout was not rebuilt after an eviction")
    bcast.__exit__(None, None, None)
    # one BIN rider call over the live rows
    b = tuple(_q(v) for v in (centers[0, 0] - 1, centers[0, 1] - 1, centers[0, 0] + 1, centers[0, 1] + 1))
    q = f"BBOX(geom, {b[0]}, {b[1]}, {b[2]}, {b[3]}) AND dtg DURING {_day(10)}/{_day(20)}"
    t = time.perf_counter()
    got = di.bin_rider(q, "count")
    wall = time.perf_counter() - t
    cnt = np.concatenate([c["count"] for _, c in truth.parts])
    dtg = np.concatenate([c["dtg"] for _, c in truth.parts])
    x, y = geom[:, 0].astype(np.float32), geom[:, 1].astype(np.float32)
    sel = (truth.alive[: truth.n] & (x >= np.float32(b[0])) & (x <= np.float32(b[2]))
           & (y >= np.float32(b[1])) & (y <= np.float32(b[3]))
           & (dtg >= T0 + 10 * DAY) & (dtg <= T0 + 20 * DAY))
    if got != np_bin(cnt, dtg, geom, sel):
        raise AssertionError("phase 3g: the BIN rider != numpy over the live rows")
    log(f"phase 3g BIN rider: {int(sel.sum()):,} records == numpy over the live rows in "
        f"{wall * 1e3:.1f} ms [{CARD}]")
    out["bin_rider_ms"] = wall * 1e3
    return out


def run_streaming_path(dev, cols, queries, traffic) -> dict:
    """Phase 3g (module docstring): the streaming index at 2^22 rows fed
    through attach_live, its drive checked against numpy and a restaged
    index; the 2^22 interleaved z3 and z2 indexes; growth and compaction;
    the scheduler burst beside a writer."""
    import threading

    import torch

    from geomesa_tpu_torch import kernels
    from geomesa_tpu_torch.bucketing import bucket_cap
    from geomesa_tpu_torch.conf import sys_prop
    from geomesa_tpu_torch.device_cache import VIS_ID
    from geomesa_tpu_torch.features.batch import FeatureBatch
    from geomesa_tpu_torch.geom import Envelope
    from geomesa_tpu_torch.sched import FusableQuery, QueryScheduler, SchedConfig
    from geomesa_tpu_torch.stream.log import Put, Remove

    out = {"launches": {k: 0 for k in kernels.KERNEL_NAMES},
           "valid": {k: 0 for k in kernels.KERNEL_NAMES}}

    def add_launches(tag):
        launches, valid = dict(kernels.LAUNCHES), dict(kernels.VALID_LAUNCHES)
        _valid_only(tag, launches, valid)
        for k in launches:
            out["launches"][k] += launches[k]
            out["valid"][k] += valid[k]

    centers = cols["_centers"]
    n = len(cols["count"])
    rng = np.random.default_rng(SEED + 40)
    # -- the dim-plane z3 index at phase 3's first 2^22 rows --------------------
    t = time.time()
    cap = n + int(sys_prop("stream.memtable.rows"))
    di = _stream(dev, cols, np.arange(n), GDELT_SPEC, "gdelt", cap)
    torch.cuda.synchronize()
    stage_s = time.time() - t
    if not (di._dim_mode and di._cap == bucket_cap(cap) and VIS_ID not in di._cols):
        raise AssertionError(f"phase 3g: dim mode {di._dim_mode}, capacity {di._cap}")
    log(f"phase 3g: staged {n:,} rows into capacity {di._cap:,} in {stage_s:.2f} s "
        f"({di.nbytes / 1e9:.3f} GB resident, validity plane included) [{CARD}]")
    feed = LiveFeed()
    detach = di.attach_live(feed)
    truth = Truth({k: cols[k] for k in ("count", "dtg", "geom")}, np.arange(n), n + (1 << 21))
    plan = feed_messages(rng, centers, n, STREAM_APPENDS, STREAM_EVICTED, STREAM_UPSERTS, n, SEED + 41)
    kernels.reset_counts()
    lat = apply_feed(feed, plan, truth)
    for kind, v in lat.items():
        log(f"phase 3g latency {kind} ({len(v)} messages, {dict(append=STREAM_APPEND_ROWS, evict=STREAM_EVICTED // STREAM_APPENDS, upsert=STREAM_UPSERT_ROWS)[kind]:,} rows each): "
            f"p50 {pct(v, 50):.3f} ms p99 {pct(v, 99):.3f} ms [{CARD}]")
    live = truth.live()
    if di.restages != 1 or di.delta_appends != STREAM_APPENDS + STREAM_UPSERTS or len(di) != len(live["fid"]):
        raise AssertionError(f"phase 3g: restages {di.restages}, delta_appends {di.delta_appends}, "
                             f"{len(di)} rows vs {len(live['fid'])} live")
    log(f"phase 3g: restages {di.restages}, delta_appends {di.delta_appends}; {di._staged_len():,} "
        f"staged rows, {len(di):,} live")
    out["latency"] = {k: {"p50_ms": pct(v, 50), "p99_ms": pct(v, 99), "n": len(v)} for k, v in lat.items()}
    out["restages"], out["delta_appends"] = di.restages, di.delta_appends
    # the drive: phase 3's queries, density, stats, fused tiles and kNN
    dcalls = [c if c[1] == "z3" else (c[0], "z3") + c[2:] for c in density_calls(queries)]
    scalls = stats_calls(queries)
    tiles = [q for pan in traffic[0] for key, q in pan if key == "z3"][:64]
    targets = [(tuple(centers[0]), 10), (tuple(centers[5]), 1000)]
    kernels.reset_counts()
    res, lat_q = drive_stream_queries(di, queries)
    grids = [di.density(ecql, Envelope(*env), w, h, weight_attr=weight, loose=loose)
             for _, _, ecql, loose, env, (w, h), weight, _, _ in dcalls]
    seqs = [di.stats(ecql, STATS_SPEC, loose=loose).to_json() for _, ecql, loose, _, _, _ in scalls]
    knn = [di.knn(px, py, k) for (px, py), k in targets]
    fused = di.fused_loose_counts(tiles, loose=True)
    fused_q = di.fused_loose_query(tiles[:4], loose=True)
    add_launches("phase 3g z3")
    planes = host_z3_planes(live, base=di._bt_base)
    t = time.time()
    fresh = _fresh(dev, live, GDELT_SPEC, "gdelt")
    log(f"phase 3g: the restaged index of the live rows in {time.time() - t:.2f} s")
    check_stream_queries("z3 2^22", di, fresh, live, queries, res, planes)
    check_fused("z3 2^22", di, fresh, tiles, fused, fused_q)
    check_density_path(live, di, di, planes, planes, dcalls, grids, scalls, seqs)
    for (tag, _, ecql, loose, env, (w, h), weight, _, _), g in zip(dcalls, grids):
        want = fresh.density(ecql, Envelope(*env), w, h, weight_attr=weight, loose=loose)
        if not same_grid(g, want, weight is not None):
            raise AssertionError(f"phase 3g density {tag}: grid != the restaged index's")
    for (tag, ecql, loose, *_), got in zip(scalls, seqs):
        if got != fresh.stats(ecql, STATS_SPEC, loose=loose).to_json():
            raise AssertionError(f"phase 3g stats {tag}: != the restaged index's")
    for ((px, py), k), got in zip(targets, knn):
        rows, d2 = np_knn(live["x"], live["y"], px, py, 45.0, k)
        check_knn(f"phase 3g knn k={k}", (got[0], got[1]), (live["fid"][rows], d2))
    for key, v in lat_q.items():
        log(f"phase 3g latency z3 {key}: p50 {pct(v, 50):.3f} ms p99 {pct(v, 99):.3f} ms [{CARD}]")
    out["query_latency"] = {k: {"p50_ms": pct(v, 50), "p99_ms": pct(v, 99)} for k, v in lat_q.items()}
    del fresh, planes
    torch.cuda.empty_cache()

    # -- the scheduler burst beside a writer -----------------------------------
    burst = [q for pan in traffic[0] for key, q in pan if key == "z3"][:STREAM_BURST]
    stop, errors = threading.Event(), []
    written = []

    def writer():
        try:
            for k in range(16):
                f0 = n + STREAM_APPENDS * STREAM_APPEND_ROWS + k * STREAM_APPEND_ROWS
                fids = np.arange(f0, f0 + STREAM_APPEND_ROWS)
                c = delta_columns(STREAM_APPEND_ROWS, SEED + 500 + k, None, box=CORNER)
                feed.emit(Put(c, fids))
                written.append((fids, c))
                if k:
                    feed.emit(Remove(written[k - 1][0][:STREAM_UPSERT_ROWS]))
        except Exception as e:  # noqa: BLE001 - raised below
            errors.append(e)
        finally:
            stop.set()

    kernels.reset_counts()
    sched = QueryScheduler(SchedConfig(max_queue=SCHED_MAX_QUEUE))
    th = threading.Thread(target=writer)
    t = time.perf_counter()
    th.start()
    try:
        reqs = [sched.submit(fuse=FusableQuery(di, q, "count", loose=True)) for q in burst]
        got = [sched.wait(r) for r in reqs]
        th.join()
        wall = time.perf_counter() - t
        again = [sched.wait(sched.submit(fuse=FusableQuery(di, q, "count", loose=True)))
                 for q in burst]
        snap = sched.snapshot()
    finally:
        sched.close(timeout=10.0)
    if errors:
        raise errors[0]
    add_launches("phase 3g burst")
    detach()
    for fids, c in written:
        truth.put(c, fids)
    for fids, _ in written[:-1]:
        truth.remove(fids[:STREAM_UPSERT_ROWS])
    live = truth.live()
    fresh = _fresh(dev, live, GDELT_SPEC, "gdelt")
    want = fresh.fused_loose_counts(burst[:64], loose=True) + fresh.fused_loose_counts(
        burst[64:128], loose=True) + fresh.fused_loose_counts(burst[128:192], loose=True) + \
        fresh.fused_loose_counts(burst[192:], loose=True)
    if got != want or again != want or len(di) != len(live["fid"]):
        raise AssertionError("phase 3g burst: counts beside the writer != the restaged index's")
    log(f"phase 3g burst: {len(burst)} fused loose counts beside a writer (16 Puts of "
        f"{STREAM_APPEND_ROWS:,} rows, 15 Removes of {STREAM_UPSERT_ROWS:,}) in {wall * 1e3:.1f} ms, {snap['launches']} launches, fusion "
        f"factor {snap['fusion_factor']}, fallbacks {snap.get('fusion_fallbacks', 0)}; every count "
        f"== the restaged index's [{CARD}]")
    del fresh
    kernels.reset_counts()
    out["join"] = stream_joins(di, truth, centers)
    add_launches("phase 3g joins and BIN")
    del di, truth, live
    torch.cuda.empty_cache()

    # -- 2^23 rows: the interleaved z3, the z2 on dim planes, the interleaved z2
    small = {k: cols[k][:STREAM_SMALL] for k in ("count", "dtg", "geom")}
    z2_queries = [(f"BBOX(geom, {b[0]}, {b[1]}, {b[2]}, {b[3]})", b, None) for _, b, _ in queries[:8]]
    z2_tiles = [q.split(" AND ")[0] for q in tiles]
    for tag, spec, name, qs, tl, kw in (
            ("z3 interleaved", GDELT_SPEC, "gdelt", queries[:8], tiles, {"dim_planes": False}),
            ("z2", Z2_SPEC, "points", z2_queries, z2_tiles, {}),
            ("z2 interleaved", Z2_SPEC, "points", z2_queries, z2_tiles, {"dim_planes": False})):
        sdi = _stream(dev, small, np.arange(STREAM_SMALL), spec, name,
                      STREAM_SMALL + int(sys_prop("stream.memtable.rows")), **kw)
        if sdi._dim_mode == ("dim_planes" in kw):
            raise AssertionError(f"phase 3g {tag}: dim mode {sdi._dim_mode}")
        feed = LiveFeed()
        sdi.attach_live(feed)
        truth = Truth(small, np.arange(STREAM_SMALL), STREAM_SMALL + (1 << 21))
        plan = feed_messages(rng, centers, STREAM_SMALL, 16, STREAM_EVICTED // 4, 4, STREAM_SMALL,
                             SEED + 60)
        kernels.reset_counts()
        lat = apply_feed(feed, plan, truth)
        live = truth.live()
        if sdi.restages != 1 or len(sdi) != len(live["fid"]):
            raise AssertionError(f"phase 3g {tag}: restages {sdi.restages}, {len(sdi)} rows")
        res, lat_q = drive_stream_queries(sdi, qs)
        counts = sdi.fused_loose_counts(tl, loose=True)
        feats = sdi.fused_loose_query(tl[:4], loose=True)
        add_launches(f"phase 3g {tag}")
        fresh = _fresh(dev, live, spec, name, **kw)
        check_stream_queries(tag, sdi, fresh, live, qs, res)
        check_fused(tag, sdi, fresh, tl, counts, feats)
        log(f"phase 3g {tag} 2^23: append p50 {pct(lat['append'], 50):.3f} ms, evict p50 "
            f"{pct(lat['evict'], 50):.3f} ms, upsert p50 {pct(lat['upsert'], 50):.3f} ms; restages "
            f"{sdi.restages}, delta_appends {sdi.delta_appends}; count p50 loose "
            f"{pct(lat_q['count_loose'], 50):.3f} ms exact {pct(lat_q['count_exact'], 50):.3f} ms [{CARD}]")
        del sdi, truth, live, fresh
        torch.cuda.empty_cache()

    # -- growth and compaction at 2^22 rows --------------------------------------
    grow = {k: cols[k][:STREAM_GROW] for k in ("count", "dtg", "geom")}
    gdi = _stream(dev, grow, np.arange(STREAM_GROW), GDELT_SPEC, "gdelt", STREAM_GROW)
    truth = Truth(grow, np.arange(STREAM_GROW), STREAM_GROW + (1 << 21))
    c = delta_columns(STREAM_APPEND_ROWS, SEED + 70, centers)
    fids = np.arange(STREAM_GROW, STREAM_GROW + STREAM_APPEND_ROWS)
    kernels.reset_counts()
    t = time.perf_counter()
    gdi.append(FeatureBatch.from_columns(gdi.sft, c, fids))
    torch.cuda.synchronize()
    grow_s = time.perf_counter() - t
    truth.put(c, fids)
    if gdi.restages != 2 or gdi._cap != bucket_cap(2 * (STREAM_GROW + STREAM_APPEND_ROWS)):
        raise AssertionError(f"phase 3g growth: restages {gdi.restages}, capacity {gdi._cap}")
    gone = rng.permutation(STREAM_GROW)[: int(0.55 * STREAM_GROW)]
    t = time.perf_counter()
    gdi.evict(gone)
    torch.cuda.synchronize()
    compact_s = time.perf_counter() - t
    truth.remove(gone)
    if gdi.restages != 3 or gdi._n_dead != 0:
        raise AssertionError(f"phase 3g compaction: restages {gdi.restages}, {gdi._n_dead} dead")
    live = truth.live()
    res, _ = drive_stream_queries(gdi, queries[:8])
    add_launches("phase 3g growth")
    check_stream_queries("z3 2^22 after growth and compaction", gdi,
                         _fresh(dev, live, GDELT_SPEC, "gdelt"), live, queries[:8], res)
    log(f"phase 3g restage seconds at {STREAM_GROW:,} rows: growth {grow_s:.3f} s (capacity "
        f"{STREAM_GROW:,} -> {gdi._cap:,}), "
        f"compaction {compact_s:.3f} s (55% dead) [{CARD}]")
    out["growth_s"], out["compaction_s"] = grow_s, compact_s
    del gdi
    torch.cuda.empty_cache()
    log(json.dumps({"stream": {k: out[k] for k in ("latency", "query_latency", "restages",
                                                   "delta_appends", "growth_s", "compaction_s")},
                    "card": CARD}))
    return out


# -- phase 3h: spatial joins on NYC-Taxi-shaped pickups (BASELINE config #3) --

TAXI_SPEC = "passenger_count:Int,trip_distance:Float,dtg:Date,*geom:Point:srid=4326"
TAXI_N = 1 << 26
TAXI_EXTENT = (-74.26, 40.49, -73.70, 40.92)
T15 = 1_420_070_400_000  # 2015-01-01T00:00:00Z
TAXI_DAYS = 31
TAXI_ZONES = 263  # TLC's taxi-zone map has 263 zones
ZONE_WIDEN = 0.002  # each zone widened so that neighbours overlap
ZONE_MIN = 0.012  # no kd cut leaves a zone narrower than this (degrees)
N_STATIONS = 64
STATION_D = 0.003
JOIN_REPEATS = 1  # timed calls of each day-level join kind (a cut: PERF.md section 4)
# right sides at or below this broadcast (the default, 64, would broadcast
# the 64 stations: 2^32 candidates at 2^26 rows); the boroughs still do
JOIN_BROADCAST = 8
# borough-like polygons: (centre, radii in x and y, vertices) for a
# Manhattan, Brooklyn, Queens, the Bronx and Staten Island
BOROUGHS = [((-73.970, 40.775), (0.030, 0.085), 64), ((-73.950, 40.645), (0.070, 0.055), 48),
            ((-73.820, 40.715), (0.090, 0.065), 56), ((-73.870, 40.845), (0.050, 0.040), 40),
            ((-74.150, 40.580), (0.060, 0.050), 32)]


def make_taxi(n: int, seed: int) -> dict:
    """NYC-Taxi-shaped pickups of January 2015 inside TAXI_EXTENT: 70% in 24
    Manhattan-like clusters (sigma 0.006 degrees) along the island, the
    rest uniform; float32 coordinates."""
    rng = np.random.default_rng(seed)
    x0, y0, x1, y1 = TAXI_EXTENT
    t = rng.uniform(0.0, 1.0, 24)
    cx = -74.012 + 0.075 * t + rng.normal(0.0, 0.003, 24)
    cy = 40.705 + 0.14 * t + rng.normal(0.0, 0.003, 24)
    cid = rng.integers(0, 24, n)
    x = cx[cid] + rng.normal(0.0, 0.006, n)
    y = cy[cid] + rng.normal(0.0, 0.006, n)
    del cid
    uni = rng.random(n) >= 0.7
    x[uni] = rng.uniform(x0, x1, int(uni.sum()))
    y[uni] = rng.uniform(y0, y1, int(uni.sum()))
    geom = np.empty((n, 2))
    geom[:, 0] = np.clip(x, x0, x1).astype(np.float32)
    geom[:, 1] = np.clip(y, y0, y1).astype(np.float32)
    return {"passenger_count": rng.integers(1, 7, n).astype(np.int32),
            "trip_distance": rng.exponential(2.8, n).astype(np.float32),
            "dtg": T15 + rng.integers(0, TAXI_DAYS * DAY, n), "geom": geom}


def taxi_zones(geom, seed: int) -> np.ndarray:
    """TAXI_ZONES zone envelopes: a seeded kd split of the extent (the zone
    holding the most of a 2^16-row sample splits at a sample quantile
    between 35% and 65% across its longer side, no side under ZONE_MIN),
    each widened by ZONE_WIDEN."""
    rng = np.random.default_rng(seed)
    sample = geom[rng.integers(0, len(geom), 1 << 16)]
    boxes = [(TAXI_EXTENT, np.arange(len(sample)))]
    while len(boxes) < TAXI_ZONES:
        weight = [len(i) if max(b[2] - b[0], b[3] - b[1]) >= 2 * ZONE_MIN else -1 for b, i in boxes]
        (bx0, by0, bx1, by1), idx = boxes.pop(int(np.argmax(weight)))
        ax = 0 if bx1 - bx0 >= by1 - by0 else 1
        lo, hi = (bx0, bx1) if ax == 0 else (by0, by1)
        v = np.sort(sample[idx, ax])
        cut = float(v[int(len(v) * rng.uniform(0.35, 0.65))]) if len(v) > 8 else (lo + hi) / 2
        cut = min(max(cut, lo + ZONE_MIN), hi - ZONE_MIN)
        a, b = idx[sample[idx, ax] < cut], idx[sample[idx, ax] >= cut]
        if ax == 0:
            boxes += [((bx0, by0, cut, by1), a), ((cut, by0, bx1, by1), b)]
        else:
            boxes += [((bx0, by0, bx1, cut), a), ((bx0, cut, bx1, by1), b)]
    envs = np.array([b for b, _ in boxes], np.float64)
    envs[:, :2] -= ZONE_WIDEN
    envs[:, 2:] += ZONE_WIDEN
    return envs


def borough_rings(seed: int) -> list:
    """Closed float64 rings of the five borough-like polygons: star-shaped,
    32-64 vertices at sorted angles, radius jittered by up to 25%."""
    rng = np.random.default_rng(seed)
    rings = []
    for (cx, cy), (rx, ry), k in BOROUGHS:
        ang = np.sort(rng.uniform(0.0, 2 * np.pi, k))
        r = rng.uniform(0.75, 1.25, k)
        ring = np.stack([cx + rx * r * np.cos(ang), cy + ry * r * np.sin(ang)], axis=1)
        rings.append(np.concatenate([ring, ring[:1]]))
    return rings


def np_even_odd(px, py, ring) -> np.ndarray:
    """Points strictly inside a closed ring by the even-odd crossing test
    (an edge counts where it straddles the point's horizontal, half-open in
    y; the crossing lies right of the point), over row blocks."""
    x1, y1, x2, y2 = ring[:-1, 0], ring[:-1, 1], ring[1:, 0], ring[1:, 1]
    out = np.zeros(len(px), bool)
    for s in range(0, len(px), 1 << 18):
        xs, ys = px[s: s + (1 << 18), None], py[s: s + (1 << 18), None]
        straddle = (y1 > ys) != (y2 > ys)
        with np.errstate(divide="ignore", invalid="ignore"):
            xint = x1 + (ys - y1) * (x2 - x1) / (y2 - y1)
        out[s: s + (1 << 18)] = (straddle & (xs < xint)).sum(axis=1) % 2 == 1
    return out


def _split_pairs(rows, wins, m) -> list:
    """Pairs sorted (window, row) -> the rows of each window."""
    starts = np.searchsorted(wins, np.arange(m))
    ends = np.searchsorted(wins, np.arange(m), side="right")
    return [rows[a:b] for a, b in zip(starts, ends)]


def _same_join(tag, a, b) -> None:
    """Two JoinResults with the same pairs and plan (the engine and its
    launches aside: the host engine counts one launch a batch)."""
    ra, rb = a.report(), b.report()
    for k in ("strategy", "level", "pairs", "candidates", "skew_splits", "stats"):
        if ra[k] != rb[k]:
            raise AssertionError(f"{tag}: {k} {ra[k]} != {rb[k]} under join.engine=host")
    if not (np.array_equal(a.rows, b.rows) and np.array_equal(a.wins, b.wins)):
        raise AssertionError(f"{tag}: pairs != the host engine's")


def _pred_pairs(res) -> tuple:
    """A predicate join's (left, right, pairs) -> (row ids, windows)."""
    left, _, pairs = res
    return left.fids[pairs[:, 0]], pairs[:, 1]


def run_join_path(dev) -> dict:
    """Phase 3h (module docstring): 2^26 NYC-Taxi-shaped pickups staged
    with key planes; the envelope join against the 263 zones, whole and
    gated by a day and four hours; window_pairs_query over the zones with a
    one-day base filter; intersects of a day against 5 borough polygons
    and dwithin 0.003 degrees of a day against 64 stations; every answer
    against numpy and the host engine, every gate on a scan kernel."""
    import torch

    from geomesa_tpu_torch import kernels
    from geomesa_tpu_torch.conf import prop_override
    from geomesa_tpu_torch.device_cache import DeviceIndex
    from geomesa_tpu_torch.features.batch import FeatureBatch
    from geomesa_tpu_torch.features.sft import SimpleFeatureType
    from geomesa_tpu_torch.geom import Polygon
    from geomesa_tpu_torch.join import JoinEngine
    from geomesa_tpu_torch.process.join import spatial_join
    from geomesa_tpu_torch.store.direct import BatchStore

    t = time.time()
    cols = make_taxi(TAXI_N, SEED + 90)
    zones = taxi_zones(cols["geom"], SEED + 91)
    rings = borough_rings(SEED + 92)
    srng = np.random.default_rng(SEED + 93)
    st = _f32(np.concatenate([cols["geom"][srng.integers(0, TAXI_N, 48)],
                              srng.uniform(TAXI_EXTENT[:2], TAXI_EXTENT[2:], (16, 2))]))
    gen_s = time.time() - t
    t = time.time()
    store = BatchStore(FeatureBatch.from_columns(SimpleFeatureType.create("taxi", TAXI_SPEC), cols))
    di = DeviceIndex(store, "taxi", z_planes=True, device=dev)
    torch.cuda.synchronize()
    stage_s = time.time() - t
    boroughs = FeatureBatch.from_columns(
        SimpleFeatureType.create("boroughs", "name:String,*geom:Polygon:srid=4326"),
        {"name": ["manhattan", "brooklyn", "queens", "bronx", "staten"],
         "geom": np.array([Polygon(r) for r in rings], dtype=object)})
    stations = FeatureBatch.from_columns(
        SimpleFeatureType.create("stations", "name:String,*geom:Point:srid=4326"),
        {"name": [f"s{i}" for i in range(N_STATIONS)], "geom": st})
    log(f"phase 3h: generated {TAXI_N:,} pickups, {len(zones)} zones in {gen_s:.1f} s; staged in "
        f"{stage_s:.2f} s ({di.nbytes / 1e9:.3f} GB resident, dim planes {di._dim_mode})")
    day = (T15 + 9 * DAY, T15 + 10 * DAY)
    day_q = f"dtg DURING {_iso(day[0])}/{_iso(day[1])}"
    hours = [(T15 + 9 * DAY + h * 3_600_000, T15 + 9 * DAY + (h + 1) * 3_600_000) for h in (0, 8, 13, 18)]
    scan = "filter_scan_mask"
    calls = Calls()
    bcast = prop_override("join.broadcast.windows", JOIN_BROADCAST)
    bcast.__enter__()
    kernels.reset_counts()
    t = time.perf_counter()
    jidx = JoinEngine(di).prepare()
    torch.cuda.synchronize()
    prepare_s = time.perf_counter() - t
    full = calls.run("join full", lambda: spatial_join(store, "taxi", zones, device_index=di))
    res_day = [calls.run("join day", lambda: spatial_join(store, "taxi", zones, device_index=di,
                                                          left_filter=day_q), scan)
               for _ in range(JOIN_REPEATS)]
    hour_q = [f"dtg DURING {_iso(a)}/{_iso(b)}" for a, b in hours]
    res_hour = [calls.run("join hour", lambda q=q: spatial_join(store, "taxi", zones, device_index=di,
                                                                left_filter=q), scan) for q in hour_q]
    res_wp = [calls.run("window pairs day", lambda: di.window_pairs_query(zones, base=day_q), scan)
              for _ in range(JOIN_REPEATS)]
    res_int = [calls.run("intersects day", lambda: spatial_join(
        store, "taxi", boroughs, on="intersects", left_filter=day_q, device_index=di), scan)
        for _ in range(2)]
    res_dw = [calls.run("dwithin day", lambda: spatial_join(
        store, "taxi", stations, on="dwithin", distance=STATION_D, left_filter=day_q, device_index=di),
        scan) for _ in range(JOIN_REPEATS)]
    torch.cuda.synchronize()
    launches = read_launches("join path", calls.want)
    if di._join_index is not jidx or full.engine != "device":
        raise AssertionError(f"phase 3h: the layout was rebuilt, or the engine was {full.engine}")
    calls.log_latency("join")
    full_s = calls.lat["join full"][0]
    log(f"phase 3h: prepare {prepare_s:.3f} s at {TAXI_N:,} rows ({jidx.kind}, "
        f"{'identity' if jidx.perm is None else 'sorted'} permutation); full join {full.pairs:,} pairs "
        f"in {full_s:.3f} s = {full.pairs / full_s:,.0f} pairs/s, {full.strategy} level {full.level}, "
        f"{full.candidates:,} candidates, {full.launches} launches, {full.splits} skew splits, plan "
        f"{full.plan_s:.4f} s refine {full.refine_s:.4f} s [{CARD}]")
    for tag, r in (("day", res_day[0]), *((f"hour {i}", h) for i, h in enumerate(res_hour))):
        log(f"phase 3h join {tag}: {r.pairs:,} pairs, {r.candidates:,} candidates, plan "
            f"{r.plan_s:.4f} s refine {r.refine_s:.4f} s [{CARD}]")

    # -- checks -----------------------------------------------------------------
    t = time.time()
    x64, y64, dtg = cols["geom"][:, 0], cols["geom"][:, 1], cols["dtg"]
    # the layout built on the card: host Z2 keys of its planes (every 16th
    # row), non-decreasing keys, a stable permutation, the planes gathered by it
    from geomesa_tpu_torch.curves.z2 import Z2SFC

    keys, perm = jidx.keys, jidx.perm
    eq = keys[1:] == keys[:-1]
    if not (np.array_equal(Z2SFC().index(jidx.planes["x"][::16], jidx.planes["y"][::16]),
                           keys[::16]) and (keys[1:] >= keys[:-1]).all()
            and (perm[1:][eq] > perm[:-1][eq]).all()
            and np.array_equal(jidx.planes["x"], x64[perm]) and np.array_equal(jidx.planes["y"], y64[perm])):
        raise AssertionError("phase 3h: the card's join layout != the host encode and a stable sort")
    in_day = (dtg >= day[0]) & (dtg <= day[1])

    # the same joins on the host engine, one thread each; not the full join,
    # whose host lexsort of 10^8 pairs alone held the checks ~40 s, nor the
    # hours (the numpy oracle checks them; the day's checks the gate)
    host_calls = {
        "day": lambda: spatial_join(store, "taxi", zones, device_index=di, left_filter=day_q),
        "int": lambda: spatial_join(store, "taxi", boroughs, on="intersects", left_filter=day_q,
                                    device_index=di),
        "dw": lambda: spatial_join(store, "taxi", stations, on="dwithin", distance=STATION_D,
                                   left_filter=day_q, device_index=di),
    }
    with prop_override("join.engine", "host"), ThreadPoolExecutor(max_workers=8) as pool:
        host_f = {k: pool.submit(fn) for k, fn in host_calls.items()}
        order = np.argsort(x64)  # any order among equal x: each zone's rows are sorted
        xs, ys = x64[order], y64[order]
        want = list(pool.map(lambda e: _np_window_rows(xs, order, ys, e, None), zones))
        host = {k: f.result() for k, f in host_f.items()}
    bcast.__exit__(None, None, None)
    _same_join("phase 3h join day", res_day[0], host["day"])
    for tag, got, gate in (("full", full, None), ("day", res_day[0], in_day),
                           *((f"hour {i}", r, (dtg >= a) & (dtg <= b))
                             for i, (r, (a, b)) in enumerate(zip(res_hour, hours)))):
        for j, rows in enumerate(_split_pairs(got.rows, got.wins, len(zones))):
            w = want[j] if gate is None else want[j][gate[want[j]]]
            if not np.array_equal(rows, w):
                raise AssertionError(f"phase 3h join {tag} zone {j}: pairs != numpy")
    for r in res_day[1:]:
        _same_join("phase 3h join day repeat", r, res_day[0])
    # window pairs: numpy over the float32 planes widened one ulp, in the
    # pack's order (group, row, window)
    x32, y32 = x64.astype(np.float32), y64.astype(np.float32)
    drows = np.nonzero(in_day)[0]
    e = _f32(zones).astype(np.float32)
    e[:, :2] = np.nextafter(e[:, :2], np.float32(-np.inf))
    e[:, 2:] = np.nextafter(e[:, 2:], np.float32(np.inf))
    wr, ww = [], []
    xr, yr = x32[drows], y32[drows]
    for j, (a, b, c, d) in enumerate(e):
        r = drows[(xr >= a) & (xr <= c) & (yr >= b) & (yr <= d)]
        wr.append(r)
        ww.append(np.full(len(r), j))
    wr, ww = np.concatenate(wr), np.concatenate(ww)
    o = np.lexsort((ww, wr, ww // 64))
    for got in res_wp:
        if not (np.array_equal(got[0], wr[o]) and np.array_equal(got[1], ww[o])):
            raise AssertionError("phase 3h window pairs: != numpy over the widened float32 planes")
    # predicate joins: the host engine and numpy
    for tag, res, h in (("intersects", res_int, host["int"]), ("dwithin", res_dw, host["dw"])):
        want_p = _pred_pairs(h)
        for r in res:
            got_p = _pred_pairs(r)
            if not (np.array_equal(got_p[0], want_p[0]) and np.array_equal(got_p[1], want_p[1])):
                raise AssertionError(f"phase 3h {tag}: pairs != the host engine's")
    dx, dy = x64[drows], y64[drows]
    rows_i = [drows[np_even_odd(dx, dy, ring)] for ring in rings]
    rows_d = [drows[np.hypot(dx - sx, dy - sy) <= STATION_D] for sx, sy in st]
    for tag, res, want_rows in (("intersects", res_int[0], rows_i), ("dwithin", res_dw[0], rows_d)):
        got_r, got_w = _pred_pairs(res)
        for j, rows in enumerate(_split_pairs(got_r, got_w, len(want_rows))):
            if not np.array_equal(rows, want_rows[j]):
                raise AssertionError(f"phase 3h {tag} right row {j}: pairs != numpy")
    n_wp = len(res_wp[0][0])
    log(f"phase 3h checks: full join {full.pairs:,} pairs, day {res_day[0].pairs:,}, hours "
        f"{[r.pairs for r in res_hour]}, window pairs {n_wp:,}, intersects "
        f"{[len(r) for r in rows_i]}, dwithin {sum(len(r) for r in rows_d):,}: equal to numpy and "
        f"the host engine, in {time.time() - t:.1f} s")
    summary = {
        "rows": TAXI_N, "zones": len(zones), "prepare_s": prepare_s,
        "full": {"pairs": full.pairs, "s": full_s, "pairs_per_s": full.pairs / full_s,
                 "plan_s": full.plan_s, "refine_s": full.refine_s, "strategy": full.strategy,
                 "level": full.level, "candidates": full.candidates, "launches": full.launches},
        "p50_ms": {k: pct(v, 50) for k, v in calls.lat.items()},
        "window_pairs": n_wp,
    }
    log(json.dumps({"join": summary, "card": CARD}))
    del host, want, order, xs, ys
    return {"launches": launches, "di": di, "zones": zones, "summary": summary}


# -- phase 4: kernel timings --------------------------------------------------


L2_FLUSH_BYTES = 128 << 20  # more than the H100's 50 MB L2


def time_ms(fn, iters: int, warm: int = 3, flush_l2: bool = False) -> float:
    """fn's time a call on the card: CUDA events over ``iters`` calls after
    ``warm`` ones. With ``flush_l2``, a buffer larger than the L2 cache is
    overwritten before each timed call, so that its inputs come from device
    memory, and an event pair around each call times the calls alone."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    if flush_l2:
        buf = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.int32, device=torch.cuda.current_device())
        marks = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                 for _ in range(iters)]
        for i, (start, end) in enumerate(marks):
            buf.fill_(i)
            start.record()
            fn()
            end.record()
        torch.cuda.synchronize()
        return sum(start.elapsed_time(end) for start, end in marks) / iters
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_call_ms(fn, iters: int = 50) -> float:
    """The host's time to issue one call (a wrapper's checks, allocation and
    launch): the host clock over ``iters`` calls enqueued back to back, no
    synchronise inside."""
    import torch

    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    ms = (time.perf_counter() - t) / iters * 1e3
    torch.cuda.synchronize()
    return ms


def _program_ops(prog) -> int:
    from geomesa_tpu_torch.ops import filter_scan as fs

    per = {fs.OP_BBOX: 7, fs.OP_BBOX_ENV: 7, fs.OP_DWITHIN: 6, fs.OP_CMP_F32: 1,
           fs.OP_CMP_I32: 1, fs.OP_CMP_I64: 5, fs.OP_AND: 1, fs.OP_OR: 1, fs.OP_NOT: 1}
    ops = 0
    for op, *_, n_edges, _ in prog.instr.tolist():
        ops += 9 * n_edges + 2 if op == fs.OP_PIP else per.get(op, 0)
    return ops


# ALU operations of the interleaved scan's steps (see zscan_ops): one
# dimension's 64-bit masked compare (an AND pair and two 64-bit compares of
# two 32-bit compares each); one de-interleaved dimension's 32-bit compare
# pair; one dimension's de-interleave of a 64-bit key (per 32-bit half a
# mask and 4 masks, its 4 multiplies on the FMA pipe; 3 merges); a bin
# lookup (a subtract, a range check, a load and a test).
MASKED_DIM_OPS, COMPACT_DIM_OPS, DEINTERLEAVE_DIM_OPS, LOOKUP_OPS = 6, 2, 13, 4


def zscan_ops(lbs, hi, lo, bins=None) -> int:
    """The least ALU work of the interleaved scan's function on this data
    for the queries ``lbs`` (their loose bounds), whatever implements it.
    A z3 row looks its bin up once; z2 rows have no bins. An entry of the
    row's bin (z2: every query's) is tested a dimension at a time, in
    order, until one fails, and an entry with lo > hi in a dimension is
    empty and needs nothing. With E the dimensions a row's entries so need
    and D the dimensions of its key that some entry reaches, the row takes
    the cheaper way: E masked compares, or D de-interleaved dimensions and
    E compare pairs on them. The multiplies run on the FMA pipe beside the
    ALU and are fewer than its operations, so the ALU's count over its rate
    is the least time. E and D are counted on these rows."""
    import torch

    from geomesa_tpu_torch.ops.int64lanes import widen_u32

    z = (widen_u32(hi) << 32) | widen_u32(lo)
    by_bin = {}  # bin (None: z2) -> (n_dims, 6) bounds of its entries
    for lb in lbs:
        if lb[2] is None:
            by_bin.setdefault(None, []).append(np.asarray(lb[1]).reshape(-1, 6))
        else:
            for b, i in zip(lb[1], lb[2]):
                if i >= 0:
                    by_bin.setdefault(int(i), []).append(np.asarray(b).reshape(-1, 6))
    ops = 0 if bins is None else LOOKUP_OPS * z.shape[0]
    for b, entries in by_bin.items():
        zb = z if b is None else z[bins == b]
        need = torch.zeros_like(zb)  # E
        reach = [torch.zeros(zb.shape, dtype=torch.bool, device=zb.device) for _ in entries[0]]
        for e in entries:
            w = e.astype(np.uint64)
            mask, elo, ehi = ((w[:, k] << np.uint64(32)) | w[:, k + 1] for k in (0, 2, 4))
            if (elo > ehi).any():
                continue
            if max(mask.max(), ehi.max()) >= 1 << 63:
                raise ValueError("zscan_ops takes bounds below 2^63, as every key is")
            alive = torch.ones_like(reach[0])
            for d in range(len(e)):
                reach[d] |= alive
                need += alive
                zm = zb & int(mask[d])
                alive = alive & (zm >= int(elo[d])) & (zm <= int(ehi[d]))
        deint = sum(r.to(torch.int64) for r in reach)  # D
        ops += int(torch.minimum(MASKED_DIM_OPS * need,
                                 COMPACT_DIM_OPS * need + DEINTERLEAVE_DIM_OPS * deint).sum())
    return ops


# ALU operations of the batched dim scan's lookup (see dimscan_ops): one
# level of a search tree (a compare and the index update), and one AND of
# two 64-bit hit words (two 32-bit ANDs).
SEARCH_LEVEL_OPS, WORD_AND_OPS = 2, 2


def _dim_way(qmat, kind: str) -> str:
    """Which way of the batched dim scan a count or mask of the group takes."""
    from geomesa_tpu_torch.ops import zscan

    return "compare way" if zscan.batched_dimscan(qmat).takes_compare(kind == "mask") \
        else "lookup way"


def dimscan_ops(qmat, n: int) -> int:
    """The least ALU work of the batched dim scan's function on n rows for
    the group ``qmat``, whatever implements it by lookup: in each dimension
    (nx, ny and, with bt ranges, bt) a row finds which of the m + 1
    intervals of that dimension's m cuts (``zscan.batched_dimscan``: lo and
    hi + 1 of the group's ranges) holds its value, which takes a comparison
    search ceil(log2(m + 1)) levels deep, a compare and an index update a
    level; then it ANDs its intervals' 64-bit words, one AND fewer than the
    dimensions. The loads of the cuts and words are not ALU operations, and
    the count's additions and the mask's transposes are left out, so the
    bound stays at or below the kernel's work. It does not grow with Q, as
    the former compare loop's Q x (4 + 2R) compares a row did; the cuts are
    counted on this group."""
    from geomesa_tpu_torch.ops import zscan

    depths = zscan.batched_dimscan(qmat).depths
    return n * (SEARCH_LEVEL_OPS * sum(depths) + WORD_AND_OPS * (len(depths) - 1))


def kernel_table(dev, di3, di2, inter, queries, z2_queries, launches, valid_launches,
                 errs: Errs) -> list:
    """Time each kernel at the main path's shapes; compare it with its
    plain version on those inputs too. Each scan has a second row with a
    validity plane (50% of the rows live at random, ``"valid": true``):
    its bound adds the plane's 1 B/row and one AND a row, its launches are
    the main path's launches that read a plane."""
    import torch

    from geomesa_tpu_torch.curves.z3 import Z3SFC
    from geomesa_tpu_torch.device_cache import Z_BT, Z_NX, Z_NY
    from geomesa_tpu_torch.filter.ecql import parse_ecql
    from geomesa_tpu_torch.ops import filter_scan, zscan

    n = len(di3)
    ecql = queries[0][0]  # the bench's Europe 5-day query
    _, q3, r3 = di3._loose_bounds(parse_ecql(ecql))
    p3 = (di3._cols[Z_NX], di3._cols[Z_NY], di3._cols[Z_BT])
    _, q2, _ = di2._loose_bounds(parse_ecql(z2_queries[0]))
    p2 = (di2._cols[Z_NX], di2._cols[Z_NY])
    cf = di3._compiled_for(parse_ecql(ecql))
    fcols = di3._resident_subset(cf)
    fbytes = 4 * len(cf.program.cols)
    rows = []

    n_all = len(di3)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 9)
    half = torch.rand(n_all, generator=gen, device=dev) < 0.5

    def row(name, source, replaces, kern, plain, in_bytes, out_bytes, ops, plain_iters=5,
            case=None, valid=None):
        """One kernel row; with ``valid`` (a function of the plane returning
        the (kernel, plain) pair), a second row under the plane."""
        got, want = kern(), plain()
        errs.check(name, got.reshape(-1), want.reshape(-1), f"main-path shapes {case or ''}")
        ms = time_ms(kern, 50)
        plain_ms = time_ms(plain, plain_iters, warm=min(3, plain_iters))
        t_bytes = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
        t_ops = ops / INT32_OPS_PER_S * 1e3
        rows.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": errs.err[name],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None,
        })
        if name.startswith("filter_scan"):
            rows[-1]["host_ms"] = host_call_ms(kern)
        if case:
            rows[-1]["case"] = case
        if valid is not None:
            vk, vp = valid(half)
            vcase = f"{case + ', ' if case else ''}validity plane, 50% live"
            row(name, source, replaces, vk, vp, in_bytes + n_all, out_bytes, ops + n_all,
                plain_iters, vcase)
            rows[-1]["valid"] = True
            rows[-1]["launches"] = valid_launches[name]
        host = f"; the wrapper's host time {rows[-1]['host_ms']:.4f} ms a call" if "host_ms" in rows[-1] else ""
        log(f"{name}{f' ({case})' if case else ''}: {ms:.4f} ms (bound {max(t_bytes, t_ops):.4f} ms: bytes {t_bytes:.4f}, "
            f"operations {t_ops:.4f}; {(in_bytes + out_bytes) / ms / 1e6:.1f} GB/s, "
            f"{n / ms / 1e6:.2f} G rows/s); plain version {plain_ms:.3f} ms (not a yardstick){host} "
            f"[{CARD}]")

    dim_src = "geomesa_tpu_torch/csrc/dimscan.cu"
    fs_src = "geomesa_tpu_torch/csrc/filter_scan.cu"
    rz3 = "geomesa_tpu/ops/zscan.py:548 build_z3_dimscan_rt"
    rz2 = "geomesa_tpu/ops/zscan.py:438 build_z2_dimscan_rt"
    rfs = "geomesa_tpu/ops/pallas_scan.py:203 build_pallas_scan"
    def dim(q, p, mask):
        def pair(v=None):
            kern = (lambda: zscan.dimscan_mask(q, *p, valid=v)) if mask else (
                lambda: zscan.dimscan_count(q, *p, valid=v))
            plain = (lambda: zscan.dimscan_plain(q, *p, valid=v)) if mask else (
                lambda: zscan.dimscan_plain(q, *p, valid=v).sum(dtype=torch.int32))
            return kern, plain
        return pair

    row("dimscan_z3_count", dim_src, f"{rz3} (pallas_call :643)", *dim(q3, p3, False)(),
        12 * n, 4, n * (4 + 2 * r3), valid=dim(q3, p3, False))
    row("dimscan_z3_mask", dim_src, f"{rz3} (pallas_call :669)", *dim(q3, p3, True)(),
        12 * n, n, n * (4 + 2 * r3), valid=dim(q3, p3, True))
    row("dimscan_z2_count", dim_src, f"{rz2} (pallas_call :498)", *dim(q2, p2, False)(),
        8 * n, 4, n * 4, valid=dim(q2, p2, False))
    row("dimscan_z2_mask", dim_src, f"{rz2} (pallas_call :521)", *dim(q2, p2, True)(),
        8 * n, n, n * 4, valid=dim(q2, p2, True))

    # the baked dim scan on the same window, beside the runtime kernel
    w = window_ms(queries[0][2])
    qnx, qny, ranges = zscan.z3_dim_plane_query(Z3SFC(), *queries[0][1], *w, di3._bt_base)
    bc, bm = zscan.build_z3_dimscan_pallas(qnx, qny, ranges)
    bake_src = "geomesa_tpu_torch/csrc/dimscan_baked.cu"
    rbake = "geomesa_tpu/ops/zscan.py:703 build_z3_dimscan_pallas"
    bake_ops = n * (4 + 2 * len(ranges))
    row("dimscan_baked_count", bake_src, f"{rbake} (pallas_call :772)", lambda: bc(*p3),
        lambda: zscan.z3_dimscan_mask(*p3, qnx, qny, ranges).sum(dtype=torch.int32),
        12 * n, 4, bake_ops)
    row("dimscan_baked_mask", bake_src, f"{rbake} (pallas_call :790)", lambda: bm(*p3),
        lambda: zscan.z3_dimscan_mask(*p3, qnx, qny, ranges), 12 * n, n, bake_ops)

    # the interleaved scan: a 2-bin main-path window (Africa, days 6-13)
    zs_src = "geomesa_tpu_torch/csrc/zscan.cu"
    rzs = "geomesa_tpu/ops/zscan.py:848 build_z3_pallas_scan"
    di3i, di2i = inter["di3i"], inter["di2i"]
    lb = di3i._loose_bounds(parse_ecql(queries[3][0]))
    zc, zm, ops3 = di3i._loose_args(lb)
    bounds, ids = lb[1], lb[2]
    zops = zscan_ops([lb], ops3[1], ops3[2], ops3[0])
    log(f"zscan_z3 timing window: {queries[3][0]} ({int((ids >= 0).sum())} bins, "
        f"{len(ids)} entries)")
    def zs3(v):
        return (lambda: zc(*ops3, valid=v), lambda: (zscan.z3_zscan_mask(
            ops3[1], ops3[2], ops3[0], bounds, ids) & v).sum(dtype=torch.int32))

    def zs3m(v):
        return (lambda: zm(*ops3, valid=v),
                lambda: zscan.z3_zscan_mask(ops3[1], ops3[2], ops3[0], bounds, ids) & v)

    row("zscan_z3_count", zs_src, f"{rzs} (pallas_call :942)", lambda: zc(*ops3),
        lambda: zscan.z3_zscan_mask(ops3[1], ops3[2], ops3[0], bounds, ids).sum(dtype=torch.int32),
        12 * n, 4, zops, plain_iters=2, valid=zs3)
    row("zscan_z3_mask", zs_src, f"{rzs} (pallas_call :960)", lambda: zm(*ops3),
        lambda: zscan.z3_zscan_mask(ops3[1], ops3[2], ops3[0], bounds, ids),
        12 * n, n, zops, plain_iters=2, valid=zs3m)
    lb2 = di2i._loose_bounds(parse_ecql(z2_queries[0]))
    z2c, z2m, ops2 = di2i._loose_args(lb2)
    z2ops = zscan_ops([lb2], *ops2)
    row("zscan_z2_count", zs_src, f"{rzs} (pallas_call :942; z2 variant of zscan.py:97)",
        lambda: z2c(*ops2),
        lambda: zscan.z2_zscan_mask(*ops2, lb2[1]).sum(dtype=torch.int32), 8 * n, 4, z2ops,
        valid=lambda v: (lambda: z2c(*ops2, valid=v),
                         lambda: (zscan.z2_zscan_mask(*ops2, lb2[1]) & v).sum(dtype=torch.int32)))
    row("zscan_z2_mask", zs_src, f"{rzs} (pallas_call :960; z2 variant of zscan.py:97)",
        lambda: z2m(*ops2), lambda: zscan.z2_zscan_mask(*ops2, lb2[1]), 8 * n, n, z2ops,
        valid=lambda v: (lambda: z2m(*ops2, valid=v), lambda: zscan.z2_zscan_mask(*ops2, lb2[1]) & v))

    # the interleaved scan over many bins: the wide day-binned index, a
    # 28-day world window (29 day bins), rows of their own
    diw, (wq, _, _) = inter["diw"], inter["wide"][4]
    lbw = diw._loose_bounds(parse_ecql(wq))
    wc, wm, opsw = diw._loose_args(lbw)
    bw, iw = lbw[1], lbw[2]
    nb = int((iw >= 0).sum())
    nw = len(diw)  # the wide index's rows (WIDE_ROWS), not phase 3's
    zops_w = zscan_ops([lbw], opsw[1], opsw[2], opsw[0])
    case = f"{nb} day bins ({len(iw)} entries), the wide index ({nw:,} rows)"
    row("zscan_z3_count", zs_src, f"{rzs} (pallas_call :942)", lambda: wc(*opsw),
        lambda: zscan.z3_zscan_mask(opsw[1], opsw[2], opsw[0], bw, iw).sum(dtype=torch.int32),
        12 * nw, 4, zops_w, plain_iters=1, case=case)
    row("zscan_z3_mask", zs_src, f"{rzs} (pallas_call :960)", lambda: wm(*opsw),
        lambda: zscan.z3_zscan_mask(opsw[1], opsw[2], opsw[0], bw, iw),
        12 * nw, nw, zops_w, plain_iters=1, case=case)
    log(f"zscan_z3 at {nb} day bins: the function's operations bound {zops_w / INT32_OPS_PER_S * 1e3:.4f} ms "
        f"({zops_w / nw:.1f} ops/row); {18 * nb * nw / INT32_OPS_PER_S * 1e3:.4f} ms at 18 ops per "
        f"row per bin entry (the TPU kernel's way) [{CARD}]")

    ops = n * _program_ops(cf.program)
    row("filter_scan_count", fs_src, f"{rfs} (pallas_call :284)",
        lambda: filter_scan.filter_scan_count(cf.program, fcols),
        lambda: filter_scan.run_program_plain(cf.program, fcols).sum(dtype=torch.int32),
        fbytes * n, 4, ops,
        valid=lambda v: (lambda: filter_scan.filter_scan_count(cf.program, fcols, valid=v),
                         lambda: filter_scan.run_program_plain(cf.program, fcols, valid=v).sum(
                             dtype=torch.int32)))
    row("filter_scan_mask", fs_src, f"{rfs} (pallas_call :304)",
        lambda: filter_scan.filter_scan_mask(cf.program, fcols),
        lambda: filter_scan.run_program_plain(cf.program, fcols),
        fbytes * n, n, ops,
        valid=lambda v: (lambda: filter_scan.filter_scan_mask(cf.program, fcols, valid=v),
                         lambda: filter_scan.run_program_plain(cf.program, fcols, valid=v)))
    # a 64-edge polygon over the same points: bound by its operations
    pip = di3._compiled_for(parse_ecql(SCAN_FILTERS[5]))
    rows.append(_env_row("filter_scan_mask", pip.program, di3._resident_subset(pip), n,
                         "INTERSECTS a 64-edge polygon, 2^26 points", launches, errs, plain_iters=2))
    return rows


def batched_rows(dev, sched, idx, launches, valid_launches, errs: Errs) -> list:
    """Phase 4 for the batched scans, at the main path's 2^26 rows with
    phase 3f's tile queries: Q in {1, 4, 8, 64}, the z3 dim scan at R = 1 and
    at R = 2 (each query's bt range split in two: the same rows), the z2
    dim scan, the interleaved z3 scan (2 week bins; 1 or 2 entries a
    query) and its z2 variant on the phase 3c indexes; count and mask.
    Beside each: Q launches of the single-query kernel (the yardstick) and
    the bound, the larger of the bytes (the planes once, the output) and
    the operations (the dim scans: :func:`dimscan_ops`; the interleaved
    scans: :func:`zscan_ops`); the rows without a plane also time the
    launch alone (``launch_ms``: the group packed and its table on the card
    before the timed loop) beside the call (``ms``: packing, upload and
    launch); the dim rows' cases name the way each takes. At Q = 4 and 64 (phase 3f's widths) each kernel
    has rows under a validity plane too (50% live, ``"valid": true``: 1
    B/row and one AND a row more in the bound; Q single launches with the
    plane beside them)."""
    import torch

    from geomesa_tpu_torch.filter.ecql import parse_ecql
    from geomesa_tpu_torch.ops import zscan

    pans, _ = sched["traffic"]
    # one tile of each pan in turn, so that a group spans the pans' days
    tiles = {k: [pan[j][1] for j in range(SCHED_TILES) for pan in pans if pan[j][0] == k]
             for k in ("z3", "z2", "z3i")}
    rows = []

    def brow(name, replaces, kern, plain, single, nbytes, ops, q, case, iters, plain_iters,
             launch=None, valid=False):
        errs.check(name, kern(), plain(), f"phase 4 {case}")
        ms = time_ms(kern, iters)
        launch_ms = None if launch is None else time_ms(launch, iters)
        single_ms = time_ms(single, max(2, iters // 4), warm=1)
        plain_ms = time_ms(plain, plain_iters, warm=1)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / INT32_OPS_PER_S * 1e3
        bound = max(t_bytes, t_ops)
        src = "geomesa_tpu_torch/csrc/" + ("dimscan.cu" if name.startswith("dimscan") else "zscan.cu")
        rows.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[name], "max_abs_err": errs.err[name], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations", "library_ms": None,
            "case": case, "q": q, "single_ms": single_ms,
        })
        if valid:
            rows[-1]["valid"] = True
            rows[-1]["launches"] = valid_launches[name]
        if launch is not None:
            errs.check(name, launch(), plain(), f"phase 4 {case}, the launch alone")
            rows[-1]["launch_ms"] = launch_ms
            log(f"{name} ({case}): the launch alone (table packed and on the card) "
                f"{launch_ms:.4f} ms ({100 * max(t_bytes, t_ops) / launch_ms:.1f}% of the bound) [{CARD}]")
        log(f"{name} ({case}): {ms:.4f} ms; {q} single-query launches {single_ms:.4f} ms; bound "
            f"{bound:.4f} ms (bytes {t_bytes:.4f}, operations {t_ops:.4f}; {100 * bound / ms:.1f}% "
            f"of it); plain version {plain_ms:.3f} ms [{CARD}]")

    rdim = "geomesa_tpu/ops/zscan.py:831 batched_dim_mask_rt (an XLA vmap of the single-query mask; no pallas_call)"
    rkind = "geomesa_tpu/ops/zscan.py:816 batched_kind_mask (an XLA vmap of z3_zscan_mask / z2_zscan_mask; no pallas_call)"
    di3, di2, di3i, di2i = idx["z3"], idx["z2"], idx["z3i"], idx["z2i"]
    n = len(di3)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 19)
    half = torch.rand(n, generator=gen, device=dev) < 0.5
    p3 = (di3._cols["__znx"], di3._cols["__zny"], di3._cols["__zbt"])
    p2 = (di2._cols["__znx"], di2._cols["__zny"])
    q3 = np.stack([di3._loose_bounds(parse_ecql(q))[1] for q in tiles["z3"][:64]])
    split = np.empty((64, 8), np.uint32)
    split[:, :4] = q3[:, :4]
    mid = (q3[:, 4].astype(np.int64) + q3[:, 5]) // 2
    split[:, 4], split[:, 5], split[:, 6], split[:, 7] = q3[:, 4], mid, mid + 1, q3[:, 5]
    q2 = np.stack([di2._loose_bounds(parse_ecql(q))[1] for q in tiles["z2"][:64]])
    zb = [di3i._loose_bounds(parse_ecql(q)) for q in tiles["z3i"][:64]]
    z2b = [di2i._loose_bounds(parse_ecql(q.split(" AND ")[0])) for q in tiles["z3i"][:64]]
    def validity_brows(nq, it, pit):
        v = half
        vc = f"Q={nq}, 2^26 rows, validity plane, 50% live"
        qm, r = q3[:nq], 1
        for kind in ("count", "mask"):
            m = kind == "mask"
            fn = zscan.batched_dimscan_mask if m else zscan.batched_dimscan_count
            one = zscan.dimscan_mask if m else zscan.dimscan_count
            brow(f"dimscan_batched_z3_{kind}", rdim, lambda fn=fn: fn(qm, *p3, valid=v),
                 (lambda: zscan.batched_dim_mask_rt(r)(*p3, qm, valid=v)) if m else (
                     lambda: zscan.batched_dim_mask_rt(r)(*p3, qm, valid=v).sum(dim=1, dtype=torch.int32)),
                 lambda one=one: [one(x, *p3, valid=v) for x in qm],
                 13 * n + (nq * n if m else 4 * nq), dimscan_ops(qm, n) + n, nq,
                 f"{vc} R=1, {_dim_way(qm, kind)}",
                 it, pit, valid=True)
            fn2 = zscan.batched_dimscan_mask if m else zscan.batched_dimscan_count
            brow(f"dimscan_batched_z2_{kind}", rdim, lambda fn=fn2: fn(q2[:nq], *p2, valid=v),
                 (lambda: zscan.batched_dim_mask_rt(0)(*p2, q2[:nq], valid=v)) if m else (
                     lambda: zscan.batched_dim_mask_rt(0)(*p2, q2[:nq], valid=v).sum(dim=1, dtype=torch.int32)),
                 lambda one=one: [one(x, *p2, valid=v) for x in q2[:nq]],
                 9 * n + (nq * n if m else 4 * nq), dimscan_ops(q2[:nq], n) + n, nq,
                 f"{vc}, {_dim_way(q2[:nq], kind)}", it, pit, valid=True)
        lbs = zb[:nq]
        bmax = max(len(lb[2]) for lb in lbs)
        bounds = np.zeros((nq, bmax, 3, 6), np.uint32)
        ids = np.full((nq, bmax), -1, np.int32)
        for i, lb in enumerate(lbs):
            bounds[i, : len(lb[2])], ids[i, : len(lb[2])] = lb[1], lb[2]
        hi, lo, bins = di3i._cols["__zhi"], di3i._cols["__zlo"], di3i._cols["__zbin"]
        pk = zscan.batched_zscan(bounds, ids)
        pk.device_table(dev)
        b2 = np.stack([lb[1] for lb in z2b[:nq]])
        h2, l2 = di2i._cols["__zhi"], di2i._cols["__zlo"]
        pk2 = zscan.batched_zscan(b2, None)
        pk2.device_table(dev)
        for kind in ("count", "mask"):
            m = kind == "mask"
            base3 = lambda: zscan.batched_kind_mask("z3")(hi, lo, bins, bounds, ids) & v  # noqa: E731
            single = [di3i._loose_args(lb)[1 if m else 0] for lb in lbs]
            brow(f"zscan_batched_z3_{kind}", rkind,
                 lambda m=m: pk.run(bins, hi, lo, want_mask=m, valid=v),
                 base3 if m else (lambda: base3().sum(dim=1, dtype=torch.int32)),
                 lambda single=single: [f(bins, hi, lo, valid=v) for f in single],
                 13 * n + (nq * n if m else 4 * nq), zscan_ops(lbs, hi, lo, bins) + n, nq,
                 vc, it, pit, valid=True)
            base2 = lambda: zscan.batched_kind_mask("z2")(h2, l2, b2) & v  # noqa: E731
            single2 = [di2i._loose_args(lb)[1 if m else 0] for lb in z2b[:nq]]
            brow(f"zscan_batched_z2_{kind}", rkind,
                 lambda m=m: pk2.run(None, h2, l2, want_mask=m, valid=v),
                 base2 if m else (lambda: base2().sum(dim=1, dtype=torch.int32)),
                 lambda single=single2: [f(h2, l2, valid=v) for f in single],
                 9 * n + (nq * n if m else 4 * nq), zscan_ops(z2b[:nq], h2, l2) + n, nq,
                 vc, it, pit, valid=True)

    for nq in (1, 4, 8, 64):
        it, pit = (50, 3) if nq < 64 else (20, 1)
        for r, qm in ((1, q3[:nq]), (2, split[:nq])):
            ops = dimscan_ops(qm, n)
            for kind in ("count", "mask"):
                fn = zscan.batched_dimscan_count if kind == "count" else zscan.batched_dimscan_mask
                one = zscan.dimscan_count if kind == "count" else zscan.dimscan_mask
                plain = (lambda qm=qm, r=r: zscan.batched_dim_mask_rt(r)(*p3, qm).sum(dim=1, dtype=torch.int32)) \
                    if kind == "count" else (lambda qm=qm, r=r: zscan.batched_dim_mask_rt(r)(*p3, qm))
                pk = zscan.batched_dimscan(qm)
                pk.device_table(dev, kind == "mask")
                brow(f"dimscan_batched_z3_{kind}", rdim, lambda fn=fn, qm=qm: fn(qm, *p3), plain,
                     lambda one=one, qm=qm: [one(v, *p3) for v in qm],
                     12 * n + (4 * nq if kind == "count" else nq * n), ops, nq,
                     f"Q={nq} R={r}, 2^26 rows, {_dim_way(qm, kind)}", it, pit,
                     launch=lambda pk=pk, m=kind == "mask": pk.run(p3, m))
        qm = q2[:nq]
        for kind in ("count", "mask"):
            fn = zscan.batched_dimscan_count if kind == "count" else zscan.batched_dimscan_mask
            one = zscan.dimscan_count if kind == "count" else zscan.dimscan_mask
            plain = (lambda qm=qm: zscan.batched_dim_mask_rt(0)(*p2, qm).sum(dim=1, dtype=torch.int32)) \
                if kind == "count" else (lambda qm=qm: zscan.batched_dim_mask_rt(0)(*p2, qm))
            pk = zscan.batched_dimscan(qm)
            pk.device_table(dev, kind == "mask")
            brow(f"dimscan_batched_z2_{kind}", rdim, lambda fn=fn, qm=qm: fn(qm, *p2), plain,
                 lambda one=one, qm=qm: [one(v, *p2) for v in qm],
                 8 * n + (4 * nq if kind == "count" else nq * n), dimscan_ops(qm, n), nq,
                 f"Q={nq}, 2^26 rows, {_dim_way(qm, kind)}", it, pit,
                 launch=lambda pk=pk, m=kind == "mask": pk.run(p2, m))
        # the interleaved z3 scan: the group as the fused path pads it
        lbs = zb[:nq]
        bmax = max(len(lb[2]) for lb in lbs)
        bounds = np.zeros((nq, bmax, 3, 6), np.uint32)
        ids = np.full((nq, bmax), -1, np.int32)
        for i, lb in enumerate(lbs):
            bounds[i, : len(lb[2])], ids[i, : len(lb[2])] = lb[1], lb[2]
        hi, lo, bins = di3i._cols["__zhi"], di3i._cols["__zlo"], di3i._cols["__zbin"]
        zops = zscan_ops(lbs, hi, lo, bins)
        entries = int((ids >= 0).sum())
        pk = zscan.batched_zscan(bounds, ids)
        pk.device_table(dev)
        for kind in ("count", "mask"):
            fn = zscan.batched_zscan_count if kind == "count" else zscan.batched_zscan_mask
            plain = (lambda b=bounds, i=ids: zscan.batched_kind_mask("z3")(hi, lo, bins, b, i).sum(
                dim=1, dtype=torch.int32)) if kind == "count" else (
                lambda b=bounds, i=ids: zscan.batched_kind_mask("z3")(hi, lo, bins, b, i))
            single = [di3i._loose_args(lb)[0 if kind == "count" else 1] for lb in lbs]
            brow(f"zscan_batched_z3_{kind}", rkind,
                 lambda fn=fn, b=bounds, i=ids: fn(b, i, hi, lo, bins=bins), plain,
                 lambda single=single: [f(bins, hi, lo) for f in single],
                 12 * n + (4 * nq if kind == "count" else nq * n), zops, nq,
                 f"Q={nq}, {entries} bin entries of 2 week bins (B={bmax}), 2^26 rows", it, pit,
                 launch=lambda pk=pk, m=kind == "mask": pk.run(bins, hi, lo, want_mask=m))
        b2 = np.stack([lb[1] for lb in z2b[:nq]])
        h2, l2 = di2i._cols["__zhi"], di2i._cols["__zlo"]
        pk2 = zscan.batched_zscan(b2, None)
        pk2.device_table(dev)
        for kind in ("count", "mask"):
            fn = zscan.batched_zscan_count if kind == "count" else zscan.batched_zscan_mask
            plain = (lambda b=b2: zscan.batched_kind_mask("z2")(h2, l2, b).sum(dim=1, dtype=torch.int32)) \
                if kind == "count" else (lambda b=b2: zscan.batched_kind_mask("z2")(h2, l2, b))
            single = [di2i._loose_args(lb)[0 if kind == "count" else 1] for lb in z2b[:nq]]
            brow(f"zscan_batched_z2_{kind}", rkind, lambda fn=fn, b=b2: fn(b, None, h2, l2), plain,
                 lambda single=single: [f(h2, l2) for f in single],
                 8 * n + (4 * nq if kind == "count" else nq * n), zscan_ops(z2b[:nq], h2, l2), nq,
                 f"Q={nq}, 2^26 rows", it, pit,
                 launch=lambda pk=pk2, m=kind == "mask": pk.run(None, h2, l2, want_mask=m))
        if nq in (4, 64):
            validity_brows(nq, it, pit)
        torch.cuda.empty_cache()
    return rows


N_ENV = 1 << 26  # rows of the synthetic envelope planes


def _env_row(name, prog, cols, n, case, launches, errs: Errs, plain_iters=3, library=None) -> dict:
    """One filter-scan row over envelope planes: bytes bound 16 B/row of
    envelopes, 8 B/row of dtg words for a during, 1 B/row for a mask (4 B
    for a count) over the HBM rate; operations bound from the program.
    ``library``: one PyTorch call computing the same mask, checked equal
    and timed as the kernel is."""
    import torch

    from geomesa_tpu_torch.ops import filter_scan

    mask = name.endswith("mask")
    kern = (lambda: filter_scan.filter_scan_mask(prog, cols)) if mask else (
        lambda: filter_scan.filter_scan_count(prog, cols))
    plain = (lambda: filter_scan.run_program_plain(prog, cols)) if mask else (
        lambda: filter_scan.run_program_plain(prog, cols).sum(dtype=torch.int32))
    errs.check(name, kern().reshape(-1), plain().reshape(-1), case)
    ms, plain_ms = time_ms(kern, 50), time_ms(plain, plain_iters, warm=1)
    host = host_call_ms(kern)
    library_ms = cold = None
    if library is not None:
        if not torch.equal(library().reshape(-1), kern().reshape(-1)):
            raise AssertionError(f"{name} ({case}): the library call != the kernel")
        library_ms = time_ms(library, 50)
        # with L2 flushed before each call: the planes come from device memory
        cold = {"ms_l2_flushed": time_ms(kern, 50, flush_l2=True),
                "library_ms_l2_flushed": time_ms(library, 50, flush_l2=True)}
    nbytes = 4 * len(prog.cols) * n + (n if mask else 4)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = n * _program_ops(prog) / INT32_OPS_PER_S * 1e3
    bound = max(t_bytes, t_ops)
    log(f"{name} ({case}): {ms:.4f} ms (bound {bound:.4f} ms, {100 * bound / ms:.1f}% of it; "
        f"{nbytes / ms / 1e6:.1f} GB/s, {n / ms / 1e6:.2f} G rows/s); plain version "
        f"{plain_ms:.3f} ms" + ("" if library_ms is None else f"; library call {library_ms:.4f} ms")
        + ("" if cold is None else f"; L2 flushed before each call: kernel {cold['ms_l2_flushed']:.4f} "
           f"ms, library call {cold['library_ms_l2_flushed']:.4f} ms")
        + f"; the wrapper's host time {host:.4f} ms a call [{CARD}]")
    return {"name": name, "route": "cuda", "source": "geomesa_tpu_torch/csrc/filter_scan.cu",
            "replaces": "geomesa_tpu/ops/pallas_scan.py:203 build_pallas_scan (pallas_call "
                        f"{':304' if mask else ':284'})",
            "launches": launches[name], "max_abs_err": errs.err[name], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms, "host_ms": host, "case": case, **(cold or {})}


def xz_rows(dev, xz, launches, errs: Errs) -> "tuple[list, list]":
    """Phase 4 for the xz path: the filter scan over envelope planes at
    2^26 synthetic rows (made on the card) and on the drive's own planes,
    BBOX and BBOX AND DURING, count and mask; then the torch ops of the
    path that replace no TPU kernel (the xz range masks and the card key
    encode), timed at the drive's size, as rows of their own."""
    import torch

    from geomesa_tpu_torch.device_cache import Z_HI, Z_LO
    from geomesa_tpu_torch.features.sft import SimpleFeatureType
    from geomesa_tpu_torch.filter.compile import compile_filter
    from geomesa_tpu_torch.filter.ecql import parse_ecql
    from geomesa_tpu_torch.index.keyplanes import encode_inputs, schema_kind

    di2, di3, traffic = xz["di2"], xz["di3"], xz["traffic"]
    bbox_q, during_q = traffic["bbox"][12], traffic["during"][12]
    sft = SimpleFeatureType.create("osm3", XZ3_SPEC)
    progs = {"BBOX": compile_filter(parse_ecql(bbox_q), sft).program,
             "BBOX AND DURING": compile_filter(parse_ecql(during_q), sft).program}
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 10)

    def rand(lo, hi):
        return (torch.rand(N_ENV, generator=gen, device=dev, dtype=torch.float64)
                * (hi - lo) + lo).to(torch.float32)

    x0, y0 = rand(-180.0, 180.0), rand(-56.0, 72.0)
    synth = {"geom__x0": x0, "geom__y0": y0,
             "geom__x1": x0 + rand(5e-5, 6e-4), "geom__y1": y0 + rand(5e-5, 6e-4)}
    dtg = torch.randint(T0, T0 + WORLD_DAYS * DAY, (N_ENV,), generator=gen, device=dev)
    synth["dtg__hi"] = (dtg >> 32).to(torch.int32)
    synth["dtg__lo"] = (dtg & 0xFFFFFFFF).to(torch.int32).view(torch.uint32)
    del dtg
    rows = []
    for what, prog in progs.items():
        for name in ("filter_scan_count", "filter_scan_mask"):
            rows.append(_env_row(name, prog, synth, N_ENV,
                                 f"envelope planes, {what}, 2^26 synthetic footprints",
                                 launches, errs, plain_iters=2))
    del synth
    for what, prog, di in (("BBOX", progs["BBOX"], di2), ("BBOX AND DURING", progs["BBOX AND DURING"], di3)):
        cols = {c: di._cols[c] for c in prog.cols}
        for name in ("filter_scan_count", "filter_scan_mask"):
            rows.append(_env_row(name, prog, cols, len(di),
                                 f"envelope planes, {what}, the {di._z_kind} drive ({len(di):,} rows)",
                                 launches, errs))

    # torch ops with no TPU kernel behind them
    ops_rows = []

    def ops_row(name, fn, n, nbytes, case):
        fn()
        ms = time_ms(fn, 20)
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        log(f"{name} ({case}): {ms:.4f} ms (bytes bound {bound:.4f} ms; {n / ms / 1e6:.2f} G rows/s) "
            f"[torch ops, no TPU kernel] [{CARD}]")
        ops_rows.append({"name": name, "route": "torch ops, no TPU kernel", "ms": ms,
                         "bound_ms": bound, "bound_by": "bytes", "rows": n, "case": case})

    for di, q in ((di2, bbox_q), (di3, during_q)):
        lb = di._loose_bounds(parse_ecql(q))
        _, mf, ops = di._loose_args(lb)
        n = len(di)
        binned = di._z_kind == "xz3"
        ops_row(f"{di._z_kind}_range_mask", lambda mf=mf, ops=ops: mf(*ops), n,
                (12 if binned else 8) * n + n,
                f"{int((lb[2] >= 0).sum()) if binned else 1} bin entries, "
                f"{int(lb[1].size // 4)} range slots, the {di._z_kind} drive")
        kind, sfc = schema_kind(di.sft)
        coords, _ = encode_inputs(di._host_batch, kind, sfc, "geom", di.sft.dtg_field)
        ct = [torch.from_numpy(np.ascontiguousarray(c, np.float64)).to(dev) for c in coords]
        hi, lo = sfc.index_hi_lo(*ct)
        if not (torch.equal(hi, di._cols[Z_HI]) and torch.equal(lo, di._cols[Z_LO])):
            raise AssertionError(f"{di._z_kind}: the card encode != the staged keys")
        ops_row(f"{di._z_kind}_card_encode", lambda s=sfc, c=ct: s.index_hi_lo(*c), n,
                8 * len(ct) * n + 8 * n, f"float64 envelopes to (hi, lo) words, the {di._z_kind} drive")
        del ct
    return rows, ops_rows


def ais_ops_rows(dev, ais) -> list:
    """Phase 4 for the AIS path: the torch ops that replace no TPU kernel,
    at the drive's 2^26 rows -- the kNN pass (distance, radius box,
    selection) for k = 10 and 8192 at a busy port, and the union mask of a
    tube's 16 and 256 segment windows with time windows. Bound: the
    larger of the bytes (x, y and the date lanes read once, the mask or
    the k results written once) and the operations this run's data needs
    (kNN: 20 a row; union: 7 a row for the union envelope, then 20 for
    each candidate row and window) over the 32-bit rate."""
    from geomesa_tpu_torch.ops import knn as knn_ops
    from geomesa_tpu_torch.ops.window import union_mask, widen
    from geomesa_tpu_torch.process.tube import _segment_windows

    di, tr = ais["di"], ais["traffic"]
    x, y = di._cols["geom__x"], di._cols["geom__y"]
    thi, tlo = di._cols["dtg__hi"], di._cols["dtg__lo"]
    n = len(di)
    rows = []

    def row(name, fn, nbytes, ops, case):
        fn()
        ms = time_ms(fn, 10, warm=2)
        b_ms, o_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / INT32_OPS_PER_S * 1e3
        bound, by = (b_ms, "bytes") if b_ms >= o_ms else (o_ms, "operations")
        log(f"{name} ({case}): {ms:.4f} ms (bound {bound:.4f} ms, {by}) "
            f"[torch ops, no TPU kernel] [{CARD}]")
        rows.append({"name": name, "route": "torch ops, no TPU kernel", "ms": ms, "bound_ms": bound,
                     "bound_by": by, "rows": n, "case": case})

    px, py = tr["knn"][0][0]
    q = knn_ops.query_vector(px, py, 45.0, knn_ops.lon_factor(py), dev)
    for k in (10, 8192):
        row("knn_select", lambda k=k: knn_ops.knn(x, y, q, k), 8 * n + 12 * k, 20 * n,
            f"k = {k}, the AIS drive's busy port, radius 45 deg")
    for xy, tt, buf, dt, _ in tr["tubes"]:
        m = len(xy) - 1
        if m not in (16, 256) or buf != 0.2:
            continue
        envs, times = _segment_windows(xy, tt, buf, dt)
        env = widen(envs)
        lo, hi = np.fmin.reduce(env[:, :2], axis=0), np.fmax.reduce(env[:, 2:], axis=0)
        cand = int(((x >= float(lo[0])) & (x <= float(hi[0])) & (y >= float(lo[1]))
                    & (y <= float(hi[1]))).sum())
        row("union_mask", lambda env=env, times=times: union_mask(x, y, env, thi, tlo, times=times),
            17 * n, 7 * n + 20 * cand * m,
            f"m = {m} windows with time windows, a vessel's track, {cand:,} candidate rows")
    return rows


def join_ops_rows(dev, join, ais) -> list:
    """Phase 4 for the join slice: its torch ops (no TPU kernel behind
    them) at phase 3h's shapes. The pair pack of window_pairs_query for one
    group of 64 zones over the 2^26 pickups (no gate); one refinement batch
    of the full zone join (the count and the compaction of its first
    2^20-candidate batch); the BIN compaction (count and gather, ending on
    the card) at 2^26 AIS rows for INCLUDE and for phase 3e's first exact
    request, with the host copy of the records timed beside it on the host
    clock. Bound: the larger of the bytes (each plane read once, each
    output written once) and the operations this run's data needs (pair
    pack: 4 compares a row for the union envelope, 256 a candidate row;
    refinement: log2(runs) + 5 a candidate; BIN: one a row)."""
    import math

    import torch

    from geomesa_tpu_torch.bucketing import bucket_cap
    from geomesa_tpu_torch.filter.ecql import parse_ecql
    from geomesa_tpu_torch.join import JoinEngine
    from geomesa_tpu_torch.join import planner as jp
    from geomesa_tpu_torch.join.engine import _join_conf
    from geomesa_tpu_torch.ops import binpack
    from geomesa_tpu_torch.ops import join as jops
    from geomesa_tpu_torch.ops.window import pairs_pack, widen

    di, zones = join["di"], join["zones"]
    n = len(di)
    x, y = di._cols["geom__x"], di._cols["geom__y"]
    rows = []

    def row(name, fn, nbytes, ops, case, iters=10, rows_in=n):
        fn()
        ms = time_ms(fn, iters, warm=2)
        b_ms, o_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / INT32_OPS_PER_S * 1e3
        bound, by = (b_ms, "bytes") if b_ms >= o_ms else (o_ms, "operations")
        log(f"{name} ({case}): {ms:.4f} ms (bound {bound:.4f} ms, {by}) "
            f"[torch ops, no TPU kernel] [{CARD}]")
        rows.append({"name": name, "route": "torch ops, no TPU kernel", "ms": ms, "bound_ms": bound,
                     "bound_by": by, "rows": rows_in, "case": case})

    env = widen(zones[:64])
    cap = min(n, max(4096, bucket_cap(n // 32)))
    lo, hi = np.fmin.reduce(env[:, :2], axis=0), np.fmax.reduce(env[:, 2:], axis=0)
    cand = int(((x >= float(lo[0])) & (x <= float(hi[0])) & (y >= float(lo[1]))
                & (y <= float(hi[1]))).sum())
    hits = int(pairs_pack(x, y, env, None, cap)[2][0])
    row("pairs_pack", lambda: pairs_pack(x, y, env, None, cap), 8 * n + 16 * min(hits, cap),
        4 * n + 256 * cand, f"one group of 64 zones at {n:,} pickups, {cand:,} rows in its union "
        f"envelope, {hits:,} with a hit, cap {cap:,}")
    eng = JoinEngine(di)
    jidx = eng.prepare()
    conf = _join_conf()
    plan = jp.plan_join(jidx, zones, conf)
    i, j = eng._batches(plan, conf["batch_candidates"])[0]
    envs_dev = torch.from_numpy(np.ascontiguousarray(zones, np.float64)).to(dev)
    args = eng._device_args(jidx, plan, i, j, envs_dev)
    planes = jidx.device_planes()
    pvals = (planes["x"], planes["y"])
    total, runs = args[-1], j - i
    kept = jops.count_pairs(pvals, *args)
    row("join_refine", lambda: (jops.count_pairs(pvals, *args), jops.compact_pairs(pvals, *args)),
        16 * total + 16 * kept + 33 * runs, total * (math.ceil(math.log2(max(runs, 2))) + 5),
        f"the full zone join's first batch: {total:,} candidates in {runs:,} runs, {kept:,} pairs")
    adi = ais["di"]
    lanes = adi._bin_lane_matrix("mmsi", adi.sft.dtg_field, adi.sft.geom_field, None)
    na = int(lanes.shape[1])
    tag, q = ais["bin_requests"][0][:2]  # exact 0
    for case, mask in (("INCLUDE", torch.ones(na, dtype=torch.bool, device=dev)),
                       (tag, adi._device_hit_mask(parse_ecql(q), False))):
        hits = binpack.bin_count(mask)
        t = time.perf_counter()
        binpack.bin_pack(mask, lanes)
        d2h = time.perf_counter() - t
        row("bin_pack", lambda mask=mask: (binpack.bin_count(mask), binpack.bin_compact(mask, lanes)),
            na + 32 * hits, na, f"{case} at {na:,} AIS rows, {hits:,} records; with the copy of the "
            f"records to the host {d2h * 1e3:.1f} ms on the host clock", iters=5, rows_in=na)
    return rows


DRIVE_GRIDS = [(128, 128), (256, 256), (512, 256), (512, 512), (1024, 1024), (2048, 1024)]
TABLE_GRIDS = ((256, 256), (1024, 1024))  # the density cases the kernel table lists


def density_rows(dev, di3, launches, errs: Errs) -> list:
    """Time the density kernel on the main path's 2^26 rows with every row
    masked in (the heaviest case: each row adds to the grid) over the world
    viewport: the main path's clustered points and uniform points, at every
    grid size of the density drive (128x128 to 2048x1024), counted and
    weighted (float32 weights, cast before timing), on the engine the grid
    takes and on every other engine that can hold it. Beside each: the
    bound, the plain version and one torch.bincount over precomputed flat
    ids (computes less: ids precomputed). The kernel table's first two
    density rows are the clustered 256x256 case; rows with a ``case`` key
    add clustered and uniform 256x256 and 1024x1024."""
    import torch

    from geomesa_tpu_torch.ops.density import (
        _launch, density_grid, density_plain, engine_for, engines, pixel_ids,
    )

    n = len(di3)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    uni = [(torch.rand(n, generator=gen, device=dev, dtype=torch.float64) * s - s / 2)
           .to(torch.float32) for s in (360.0, 180.0)]
    ones = torch.ones(n, dtype=torch.bool, device=dev)
    wts = di3._cols["count"].to(torch.float32)
    found = {}
    for data, (px, py) in (("clustered", (di3._cols["geom__x"], di3._cols["geom__y"])),
                           ("uniform", uni)):
        for width, height in DRIVE_GRIDS:
            ix, iy, inside = pixel_ids(px, py, WORLD, width, height)
            flat = (iy.to(torch.int64) * width + ix.to(torch.int64))[inside]
            del ix, iy
            for w in (None, wts):
                name = "density_count" if w is None else "density_weighted"
                args = (px, py, WORLD, width, height)
                static = engine_for(width, height, w is not None)
                kern = lambda a=args, w=w: density_grid(*a, mask=ones, weights=w)  # noqa: E731
                plain = lambda a=args, w=w: density_plain(*a, mask=ones, weights=w)  # noqa: E731
                wf = None if w is None else w[inside]
                lib = lambda f=flat, wf=wf, c=width * height: torch.bincount(  # noqa: E731
                    f, weights=wf, minlength=c)
                what = f"{data} {width}x{height} main-path shapes"
                rtol = 0.0 if w is None else 1e-6
                want = plain()
                errs.check_grid(name, kern(), want, rtol, what)
                ms, plain_ms, lib_ms = time_ms(kern, 20), time_ms(plain, 2), time_ms(lib, 10)
                nbytes = (9 if w is None else 13) * n + 4 * width * height
                t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
                t_ops = 12 * n / F64_OPS_PER_S * 1e3  # float64 pixel math per row
                bound = max(t_bytes, t_ops)
                per_engine = {}
                for engine in engines(width, height, w is not None):
                    if engine == static:
                        per_engine[_engine_name(engine)] = ms
                        continue
                    run = lambda a=args, w=w, e=engine: _launch(*a, ones, w, engine=e)  # noqa: E731
                    errs.check_grid(name, run(), want, rtol, f"{what} {_engine_name(engine)} engine")
                    per_engine[_engine_name(engine)] = time_ms(run, 20)
                del want
                found[(data, width, height, name)] = (ms, plain_ms, lib_ms, bound,
                                                      "bytes" if t_bytes >= t_ops else "operations",
                                                      _engine_name(static))
                log(f"{name} {data} {width}x{height}: {ms:.4f} ms on the {_engine_name(static)} "
                    f"engine (bound {bound:.4f} ms, {100 * bound / ms:.1f}% of it, "
                    f"{n / ms / 1e6:.2f} G rows/s); every engine: "
                    + ", ".join(f"{k} {v:.4f}" for k, v in per_engine.items())
                    + f" ms; torch.bincount {lib_ms:.4f} ms (computes less: ids precomputed); "
                    f"plain version {plain_ms:.3f} ms (not a yardstick) [{CARD}]")
            del flat, inside
    src = "geomesa_tpu_torch/csrc/density.cu"
    rep = "geomesa_tpu/ops/density_pallas.py:42 build_density_pallas (pallas_call :124)"
    rows = []
    cases = [("clustered", 256, 256, None)] + [
        (d, w, h, f"{d} {w}x{h}, world viewport, every row in")
        for d in ("clustered", "uniform") for w, h in TABLE_GRIDS if (d, w) != ("clustered", 256)]
    for data, width, height, case in cases:
        for name in ("density_count", "density_weighted"):
            ms, plain_ms, lib_ms, bound, bound_by, engine = found[(data, width, height, name)]
            rows.append({
                "name": name, "route": "cuda", "source": src, "replaces": rep,
                "launches": launches[name], "max_abs_err": errs.err[name],
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by,
                "library_ms": lib_ms, "engine": engine,
            })
            if case:
                rows[-1]["case"] = case
    return rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from geomesa_tpu_torch.kernels import _build
    except ImportError as e:
        print(f"chip_smoke: the geomesa_tpu_torch package is missing ({e})", file=sys.stderr)
        return 2
    global CARD
    t_all = time.time()
    dev = torch.device("cuda:0")
    CARD = card_line()
    log(f"phase 0: {CARD}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}, {torch.cuda.get_device_name(0)}")

    t = time.time()
    logs = _build.build_all()
    log(f"phase 1: built {sorted(logs) or 'nothing (cached)'} in {time.time() - t:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    t = time.time()
    errs = Errs()
    check_dimscans(dev, errs)
    check_baked_dimscans(dev, errs)
    check_zscans(dev, errs)
    check_filter_scans(dev, errs)
    check_envelope_scans(dev, errs)
    check_density(dev, errs)
    check_ais_ops(dev)
    check_join_ops(dev)
    check_batched_scans(dev, errs)
    tv = time.time()
    nv = check_validity(dev, errs, N_ROWS)
    log(f"phase 2 validity: {nv} count and mask comparisons at {N_ROWS:,} rows (patterns "
        f"{[p for p, _ in valid_patterns(1, dev, 0)]}, batched at Q in {list(VALID_QS)}) in "
        f"{time.time() - tv:.1f} s")
    torch.cuda.empty_cache()
    log(f"phase 2: kernels == plain versions, bit-exact (weighted density: rtol 1e-6) "
        f"({time.time() - t:.1f} s)")
    launch_floor(dev)

    t = time.time()
    cols = make_columns(N_ROWS, SEED)
    log(f"phase 3: generated {N_ROWS:,} rows in {time.time() - t:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    t = time.time()
    di3, di2, queries, z2q, res3, res2, main_launches = run_main_path(dev, cols)
    planes3, planes2 = check_main_path(cols, di3, di2, queries, z2q, res3, res2)
    dcalls, grids, scalls, seqs, dens_launches = run_density_path(di3, di2, queries)
    check_density_path(cols, di3, di2, planes3, planes2, dcalls, grids, scalls, seqs)
    inter = run_interleaved_path(dev, cols, di3, di2, queries, z2q, res3, res2, planes2,
                                 dcalls, grids, scalls, seqs)
    del planes3, planes2, grids, res2
    lab_launches = run_labeled_path(dev, queries)
    log(f"phase 3: the main path, density, 3c and 3b in {time.time() - t:.1f} s")
    t = time.time()
    xz = run_xz_path(dev)
    log(f"phase 3d: the xz path in {time.time() - t:.1f} s")
    t = time.time()
    ais = run_ais_path(dev)
    log(f"phase 3e: the AIS path in {time.time() - t:.1f} s")
    t = time.time()
    sched = run_sched_path(dev, cols, di3, di2, inter["di3i"], inter["di2i"])
    log(f"phase 3f: the scheduler in {time.time() - t:.1f} s")
    t = time.time()
    stream = run_streaming_path(dev, {k: v if k == "_centers" else v[:STREAM_ROWS]
                                      for k, v in cols.items()}, queries, sched["traffic"])
    log(f"phase 3g: the streaming index in {time.time() - t:.1f} s")
    t = time.time()
    join = run_join_path(dev)
    log(f"phase 3h: the joins in {time.time() - t:.1f} s")
    t = time.time()
    store = run_store_path(dev, cols, di3, queries, res3)
    log(f"phase 3i: the store path in {time.time() - t:.1f} s")
    base_loose = [o["count_loose"] for o in res3]  # numpy-checked in phase 3; 3k's base
    del res3
    t = time.time()
    fs = run_fs_path(dev, cols, queries, store.pop("answers"), base_loose)
    log(f"phase 3j and 3k: the file-system store and its live layer in {time.time() - t:.1f} s")
    log(f"peak device memory {torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
    launches = {k: main_launches[k] + dens_launches[k] + inter["launches"][k] + lab_launches[k]
                + xz["launches"].get(k, 0) + ais["launches"].get(k, 0) + sched["launches"][k]
                + stream["launches"][k] + join["launches"][k] + store["launches"][k]
                + fs["launches"][k] for k in main_launches}
    valid_launches = {k: stream["valid"][k] + fs["valid"][k] for k in stream["valid"]}
    missing = sorted(k for k in ("dimscan_z3_count", "dimscan_batched_z3_count", "zscan_z3_count",
                                 "zscan_batched_z3_count", "filter_scan_count")
                     if not valid_launches[k])
    if missing:
        raise AssertionError(f"phase 3g: no launch of {missing} read the validity plane")

    t = time.time()
    rows = kernel_table(dev, di3, di2, inter, queries, z2q, launches, valid_launches, errs)
    rows += density_rows(dev, di3, launches, errs)
    env_rows, ops_rows = xz_rows(dev, xz, launches, errs)
    rows += env_rows
    rows += store_rows(dev, store, launches, errs)
    rows += batched_rows(dev, sched, {"z3": di3, "z2": di2, "z3i": inter["di3i"],
                                      "z2i": inter["di2i"]}, launches, valid_launches, errs)
    for r in rows:
        r.setdefault("valid", False)
        r["valid_launches"] = valid_launches[r["name"]]
    missing = sorted(set(launches) - {r["name"] for r in rows})
    missing += sorted(k for k, v in valid_launches.items() if v and not any(
        r["name"] == k and r["valid"] for r in rows))
    if missing:
        raise AssertionError(f"the kernels line lacks {missing}")
    ops_rows += ais_ops_rows(dev, ais)
    ops_rows += join_ops_rows(dev, join, ais)
    log(json.dumps({"torch_ops": ops_rows}))
    log(f"phase 4: the kernel and torch-ops rows in {time.time() - t:.1f} s")
    log(json.dumps({"kernels": rows}))
    log(f"total {time.time() - t_all:.1f} s")
    log(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
