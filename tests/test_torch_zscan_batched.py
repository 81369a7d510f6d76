"""The Q-batched interleaved scan's packed layout in ``geomesa_tpu_torch``
against ``geomesa_tpu``'s ``batched_kind_mask``.

The batched kernel (``csrc/zscan.cu`` ``gm_zscan_batched``) reads a group
packed by ``ops/zscan.py`` ``_BatchedZScan``: only real entries, cell boxes
as compact records of de-interleaved bounds (unless no row can meet more
than one record), any other entry as a masked record, cut into launches whose table fits one block's shared memory, with
a bin index when a launch holds more than a few z3 records. Its plain
version reads those records back and de-interleaves the keys with
``curves/zorder.py``. Held here, bit for bit, on the CPU:

- against the port's semantic reference (``batched_kind_mask``) and the JAX
  package's ``batched_kind_mask`` (an XLA vmap, x64), over seeded numpy
  groups: cell boxes, random words, entries with lo > hi, all-padding
  queries, 1 to 8 bins a query and a group of 64 queries x 64 bins past
  one launch's table, at Q in {1, 3, 8, 47, 64}. Rows in bin -1 stay in
  the data; the reference lets them match a padded entry's all-zero
  bounds (ROADMAP section 3), so the JAX comparison leaves those rows out
  and the port's must match nothing there;
- a property: the compact compare equals the masked compare for any z3 or
  z2 cell box and any key, keys at 0, at the maximum and one either side
  of each edge included;
- the fused loose paths at group sizes that are not powers of two: equal
  to the serial answers, and the batched launch gets the group's queries
  and no padding.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from geomesa_tpu.ops import zscan as jz
from geomesa_tpu_torch.curves import zorder
from geomesa_tpu_torch.curves.z2 import Z2SFC
from geomesa_tpu_torch.curves.z3 import Z3SFC
from geomesa_tpu_torch.device_cache import DeviceIndex
from geomesa_tpu_torch.features.batch import FeatureBatch
from geomesa_tpu_torch.features.sft import SimpleFeatureType
from geomesa_tpu_torch.filter.ecql import parse_ecql
from geomesa_tpu_torch.ops import zscan
from geomesa_tpu_torch.store.direct import BatchStore

torch.set_num_threads(2)  # xdist workers share the host's cores

MAX3, MAX2 = zorder.MAX_MASK_3D, zorder.MAX_MASK_2D
N = 2003
QS = [1, 3, 8, 47, 64]


def _keys(n, n_bins, seed):
    """Interleaved Z3 and Z2 key words of random points, bins 2600.. with
    the first rows in bin -1, and a corner row at each extreme."""
    rng = np.random.default_rng(seed)
    x, y = rng.uniform(-180, 180, n), rng.uniform(-90, 90, n)
    off = rng.uniform(0, 604_800, n)
    x[:4], y[:4], off[:4] = [180, -180, 0, 5], [90, -90, 0, 5], [604_800, 0, 0, 302_400]
    bins = (2600 + rng.integers(0, n_bins, n)).astype(np.int32)
    bins[:5] = -1
    h3, l3 = zorder.u64_hi_lo(Z3SFC().index(x, y, off))
    h2, l2 = zorder.u64_hi_lo(Z2SFC().index(x, y))
    return rng, bins, (h3, l3), (h2, l2)


def _cells(rng, shape, n_dims):
    top = MAX3 if n_dims == 3 else MAX2
    dim_bounds = zscan.z3_dim_bounds if n_dims == 3 else zscan.z2_dim_bounds
    lo, hi = np.sort(rng.integers(0, top + 1, (2,) + shape + (n_dims,)), axis=0)
    out = np.empty(shape + (n_dims, 6), np.uint32)
    for i in np.ndindex(*shape):
        out[i] = dim_bounds(tuple(lo[i]), tuple(hi[i]))
    return out


def _words(rng, shape, n_dims):
    return rng.integers(0, 1 << 32, shape + (n_dims, 6), dtype=np.uint64).astype(np.uint32)


def _z3_group(rng, nq, n_bins, form):
    """(bounds (Q, B, 3, 6), ids (Q, B)): per query 1 to 8 bins, some ids
    padded; form "cells", "words" or "mixed" (cells, random words and lo >
    hi entries); for nq > 2 the last query all padding."""
    b = 8
    bounds = _cells(rng, (nq, b), 3)
    if form != "cells":
        pick = rng.random((nq, b)) < (1.0 if form == "words" else 0.3)
        bounds[pick] = _words(rng, (int(pick.sum()),), 3)
    if form == "mixed":  # lo > hi in one dimension: an empty cell box
        e = rng.random((nq, b)) < 0.15
        bounds[e, 1, 2:4] = bounds[e, 1, 4:6] + np.array([0, 1], np.uint32)
        bounds[e, 1, 3] = np.maximum(bounds[e, 1, 3], 1)
        bounds[e, 1, 4:6] = 0
    ids = np.full((nq, b), -1, np.int32)
    for q in range(nq):
        k = int(rng.integers(1, b + 1))
        ids[q, :k] = 2600 + rng.permutation(n_bins)[:k]
        ids[q, rng.random(b) < 0.2] = -1
    if nq > 2:
        ids[-1] = -1
    return bounds, ids


def _jax_z3(h, l, bins, bounds, ids):
    return np.asarray(jz.batched_kind_mask("z3")(
        jnp.asarray(h), jnp.asarray(l), jnp.asarray(bins), jnp.asarray(bounds), jnp.asarray(ids)))


@pytest.mark.parametrize("nq", QS)
@pytest.mark.parametrize("form", ["cells", "words", "mixed"])
def test_z3_packed_plain_matches_both_references(nq, form):
    rng, bins, (h, l), _ = _keys(N, 16, seed=nq + len(form))
    bounds, ids = _z3_group(rng, nq, 16, form)
    th, tl, tb = torch.from_numpy(h), torch.from_numpy(l), torch.from_numpy(bins)
    pk = zscan.batched_zscan(bounds, ids)
    got = pk.plain(tb, th, tl)
    want = zscan.batched_kind_mask("z3")(th, tl, tb, bounds, ids)
    assert got.shape == (nq, N) and torch.equal(got, want)
    real = bins >= 0
    np.testing.assert_array_equal(got.numpy()[:, real], _jax_z3(h, l, bins, bounds, ids)[:, real])
    assert not got[:, ~real].any()  # bin -1 matches no padding
    # the wrapper on CPU planes: the same answers
    assert torch.equal(zscan.batched_zscan_mask(bounds, ids, th, tl, bins=tb), want)
    assert torch.equal(zscan.batched_zscan_count(bounds, ids, th, tl, bins=tb),
                       want.sum(dim=1, dtype=torch.int32))
    if nq > 2:
        assert nq - 1 in pk.idle  # the all-padding query: no launch


@pytest.mark.parametrize("n_bins", [1, 2, 4, 8])
@pytest.mark.parametrize("nq", [1, 8, 47])
def test_z3_groups_of_few_bins(nq, n_bins):
    """Groups over 1 to 8 bins: the flat record list at a few records, the
    bin index beyond, both against the JAX package."""
    rng, bins, (h, l), _ = _keys(N, n_bins, seed=10 * n_bins + nq)
    bounds = _cells(rng, (nq, n_bins), 3)
    ids = np.stack([(2600 + rng.permutation(n_bins)).astype(np.int32) for _ in range(nq)])
    pk = zscan.batched_zscan(bounds, ids)
    records = sum(lc.nc + lc.nm for lc in pk.launches)
    assert [lc.binned for lc in pk.launches] == [records > zscan.FLAT_MAX_RECORDS]
    th, tl, tb = torch.from_numpy(h), torch.from_numpy(l), torch.from_numpy(bins)
    got = pk.plain(tb, th, tl).numpy()
    real = bins >= 0
    np.testing.assert_array_equal(got[:, real], _jax_z3(h, l, bins, bounds, ids)[:, real])
    assert not got[:, ~real].any()


@pytest.mark.parametrize("form", ["cells", "words"])
def test_z3_group_past_one_table(form):
    """64 queries x 64 bins: the packed records exceed one launch's table
    (one block's shared memory), so the packer cuts the queries into
    several launches; the answers do not change."""
    rng, bins, (h, l), _ = _keys(N, 128, seed=64)
    bounds = _cells(rng, (64, 64), 3) if form == "cells" else _words(rng, (64, 64), 3)
    if form == "words":
        bounds[..., 2:4], bounds[..., 4:6] = 0, 0xFFFFFFFF
    ids = np.stack([(2600 + rng.permutation(128)[:64]).astype(np.int32) for _ in range(64)])
    pk = zscan.batched_zscan(bounds, ids)
    assert len(pk.launches) > 1 and 4 * len(pk.table) > zscan.BATCH_TABLE_BYTES
    assert all(4 * lc.words <= zscan.BATCH_TABLE_BYTES for lc in pk.launches)
    assert [lc.q0 for lc in pk.launches[1:]] == [lc.q1 for lc in pk.launches[:-1]]
    th, tl, tb = torch.from_numpy(h), torch.from_numpy(l), torch.from_numpy(bins)
    got = pk.plain(tb, th, tl)
    assert torch.equal(got, zscan.batched_kind_mask("z3")(th, tl, tb, bounds, ids))
    real = bins >= 0
    np.testing.assert_array_equal(got.numpy()[:, real], _jax_z3(h, l, bins, bounds, ids)[:, real])


@pytest.mark.parametrize("nq", QS)
@pytest.mark.parametrize("form", ["cells", "words"])
def test_z2_packed_plain_matches_both_references(nq, form):
    rng, _, _, (h, l) = _keys(N, 4, seed=100 + nq)
    bounds = _cells(rng, (nq,), 2) if form == "cells" else _words(rng, (nq,), 2)
    bounds[1::3] = _words(rng, (len(bounds[1::3]),), 2)
    if nq > 2:
        bounds[-1] = 0
        bounds[-1, :, 3] = 1  # lo_lo 1 > hi 0: the fused paths' z2 padding
    th, tl = torch.from_numpy(h), torch.from_numpy(l)
    pk = zscan.batched_zscan(bounds, None)
    got = pk.plain(None, th, tl)
    assert torch.equal(got, zscan.batched_kind_mask("z2")(th, tl, bounds))
    want = np.asarray(jz.batched_kind_mask("z2")(jnp.asarray(h), jnp.asarray(l), jnp.asarray(bounds)))
    np.testing.assert_array_equal(got.numpy(), want)
    if nq > 2:
        assert nq - 1 in pk.idle and not got[-1].any()


def test_packed_records_hold_the_de_interleaved_bounds():
    """A cell box packs as each dimension's lo and hi (the curve's own
    coordinates), its bin and its query; random words keep all 18 words.
    Bin 2610 holds both queries' records, so its cell boxes pack compact."""
    rng = np.random.default_rng(7)
    lo, hi = np.sort(rng.integers(0, MAX3 + 1, (2, 3)), axis=0)
    bounds = np.stack([zscan.z3_dim_bounds(tuple(lo), tuple(hi)), _words(rng, (), 3)])
    bounds[1, :, 2:4], bounds[1, :, 4:6] = 0, 0xFFFFFFFF
    bounds = np.stack([bounds, bounds[::-1]])
    pk = zscan.batched_zscan(bounds, np.array([[2610, 2611], [2612, 2610]], np.int32))
    (lc,) = pk.launches
    c, m, index = pk._records(lc)
    assert (lc.nc, lc.nm, lc.first, lc.span, lc.binned, index) == (2, 2, 2610, 3, False, None)
    for q in (0, 1):
        assert c[q].tolist() == [lo[0], hi[0], lo[1], hi[1], lo[2], hi[2], 2610, q]
    assert m[:, :4].tolist() == [[2611, 0, 0, 0], [2612, 1, 0, 0]]
    np.testing.assert_array_equal(m[:, 4:22], bounds[[0, 1], [1, 0]].reshape(2, -1))


@pytest.mark.parametrize("n_dims", [2, 3])
def test_cell_boxes_stay_masked_where_a_row_meets_one_record(n_dims):
    """Where no row can meet more than MASKED_MAX_MEET records (z2: one
    query; z3: no bin shared) and the masked table fits one launch, cell
    boxes pack as masked records; a shared bin, a second z2 query, or a
    group whose masked table would need a second launch packs them
    compact. The answers are the same either way."""
    rng, bins, k3, k2 = _keys(N, 16, seed=21)
    h, l = (torch.from_numpy(a) for a in (k3 if n_dims == 3 else k2))
    tb = torch.from_numpy(bins) if n_dims == 3 else None
    assert zscan.MASKED_MAX_MEET == 1

    def forms(bounds, ids):
        pk = zscan.batched_zscan(bounds, ids)
        got = pk.plain(tb, h, l)
        want = (zscan.batched_kind_mask("z3")(h, l, tb, bounds, ids) if n_dims == 3
                else zscan.batched_kind_mask("z2")(h, l, bounds))
        assert torch.equal(got, want)
        return sum(lc.nc for lc in pk.launches), sum(lc.nm for lc in pk.launches)

    if n_dims == 2:
        b = _cells(rng, (2,), 2)
        assert forms(b[:1], None) == (0, 1)
        assert forms(b, None) == (2, 0)
        return
    b = _cells(rng, (2, 3), 3)
    ids = np.array([[2600, 2601, 2602], [2603, 2604, -1]], np.int32)
    assert forms(b, ids) == (0, 5)  # five bins of one record each
    ids[1, 1] = 2600
    assert forms(b, ids) == (5, 0)
    # 64 queries x 16 bins, none shared: 1,024 masked records exceed one table
    wide = np.arange(2600, 2600 + 64 * 16, dtype=np.int32).reshape(64, 16)
    pk = zscan.batched_zscan(_cells(rng, (64, 16), 3), wide)
    assert sum(lc.nm for lc in pk.launches) == 0 and len(pk.launches) == 1


def test_packer_rejects_what_the_kernel_cannot_take():
    b = _cells(np.random.default_rng(1), (1, 2), 3)
    with pytest.raises(ValueError, match="share a bin"):
        zscan.batched_zscan(b, np.array([[2600, 2600]], np.int32))
    with pytest.raises(ValueError, match="span"):
        zscan.batched_zscan(b, np.array([[0, zscan.ZSCAN_MAX_SPAN]], np.int32))
    with pytest.raises(ValueError, match="1 to 64"):
        zscan.batched_zscan_group([], None)


# -- the compact compare is the masked compare --------------------------------


def _edges(lo, hi, top):
    return sorted({min(max(v, 0), top) for e in (lo, hi) for v in (e - 1, e, e + 1)} | {0, top})


@settings(max_examples=60, deadline=None)
@given(st.integers(2, 3), st.data())
def test_compact_compare_equals_masked_compare(n_dims, data):
    top = MAX3 if n_dims == 3 else MAX2
    box = [sorted(data.draw(st.lists(st.integers(0, top), min_size=2, max_size=2)))
           for _ in range(n_dims)]
    lo, hi = tuple(b[0] for b in box), tuple(b[1] for b in box)
    bounds = (zscan.z3_dim_bounds if n_dims == 3 else zscan.z2_dim_bounds)(lo, hi)
    # keys: every combination of each dimension's edge values, plus random keys
    grids = np.meshgrid(*[_edges(lo[d], hi[d], top) for d in range(n_dims)], indexing="ij")
    coords = [g.reshape(-1).astype(np.uint64) for g in grids]
    extra = data.draw(st.lists(st.tuples(*[st.integers(0, top)] * n_dims), max_size=20))
    coords = [np.concatenate([c, np.array([e[d] for e in extra], np.uint64)])
              for d, c in enumerate(coords)]
    enc = zorder.encode_3d_np if n_dims == 3 else zorder.encode_2d_np
    h, l = (torch.from_numpy(a) for a in zorder.u64_hi_lo(enc(*coords)))
    masked = zscan._dims_mask(zscan.widen_u32(h), zscan.widen_u32(l), bounds, n_dims)
    # two queries of the same box and bin: a row meets both, so they pack compact
    pk = zscan._BatchedZScan(n_dims, 2, [0, 1], None if n_dims == 2 else [5, 5],
                             np.stack([bounds, bounds]))
    c, m, _ = pk._records(pk.launches[0])
    assert len(c) == 2 and not len(m)
    decode = zorder.decode_3d_hi_lo_t if n_dims == 3 else zorder.decode_2d_hi_lo_t
    compact = torch.ones_like(masked)
    for d, v in enumerate(decode(h, l)):
        compact &= (v >= int(c[0, 2 * d])) & (v <= int(c[0, 2 * d + 1]))
    assert torch.equal(compact, masked)
    inside = np.all([(coords[d] >= lo[d]) & (coords[d] <= hi[d]) for d in range(n_dims)], axis=0)
    np.testing.assert_array_equal(masked.numpy(), inside)


# -- the fused loose paths launch the group's queries only --------------------

DAY = 86_400_000
T0 = 1_577_836_800_000


def _iso(ms):
    return str(np.datetime64(int(ms), "ms")) + "Z"


@pytest.fixture(scope="module")
def indexes():
    rng = np.random.default_rng(3)
    n = 4000
    xy = rng.uniform([-40, -30], [40, 30], (n, 2)).astype(np.float32).astype(np.float64)
    cols = {"dtg": rng.integers(T0, T0 + 40 * DAY, n), "geom": xy}
    out = {}
    for kind, spec in (("z3", "dtg:Date,*geom:Point:srid=4326"), ("z2", "*geom:Point:srid=4326")):
        c = cols if kind == "z3" else {"geom": xy}
        batch = FeatureBatch.from_columns(SimpleFeatureType.create("t", spec), c)
        for dim in (None, False):
            out[(kind, dim)] = DeviceIndex(BatchStore(batch), "t", z_planes=True, dim_planes=dim,
                                           device="cpu")
    return out


def _tile_queries(k, dated):
    rng = np.random.default_rng(k)
    out = []
    for i in range(k):
        x, y = rng.uniform(-35, 30), rng.uniform(-25, 20)
        q = f"BBOX(geom, {x:.2f}, {y:.2f}, {x + 6:.2f}, {y + 5:.2f})"
        if dated:
            d = T0 + int(rng.integers(0, 35)) * DAY
            q += f" AND dtg DURING {_iso(d)}/{_iso(d + int(rng.integers(1, 12)) * DAY)}"
        out.append(q)
    return out


@pytest.mark.parametrize("k", [3, 5, 13, 47])
@pytest.mark.parametrize("layout", ["z3 interleaved", "z2 interleaved", "z3 dim", "z2 dim"])
def test_fused_paths_launch_the_real_queries(indexes, monkeypatch, k, layout):
    kind, engine = layout.split()
    di = indexes[(kind, False if engine == "interleaved" else None)]
    qs = _tile_queries(k, kind == "z3")
    seen = []
    if engine == "interleaved":
        real = zscan._BatchedZScan.run

        def spy(self, *a, **kw):
            seen.append(self.nq)
            return real(self, *a, **kw)

        monkeypatch.setattr(zscan._BatchedZScan, "run", spy)
    else:
        for name in ("batched_dimscan_count", "batched_dimscan_mask"):
            real_fn = getattr(zscan, name)
            monkeypatch.setattr(zscan, name, lambda q, *p, f=real_fn, **kw: (
                seen.append(len(q)), f(q, *p, **kw))[1])
    serial = [di.count(q, loose=True) for q in qs]
    assert sum(serial) > 0
    assert di.fused_loose_counts(qs, loose=True) == serial
    for q, got in zip(qs, di.fused_loose_query(qs, loose=True)):
        np.testing.assert_array_equal(got.fids, di.query(q, loose=True).fids)
    assert seen == [k, k]  # one launch each for counts and masks, k queries, no padding
    assert all(lb is not None for lb in (di._loose_bounds(parse_ecql(q)) for q in qs))


@pytest.mark.parametrize("nq", [1, 4, 47])
@pytest.mark.parametrize("n_dims", [3, 2])
def test_packed_plain_validity_is_the_mask_anded(nq, n_dims):
    """The batched interleaved scan's plain version on the packed layout,
    count and mask with a validity plane equal the plain version without
    one ANDed with the plane, and equal Q single-query plain versions."""
    rng, bins, (h3, l3), (h2, l2) = _keys(N, 16, seed=5 * nq + n_dims)
    if n_dims == 3:
        bounds, ids = _z3_group(rng, nq, 16, "mixed")
        h, l, tb = torch.from_numpy(h3), torch.from_numpy(l3), torch.from_numpy(bins)
        singles = [tz for tz in (zscan._ZScan(b, i) for b, i in zip(bounds, ids))]
    else:
        bounds, ids = _cells(rng, (nq,), 2), None
        h, l, tb = torch.from_numpy(h2), torch.from_numpy(l2), None
        singles = [zscan._ZScan(b, None) for b in bounds]
    pk = zscan.batched_zscan(bounds, ids)
    base = pk.plain(tb, h, l)
    tail = np.ones(N, bool)
    tail[N // 2:] = False
    for v in map(torch.from_numpy, (np.ones(N, bool), rng.random(N) < 0.5, tail,
                                    np.zeros(N, bool))):
        got = pk.plain(tb, h, l, valid=v)
        assert torch.equal(got, base & v)
        assert torch.equal(got, torch.stack([s.plain(tb, h, l, valid=v) for s in singles]))
        assert torch.equal(pk.run(tb, h, l, want_mask=True, valid=v), got)
        assert torch.equal(zscan.batched_zscan_count(bounds, ids, h, l, bins=tb, valid=v),
                           got.sum(dim=1, dtype=torch.int32))
