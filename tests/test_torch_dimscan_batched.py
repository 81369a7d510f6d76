"""The Q-batched dim scan's packed layout in ``geomesa_tpu_torch`` against
``geomesa_tpu``'s ``batched_dim_mask_rt``.

The batched kernel (``csrc/dimscan.cu`` ``gm_dimscan_batched``) reads a
group packed by ``ops/zscan.py`` ``_BatchedDimScan``: per dimension the
sorted cuts of the group's ranges (lo and hi + 1, none at 0 or 2^32) in a
breadth-first search tree, and a 64-bit word per interval between cuts of
the queries whose ranges hold it. A row's hits are the AND of its
intervals' words. Held here, bit for bit, on the CPU:

- the plain version on the packed layout (``_BatchedDimScan.plain``:
  ``torch.searchsorted`` over the cuts read back from the table, a gather
  of the words, the AND) and the wrappers' CPU path (``batched_dimscan_count``
  / ``_mask``), against the port's ``batched_dim_mask_rt`` and the JAX
  package's (an XLA vmap, x64), at Q in {1, 3, 8, 47, 64} and R in {0, 1,
  2, 4, 8}, without and with a validity plane;
- the edge groups of ``chip_smoke.py`` (ranges at 0 and 0xFFFFFFFF, rows
  at 0xFFFFFFFF, identical queries, nested ranges and shared ends,
  adjacent and overlapping bt ranges inside a query, all padding) over
  rows at the groups' range ends and one either side;
- the table itself: cuts, depths, the search tree's order, the words by
  rank, against a brute force over each interval's start;
- a property: the packed plain version equals the per-query one for any
  group and rows drawn near its ends.
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from geomesa_tpu.ops import zscan as jz
from geomesa_tpu_torch import kernels
from geomesa_tpu_torch.ops import zscan

torch.set_num_threads(2)  # xdist workers share the host's cores

N = 2003
QS = [1, 3, 8, 47, 64]
RS = [0, 1, 2, 4, 8]
U32 = 0xFFFFFFFF


def _load_chip_smoke():
    """``chip_smoke.py`` at the repo's root (importing it runs nothing): its
    group generators ``batch_qmat``, ``batch_qmat_edge`` and
    ``batch_edge_planes``, so that the card's checks and these tests draw
    their groups from one copy."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("_chip_smoke_dim_cases", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_CASES = _load_chip_smoke()


def _jax_mask(r, planes, qmat, valid=None) -> np.ndarray:
    m = np.asarray(jz.batched_dim_mask_rt(r)(*(jnp.asarray(p) for p in planes), jnp.asarray(qmat)))
    return m if valid is None else m & valid[None, :]


def _check_group(r, qmat, planes, valid=None):
    """The packed plain version, the wrappers and the port's reference
    against the JAX package's mask, bit for bit."""
    tp = [torch.from_numpy(p) for p in planes]
    tv = None if valid is None else torch.from_numpy(valid)
    want = _jax_mask(r, planes, qmat, valid)
    ref = zscan.batched_dim_mask_rt(r)(*tp, qmat, valid=tv)
    assert ref.shape == (len(qmat), len(planes[0])) and ref.dtype == torch.bool
    assert np.array_equal(ref.numpy(), want)
    pk = zscan.batched_dimscan(qmat)
    assert np.array_equal(pk.plain(*tp, valid=tv).numpy(), want)
    assert np.array_equal(pk.run(tp, want_mask=True, valid=tv).numpy(), want)
    assert pk.run(tp, want_mask=False, valid=tv).tolist() == want.sum(axis=1).tolist()
    assert np.array_equal(zscan.batched_dimscan_mask(qmat, *tp, valid=tv).numpy(), want)
    got_c = zscan.batched_dimscan_count(qmat, *tp, valid=tv)
    assert got_c.dtype == torch.int32 and got_c.tolist() == want.sum(axis=1).tolist()
    return want


@pytest.mark.parametrize("valid", [False, True])
@pytest.mark.parametrize("r", RS)
@pytest.mark.parametrize("nq", QS)
def test_packed_plain_matches_both_references(nq, r, valid):
    """Random groups (boxes, bt ranges, some inverted, the last query all
    padding) over random rows and rows at the groups' range ends."""
    rng = np.random.default_rng(1000 * nq + 10 * r + valid)
    qmat = _CASES.batch_qmat(rng, nq, r, 12 << 21)
    planes = _CASES.batch_edge_planes(rng, qmat, N)
    live = rng.random(N) < 0.5 if valid else None
    want = _check_group(r, qmat, planes, live)
    if nq > 2:
        assert not want[-1].any()
    assert kernels.LAUNCHES["dimscan_batched_z3_count"] == 0


@pytest.mark.parametrize("r", RS)
@pytest.mark.parametrize("edge", _CASES.BATCH_EDGES)
def test_edge_groups_match_both_references(edge, r):
    """Each edge group at Q = 64 and Q = 3 over rows at its range ends, one
    either side of them, 0, 1, 0xFFFFFFFE and 0xFFFFFFFF."""
    for nq in (64, 3):
        rng = np.random.default_rng(1000 * _CASES.BATCH_EDGES.index(edge) + 10 * r + nq)
        qmat = _CASES.batch_qmat_edge(rng, edge, nq, r, 12 << 21)
        planes = _CASES.batch_edge_planes(rng, qmat, N)
        want = _check_group(r, qmat, planes)
        if edge == "identical queries":
            assert (want == want[0]).all()
        if edge == "all padding":
            assert not want.any() and zscan.batched_dimscan(qmat).depths == [0] * (3 if r else 2)


def test_rows_at_the_top_of_uint32():
    """Rows at 0xFFFFFFFF in every plane: only queries whose ranges reach
    0xFFFFFFFF in every dimension hold them, though the search tree's
    padding equals their value."""
    q = np.array([[0, U32, 0, U32, 5, U32],       # holds the top
                  [0, U32 - 1, 0, U32, 0, U32],    # stops one short in nx
                  [U32, U32, U32, U32, U32, U32],  # the top alone
                  [1, 0, 1, 0, U32, 0]], np.uint32)  # padding
    planes = [np.array([U32, U32 - 1, 0, 5, U32], np.uint32) for _ in range(3)]
    want = _check_group(1, q, planes)
    assert want.tolist() == [[True, True, False, True, True], [False, True, True, True, False],
                             [True, False, False, False, True], [False] * 5]


def test_packed_table_layout():
    """Cuts, depths, the breadth-first tree and the words by rank, against
    a brute force over each interval's start."""
    rng = np.random.default_rng(3)
    for r in RS:
        qmat = _CASES.batch_qmat(rng, 47, r, 12 << 21)
        qmat[0, :4] = [0, U32, 7, U32 - 1]
        pk = zscan.batched_dimscan(qmat, compare=False)
        q = qmat.astype(np.int64)
        dims = [q[:, 0:2], q[:, 2:4]] + ([q[:, 4:]] if r else [])
        table = pk.table(compare=False)
        assert pk.n_dims == len(dims) and table is pk.lookup_table and len(table) % 4 == 0
        assert len(table) == -(-3 * sum(1 << d for d in pk.depths) // 4) * 4
        for (padded, words), cols, cuts, depth in zip(pk._layout(), dims, pk.cuts, pk.depths):
            lo, hi = cols[:, 0::2], cols[:, 1::2]
            real = lo <= hi
            want = np.unique(np.concatenate([lo[real], hi[real] + 1]))
            want = want[(want > 0) & (want <= U32)]
            assert np.array_equal(cuts, want) and depth == len(want).bit_length() <= 11
            # the tree read back in order: the cuts, then 0xFFFFFFFF padding
            assert np.array_equal(padded, np.concatenate([want, np.full((1 << depth) - 1 - len(want), U32)]))
            starts = np.concatenate([[0], want])
            inside = ((lo[None] <= starts[:, None, None]) & (starts[:, None, None] <= hi[None])).any(2)
            brute = (inside.astype(np.uint64) << np.arange(len(q), dtype=np.uint64)).sum(1)
            w = words.view(np.uint64)
            assert np.array_equal(w[: len(want) + 1], brute)
            assert (w[len(want):] == brute[-1]).all()  # past the last interval: its word


def test_eytzinger_order_is_a_search_tree():
    """Node i's value lies between its left subtree's and its right
    subtree's, every sorted position once."""
    for depth in range(0, 12):
        order = zscan._eytzinger(depth)
        assert sorted(order[1:].tolist()) == list(range((1 << depth) - 1))
        for i in range(1, (1 << depth) // 2):
            assert order[2 * i] < order[i] < order[2 * i + 1]


def test_packer_rejects_what_the_kernel_cannot_take():
    rng = np.random.default_rng(0)
    with pytest.raises(TypeError):
        zscan.batched_dimscan(_CASES.batch_qmat(rng, 3, 1, 1 << 21).astype(np.int64))
    with pytest.raises(ValueError):
        zscan.batched_dimscan(np.zeros((0, 6), np.uint32))
    with pytest.raises(ValueError):
        zscan.batched_dimscan(np.zeros((65, 6), np.uint32))
    with pytest.raises(ValueError):
        zscan.batched_dimscan(np.zeros((3, 10), np.uint32))  # R = 3
    pk = zscan.batched_dimscan(_CASES.batch_qmat(rng, 3, 1, 1 << 21))
    planes = [torch.zeros(8, dtype=torch.uint32) for _ in range(2)]
    with pytest.raises(ValueError, match="planes"):
        pk.run(planes, want_mask=True)


_ENDS = st.sampled_from([0, 1, 2, 3, 100, 101, U32 - 2, U32 - 1, U32])


@settings(max_examples=60, deadline=None)
@given(st.sampled_from(RS), st.integers(1, 64), st.data())
def test_packed_plain_equals_per_query_plain(r, nq, data):
    """For any group whose ends come from a few values near 0, 100 and
    0xFFFFFFFF (so that ranges nest, share ends, touch, overlap, invert and
    reach both ends of uint32), over rows at every such value and one
    either side: the plain version on the packed layout equals the
    per-query plain version."""
    vals = data.draw(st.lists(_ENDS, min_size=nq * (4 + 2 * r), max_size=nq * (4 + 2 * r)))
    qmat = np.array(vals, np.uint32).reshape(nq, 4 + 2 * r)
    ends = np.unique(np.array([0, 1, 2, 3, 4, 99, 100, 101, 102, U32 - 3, U32 - 2, U32 - 1, U32], np.uint32))
    rng = np.random.default_rng(data.draw(st.integers(0, 2**32 - 1)))
    planes = [torch.from_numpy(rng.choice(ends, 257)) for _ in range(3 if r else 2)]
    want = zscan.batched_dim_mask_rt(r)(*planes, qmat)
    assert torch.equal(zscan.batched_dimscan(qmat).plain(*planes), want)


@pytest.mark.parametrize("r", RS)
def test_the_group_shape_picks_the_way(r):
    """A count of at most DIMSCAN_COUNT_COMPARE_MAX compares a row, and a
    mask of at most DIMSCAN_MASK_COMPARE_MAX, take the compare way, whose
    table is the query vectors; others the lookup way. Either way can be
    forced, and the lookup layout is packed on demand."""
    rng = np.random.default_rng(r)
    for nq in QS:
        qmat = _CASES.batch_qmat(rng, nq, r, 12 << 21)
        pk = zscan.batched_dimscan(qmat)
        compares = nq * (4 + 2 * r)
        assert pk.takes_compare(False) == (compares <= zscan.DIMSCAN_COUNT_COMPARE_MAX)
        assert pk.takes_compare(True) == (compares <= zscan.DIMSCAN_MASK_COMPARE_MAX)
        assert np.array_equal(pk.table(True), qmat.reshape(-1))
        assert pk.table(False) is pk.lookup_table
        for compare in (True, False):
            forced = zscan.batched_dimscan(qmat, compare=compare)
            assert forced.takes_compare(False) is compare and forced.takes_compare(True) is compare
            assert forced.depths == pk.depths and np.array_equal(forced.lookup_table, pk.lookup_table)
