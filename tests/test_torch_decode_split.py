"""K2's and K6's split-KV, in plain PyTorch.

On the card K2 (paged decode) and K6 (dense decode) share a long row's
live range over several blocks (``kernels/split.py``: ``split_count``
blocks, each taking its share ``split_ranges``) and fold the blocks'
partials with one merge kernel.  Here each row's live range is cut the
kernels' way into 2 to 5 shares, the plain partials of each share are
computed with ``paged_attend_plain`` and ``flash_decode_partials_plain``,
merged with ``merge_split_partials_plain``, and held to the unsplit plain
partials and to the JAX package's Pallas kernels in interpret mode (B2,
B7) and their oracles (``repro/kernels/ref.py`` ``paged_decode_ref``,
``flash_decode_ref``), on the same numpy-made pages, caches and masks."""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref

from repro_torch.kernels.flash_decode import flash_decode_partials_plain
from repro_torch.kernels.paged_decode import paged_attend_plain
from repro_torch.kernels.split import (DECODE_MAX_SPLITS, MAX_SPLITS,
                                       SPLIT_MIN_POSITIONS,
                                       merge_split_partials_plain,
                                       split_count, split_ranges)

# the tolerance of tests/test_torch_paged_decode.py and
# tests/test_torch_flash_decode.py: f32 sums in another order than XLA's
ATOL = 1e-5
# bf16 outputs of the JAX side: one bf16 ulp (2^-7 relative) apart
BF16_RTOL = 2.0 ** -7
# a merge only reorders f32 sums: 1e-6 of the unsplit partials' scale
MERGE_RTOL = 1e-6
NEG_INF = float(np.float32(-1e30))


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _bf16_torch(a):
    return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)


def _torch(*arrays):
    out = []
    for a in arrays:
        if a is None:
            out.append(None)
        elif a.dtype == ml_dtypes.bfloat16:
            out.append(_bf16_torch(a))
        else:
            out.append(torch.from_numpy(np.array(a)))
    return out


def _split_masks(valid, n_split):
    """(n_split, B, S) bool: each block's share of each row, the kernels'
    cut of the row's live range."""
    keep = np.zeros((n_split,) + valid.shape, bool)
    for b in range(valid.shape[0]):
        for s, (lo, hi) in enumerate(split_ranges(valid[b], n_split)):
            keep[s, b, lo:hi] = True
    return keep


def _merged(partials, valid, n_split):
    """The plain partials of each share of every row, merged."""
    parts = [partials(valid & keep) for keep in _split_masks(valid, n_split)]
    return merge_split_partials_plain(*(torch.stack(t) for t in zip(*parts)))


def _hold_to_unsplit(got, want):
    for g, w in zip(got, want):
        live = w[w > NEG_INF / 2]
        scale = float(live.abs().max()) if live.numel() else 1.0
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                   atol=MERGE_RTOL * max(scale, 1.0))


def _hold_empty(o, l, m, rows):
    assert float(o[rows].abs().max()) == 0.0
    assert float(l[rows].abs().max()) == 0.0
    assert bool((m[rows] == NEG_INF).all())


def _normalised(o, l):
    return (o / torch.clamp(l, min=1e-30)[..., None]).numpy()


# ---------------------------------------------------------------------------
# the split policy and the kernels' cut

def test_split_count_keeps_served_shapes_one_split():
    """Up to SPLIT_MIN_POSITIONS virtual positions (the served caches of
    112, phase model's 80 at most, the harvest's 112, the chunked fleet's
    256) every call is one block a row: one launch, no merge."""
    assert SPLIT_MIN_POSITIONS == 256
    for n_pos in (1, 16, 80, 112, 256):
        assert split_count(n_pos, DECODE_MAX_SPLITS) == 1
        assert split_count(n_pos) == 1
    assert split_count(257, DECODE_MAX_SPLITS) == 2
    assert split_count(1024, DECODE_MAX_SPLITS) == 4
    assert split_count(4096, DECODE_MAX_SPLITS) == DECODE_MAX_SPLITS == 8
    assert split_count(4096) == MAX_SPLITS == 16
    assert split_count(1 << 20, DECODE_MAX_SPLITS) == DECODE_MAX_SPLITS


@pytest.mark.parametrize("n_split", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("row", ["full", "tail", "band", "holes", "one",
                                 "ends", "empty"])
def test_split_ranges_cut_the_live_range(row, n_split):
    """The shares are consecutive, in order, each ceil(live / n_split)
    long but the last ones, which may be short or empty; together they are
    exactly [first valid, last valid + 1)."""
    n_pos = 100
    valid = np.zeros(n_pos, bool)
    if row == "full":
        valid[:] = True
    elif row == "tail":
        valid[:37] = True
    elif row == "band":
        valid[20:61] = True
    elif row == "holes":
        valid[np.random.default_rng(n_split).random(n_pos) < 0.3] = True
        valid[[5, 90]] = True
    elif row == "one":
        valid[42] = True
    elif row == "ends":
        valid[[0, n_pos - 1]] = True
    ranges = split_ranges(valid, n_split)
    assert len(ranges) == n_split
    if row == "empty":
        assert all(lo == hi for lo, hi in ranges)
        return
    idx = np.flatnonzero(valid)
    first, last = int(idx[0]), int(idx[-1])
    per = -(-(last - first + 1) // n_split)
    covered = []
    for s, (lo, hi) in enumerate(ranges):
        assert lo <= hi and hi - lo <= per
        if hi > lo:
            assert lo == first + s * per
        covered.extend(range(lo, hi))
    assert covered == list(range(first, last + 1))
    if row == "one":        # a single valid position: all in one share
        assert sum(hi > lo for lo, hi in ranges) == 1


# ---------------------------------------------------------------------------
# K2: paged decode, f32 / bf16 / int8 pages

def _paged_case(dtype, seed, B=4, H=6, KV=2, d=32, bs=8, nb=8):
    """Pages from a shuffled pool with NULL (page 0) entries; rows: fully
    valid, holes inside the range behind a masked NULL entry, valid only
    at both ends (the middle shares empty), and no valid position (empty
    in every share)."""
    rng = np.random.default_rng(seed)
    P = B * nb + 1
    q = rng.standard_normal((B, H, d)).astype(np.float32)
    if dtype == "int8":
        k = rng.integers(-127, 128, (P, KV, bs, d)).astype(np.int8)
        v = rng.integers(-127, 128, (P, KV, bs, d)).astype(np.int8)
        ks = rng.uniform(0.001, 0.02, (P, KV, bs, 1)).astype(np.float32)
        vs = rng.uniform(0.001, 0.02, (P, KV, bs, 1)).astype(np.float32)
    else:
        k = rng.standard_normal((P, KV, bs, d)).astype(np.float32)
        v = rng.standard_normal((P, KV, bs, d)).astype(np.float32)
        if dtype == "bf16":
            k, v = k.astype(ml_dtypes.bfloat16), v.astype(ml_dtypes.bfloat16)
        ks = vs = None
    tables = (1 + rng.permutation(B * nb)).reshape(B, nb).astype(np.int32)
    n_pos = nb * bs
    valid = np.zeros((B, n_pos), bool)
    valid[0] = True
    tables[1, 0] = 0                      # NULL entry, masked off
    valid[1, bs:] = rng.random(n_pos - bs) < 0.4
    valid[1, [bs + 2, n_pos - 3]] = True
    valid[2, [1, 2, n_pos - 2]] = True
    return q, k, v, tables, valid, ks, vs


@pytest.mark.parametrize("n_split", [2, 3, 4, 5])
@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
def test_k2_merged_splits_match_unsplit_and_pallas(dtype, n_split):
    q, k, v, tables, valid, ks, vs = _paged_case(dtype, seed=n_split)
    b, h, d = q.shape
    n_kv = k.shape[1]
    tq, tk, tv, ttab, tks, tvs = _torch(q, k, v, tables, ks, vs)
    qg = tq.reshape(b, n_kv, h // n_kv, d)

    def partials(mask):
        return paged_attend_plain(qg, tk, tv, ttab, torch.from_numpy(mask),
                                  tks, tvs)
    o, l, m = _merged(partials, valid, n_split)
    _hold_to_unsplit((o, l, m), partials(valid))
    _hold_empty(o, l, m, 3)
    live = valid.any(1)
    # the Pallas kernel (rows with a valid position) and its oracle
    jargs = [None if a is None else jnp.asarray(a)
             for a in (q, k, v, tables, valid, ks, vs)]
    jo, jl, jm = jops.paged_flash_decode(*jargs, interpret=True,
                                         return_partials=True)
    for port, ref in ((o, jo), (l, jl), (m, jm)):
        np.testing.assert_allclose(port.numpy()[live], np.asarray(ref)[live],
                                   rtol=0, atol=ATOL)
    ref = np.asarray(jref.paged_decode_ref(*jargs))
    out = _normalised(o, l).reshape(b, h, d)
    np.testing.assert_allclose(out, ref, rtol=0, atol=ATOL)


# ---------------------------------------------------------------------------
# K6: dense decode, f32 / bf16 caches

def _dense_case(seed, B=5, H=6, KV=2, d=64, S=48):
    """Rows: fully valid, a ragged tail, a sliding-window band (a ring's
    live span), holes inside a band, and no valid position at all."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, d)).astype(np.float32)
    k = rng.standard_normal((B, KV, S, d)).astype(np.float32)
    v = rng.standard_normal((B, KV, S, d)).astype(np.float32)
    valid = np.zeros((B, S), bool)
    valid[0] = True
    valid[1, :S // 2 + 3] = True
    valid[2, 7:S - 5] = True
    valid[3, 4:40] = rng.random(36) < 0.5
    valid[3, [4, 39]] = True
    return q, k, v, valid


def _as(dtype, *arrays):
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    tt = [torch.from_numpy(a).to(tdt) for a in arrays]
    jj = [jnp.asarray(a).astype(jdt) for a in arrays]
    return tt, jj


def _f32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.mark.parametrize("n_split", [2, 3, 4, 5])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_k6_merged_splits_match_unsplit_and_pallas(dtype, n_split):
    """f32: the merge reorders f32 sums only.  bf16: each share rounds p
    to bf16 against its own running max, not the row's, so p may land one
    bf16 ulp apart (2^-9 of p) from the unsplit rounding; on the
    normalised output that is at most 2 x 2^-9 = 2^-8 of max(1, max |v|)
    from the unsplit plain version (or from B7 in one block, which rounds
    against the row max), and 2^-9 of it from the oracle's f32 p."""
    q, k, v, valid = _dense_case(seed=n_split)
    (tq, tk, tv), (jq, jk, jv) = _as(dtype, q, k, v)
    b, h, d = q.shape
    n_kv = k.shape[1]
    qg = tq.reshape(b, n_kv, h // n_kv, d)

    def partials(mask):
        return flash_decode_partials_plain(qg, tk, tv, torch.from_numpy(mask))
    o, l, m = _merged(partials, valid, n_split)
    uo, ul, um = partials(valid)
    _hold_empty(o, l, m, 4)
    live = valid.any(1)
    out = _normalised(o, l).reshape(b, h, d)
    jval = jnp.asarray(valid)
    pallas = _f32(jops.flash_decode(jq, jk, jv, jval, bs=512,
                                    interpret=True))
    oracle = _f32(jref.flash_decode_ref(jq, jk, jv, jval))
    if dtype == "f32":
        _hold_to_unsplit((o, l, m), (uo, ul, um))
        np.testing.assert_allclose(out[live], pallas[live], rtol=0,
                                   atol=ATOL)
        np.testing.assert_allclose(out, oracle, rtol=0, atol=ATOL)
        return
    # l sums the unrounded p and m is the row max: both as unsplit
    _hold_to_unsplit((l, m), (ul, um))
    vmax = max(1.0, float(tv.float().abs().max()))
    np.testing.assert_allclose(out, _normalised(uo, ul).reshape(b, h, d),
                               rtol=0, atol=2.0 ** -8 * vmax)
    np.testing.assert_allclose(out[live], pallas[live], rtol=BF16_RTOL,
                               atol=2.0 ** -8 * vmax)
    np.testing.assert_allclose(out, oracle, rtol=BF16_RTOL,
                               atol=2.0 ** -9 * vmax)
