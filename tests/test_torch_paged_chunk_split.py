"""K3's split-KV merge and the three-term bf16 split, in plain PyTorch.

On the card K3 shares a long segment's positions over several blocks and
merges their partials by the log-sum-exp rule; its tensor-core tile body
(``csrc/attn_tile.cuh``) splits f32 operands into three bf16 terms.  Here
the positions of each segment are cut into 2 to 5 ranges (empty ranges
and a segment empty in every range included), the plain partials of each
range are merged with ``merge_split_partials_plain``, and the result is
held to the unsplit plain partials and to the JAX package's Pallas kernel
in interpret mode and its jnp oracle (``repro/kernels/ref.py``
``paged_packed_chunk_ref``), on the same numpy-made pages."""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref

from repro_torch.kernels.paged_chunk import (MAX_SPLITS, SPLIT_MIN_POSITIONS,
                                             merge_split_partials_plain,
                                             paged_packed_chunk_plain,
                                             split_count)

# the Pallas oracle's tolerance in tests/test_torch_paged_chunk.py: f32
# sums in another order than XLA's
ATOL = 1e-5
# a merge only reorders f32 sums: 1e-6 of the unsplit partials' scale
MERGE_RTOL = 1e-6
# chip_smoke.py's tolerance for K7's f32 contract (of max(1, max |v|))
K7_F32_TOL = 2e-5
H, KV, D, BS, NB = 6, 2, 32, 8, 8
NEG_INF = float(np.float32(-1e30))


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _case(dtype, seed):
    """C = 24 tokens of R = 4 segments over NB * BS = 64 positions:
    segment 0 a prefix of 37 positions, segment 1 no cache at all (empty
    in every range), segment 2 a row with holes, segment 3 full; padding
    tokens carry the last segment's id."""
    rng = np.random.default_rng(seed)
    C, R = 24, 4
    P = R * NB + 1
    q = rng.standard_normal((C, H, D)).astype(np.float32)
    if dtype == "int8":
        k = rng.integers(-127, 128, (P, KV, BS, D)).astype(np.int8)
        v = rng.integers(-127, 128, (P, KV, BS, D)).astype(np.int8)
        ks = rng.uniform(0.001, 0.02, (P, KV, BS, 1)).astype(np.float32)
        vs = rng.uniform(0.001, 0.02, (P, KV, BS, 1)).astype(np.float32)
    else:
        k = rng.standard_normal((P, KV, BS, D)).astype(np.float32)
        v = rng.standard_normal((P, KV, BS, D)).astype(np.float32)
        if dtype == "bf16":
            k, v = k.astype(ml_dtypes.bfloat16), v.astype(ml_dtypes.bfloat16)
        ks = vs = None
    tables = (1 + rng.permutation(R * NB)).reshape(R, NB).astype(np.int32)
    n_pos = NB * BS
    valid = np.zeros((R, n_pos), bool)
    valid[0, :37] = True
    valid[2] = rng.random(n_pos) < 0.4          # holes inside the range
    valid[2, [3, 50]] = True
    valid[3] = True
    seg = np.array([0] * 6 + [1] * 5 + [2] * 7 + [3] * 3 + [3] * 3, np.int32)
    return q, k, v, seg, tables, valid, ks, vs


def _ranges(rng, n_ranges, n_pos):
    """Cut [0, n_pos) into n_ranges runs; two cuts coincide (an empty
    range) whenever n_ranges > 2."""
    cuts = np.sort(rng.integers(0, n_pos + 1, n_ranges - 1))
    if n_ranges > 2:
        cuts[1] = cuts[0]
    edges = np.concatenate([[0], cuts, [n_pos]])
    return list(zip(edges[:-1], edges[1:]))


def _torch(*arrays):
    out = []
    for a in arrays:
        if a is None:
            out.append(None)
        elif a.dtype == ml_dtypes.bfloat16:
            out.append(torch.from_numpy(a.view(np.int16))
                       .view(torch.bfloat16))
        else:
            out.append(torch.from_numpy(np.array(a)))
    return out


def _split_partials(q, k, v, seg, tables, valid, ks, vs, ranges):
    parts = []
    for lo, hi in ranges:
        keep = np.zeros_like(valid)
        keep[:, lo:hi] = True
        parts.append(paged_packed_chunk_plain(*_torch(
            q, k, v, seg, tables, valid & keep, ks, vs)))
    return merge_split_partials_plain(*(torch.stack(t) for t in zip(*parts)))


@pytest.mark.parametrize("n_ranges", [2, 3, 4, 5])
@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
def test_merged_ranges_match_unsplit_and_pallas(dtype, n_ranges):
    q, k, v, seg, tables, valid, ks, vs = _case(dtype, seed=n_ranges)
    ranges = _ranges(np.random.default_rng(10 + n_ranges), n_ranges,
                     valid.shape[1])
    o, l, m = _split_partials(q, k, v, seg, tables, valid, ks, vs, ranges)
    uo, ul, um = paged_packed_chunk_plain(*_torch(q, k, v, seg, tables,
                                                  valid, ks, vs))
    for got, want in ((o, uo), (l, ul), (m, um)):
        scale = float(want[want > NEG_INF / 2].abs().max())
        np.testing.assert_allclose(got.numpy(), want.numpy(),
                                   rtol=MERGE_RTOL, atol=MERGE_RTOL * scale)
    jargs = [None if a is None else jnp.asarray(a)
             for a in (q, k, v, seg, tables, valid, ks, vs)]
    jo, jl, jm = jops.paged_flash_packed_chunk(*jargs, interpret=True)
    ro, rl, rm = jref.paged_packed_chunk_ref(*jargs)
    live = valid.any(1)[seg]
    for got, pal, ref in ((o, jo, ro), (l, jl, rl), (m, jm, rm)):
        np.testing.assert_allclose(got.numpy()[live], np.asarray(pal)[live],
                                   rtol=0, atol=ATOL)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                                   atol=ATOL)
    # segment 1 has no valid position in any range: the empty-row contract
    empty = seg == 1
    assert float(l.numpy()[empty].max()) == 0.0
    assert float(np.abs(o.numpy()[empty]).max()) == 0.0
    assert bool((m.numpy()[empty] == NEG_INF).all())


def test_merge_of_one_range_is_the_partials_themselves():
    q, k, v, seg, tables, valid, ks, vs = _case("bf16", seed=20)
    o, l, m = paged_packed_chunk_plain(*_torch(q, k, v, seg, tables, valid))
    mo, ml, mm = merge_split_partials_plain(o[None], l[None], m[None])
    for a, b in ((o, mo), (l, ml), (m, mm)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_all_ranges_empty_keeps_the_empty_row_contract():
    S, rows = 4, 7
    o = torch.zeros(S, rows, D)
    l = torch.zeros(S, rows)
    m = torch.full((S, rows), NEG_INF)
    mo, ml, mm = merge_split_partials_plain(o, l, m)
    assert bool((mo == 0).all()) and bool((ml == 0).all())
    assert bool((mm == NEG_INF).all())


def test_split_count_keeps_served_shapes_one_launch():
    """Up to SPLIT_MIN_POSITIONS positions (the served chunk's 16 pages of
    16, the verify shape's 7) and for f32 pages: one block per segment."""
    for n_pos in (16, 112, 256):
        assert split_count(n_pos, torch.bfloat16) == 1
    assert split_count(4096, torch.float32) == 1
    assert split_count(SPLIT_MIN_POSITIONS + 1, torch.bfloat16) == 2
    assert split_count(1024, torch.int8) == 4
    assert split_count(4096, torch.bfloat16) == MAX_SPLITS
    assert split_count(1 << 20, torch.bfloat16) == MAX_SPLITS


def _split3(x):
    """The tile body's split: each term the bf16 rounding of what the
    terms before it left."""
    t0 = x.to(torch.bfloat16)
    r1 = x - t0.float()
    t1 = r1.to(torch.bfloat16)
    t2 = (r1 - t1.float()).to(torch.bfloat16)
    return t0, t1, t2


@pytest.mark.parametrize("operand", ["p", "q"])
def test_three_bf16_terms_give_the_f32_product(operand):
    """p (softmax weights, int8's v_scale folded in) or an f32 q, split in
    three bf16 terms: the terms add back to the f32 value exactly, and the
    three bf16 x bf16 products summed in f32 (what the three mma.sync
    calls compute) stay within K7_F32_TOL of the f32 product."""
    rng = np.random.default_rng(30)
    n, width = 64, 64
    if operand == "p":
        s = rng.standard_normal((n, width)).astype(np.float32) * 4
        x = torch.softmax(torch.from_numpy(s), -1)
        x = x * torch.from_numpy(
            rng.uniform(0.001, 0.02, (1, width)).astype(np.float32))
        other = torch.from_numpy(
            rng.integers(-127, 128, (width, D)).astype(np.float32))
    else:
        x = torch.from_numpy(
            rng.standard_normal((n, width)).astype(np.float32)) / 8
        other = torch.from_numpy(rng.standard_normal((width, D))
                                 .astype(np.float32)).to(torch.bfloat16) \
            .float()
    terms = _split3(x)
    assert torch.equal(terms[0].float() + terms[1].float()
                       + terms[2].float(), x)
    want = x.double() @ other.double()
    got = sum(t.float() @ other for t in terms)
    tol = K7_F32_TOL * max(1.0, float(want.abs().max()))
    assert float((got.double() - want).abs().max()) <= tol
    # one bf16 term alone (p rounded to bf16) would miss the contract
    one = (terms[0].float() @ other).double()
    assert float((one - want).abs().max()) > tol
