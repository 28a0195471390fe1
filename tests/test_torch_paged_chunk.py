"""K3's plain versions (``paged_flash_prefill_chunk`` and
``paged_flash_packed_chunk`` on CPU tensors) held to the JAX package's
Pallas kernels in interpret mode and to their jnp oracles
(``repro/kernels/ref.py`` ``paged_prefill_chunk_ref`` and
``paged_packed_chunk_ref``), on the same numpy-made pages, tables and
masks, in f32, bf16 and int8 pages."""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import attention as jattn

from repro_torch.kernels.paged_chunk import (paged_flash_packed_chunk,
                                             paged_flash_prefill_chunk)
from repro_torch.kernels.paged_decode import paged_flash_decode

# f32 sums in another order than XLA's (and online vs one-shot softmax)
ATOL = 1e-5
H, KV, D, BS, NB = 6, 2, 32, 8, 4


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _pool(rng, dtype, n_rows):
    """A shuffled pool of n_rows * NB + 1 pages (page 0 NULL)."""
    P = n_rows * NB + 1
    if dtype == "int8":
        k = rng.integers(-127, 128, (P, KV, BS, D)).astype(np.int8)
        v = rng.integers(-127, 128, (P, KV, BS, D)).astype(np.int8)
        ks = rng.uniform(0.001, 0.02, (P, KV, BS, 1)).astype(np.float32)
        vs = rng.uniform(0.001, 0.02, (P, KV, BS, 1)).astype(np.float32)
        return k, v, ks, vs
    k = rng.standard_normal((P, KV, BS, D)).astype(np.float32)
    v = rng.standard_normal((P, KV, BS, D)).astype(np.float32)
    if dtype == "bf16":
        k = k.astype(ml_dtypes.bfloat16)
        v = v.astype(ml_dtypes.bfloat16)
    return k, v, None, None


def _tables(rng, n_rows):
    return (1 + rng.permutation(n_rows * NB)).reshape(n_rows, NB) \
        .astype(np.int32)


def _packed_case(dtype, seed=0):
    """C = 16 tokens of R = 4 segments: segment 0 with 13 cached positions
    (4 tokens), segment 1 a prompt head with no cache (5 tokens), segment 2
    of zero length, segment 3 with a full cache (3 tokens), then 4 padding
    tokens carrying the last segment's id."""
    rng = np.random.default_rng(seed)
    C, R = 16, 4
    q = rng.standard_normal((C, H, D)).astype(np.float32)
    k, v, ks, vs = _pool(rng, dtype, R)
    tables = _tables(rng, R)
    tables[1, :] = 0                      # no pages yet: NULL entries
    starts = np.array([13, 0, 0, NB * BS], np.int32)
    valid = np.arange(NB * BS)[None, :] < starts[:, None]
    seg = np.array([0] * 4 + [1] * 5 + [3] * 3 + [3] * 4, np.int32)
    return q, k, v, seg, tables, valid, ks, vs


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


def _jax(*arrays):
    return [None if a is None else jnp.asarray(a) for a in arrays]


def _close(port, ref, mask=None, atol=ATOL):
    port = port.numpy()
    ref = np.asarray(ref)
    if mask is not None:
        port, ref = port[mask], ref[mask]
    np.testing.assert_allclose(port, ref, rtol=0, atol=atol)


@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
def test_packed_partials_match_pallas_and_ref(dtype):
    q, k, v, seg, tables, valid, ks, vs = _packed_case(dtype)
    o, l, m = paged_flash_packed_chunk(*_torch(q, k, v, seg, tables, valid,
                                               ks, vs))
    jargs = _jax(q, k, v, seg, tables, valid, ks, vs)
    jo, jl, jm = jops.paged_flash_packed_chunk(*jargs, interpret=True)
    ro, rl, rm = jref.paged_packed_chunk_ref(*jargs)
    # tokens whose segment has a valid position: the Pallas partials
    live = valid.any(1)[seg]
    for port, pal in ((o, jo), (l, jl), (m, jm)):
        _close(port, pal, live)
    # every token, the empty segment's included: the guarded jnp oracle
    for port, ref in ((o, ro), (l, rl), (m, rm)):
        _close(port, ref)
    empty = seg == 1
    assert float(l.numpy()[empty].max()) == 0.0
    assert float(np.abs(o.numpy()[empty]).max()) == 0.0
    assert float(m.numpy()[empty].max()) == float(np.float32(-1e30))


def test_padding_tokens_get_the_last_segments_partials():
    """Padding tokens (ids of the last real segment, past its length)
    carry that segment's partials, computed from their own queries."""
    q, k, v, seg, tables, valid, ks, vs = _packed_case("f32", seed=3)
    q[12:] = q[9]                         # padding repeats a seg-3 query
    o, l, m = paged_flash_packed_chunk(*_torch(q, k, v, seg, tables, valid))
    for t in (o, l, m):
        np.testing.assert_array_equal(t[12:].numpy(),
                                      np.broadcast_to(t[9].numpy(),
                                                      t[12:].shape))


def test_zero_length_segment_changes_nothing():
    """A zero-length segment between two real ones contributes no token
    and leaves the other segments' partials as they were."""
    q, k, v, seg, tables, valid, ks, vs = _packed_case("f32", seed=4)
    o, l, m = paged_flash_packed_chunk(*_torch(q, k, v, seg, tables, valid))
    keep = [0, 1, 3]                      # drop the zero-length segment 2
    remap = np.array([0, 1, -1, 2], np.int32)[seg]
    o2, l2, m2 = paged_flash_packed_chunk(*_torch(
        q, k, v, remap, tables[keep], valid[keep]))
    for a, b in ((o, o2), (l, l2), (m, m2)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
def test_empty_segment_merges_like_pallas(dtype):
    """On a segment with no cache the Pallas kernel returns l = nb*bs and
    o = sum V where the port returns l = 0, o = 0; after the chunk's own
    keys are folded in (``_merge_packed_block``) both give the same
    output."""
    q, k, v, seg, tables, valid, ks, vs = _packed_case(dtype, seed=5)
    rng = np.random.default_rng(6)
    kn = rng.standard_normal((q.shape[0], KV, D)).astype(np.float32)
    vn = rng.standard_normal((q.shape[0], KV, D)).astype(np.float32)
    jargs = _jax(q, k, v, seg, tables, valid, ks, vs)
    jo, jl, jm = jops.paged_flash_packed_chunk(*jargs, interpret=True)
    o, l, m = paged_flash_packed_chunk(*_torch(q, k, v, seg, tables, valid,
                                               ks, vs))
    lengths = jnp.asarray([4, 5, 0, 3], jnp.int32)
    offsets = jnp.concatenate([jnp.zeros((1,), jnp.int32),
                               jnp.cumsum(lengths)[:-1]])
    sj = jnp.asarray(seg)
    off = jnp.arange(q.shape[0]) - offsets[sj]
    mask = jattn.packed_chunk_mask(sj, (off >= 0) & (off < lengths[sj]))
    qg = jnp.asarray(q).reshape(q.shape[0], KV, H // KV, D)
    outs = []
    for oo, ll, mm in ((jo, jl, jm), _jax(o.numpy(), l.numpy(), m.numpy())):
        o2, l2 = jattn._merge_packed_block(qg, oo, ll, mm, jnp.asarray(kn),
                                           jnp.asarray(vn), mask)
        outs.append(np.asarray(o2 / l2[..., None]))
    np.testing.assert_allclose(outs[0], outs[1], rtol=0, atol=ATOL)


@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
def test_prefill_chunk_partials_match_pallas_and_ref(dtype):
    """B3: B = 3 requests of C = 5 queries; request 2 has no cache."""
    rng = np.random.default_rng(7)
    B, C = 3, 5
    q = rng.standard_normal((B, C, H, D)).astype(np.float32)
    k, v, ks, vs = _pool(rng, dtype, B)
    tables = _tables(rng, B)
    starts = np.array([NB * BS, 11, 0], np.int32)
    valid = np.arange(NB * BS)[None, :] < starts[:, None]
    o, l, m = paged_flash_prefill_chunk(*_torch(q, k, v, tables, valid, ks,
                                                vs))
    assert tuple(o.shape) == (B, KV, H // KV, C, D)
    jargs = _jax(q, k, v, tables, valid, ks, vs)
    jo, jl, jm = jops.paged_flash_prefill_chunk(*jargs, interpret=True)
    ro, rl, rm = jref.paged_prefill_chunk_ref(*jargs)
    live = valid.any(1)
    for port, pal in ((o, jo), (l, jl), (m, jm)):
        _close(port, pal, live)
    for port, ref in ((o, ro), (l, rl), (m, rm)):
        _close(port, ref)


def test_prefill_chunk_of_one_token_is_the_decode_partials():
    """C = 1: the chunk kernel's partials are the decode kernel's."""
    rng = np.random.default_rng(8)
    B = 3
    q = rng.standard_normal((B, 1, H, D)).astype(np.float32)
    k, v, _, _ = _pool(rng, "f32", B)
    tables = _tables(rng, B)
    valid = np.arange(NB * BS)[None, :] < np.array([32, 9, 1])[:, None]
    o, l, m = paged_flash_prefill_chunk(*_torch(q, k, v, tables, valid))
    do, dl, dm = paged_flash_decode(*_torch(q[:, 0], k, v, tables, valid),
                                    return_partials=True)
    np.testing.assert_allclose(o[:, :, :, 0].numpy(), do.numpy(), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(l[..., 0].numpy(), dl.numpy(), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(m[..., 0].numpy(), dm.numpy(), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("fn", ["packed", "prefill"])
def test_non_cpu_tensor_never_takes_the_plain_version(fn):
    """Only CPU tensors take the plain versions: any other device reaches
    the kernel path or raises — here the meta device, which has none."""
    q, k, v, seg, tables, valid, _, _ = _packed_case("f32")
    if fn == "packed":
        args = [t.to("meta") for t in _torch(q, k, v, seg, tables, valid)]
        call = paged_flash_packed_chunk
    else:
        args = [t.to("meta") for t in _torch(q.reshape(4, 4, H, D), k, v,
                                             tables, valid)]
        call = paged_flash_prefill_chunk
    with pytest.raises(RuntimeError, match="no kernel for device"):
        call(*args)
