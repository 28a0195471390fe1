"""K2's plain version (``paged_flash_decode`` on CPU tensors) held to the
JAX package's Pallas kernel in interpret mode and to its jnp oracle, on
the same numpy-made pages, tables and masks."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import attention as jattn

from repro_torch.kernels.paged_decode import paged_flash_decode

# f32 sums in another order than XLA's (and online vs one-shot softmax)
ATOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _case(quantized, seed=0, B=4, H=6, KV=2, d=32, bs=8, nb=4):
    """Pages from a shuffled pool with NULL (page 0) table entries; rows:
    fully valid, partly valid (ragged tail), valid behind a NULL entry,
    and one row with no valid position at all."""
    rng = np.random.default_rng(seed)
    P = B * nb + 1
    q = rng.standard_normal((B, H, d)).astype(np.float32)
    if quantized:
        k = rng.integers(-127, 128, (P, KV, bs, d)).astype(np.int8)
        v = rng.integers(-127, 128, (P, KV, bs, d)).astype(np.int8)
        ks = rng.uniform(0.001, 0.02, (P, KV, bs, 1)).astype(np.float32)
        vs = rng.uniform(0.001, 0.02, (P, KV, bs, 1)).astype(np.float32)
    else:
        k = rng.standard_normal((P, KV, bs, d)).astype(np.float32)
        v = rng.standard_normal((P, KV, bs, d)).astype(np.float32)
        ks = vs = None
    tables = (1 + rng.permutation(B * nb)).reshape(B, nb).astype(np.int32)
    tables[1, 3] = 0                      # NULL entry past the valid prefix
    tables[2, 0] = 0                      # NULL entry masked off in front
    valid = np.ones((B, nb * bs), bool)
    valid[1, 2 * bs + 3:] = False         # ragged tail
    valid[2, :bs] = False
    valid[3, :] = False                   # no valid position
    return q, k, v, tables, valid, ks, vs


def _torch(*arrays):
    return [None if a is None else torch.from_numpy(np.array(a))
            for a in arrays]


@pytest.mark.parametrize("quantized", [False, True])
def test_partials_match_pallas_interpret_and_jnp_oracle(quantized):
    q, k, v, tables, valid, ks, vs = _case(quantized)
    o, l, m = paged_flash_decode(*_torch(q, k, v, tables, valid, ks, vs),
                                 return_partials=True)
    jargs = [None if a is None else jnp.asarray(a)
             for a in (q, k, v, tables, valid, ks, vs)]
    jo, jl, jm = jops.paged_flash_decode(*jargs, interpret=True,
                                         return_partials=True)
    live = valid.any(1)
    # rows with a valid position: the Pallas kernel's partials
    for port, ref in ((o, jo), (l, jl), (m, jm)):
        np.testing.assert_allclose(port.numpy()[live], np.asarray(ref)[live],
                                   rtol=0, atol=ATOL)
    # every row, the empty one included: the guarded jnp partials
    # (repro.models.attention._decode_partial over the gathered pages)
    n_kv = k.shape[1]
    kc, vc = jref._gather_virtual_cache(jargs[1], jargs[2], jargs[3],
                                        jargs[5], jargs[6])
    qg = jnp.asarray(q).reshape(q.shape[0], n_kv, -1, q.shape[-1])
    ro, rl, rm = jattn._decode_partial(qg, kc, vc, jargs[4])
    for port, ref in ((o, ro), (l, rl), (m, rm)):
        np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=0,
                                   atol=ATOL)
    assert float(l[3].abs().max()) == 0.0 and float(o[3].abs().max()) == 0.0
    assert float(m[3].max()) == float(np.float32(-1e30))


@pytest.mark.parametrize("quantized", [False, True])
def test_normalised_output_matches_pallas_and_ref(quantized):
    q, k, v, tables, valid, ks, vs = _case(quantized, seed=1)
    out = paged_flash_decode(*_torch(q, k, v, tables, valid, ks, vs))
    jargs = [None if a is None else jnp.asarray(a)
             for a in (q, k, v, tables, valid, ks, vs)]
    live = valid.any(1)
    jout = jops.paged_flash_decode(*jargs, interpret=True)
    ref = jref.paged_decode_ref(*jargs)
    np.testing.assert_allclose(out.numpy()[live], np.asarray(jout)[live],
                               rtol=0, atol=ATOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=ATOL)


def test_empty_row_merges_like_pallas_after_current_token():
    """The Pallas kernel leaves l = nb*bs (unguarded exp) on a row with no
    valid position where the port returns l = 0; folding in the current
    token weighs the cache at zero either way, so the attention output the
    model sees is the same."""
    q, k, v, tables, valid, ks, vs = _case(False, seed=2)
    rng = np.random.default_rng(5)
    kx = rng.standard_normal((q.shape[0], k.shape[1], q.shape[-1]))
    vx = rng.standard_normal((q.shape[0], k.shape[1], q.shape[-1]))
    kx, vx = kx.astype(np.float32), vx.astype(np.float32)
    jo, jl, jm = jops.paged_flash_decode(
        *[jnp.asarray(a) for a in (q, k, v, tables, valid)], interpret=True,
        return_partials=True)
    o, l, m = paged_flash_decode(*_torch(q, k, v, tables, valid),
                                 return_partials=True)
    n_kv, d = k.shape[1], q.shape[-1]
    qg = jnp.asarray(q).reshape(q.shape[0], n_kv, -1, d)
    jo2, jl2 = jattn._merge_extra_kv(qg, jo, jl, jm, (jnp.asarray(kx),
                                                      jnp.asarray(vx)), d)
    o2, l2 = jattn._merge_extra_kv(qg, jnp.asarray(o.numpy()),
                                   jnp.asarray(l.numpy()),
                                   jnp.asarray(m.numpy()),
                                   (jnp.asarray(kx), jnp.asarray(vx)), d)
    np.testing.assert_allclose(np.asarray(o2 / l2[..., None]),
                               np.asarray(jo2 / jl2[..., None]), rtol=0,
                               atol=ATOL)


def test_non_cpu_tensor_never_takes_the_plain_version():
    """Only CPU tensors take the plain version: any other device reaches
    the kernel path or raises — here the meta device, which has none."""
    q, k, v, tables, valid, _, _ = _case(False)
    args = [t.to("meta") for t in _torch(q, k, v, tables, valid)]
    with pytest.raises(RuntimeError, match="no kernel for device"):
        paged_flash_decode(*args)
