"""K6's plain version (``flash_decode`` on CPU tensors) held to the JAX
package's Pallas ``flash_decode`` (B7) in interpret mode, to its oracle
``flash_decode_ref`` and to the jnp ``_decode_partial`` the JAX model
serves with, on the same numpy-made caches and masks, f32 and bf16, G = 3."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import attention as jattn

from repro_torch.kernels.flash_decode import flash_decode
from repro_torch.models import attention as tattn

# f32: sums in another order than XLA's
ATOL = 1e-5
# bf16 caches: the f32 results above, then the bf16 cast of the normalised
# output, which may land one bf16 ulp (2^-7 relative) apart
BF16_RTOL = 2.0 ** -7


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _case(seed=0, B=5, H=6, KV=2, d=64, S=48):
    """Rows: fully valid, a ragged tail, a sliding-window band (a ring's
    live span), one position only, and no valid position at all."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, d)).astype(np.float32)
    k = rng.standard_normal((B, KV, S, d)).astype(np.float32)
    v = rng.standard_normal((B, KV, S, d)).astype(np.float32)
    valid = np.ones((B, S), bool)
    valid[1, S // 2 + 3:] = False
    valid[2, :7] = False
    valid[2, S - 5:] = False
    valid[3, :] = False
    valid[3, 11] = True
    valid[4, :] = False
    return q, k, v, valid


def _as(dtype, *arrays):
    """The same numpy values as torch tensors and as jnp arrays of one
    dtype (both round f32 to bf16 to nearest even)."""
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    tt = [torch.from_numpy(a).to(tdt) if a.dtype != bool
          else torch.from_numpy(a) for a in arrays]
    jj = [jnp.asarray(a).astype(jdt) if a.dtype != bool else jnp.asarray(a)
          for a in arrays]
    return tt, jj


def _f32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32)) \
        if not isinstance(x, torch.Tensor) else x.float().numpy()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("S", [48, 37])
def test_partials_match_the_jnp_decode_partial(dtype, S):
    """Every row, the empty one included, and S that no Pallas block
    divides (37): the jnp path's partials."""
    q, k, v, valid = _case(S=S)
    (tq, tk, tv, tval), (jq, jk, jv, jval) = _as(dtype, q, k, v, valid)
    o, l, m = flash_decode(tq, tk, tv, tval, return_partials=True)
    n_kv = k.shape[1]
    qg = jq.astype(jnp.float32).reshape(q.shape[0], n_kv, -1, q.shape[-1])
    ro, rl, rm = jattn._decode_partial(qg, jk, jv, jval)
    for port, ref in ((o, ro), (l, rl), (m, rm)):
        np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=0,
                                   atol=ATOL)
    assert float(l[4].abs().max()) == 0.0 and float(o[4].abs().max()) == 0.0
    assert float(m[4].max()) == float(np.float32(-1e30))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_output_matches_pallas_interpret_and_the_oracle(dtype):
    """Rows with a valid position: B7 in interpret mode (one 48-position
    block, so its block max is the row max and it rounds p as the jnp path
    does; d 64, so its bf16 q * 1/8 is exact) and ``flash_decode_ref``,
    which keeps p in f32: on bf16 caches the port's p rounding moves the
    output by at most 2^-9 of max|v|."""
    q, k, v, valid = _case(seed=1)
    (tq, tk, tv, tval), (jq, jk, jv, jval) = _as(dtype, q, k, v, valid)
    out = _f32(flash_decode(tq, tk, tv, tval))
    live = valid.any(1)
    pallas = _f32(jops.flash_decode(jq, jk, jv, jval, bs=512,
                                    interpret=True))
    oracle = _f32(jref.flash_decode_ref(jq, jk, jv, jval))
    if dtype == "f32":
        np.testing.assert_allclose(out[live], pallas[live], rtol=0,
                                   atol=ATOL)
        np.testing.assert_allclose(out, oracle, rtol=0, atol=ATOL)
    else:
        np.testing.assert_allclose(out[live], pallas[live], rtol=BF16_RTOL,
                                   atol=ATOL)
        vmax = float(np.abs(_f32(jv)).max())
        np.testing.assert_allclose(out, oracle, rtol=BF16_RTOL,
                                   atol=2.0 ** -9 * vmax)


def test_empty_row_merges_like_pallas_after_current_token():
    """B7's body leaves l = S and o = sum V on a row with no valid position
    (its output there is the mean of V) where the port returns l = 0, o = 0
    and m = -1e30; folding in the current token weighs the cache at zero
    either way, so the attention output the model sees is the same."""
    q, k, v, valid = _case(seed=2)
    rng = np.random.default_rng(5)
    kx = rng.standard_normal((q.shape[0], k.shape[1], q.shape[-1]))
    vx = rng.standard_normal((q.shape[0], k.shape[1], q.shape[-1]))
    kx, vx = kx.astype(np.float32), vx.astype(np.float32)
    (tq, tk, tv, tval), (jq, jk, jv, jval) = _as("f32", q, k, v, valid)
    S = k.shape[2]
    b, h, d = q.shape
    n_kv = k.shape[1]
    pallas = np.asarray(jops.flash_decode(jq, jk, jv, jval, interpret=True))
    np.testing.assert_allclose(
        pallas[4], np.repeat(v[4].mean(1), h // n_kv, axis=0), rtol=0,
        atol=ATOL)
    # the Pallas partials of the empty row, from its output
    jo = (pallas * S).reshape(b, n_kv, h // n_kv, d)
    jl = np.full((b, n_kv, h // n_kv), float(S), np.float32)
    jm = np.full((b, n_kv, h // n_kv), -1e30, np.float32)
    o, l, m = flash_decode(tq, tk, tv, tval, return_partials=True)
    qg = jnp.asarray(q).reshape(b, n_kv, -1, d)
    extra = (jnp.asarray(kx), jnp.asarray(vx))
    jo2, jl2 = jattn._merge_extra_kv(qg[4:], jnp.asarray(jo[4:]),
                                     jnp.asarray(jl[4:]),
                                     jnp.asarray(jm[4:]),
                                     tuple(e[4:] for e in extra), d)
    o2, l2 = tattn._merge_extra_kv(torch.from_numpy(q).reshape(b, n_kv, -1,
                                                               d)[4:],
                                   o[4:], l[4:], m[4:],
                                   (torch.from_numpy(kx[4:]),
                                    torch.from_numpy(vx[4:])), d)
    np.testing.assert_allclose((o2 / l2[..., None]).numpy(),
                               np.asarray(jo2 / jl2[..., None]), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_attn_decode_matches_jax_with_the_current_token(dtype):
    """The model's dense decode attention end to end (K6's partials, then
    the current token's column): the JAX ``attn_decode``."""
    q, k, v, valid = _case(seed=3)
    rng = np.random.default_rng(6)
    kx = rng.standard_normal((q.shape[0], k.shape[1], q.shape[-1]))
    vx = rng.standard_normal((q.shape[0], k.shape[1], q.shape[-1]))
    (tq, tk, tv, tval, tkx, tvx), (jq, jk, jv, jval, jkx, jvx) = _as(
        dtype, q, k, v, valid, kx.astype(np.float32), vx.astype(np.float32))
    tdt = tq.dtype
    jdt = jq.dtype
    out = tattn.attn_decode(tq, {"k": tk, "v": tv}, tval, tdt,
                            extra_kv=(tkx, tvx))
    ref = jattn.attn_decode(jq, {"k": jk, "v": jv}, jval, jdt,
                            extra_kv=(jkx, jvx))
    rtol = 0 if dtype == "f32" else BF16_RTOL
    np.testing.assert_allclose(_f32(out), _f32(ref), rtol=rtol, atol=ATOL)
