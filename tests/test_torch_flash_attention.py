"""K7's plain version (``flash_attention`` on CPU tensors) held to the JAX
package's Pallas ``flash_attention`` (B8) in interpret mode, to its oracle
``flash_attention_ref`` and to the einsum the JAX model's prefill serves
with, on the same numpy-made inputs: causal, sliding window, Sq != Sk, a
row with no visible key, G = 3, f32 and bf16."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import attention as jattn

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as T

# f32: sums in another order than XLA's, online (Pallas) vs one-shot softmax
ATOL = 1e-5
# bf16 inputs against the einsum: the same f32 arithmetic, then the bf16
# cast of the output, which may land one bf16 ulp (2^-7 relative) apart
BF16_RTOL = 2.0 ** -7
# bf16 inputs against the Pallas body, which also rounds p to bf16 before
# P.V (flash_attention.py:53): at most 2^-9 of max|v| more (d 64, so its
# bf16 q * 1/8 is exact)
BF16_PALLAS_P = 2.0 ** -9


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _inputs(seed, B, Sq, Sk, H=6, KV=2, d=64):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Sq, H, d)).astype(np.float32)
    k = rng.standard_normal((B, Sk, KV, d)).astype(np.float32)
    v = rng.standard_normal((B, Sk, KV, d)).astype(np.float32)
    return q, k, v


def _as(dtype, *arrays):
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    return ([torch.from_numpy(a).to(tdt) for a in arrays],
            [jnp.asarray(a).astype(jdt) for a in arrays])


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


# (Sq, Sk, window): causal; a sliding window; Sq < Sk (query i still sees
# keys <= i from key 0); Sq > Sk with a window, where rows 23 on see no key
CASES = [(64, 64, None), (64, 64, 24), (32, 64, None), (48, 16, 8)]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("sq,sk,window", CASES)
def test_matches_pallas_interpret_oracle_and_einsum(dtype, sq, sk, window):
    q, k, v = _inputs(0, 2, sq, sk)
    (tq, tk, tv), (jq, jk, jv) = _as(dtype, q, k, v)
    out = flash_attention(tq, tk, tv, causal=True, window=window)
    assert out.dtype == tq.dtype and out.shape == tq.shape
    out = _f32(out)
    pallas = _f32(jops.flash_attention(jq, jk, jv, causal=True,
                                       window=window, bq=16, bk=16,
                                       interpret=True))
    oracle = _f32(jref.flash_attention_ref(jq, jk, jv, causal=True,
                                           window=window))
    einsum = _f32(jattn.attn_prefill_einsum(jq, jk, jv, causal=True,
                                            window=window))
    np.testing.assert_array_equal(oracle, einsum)
    if dtype == "f32":
        np.testing.assert_allclose(out, pallas, rtol=0, atol=ATOL)
        np.testing.assert_allclose(out, einsum, rtol=0, atol=ATOL)
    else:
        vmax = float(np.abs(_f32(jv)).max())
        np.testing.assert_allclose(out, pallas, rtol=BF16_RTOL,
                                   atol=BF16_PALLAS_P * vmax)
        np.testing.assert_allclose(out, einsum, rtol=BF16_RTOL, atol=ATOL)
    if window and sq > sk + window - 1:
        # no visible key: the softmax of all-masked scores is uniform
        np.testing.assert_allclose(
            out[:, sk + window - 1:],
            np.broadcast_to(np.repeat(_f32(jv).mean(1), 3, axis=1)[:, None],
                            out[:, sk + window - 1:].shape),
            rtol=BF16_RTOL if dtype == "bf16" else 0, atol=ATOL)


@pytest.mark.parametrize("window", [None, 64])
def test_served_harvest_length_against_the_einsum(window):
    """160 positions (the chunked fleets' prompts), which no power-of-two
    Pallas block of 128 divides: the einsum only."""
    q, k, v = _inputs(1, 2, 160, 160)
    (tq, tk, tv), (jq, jk, jv) = _as("f32", q, k, v)
    out = flash_attention(tq, tk, tv, causal=True, window=window)
    ref = jattn.attn_prefill_einsum(jq, jk, jv, causal=True, window=window)
    np.testing.assert_allclose(_f32(out), _f32(ref), rtol=0, atol=ATOL)


def test_layer_prefill_runs_attn_prefill(monkeypatch):
    """The model's prefill layer takes its attention from ``attn_prefill``
    (K7 on the card), with the config's window."""
    calls = []
    served = tattn.attn_prefill

    def spy(q, k, v, causal=True, window=None):
        calls.append((tuple(q.shape), causal, window))
        return served(q, k, v, causal=causal, window=window)

    monkeypatch.setattr(tattn, "attn_prefill", spy)
    from repro_torch.configs import get_config
    from repro_torch.models import build
    cfg = get_config("smollm-360m").reduced()
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 5),
                           generator=torch.Generator().manual_seed(1),
                           dtype=torch.int32)
    T.prefill(cfg, params, {"tokens": tokens}, 8)
    assert calls == [((2, 5, cfg.n_heads, cfg.d_head), True,
                      cfg.sliding_window)] * cfg.n_layers
