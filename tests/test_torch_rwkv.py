"""The port's RWKV6 model (``models/rwkv6.py``) held to the JAX package's on
the reduced rwkv6-1.6b (2 layers, d_model 256, 8 WKV heads of 32), with
the weights carried across through ``from_jax_params``: prefill and decode
logits, hidden states and every state leaf, in f32 and in bf16; decode
after prefill against a one-shot prefill; the float32 leaves; the
registry's RWKV model."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import build as j_build

from repro_torch.configs import get_config
from repro_torch.models import build, rwkv6
from repro_torch.models.common import Param
from repro_torch.models.convert import from_jax_params

# f32: sums in other orders than XLA's through a random-weight stack whose
# residual stream reaches about 1e3 (the JAX init draws the stacked
# matrices with fan-in L); each leaf within this share of its largest
# |value|
F32_REL = 2e-4
# bf16: both packages round every op's result to bf16, XLA after fused
# chains of ops and PyTorch after each one, and the random stack amplifies
# the one-ulp flips: hidden states within 2^-4 of the largest |value|
# (16 bf16 ulps there) and, on average, within 2^-6 of the mean |value|
BF16_MAX_REL = 2.0 ** -4
BF16_MEAN_REL = 2.0 ** -6
# the leaves the JAX model reads through a float32 cast
F32_LEAVES = ("ln0.scale", "ln0.bias", "final_norm.scale", "final_norm.bias",
              "layers.ln1.scale", "layers.ln1.bias", "layers.ln2.scale",
              "layers.ln2.bias", "layers.tm.w0", "layers.tm.u",
              "layers.tm.gn_scale", "layers.tm.gn_bias")


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: tree}


def _pair(dtype="float32", seed=0):
    jcfg = dataclasses.replace(j_get_config("rwkv6_1b6").reduced(),
                               dtype=dtype)
    cfg = dataclasses.replace(get_config("rwkv6-1b6").reduced(), dtype=dtype)
    jmodel, model = j_build(jcfg), build(cfg)
    jparams = jmodel.init(jax.random.PRNGKey(seed))
    params = from_jax_params(jax.tree.map(np.asarray, jparams), model,
                             device="cpu")
    return jmodel, jparams, model, params


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _t(x):
    return x.float().numpy()


def _close_f32(a, b, name):
    np.testing.assert_allclose(_t(a), _np(b), rtol=0,
                               atol=F32_REL * np.abs(_np(b)).max(),
                               err_msg=name)


def _tokens(vocab, B, S, seed):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(
        np.int32)


@pytest.fixture(scope="module")
def f32_pair():
    return _pair()


def _both_prefill(pair, toks):
    jmodel, jparams, model, params = pair
    jst, jlast, jh = jmodel.prefill(jmodel.cfg, jparams,
                                    {"tokens": jnp.asarray(toks)}, 0)
    st, last, h = model.prefill(model.cfg, params,
                                {"tokens": torch.as_tensor(toks)}, 0)
    return (jst, jlast, jh), (st, last, h)


@pytest.mark.parametrize("B,S", [(1, 1), (2, 9), (3, 37)])
def test_prefill_matches_jax(f32_pair, B, S):
    (jst, jlast, jh), (st, last, h) = _both_prefill(
        f32_pair, _tokens(f32_pair[2].cfg.vocab_size, B, S, seed=S))
    assert set(st) == {"wkv", "tm_x", "cm_x"}
    assert h.shape == (B, S, 256)
    _close_f32(h, jh, "hidden")
    _close_f32(last, jlast, "last hidden")
    for key in st:
        assert tuple(st[key].shape) == tuple(jst[key].shape), key
        assert st[key].dtype == getattr(torch, str(jst[key].dtype)), key
        _close_f32(st[key], jst[key], key)


def test_decode_steps_match_jax(f32_pair):
    """Prefill 9 tokens, then 6 decode steps fed the same tokens in both
    packages: logits, hidden and every state leaf at every step; the port
    updates its state in place."""
    jmodel, jparams, model, params = f32_pair
    vocab = model.cfg.vocab_size
    (jst, _, _), (st, _, _) = _both_prefill(f32_pair,
                                            _tokens(vocab, 2, 9, seed=1))
    feed = _tokens(vocab, 6, 2, seed=2)
    wkv = st["wkv"]
    for t in range(feed.shape[0]):
        pos = 9 + t
        jl, jh, jst = jmodel.decode_step(jmodel.cfg, jparams,
                                         jnp.asarray(feed[t]), jst,
                                         jnp.full((2,), pos, jnp.int32))
        l, h, st_out = model.decode_step(
            model.cfg, params, torch.as_tensor(feed[t]), st,
            torch.full((2,), pos, dtype=torch.int32),
            write_mask=torch.tensor([True, False]))
        assert st_out is st and st["wkv"] is wkv
        _close_f32(l, jl, f"logits step {t}")
        _close_f32(h, jh, f"hidden step {t}")
        for key in st:
            _close_f32(st[key], jst[key], f"{key} step {t}")
    assert l.shape == (2, model.cfg.padded_vocab())


def test_prefill_then_decode_equals_one_shot_prefill(f32_pair):
    """The recurrence is the same function token by token: decoding the
    prompt's tail after prefilling its head gives the one-shot prefill's
    hidden states and final state (the JAX suite's
    ``test_model_consistency`` check)."""
    _, _, model, params = f32_pair
    toks = _tokens(model.cfg.vocab_size, 2, 12, seed=4)
    cut = 5
    st, _, _ = model.prefill(model.cfg, params,
                             {"tokens": torch.as_tensor(toks[:, :cut])}, 0)
    hs = []
    for t in range(cut, toks.shape[1]):
        logits, h, st = model.decode_step(
            model.cfg, params, torch.as_tensor(toks[:, t]), st,
            torch.full((2,), t, dtype=torch.int32))
        hs.append(h)
    one_st, _, one_h = model.prefill(model.cfg, params,
                                     {"tokens": torch.as_tensor(toks)}, 0)
    want = one_h[:, cut:].numpy()
    got = torch.stack(hs, dim=1).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=F32_REL * np.abs(want).max())
    want_logits = (one_h[:, -1] @ params["lm_head"]).numpy()
    np.testing.assert_allclose(logits.numpy(), want_logits, rtol=0,
                               atol=F32_REL * np.abs(want_logits).max())
    assert (logits.argmax(-1) == torch.as_tensor(want_logits).argmax(-1)
            ).all()
    for key in st:
        np.testing.assert_allclose(
            _t(st[key]), _t(one_st[key]), rtol=0,
            atol=F32_REL * np.abs(_t(one_st[key])).max(), err_msg=key)


@pytest.mark.parametrize("seed", [0, 1])
def test_bf16_keeps_the_f32_leaves_and_tracks_jax(seed):
    jmodel, jparams, model, params = _pair("bfloat16", seed)
    flat, jflat = _flat(params), _flat(jparams)
    assert set(flat) == set(jflat)
    for name, t in flat.items():
        ref = np.asarray(jflat[name])
        if name in F32_LEAVES:
            assert t.dtype == torch.float32, name
            np.testing.assert_array_equal(t.numpy(), ref, err_msg=name)
        else:
            assert t.dtype == torch.bfloat16, name
            np.testing.assert_array_equal(
                _t(t), _np(jnp.asarray(ref).astype(jnp.bfloat16)),
                err_msg=name)
    # Model.init keeps the same leaves float32
    init = _flat(model.init(torch.Generator().manual_seed(0), "cpu"))
    assert {n for n, t in init.items() if t.dtype == torch.float32} \
        == set(F32_LEAVES)
    toks = _tokens(model.cfg.vocab_size, 2, 9, seed=10 + seed)
    (jst, _, jh), (st, _, h) = _both_prefill(
        (jmodel, jparams, model, params), toks)
    assert h.dtype == torch.bfloat16 and st["wkv"].dtype == torch.float32
    feed = _tokens(model.cfg.vocab_size, 1, 2, seed=20 + seed)[0]
    jl, jh1, _ = jmodel.decode_step(jmodel.cfg, jparams, jnp.asarray(feed),
                                    jst, jnp.full((2,), 9, jnp.int32))
    _, h1, _ = model.decode_step(model.cfg, params, torch.as_tensor(feed),
                                 st, torch.full((2,), 9, dtype=torch.int32))
    for got, want, name in ((h, jh, "prefill hidden"),
                            (h1, jh1, "decode hidden")):
        a, b = _t(got), _np(want)
        err = np.abs(a - b)
        assert err.max() <= BF16_MAX_REL * np.abs(b).max(), \
            (name, err.max(), np.abs(b).max())
        assert err.mean() <= BF16_MEAN_REL * np.abs(b).mean(), \
            (name, err.mean(), np.abs(b).mean())


def test_registry_builds_rwkv_without_paged_chunked_or_spec():
    cfg = get_config("rwkv6-1.6b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.ssm.head_dim,
            cfg.d_ff, cfg.vocab_size) == (24, 2048, 32, 64, 7168, 65536)
    assert get_config("rwkv6_1b6") is cfg
    model = build(cfg.reduced())
    assert not (model.supports_paged or model.supports_chunked
                or model.supports_spec)
    st = model.init_decode_state(3, 1000, device="cpu")
    assert st["wkv"].shape == (2, 3, 8, 32, 32)
    assert st["tm_x"].shape == st["cm_x"].shape == (2, 3, 256)
    decl = rwkv6.layer_decls(cfg)["tm"]["u"]
    assert decl == Param((32, 64), ("heads", None), "small", dtype="float32")
    # hymba, the other recurrent family, is built the same way: a dense
    # state, no page layout, chunked prefill or speculative decode
    hybrid = build(get_config("hymba-1.5b").reduced())
    assert not (hybrid.supports_paged or hybrid.supports_chunked
                or hybrid.supports_spec)
