"""The port's dense transformer on the reduced smollm-360m, llama3.2-3b,
qwen1.5-32b and stablelm-3b (2 layers, f32; qwen with QKV bias and MHA;
stablelm with LayerNorm, QKV bias and a quarter of each head rotary), and
the MoE family on the reduced granite-moe-1b and phi3.5-moe (4 experts,
top-2, every MLP routed per token; phi with LayerNorm), held
to the JAX package on weights carried across: prefill logits and caches,
teacher-forced dense and paged decode steps (logits, hidden states,
pages), against the JAX jnp paged path and its Pallas kernel, and on int8
pages (qwen's served KV dtype).  stablelm-3b once more at its served head
dim of 80 (d_rot 20), its biases and norm weights drawn at random."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import attention as jattn
from repro.models import build as j_build
from repro.models import transformer as jtf

from repro_torch.configs import get_config
from repro_torch.models import attention as tattn
from repro_torch.models import build
from repro_torch.models import transformer as ttf
from repro_torch.models.convert import from_jax_params

ATOL_LOGITS = 1e-4      # f32 matmuls and softmax in another order than XLA's
# K/V entries reach ~45 at this init (the fan-in of stacked leaves is L):
# held to f32 rounding relative to the largest entry.  The worst entry seen
# is 1.05e-5 of it (layer 1, the second decoded token, whose residual
# stream amplifies the two frameworks' different summation orders)
RTOL_KV = 2e-5
# final-norm hidden states (O(1)) carry the residual stream's f32 rounding
ATOL_HIDDEN = 1e-4
# the MoE configs' bounds are these times MOE_SLACK.  Their reduced stacks
# draw the experts at std 1/sqrt(L) (the fan-in rule reads the stacked
# layer axis) and sum k expert outputs a token, so the residual stream
# reaches about 1e3 before the final norm and carries more f32 rounding:
# the worst seen is phi3.5-moe's paged decode, logits 1.16e-4, hidden
# states 9.7e-5, K/V 1.4e-5 of the largest entry
MOE_SLACK = 2.5
B, S, BS, STEPS = 2, 11, 8, 8
# the ported dense and MoE configs, each at .reduced()
ARCHS = ("smollm-360m", "llama3.2-3b", "qwen1.5-32b", "stablelm-3b",
         "granite-moe-1b-a400m", "phi3.5-moe-42b-a6.6b")


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _pair(arch="smollm-360m", kv_cache_dtype=None, d_head=None):
    """Both packages' reduced ``arch`` on the same weights.  With
    ``d_head`` the heads take that width, and the norms and biases are
    drawn at random (``_random_norms_and_biases``)."""
    jcfg = j_get_config(arch).reduced()
    cfg = get_config(arch).reduced()
    if kv_cache_dtype:
        jcfg = dataclasses.replace(jcfg, kv_cache_dtype=kv_cache_dtype)
        cfg = dataclasses.replace(cfg, kv_cache_dtype=kv_cache_dtype)
    if d_head:
        jcfg = dataclasses.replace(jcfg, d_head=d_head)
        cfg = dataclasses.replace(cfg, d_head=d_head)
    jmodel = j_build(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    if d_head:
        jparams = _random_norms_and_biases(jparams)
    tree = jax.tree.map(np.asarray, jparams)
    return jcfg, jparams, cfg, from_jax_params(tree, build(cfg),
                                               device="cpu")


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    return _pair(request.param)


def _tokens(cfg, seed=0):
    rng = np.random.default_rng(seed)
    prompt = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    feed = rng.integers(0, cfg.vocab_size, (STEPS, B)).astype(np.int32)
    return prompt, feed


def _close(port, ref, atol, msg):
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(ref, np.float32), rtol=0,
                               atol=atol, err_msg=msg)


def _close_kv(port, ref, msg, slack=1.0):
    ref = np.asarray(ref, np.float32)
    _close(port, ref, slack * RTOL_KV * max(1.0, float(np.abs(ref).max())),
           msg)


def _slack(cfg):
    return MOE_SLACK if cfg.moe is not None else 1.0


def test_from_jax_params_round_trip(pair):
    jcfg, jparams, cfg, params = pair
    flat, _ = jax.tree_util.tree_flatten_with_path(jparams)
    assert len(flat) == len(jax.tree.leaves(jax.tree.map(
        lambda t: 0, params)))
    for path, leaf in flat:
        node = params
        for k in path:
            node = node[k.key]
        assert tuple(node.shape) == leaf.shape, path
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))
    # the same decls, shape for shape
    shapes = jax.tree.map(lambda t: tuple(t.shape), params)
    assert shapes == jax.tree.map(lambda a: tuple(a.shape), jparams)
    assert build(cfg).decls.keys() == jparams.keys()


def test_prefill_logits_and_cache_match_jax(pair):
    jcfg, jparams, cfg, params = pair
    prompt, _ = _tokens(cfg)
    jcache, jlast, jh = jtf.prefill(jcfg, jparams, {"tokens": prompt}, 24)
    cache, last, h = ttf.prefill(cfg, params,
                                 {"tokens": torch.from_numpy(prompt)}, 24)
    for key in ("k", "v"):
        _close_kv(cache[key], jcache[key], key, _slack(cfg))
    _close(h, jh, ATOL_HIDDEN * _slack(cfg), "hidden")
    _close(ttf.logits_from_hidden(cfg, params, h),
           jtf.logits_from_hidden(jcfg, jparams, jh),
           ATOL_LOGITS * _slack(cfg), "logits")


def _paged_pair(jcfg, jparams, cfg, params, prompt, nb):
    """Both packages' page pools with each row's prompt scattered into a
    shuffled set of pages (page 0 stays the NULL page)."""
    n_pages = B * nb + 1
    rows = (1 + np.random.default_rng(7).permutation(B * nb)).reshape(B, nb)
    rows = rows.astype(np.int32)
    n_pre = -(-S // BS)
    jmodel = j_build(jcfg)
    jstate = jmodel.init_paged_state(B, n_pages, BS, nb)
    jpages = {k: v for k, v in jstate.items() if k != "block_tables"}
    state = build(cfg).init_paged_state(B, n_pages, BS, nb, device="cpu")
    pages = {k: v for k, v in state.items() if k != "block_tables"}
    jpre, _, _ = jtf.prefill(jcfg, jparams, {"tokens": prompt}, n_pre * BS)
    pre, _, _ = ttf.prefill(cfg, params, {"tokens": torch.from_numpy(prompt)},
                            n_pre * BS)
    for i in range(B):
        jpages = jattn.prefill_to_pages(
            jpages, {k: v[:, i:i + 1] for k, v in jpre.items()},
            jnp.asarray(rows[i]), n_pre)
        tattn.prefill_to_pages(pages, {k: v[:, i:i + 1] for k, v in
                                       pre.items()},
                               torch.from_numpy(rows[i]), n_pre)
    jstate = dict(jpages, block_tables=jnp.asarray(rows))
    state["block_tables"].copy_(torch.from_numpy(rows))
    return jstate, state


def _decode_run(jcfg, jparams, cfg, params, jstate, state, feed):
    # one compiled JAX step for the run (the paged attention impl is read
    # from the environment when it traces, inside the test)
    jstep = jax.jit(functools.partial(jtf.decode_step, jcfg))
    pos0 = np.full((B,), S, np.int32)
    for t in range(STEPS):
        pos = pos0 + t
        jlog, jh, jstate = jstep(jparams, jnp.asarray(feed[t]), jstate,
                                 jnp.asarray(pos))
        log, h, state = ttf.decode_step(cfg, params,
                                        torch.from_numpy(feed[t]), state,
                                        torch.from_numpy(pos))
        _close(log, jlog, ATOL_LOGITS * _slack(cfg), f"logits @ step {t}")
        _close(h, jh, ATOL_HIDDEN * _slack(cfg), f"hidden @ step {t}")
    return jstate, state


def test_dense_decode_steps_match_jax(pair):
    jcfg, jparams, cfg, params = pair
    prompt, feed = _tokens(cfg, seed=1)
    jcache, _, _ = jtf.prefill(jcfg, jparams, {"tokens": prompt}, S + STEPS)
    cache, _, _ = ttf.prefill(cfg, params,
                              {"tokens": torch.from_numpy(prompt)}, S + STEPS)
    jcache, cache = _decode_run(jcfg, jparams, cfg, params, jcache, cache,
                                feed)
    for key in ("k", "v"):
        _close_kv(cache[key], jcache[key], key, _slack(cfg))


@pytest.mark.parametrize("impl,kv", [("jnp", None), ("pallas", None),
                                     ("pallas", "int8")])
def test_paged_decode_steps_match_jax(monkeypatch, pair, impl, kv):
    """The port's paged decode runs K2's plain version (f32 contract);
    the JAX package is run through its default jnp gather and through its
    Pallas kernel (interpret mode).  The int8 cache is held to the Pallas
    path only: the jnp path dequantises to bf16."""
    if impl == "pallas":
        monkeypatch.setenv("REPRO_PAGED_ATTN", "pallas")
    else:
        monkeypatch.delenv("REPRO_PAGED_ATTN", raising=False)
    _paged_decode_matches(pair if kv is None else _pair(pair[0].name, kv),
                          kv)


def _paged_decode_matches(quad, kv):
    """Both packages' pages filled from one prefill, then STEPS fed tokens
    decoded through each: logits, hidden states and pages held."""
    jcfg, jparams, cfg, params = quad
    prompt, feed = _tokens(cfg, seed=2)
    nb = -(-(S + STEPS) // BS)
    jstate, state = _paged_pair(jcfg, jparams, cfg, params, prompt, nb)
    jstate, state = _decode_run(jcfg, jparams, cfg, params, jstate, state,
                                feed)
    for key in state:
        if key == "block_tables":
            continue
        if key in ("k", "v") and kv == "int8":
            # an int8 code may round the other way on a tie: one step
            _close(state[key], jstate[key], 1, key)
        else:
            _close_kv(state[key], jstate[key], key, _slack(cfg))


# ---------------------------------------------------------------------------
# stablelm-3b at its served head dim, 80

def _random_norms_and_biases(jparams, seed=3):
    """The JAX init's LayerNorm scales (ones) and biases (zeros) replaced
    by random values, so that carrying them across and applying them is
    what the comparison sees."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = path[-1].key
        if name in ("bias", "bq", "bk", "bv"):
            return jnp.asarray(0.1 * rng.standard_normal(leaf.shape),
                               leaf.dtype)
        if name == "scale":
            return jnp.asarray(1 + 0.1 * rng.standard_normal(leaf.shape),
                               leaf.dtype)
        return leaf
    return jax.tree_util.tree_map_with_path(draw, jparams)


@pytest.fixture(scope="module")
def pair_d80():
    """The reduced stablelm-3b at d_head 80: 4 heads of 80 on d_model 256,
    d_rot 20."""
    return _pair("stablelm-3b", d_head=80)


def test_d80_round_trip_carries_norms_and_biases(pair_d80):
    jcfg, jparams, cfg, params = pair_d80
    assert (cfg.d_head, int(cfg.d_head * cfg.rotary_pct)) == (80, 20)
    layers = params["layers"]
    for leaf, want in ((params["final_norm"]["bias"],
                        jparams["final_norm"]["bias"]),
                       (layers["ln1"]["bias"], jparams["layers"]["ln1"]["bias"]),
                       (layers["ln2"]["scale"],
                        jparams["layers"]["ln2"]["scale"]),
                       (layers["attn"]["bq"], jparams["layers"]["attn"]["bq"]),
                       (layers["attn"]["bk"], jparams["layers"]["attn"]["bk"]),
                       (layers["attn"]["bv"], jparams["layers"]["attn"]["bv"])):
        assert float(np.abs(np.asarray(want)).max()) > 0
        np.testing.assert_array_equal(leaf.numpy(), np.asarray(want))
    assert tuple(layers["attn"]["bq"].shape) == (2, cfg.n_heads * 80)


def test_d80_prefill_logits_and_cache_match_jax(pair_d80):
    test_prefill_logits_and_cache_match_jax(pair_d80)


@pytest.mark.parametrize("kv", [None, "int8"])
def test_d80_paged_decode_steps_match_jax(monkeypatch, pair_d80, kv):
    """K2's plain version at d 80 against the JAX package's Pallas paged
    kernel (interpret mode), on f32 and on int8 pages."""
    monkeypatch.setenv("REPRO_PAGED_ATTN", "pallas")
    _paged_decode_matches(
        pair_d80 if kv is None else _pair("stablelm-3b", kv, d_head=80), kv)
