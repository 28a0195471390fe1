"""The port's chunked and packed prefill on the reduced smollm-360m (2
layers, f32) held to the JAX package on weights carried across:
``prefill_chunk`` and ``prefill_packed_chunk``, dense and paged (the JAX
paged path run through its Pallas kernels in interpret mode), the same
two paged on the reduced MoE configs granite-moe-1b and phi3.5-moe, chunked
against one-shot prefill, a packed two-request chunk against each
request's solo prefill, ``packed_chunk_mask`` against its oracle, and the
decode write mask."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.kernels import ref as jref
from repro.models import attention as jattn
from repro.models import build as j_build
from repro.models import transformer as jtf

from repro_torch.configs import get_config
from repro_torch.models import attention as tattn
from repro_torch.models import build
from repro_torch.models import transformer as ttf
from repro_torch.models.convert import from_jax_params

# K/V entries reach ~45 at this init: held to f32 rounding relative to the
# largest entry, as the model tests hold prefill and decode caches
RTOL_KV = 2e-5
BS, NB = 4, 6          # pages of 4 positions, 6 pages (24 positions) a row
CACHE = BS * NB


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _pair(arch):
    jcfg = j_get_config(arch).reduced()
    cfg = get_config(arch).reduced()
    jparams = j_build(jcfg).init(jax.random.PRNGKey(0))
    params = from_jax_params(jax.tree.map(np.asarray, jparams), build(cfg),
                             device="cpu")
    return jcfg, jparams, cfg, params


@pytest.fixture(scope="module")
def pair():
    return _pair("smollm-360m")


@pytest.fixture(scope="module", params=["granite-moe-1b-a400m",
                                        "phi3.5-moe-42b-a6.6b"])
def moe_pair(request):
    return _pair(request.param)


def _close_kv(port, ref, msg):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(
        port.float().numpy(), ref, rtol=0,
        atol=RTOL_KV * max(1.0, float(np.abs(ref).max())), err_msg=msg)


def _prompts(cfg, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
            for n in lens]


def _rows(n_rows, seed=1):
    """Each row's NB pages, shuffled over a pool of n_rows*NB + 1 (page 0
    the NULL page)."""
    perm = 1 + np.random.default_rng(seed).permutation(n_rows * NB)
    return perm.reshape(n_rows, NB).astype(np.int32)


def _states(jcfg, cfg, paged, n_rows):
    if paged:
        jst = j_build(jcfg).init_paged_state(n_rows, n_rows * NB + 1, BS, NB)
        st = build(cfg).init_paged_state(n_rows, n_rows * NB + 1, BS, NB,
                                         device="cpu")
    else:
        jst = j_build(jcfg).init_decode_state(n_rows, CACHE)
        st = build(cfg).init_decode_state(n_rows, CACHE, device="cpu")
    return jst, st


def _use_pallas(monkeypatch, paged):
    if paged:
        monkeypatch.setenv("REPRO_PAGED_ATTN", "pallas")


def _compare_states(st, jst):
    """Every cache leaf; paged pools without page 0, the NULL page, whose
    duplicate padding writes race by design."""
    paged = "block_tables" in st
    for key in st:
        if key != "block_tables":
            got, want = st[key], np.asarray(jst[key])
            if paged:
                got, want = got[:, 1:], want[:, 1:]
            _close_kv(got, want, key)


@pytest.mark.parametrize("paged", [False, True])
def test_prefill_chunk_matches_jax(monkeypatch, pair, paged):
    """Two requests, an 11-token prompt each, in chunks of 4: every chunk
    through both packages, the caches (or pages) compared at the end."""
    _use_pallas(monkeypatch, paged)
    jcfg, jparams, cfg, params = pair
    toks = np.stack(_prompts(cfg, [11, 11]))
    jst, st = _states(jcfg, cfg, paged, 2)
    rows = np.arange(2, dtype=np.int32)
    brows = _rows(2) if paged else None
    for start in range(0, 11, 4):
        n = min(4, 11 - start)
        buf = np.zeros((2, 4), np.int32)
        buf[:, :n] = toks[:, start:start + n]
        jst = jtf.prefill_chunk(
            jcfg, jparams, jnp.asarray(buf), jst, jnp.asarray(rows),
            jnp.asarray(start), jnp.asarray(n),
            block_rows=None if brows is None else jnp.asarray(brows))
        st = ttf.prefill_chunk(
            cfg, params, torch.from_numpy(buf), st, torch.from_numpy(rows),
            start, n,
            block_rows=None if brows is None else torch.from_numpy(brows))
    _compare_states(st, jst)


def test_moe_prefill_chunk_matches_jax(monkeypatch, moe_pair):
    """The paged chunked prefill above on the reduced MoE configs, every
    chunk token routed through the experts."""
    test_prefill_chunk_matches_jax(monkeypatch, moe_pair, True)


def _packed_args(paged):
    """Request A (slot 0) has 5 prompt positions written; the packed chunk
    carries A's next 4 tokens and B's (slot 1) first 3, then a zero-length
    segment, then 5 padding tokens: C = 12, R = 3."""
    seg = np.array([0] * 4 + [1] * 3 + [1] * 5, np.int32)
    slots = np.array([0, 1, 0], np.int32)
    starts = np.array([5, 0, 0], np.int32)
    lengths = np.array([4, 3, 0], np.int32)
    brows = None
    if paged:
        rows = _rows(2, seed=2)
        brows = np.concatenate([rows, np.zeros((1, NB), np.int32)])
    return seg, slots, starts, lengths, brows


@pytest.mark.parametrize("paged", [False, True])
def test_prefill_packed_chunk_matches_jax(monkeypatch, pair, paged):
    _use_pallas(monkeypatch, paged)
    jcfg, jparams, cfg, params = pair
    a, b = _prompts(cfg, [9, 3], seed=3)
    seg, slots, starts, lengths, brows = _packed_args(paged)
    jst, st = _states(jcfg, cfg, paged, 2)
    # first A's 5 prompt positions, one segment; then the packed chunk
    head = np.zeros((12,), np.int32)
    head[:5] = a[:5]
    chunk = np.zeros((12,), np.int32)
    chunk[:4] = a[5:9]
    chunk[4:7] = b
    calls = ((head, np.zeros((12,), np.int32),
              np.array([5, 0, 0], np.int32), np.zeros((3,), np.int32)),
             (chunk, seg, lengths, starts))
    for tokens, sg, ln, st_ in calls:
        jst = jtf.prefill_packed_chunk(
            jcfg, jparams, jnp.asarray(tokens), jst, jnp.asarray(sg),
            jnp.asarray(slots), jnp.asarray(st_), jnp.asarray(ln),
            block_rows=None if brows is None else jnp.asarray(brows))
        st = ttf.prefill_packed_chunk(
            cfg, params, torch.from_numpy(tokens), st, torch.from_numpy(sg),
            torch.from_numpy(slots), torch.from_numpy(st_),
            torch.from_numpy(ln),
            block_rows=None if brows is None else torch.from_numpy(brows))
    _compare_states(st, jst)


def test_moe_prefill_packed_chunk_matches_jax(monkeypatch, moe_pair):
    """The paged packed chunk above (two requests' tokens, a zero-length
    segment, padding) on the reduced MoE configs."""
    test_prefill_packed_chunk_matches_jax(monkeypatch, moe_pair, True)


def _virtual(state, paged, rows, slot, n):
    """The first n positions of one request's K/V: (L, KV, n, dh) each."""
    if not paged:
        return {k: state[k][:, slot, :, :n] for k in ("k", "v")}
    out = {}
    for k in ("k", "v"):
        pages = state[k][:, torch.from_numpy(rows[slot]).long()]
        L, nb, kv, bs, d = pages.shape
        out[k] = pages.permute(0, 2, 1, 3, 4).reshape(L, kv, nb * bs, d)[
            :, :, :n]
    return out


def _one_shot(cfg, params, prompt):
    cache, _, _ = ttf.prefill(cfg, params,
                              {"tokens": torch.from_numpy(prompt[None])},
                              len(prompt))
    return {k: cache[k][:, 0] for k in ("k", "v")}


@pytest.mark.parametrize("paged,chunk", [(False, 4), (False, 5),
                                         (False, 11), (False, 64),
                                         (True, 4), (True, 5)])
def test_chunked_prefill_equals_one_shot(pair, paged, chunk):
    """Chunked prefill writes the caches one-shot prefill writes, within
    f32 reordering, and leaves every position past the prompt untouched."""
    _, _, cfg, params = pair
    prompt = _prompts(cfg, [11], seed=4)[0]
    _, st = _states(j_get_config("smollm-360m").reduced(), cfg, paged, 1)
    rows = _rows(1, seed=5)
    for start in range(0, 11, chunk):
        n = min(chunk, 11 - start)
        buf = np.zeros((1, chunk), np.int32)
        buf[0, :n] = prompt[start:start + n]
        st = ttf.prefill_chunk(cfg, params, torch.from_numpy(buf), st,
                               torch.zeros(1, dtype=torch.long), start, n,
                               block_rows=(torch.from_numpy(rows) if paged
                                           else None))
    got = _virtual(st, paged, rows, 0, CACHE)
    want = _one_shot(cfg, params, prompt)
    for k in ("k", "v"):
        _close_kv(got[k][:, :, :11], want[k].numpy(), k)
        assert float(got[k][:, :, 11:].abs().max()) == 0.0


@pytest.mark.parametrize("paged", [False, True])
def test_packed_two_requests_equal_their_solo_prefills(pair, paged):
    """Two whole prompts packed into one chunk from an empty cache: each
    request's K/V equals its own one-shot prefill; the tokens of one
    request never see the other's."""
    _, _, cfg, params = pair
    a, b = _prompts(cfg, [6, 5], seed=6)
    _, st = _states(j_get_config("smollm-360m").reduced(), cfg, paged, 2)
    rows = _rows(2, seed=7)
    tokens = np.zeros((12,), np.int32)
    tokens[:6], tokens[6:11] = a, b
    seg = np.array([0] * 6 + [1] * 6, np.int32)
    ttf.prefill_packed_chunk(
        cfg, params, torch.from_numpy(tokens), st, torch.from_numpy(seg),
        torch.tensor([0, 1], dtype=torch.int32),
        torch.zeros(2, dtype=torch.int32),
        torch.tensor([6, 5], dtype=torch.int32),
        block_rows=torch.from_numpy(rows) if paged else None)
    for slot, prompt in ((0, a), (1, b)):
        got = _virtual(st, paged, rows, slot, CACHE)
        want = _one_shot(cfg, params, prompt)
        for k in ("k", "v"):
            _close_kv(got[k][:, :, :len(prompt)], want[k].numpy(), k)
            assert float(got[k][:, :, len(prompt):].abs().max()) == 0.0


@pytest.mark.parametrize("int8", [False, True])
def test_chunk_helpers_match_jax(int8):
    """Chunk write positions and the dense and paged gathers (int8 lanes
    and pages dequantised) against the JAX package's."""
    np.testing.assert_array_equal(
        tattn.chunk_write_positions(3, 2, 5, 10).numpy(),
        np.asarray(jattn.chunk_write_positions(jnp.asarray(3),
                                               jnp.asarray(2), 5, 10)))
    rng = np.random.default_rng(9)
    shape = (7, 2, 4, 8)                  # dense (B,KV,S,d) or pages
    if int8:
        leaves = {"k": rng.integers(-127, 128, shape).astype(np.int8),
                  "v": rng.integers(-127, 128, shape).astype(np.int8),
                  "k_scale": rng.uniform(.001, .02, shape[:3] + (1,)),
                  "v_scale": rng.uniform(.001, .02, shape[:3] + (1,))}
        leaves["k_scale"] = leaves["k_scale"].astype(np.float32)
        leaves["v_scale"] = leaves["v_scale"].astype(np.float32)
    else:
        leaves = {k: rng.standard_normal(shape).astype(np.float32)
                  for k in ("k", "v")}
    tl = {k: torch.from_numpy(v) for k, v in leaves.items()}
    jl = {k: jnp.asarray(v) for k, v in leaves.items()}
    rows = np.array([5, 0, 3], np.int32)
    tables = np.array([[1, 6, 0], [4, 2, 3]], np.int32)
    for got, want in (
            (tattn.gather_cache_rows(tl, torch.from_numpy(rows)),
             jattn.gather_cache_rows(jl, jnp.asarray(rows))),
            (tattn.gather_page_rows(tl, torch.from_numpy(tables)),
             jattn.gather_page_rows(jl, jnp.asarray(tables)))):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                       atol=1e-7)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_packed_chunk_mask_matches_oracle(seed):
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, 5, 4)
    c = int(lens.sum()) + 3
    seg = np.repeat(np.arange(4), lens).astype(np.int32)
    seg = np.concatenate([seg, np.full((3,), seg[-1] if seg.size else 0,
                                       np.int32)])
    valid_tok = np.arange(c) < lens.sum()
    got = tattn.packed_chunk_mask(torch.from_numpy(seg),
                                  torch.from_numpy(valid_tok))
    want = jref.packed_chunk_mask_ref(jnp.asarray(seg),
                                      jnp.asarray(valid_tok))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jattn.packed_chunk_mask(
            jnp.asarray(seg), jnp.asarray(valid_tok))))


def test_decode_write_mask_drops_masked_rows(pair):
    """A row with its write masked off keeps its dense lane as it was; the
    other row writes as the JAX decode step writes."""
    jcfg, jparams, cfg, params = pair
    prompt = np.stack(_prompts(cfg, [7, 7], seed=8))
    jcache, _, _ = jtf.prefill(jcfg, jparams, {"tokens": prompt}, 12)
    cache, _, _ = ttf.prefill(cfg, params,
                              {"tokens": torch.from_numpy(prompt)}, 12)
    before = cache["k"][:, 1].clone()
    token = np.array([3, 5], np.int32)
    pos = np.array([7, 7], np.int32)
    mask = np.array([True, False])
    _, _, jcache = jtf.decode_step(jcfg, jparams, jnp.asarray(token), jcache,
                                   jnp.asarray(pos),
                                   write_mask=jnp.asarray(mask))
    _, _, cache = ttf.decode_step(cfg, params, torch.from_numpy(token), cache,
                                  torch.from_numpy(pos),
                                  write_mask=torch.from_numpy(mask))
    assert torch.equal(cache["k"][:, 1], before)
    _compare_states(cache, jcache)


def test_chunked_prefill_helper_and_harvest(pair):
    """``chunked_prefill`` builds the cache one-shot prefill builds, and
    ``extract_trajectories`` harvests the same tokens and step embeddings
    through it."""
    from repro_torch.serving import chunked_prefill, extract_trajectories
    _, _, cfg, params = pair
    model = build(cfg)
    batch = {"tokens": torch.from_numpy(np.stack(_prompts(cfg, [9, 9],
                                                          seed=10)))}
    full, _, _ = model.prefill(cfg, params, batch, 16)
    state = chunked_prefill(model, params, batch, 16, chunk_tokens=4)
    for k in ("k", "v"):
        _close_kv(state[k][:, :, :, :9], full[k][:, :, :, :9].numpy(), k)
        assert float(state[k][:, :, :, 9:].abs().max()) == 0.0
    np_batch = {"tokens": batch["tokens"].numpy()}
    phis_a, toks_a = extract_trajectories(model, params, np_batch, 9, 6, 3)
    phis_b, toks_b = extract_trajectories(model, params, np_batch, 9, 6, 3,
                                          chunk_tokens=4)
    np.testing.assert_array_equal(toks_a, toks_b)
    np.testing.assert_allclose(phis_a, phis_b, rtol=0, atol=1e-4)
