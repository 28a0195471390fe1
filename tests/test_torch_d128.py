"""The head dims and groups past smollm-360m's (64, 3): llama3.2-3b (d 128,
24 heads on 8 KV heads, G 3), qwen1.5-32b (d 128, MHA, G 1, int8 KV),
stablelm-3b (d 80, MHA, G 1: the first head dim that is not a power of
two), the MoE configs granite-moe-1b (d 64, G 2) and phi3.5-moe
(d 128, G 4), and the VLM llava-next-34b (d 128, 56 heads on 8: G 7).

* the eight configs equal the JAX package's field by field; hymba-1.5b
  and whisper-tiny, refused until ROADMAP A7.3, resolve;
* every ported config with attention has its (d_head, heads per KV head)
  in the instance set of each attention kernel its family runs (K2, K3,
  K6 and K7 by d for the dense, MoE and VLM families; K6 and K7 for
  hymba's hybrid layers and whisper's encoder-decoder), and each
  kernel module's ``INSTANCES`` names exactly the instances its CUDA source
  builds; a pair outside the set is refused;
* the plain versions of K2, K3 (prefill and packed chunks), K6 and K7 at
  d 128, G 3, G 1, G 4 and G 7, at d 80, G 1, and at d 64, G 2, on
  bf16-valued f32 inputs and on
  int8 pages with their scales, match the JAX package's Pallas kernels in
  interpret mode (each test is named for d 128, its first head dim).
"""
import dataclasses
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.kernels import ops as jops

from repro_torch.configs import base as cfg_base
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as K7
from repro_torch.kernels import flash_decode as K6
from repro_torch.kernels import paged_chunk as K3
from repro_torch.kernels import paged_decode as K2
from repro_torch.models import build

# f32 sums in another order than XLA's (and online vs one-shot softmax);
# d 128 sums twice the terms of the d-64 tests, so twice their 1e-5 (d 80
# sums fewer)
ATOL = 2e-5
# (head dim, query heads, KV heads): llama's G 3, qwen's G 1,
# phi3.5-moe's G 4 and llava-next-34b's G 7 at d 128, stablelm's G 1 at
# d 80 and granite-moe-1b's G 2 at d 64, at reduced head counts
SHAPES = [pytest.param(128, 6, 2, id="6-2"), pytest.param(128, 2, 2, id="2-2"),
          pytest.param(128, 8, 2, id="8-2"),
          pytest.param(128, 14, 2, id="14-2"),
          pytest.param(80, 2, 2, id="d80-2-2"),
          pytest.param(64, 4, 2, id="d64-4-2")]
# each ported config's head dim past smollm-360m's: the dense ones, the
# MoE ones (granite-moe-1b at d 64, G 2; phi3.5-moe at d 128, G 4) and the
# VLM (llava-next-34b at d 128, G 7)
D_HEAD = {"llama3.2-3b": 128, "qwen1.5-32b": 128, "stablelm-3b": 80,
          "granite-moe-1b-a400m": 64, "phi3.5-moe-42b-a6.6b": 128,
          "llava-next-34b": 128, "hymba-1.5b": 64, "whisper-tiny": 64}
# K6 and K7 alone also at hymba-1.5b's G 5 and whisper-tiny's G 1 at d 64
# (neither family has a page layout: K2 and K3 never run for them)
DENSE_SHAPES = SHAPES + [pytest.param(64, 10, 2, id="d64-10-2"),
                         pytest.param(64, 2, 2, id="d64-2-2")]
BS, NB = 8, 4
CSRC = Path(K2.__file__).resolve().parent.parent / "csrc"


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


# ---------------------------------------------------------------------------
# configs

@pytest.mark.parametrize("name", list(D_HEAD))
def test_config_equals_jax_field_by_field(name):
    cfg, jcfg = get_config(name), j_get_config(name)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert type(cfg).__module__.startswith("repro_torch.")
    assert cfg.d_head == D_HEAD[name]
    assert (cfg.param_count(), cfg.reduced().n_layers) == \
        (jcfg.param_count(), jcfg.reduced().n_layers)


@pytest.mark.parametrize("name", ["hymba-1.5b", "whisper-tiny"])
def test_unported_family_raises_naming_a7(name):
    """The two families refused until ROADMAP A7.3 resolve now, and every
    config the JAX package names is ported."""
    cfg = get_config(name)
    assert cfg is get_config(cfg_base.ALIASES[name])
    assert set(cfg_base.PORTED) == set(cfg_base.ARCH_IDS)
    assert build(cfg.reduced()).cfg.arch_type in ("hybrid", "audio")


def test_widths_of_the_new_fleets():
    llama, qwen = get_config("llama3.2-3b"), get_config("qwen1.5-32b")
    assert (llama.n_layers, llama.d_model, llama.n_heads, llama.n_kv_heads,
            llama.d_ff, llama.vocab_size, llama.tie_embeddings,
            llama.rope_theta) == (28, 3072, 24, 8, 8192, 128256, True,
                                  500_000.0)
    assert (qwen.n_layers, qwen.d_model, qwen.n_heads, qwen.n_kv_heads,
            qwen.d_ff, qwen.vocab_size, qwen.qkv_bias, qwen.tie_embeddings,
            qwen.kv_cache_dtype) == (64, 5120, 40, 40, 27392, 152064, True,
                                     False, "int8")
    # the reduced variants keep the group character: GQA and MHA
    assert llama.reduced().n_heads // llama.reduced().n_kv_heads > 1
    assert qwen.reduced().n_heads == qwen.reduced().n_kv_heads
    assert build(qwen.reduced()).decls["layers"]["attn"]["bq"].shape == \
        (2, qwen.reduced().n_heads * qwen.reduced().d_head)


def test_stablelm_widths():
    """stablelm-3b as served: MHA at d 80, LayerNorm, QKV bias and rotary
    on a quarter of each head (d_rot 20), untied embeddings."""
    cfg = get_config("stablelm-3b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.d_head, cfg.d_ff, cfg.vocab_size, cfg.norm, cfg.mlp,
            cfg.qkv_bias, cfg.rotary_pct, cfg.tie_embeddings, cfg.dtype) == \
        (32, 2560, 32, 32, 80, 6912, 50304, "layernorm", "swiglu", True,
         0.25, False, "bfloat16")
    assert cfg.param_count() == 2_795_765_760
    assert int(cfg.d_head * cfg.rotary_pct) == 20
    decls = build(cfg.reduced()).decls
    assert set(decls["final_norm"]) == {"scale", "bias"}
    assert {"bq", "bk", "bv"} <= set(decls["layers"]["attn"])


# ---------------------------------------------------------------------------
# the instance sets

def _source_instances(name, macro):
    src = (CSRC / name).read_text()
    return {tuple(int(x) for x in m.group(1).split(","))
            for m in re.finditer(rf"^\s*{macro}\(([\d,\s]+)\)\s*$", src,
                                 re.M)}


def test_instance_sets_equal_the_cuda_sources():
    # llava-next-34b's (128, 7), the first odd group above 3, among them
    for mod in (K2, K3, K6):
        assert (128, 7) in mod.INSTANCES
    assert _source_instances("paged_decode.cu", "DECODE_INSTANCE") == \
        set(K2.INSTANCES)
    assert _source_instances("flash_decode.cu", "DECODE_INSTANCE") == \
        set(K6.INSTANCES)
    assert _source_instances("paged_chunk.cu", "CHUNK_INSTANCE") == \
        set(K3.INSTANCES)
    assert _source_instances("flash_attention.cu", "FLASH_INSTANCE") == \
        {(d,) for d in K7.INSTANCES}


@pytest.mark.parametrize("mod", cfg_base.PORTED)
def test_every_ported_config_has_its_kernel_instances(mod):
    """Every ported config with attention, dense, MoE, VLM, hybrid and
    audio alike; RWKV6 has none (K8 is built per head size,
    tests/test_torch_rwkv_scan.py)."""
    cfg = get_config(mod)
    if cfg.arch_type == "ssm":
        return
    pair = (cfg.d_head, cfg.n_heads // cfg.n_kv_heads)
    assert pair in K6.INSTANCES
    assert cfg.d_head in K7.INSTANCES
    if cfg.arch_type in ("hybrid", "audio"):
        # no page layout, chunk or verify path in the JAX registry: K2 and
        # K3 never run for them
        assert not build(cfg.reduced()).supports_paged
        return
    assert cfg.arch_type in ("dense", "moe", "vlm"), cfg.arch_type
    assert pair in K2.INSTANCES
    assert pair in K3.INSTANCES


def test_a_pair_outside_the_instance_set_is_refused():
    """d 64 at G 5 (10 heads on 2), a d-128 group of 2 and a head dim of
    96: every wrapper's check refuses them, naming A7, before any
    launch."""
    q = torch.zeros(1, 10, 64)
    pages = torch.zeros(3, 2, BS, 64)
    tables = torch.zeros(1, 2, dtype=torch.int32)
    valid = torch.zeros(1, 2 * BS, dtype=torch.bool)
    with pytest.raises(ValueError, match="A7"):
        K2._check(q.reshape(1, 2, 5, 64), pages, pages, tables, valid,
                  None, None)
    with pytest.raises(ValueError, match="A7"):
        K3._check("paged_flash_packed_chunk", q, pages, pages, None, tables,
                  valid, None, None)
    k = torch.zeros(1, 2, 16, 128)
    with pytest.raises(ValueError, match="A7"):
        K6._check(torch.zeros(1, 2, 2, 128), k, k, torch.zeros(
            1, 16, dtype=torch.bool))
    with pytest.raises(ValueError, match="A7"):
        K7._check(torch.zeros(1, 4, 2, 96), torch.zeros(1, 4, 2, 96),
                  torch.zeros(1, 4, 2, 96), None)


# ---------------------------------------------------------------------------
# the plain versions at d 128 and d 80 against the Pallas kernels

def _bf16_valued(x):
    """f32 values that bf16 holds exactly (what the served model hands the
    kernels: bf16 activations and pages upcast)."""
    return np.asarray(jnp.asarray(x).astype(jnp.bfloat16)
                      .astype(jnp.float32))


def _pool(rng, dtype, n_rows, kv, d):
    P = n_rows * NB + 1
    if dtype == "int8":
        k = rng.integers(-127, 128, (P, kv, BS, d)).astype(np.int8)
        v = rng.integers(-127, 128, (P, kv, BS, d)).astype(np.int8)
        ks = rng.uniform(0.001, 0.02, (P, kv, BS, 1)).astype(np.float32)
        vs = rng.uniform(0.001, 0.02, (P, kv, BS, 1)).astype(np.float32)
        return k, v, ks, vs
    k = _bf16_valued(rng.standard_normal((P, kv, BS, d)))
    v = _bf16_valued(rng.standard_normal((P, kv, BS, d)))
    return k, v, None, None


def _t(*arrays):
    return [None if a is None else torch.from_numpy(np.array(a))
            for a in arrays]


def _j(*arrays):
    return [None if a is None else jnp.asarray(a) for a in arrays]


def _close(port, ref, rows=None):
    port, ref = port.numpy(), np.asarray(ref)
    if rows is not None:
        port, ref = port[rows], ref[rows]
    np.testing.assert_allclose(port, ref, rtol=0, atol=ATOL)


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
@pytest.mark.parametrize("d,h,kv", SHAPES)
def test_k2_plain_matches_pallas_at_d128(dtype, d, h, kv):
    """Rows: fully valid, a ragged tail, valid behind a NULL table entry."""
    rng = np.random.default_rng(0)
    B = 3
    q = _bf16_valued(rng.standard_normal((B, h, d)))
    k, v, ks, vs = _pool(rng, dtype, B, kv, d)
    tables = (1 + rng.permutation(B * NB)).reshape(B, NB).astype(np.int32)
    tables[2, 0] = 0
    valid = np.ones((B, NB * BS), bool)
    valid[1, 2 * BS + 3:] = False
    valid[2, :BS] = False
    args = (q, k, v, tables, valid, ks, vs)
    o, l, m = K2.paged_flash_decode(*_t(*args), return_partials=True)
    jo, jl, jm = jops.paged_flash_decode(*_j(*args), interpret=True,
                                         return_partials=True)
    for port, ref in ((o, jo), (l, jl), (m, jm)):
        _close(port, ref)
    _close(K2.paged_flash_decode(*_t(*args)),
           jops.paged_flash_decode(*_j(*args), interpret=True))


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
@pytest.mark.parametrize("d,h,kv", SHAPES)
def test_k3_prefill_chunk_plain_matches_pallas_at_d128(dtype, d, h, kv):
    """B3: two requests of 8 chunk tokens, 13 and 32 cached positions."""
    rng = np.random.default_rng(1)
    B, C = 2, 8
    q = _bf16_valued(rng.standard_normal((B, C, h, d)))
    k, v, ks, vs = _pool(rng, dtype, B, kv, d)
    tables = (1 + rng.permutation(B * NB)).reshape(B, NB).astype(np.int32)
    valid = np.arange(NB * BS)[None, :] < np.array([13, NB * BS])[:, None]
    args = (q, k, v, tables, valid, ks, vs)
    got = K3.paged_flash_prefill_chunk(*_t(*args))
    want = jops.paged_flash_prefill_chunk(*_j(*args), interpret=True)
    for port, ref in zip(got, want):
        _close(port, ref)


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
@pytest.mark.parametrize("d,h,kv", SHAPES)
def test_k3_packed_chunk_plain_matches_pallas_at_d128(dtype, d, h, kv):
    """B4: 12 tokens of three segments (13 cached positions, a full cache,
    and a prompt head with none) and two padding tokens; the Pallas kernel
    is held on the tokens whose segment has a valid position (the empty
    segment's partials differ by contract, ROADMAP C)."""
    rng = np.random.default_rng(2)
    C, R = 12, 3
    q = _bf16_valued(rng.standard_normal((C, h, d)))
    k, v, ks, vs = _pool(rng, dtype, R, kv, d)
    tables = (1 + rng.permutation(R * NB)).reshape(R, NB).astype(np.int32)
    tables[2, :] = 0
    starts = np.array([13, NB * BS, 0])
    valid = np.arange(NB * BS)[None, :] < starts[:, None]
    seg = np.array([0] * 4 + [1] * 3 + [2] * 3 + [2] * 2, np.int32)
    args = (q, k, v, seg, tables, valid, ks, vs)
    got = K3.paged_flash_packed_chunk(*_t(*args))
    want = jops.paged_flash_packed_chunk(*_j(*args), interpret=True)
    live = starts[seg] > 0
    for port, ref in zip(got, want):
        _close(port, ref, live)
    assert float(got[1][~live].abs().max()) == 0.0


@pytest.mark.parametrize("d,h,kv", DENSE_SHAPES)
def test_k6_plain_matches_pallas_at_d128(d, h, kv):
    """bf16-valued f32 caches (qwen's int8 cache reaches K6 dequantised
    to bf16); rows fully valid, ragged, and a window band."""
    rng = np.random.default_rng(3)
    B, S = 3, 48
    q = _bf16_valued(rng.standard_normal((B, h, d)))
    k = _bf16_valued(rng.standard_normal((B, kv, S, d)))
    v = _bf16_valued(rng.standard_normal((B, kv, S, d)))
    valid = np.ones((B, S), bool)
    valid[1, S // 2 + 3:] = False
    valid[2, :7] = False
    valid[2, S - 5:] = False
    out = K6.flash_decode(*_t(q, k, v, valid))
    pallas = jops.flash_decode(*_j(q, k, v, valid), bs=512, interpret=True)
    _close(out, pallas)


@pytest.mark.parametrize("window", [None, 24, "bidirectional"])
@pytest.mark.parametrize("d,h,kv", DENSE_SHAPES)
def test_k7_plain_matches_pallas_at_d128(d, h, kv, window):
    """Causal, windowed (hymba's prefill) and bidirectional (whisper's
    encoder, ``causal=False``)."""
    rng = np.random.default_rng(4)
    B, S = 2, 64
    q = _bf16_valued(rng.standard_normal((B, S, h, d)))
    k = _bf16_valued(rng.standard_normal((B, S, kv, d)))
    v = _bf16_valued(rng.standard_normal((B, S, kv, d)))
    causal = window != "bidirectional"
    window = window if causal else None
    out = K7.flash_attention(*_t(q, k, v), causal=causal, window=window)
    pallas = jops.flash_attention(*_j(q, k, v), causal=causal, window=window,
                                  bq=16, bk=16, interpret=True)
    _close(out, pallas)
