"""The trainer's substrates held to the JAX package on the CPU, and the
kernels' grad guard:

* ``data.TokenPipeline``'s batches bitwise JAX's at three indices;
* checkpoints: one saved by JAX restores in the port exactly, bf16 leaf
  included, and one saved by the port restores in JAX exactly; a shape
  mismatch and a missing key raise; ``latest_step``;
* ``optim.cosine_schedule`` against JAX's over steps 0 to total + 5;
* ``roofline.analytic.estimate`` equal to JAX's for every config and
  input shape;
* ``Model.abstract_params`` and ``make_batch`` shaped as JAX's;
* the training CLI on the CPU (``--reduced --device cpu --ckpt-dir``)
  exits 0, saves, and resumes bitwise from its checkpoint;
* every kernel entry refuses an input that requires grad while grad mode
  is on (on the CPU too, where its plain version would have run), and
  takes the same input under ``torch.no_grad()``."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import restore as j_restore
from repro.checkpoint import save_pytree as j_save_pytree
from repro.configs import ARCH_IDS as J_ARCH_IDS
from repro.configs import INPUT_SHAPES as J_INPUT_SHAPES
from repro.configs import InputShape as JInputShape
from repro.configs import get_config as j_get_config
from repro.data import TokenPipeline as JTokenPipeline
from repro.data import TokenPipelineConfig as JTokenPipelineConfig
from repro.models import build as j_build
from repro.optim import cosine_schedule as j_cosine_schedule
from repro.roofline import analytic as j_analytic

from repro_torch.checkpoint import (latest_step, load_pytree, restore,
                                    save_pytree)
from repro_torch.configs import INPUT_SHAPES, InputShape, get_config
from repro_torch.data import TokenPipeline, TokenPipelineConfig, device_batch
from repro_torch.kernels import (flash_attention, flash_decode, paged_chunk,
                                 paged_decode, probe_spec, probe_step,
                                 rwkv6_scan, ttt_scan)
from repro_torch.launch import train as ttrain
from repro_torch.models import build
from repro_torch.optim import cosine_schedule
from repro_torch.optim.adam import tree_leaves
from repro_torch.roofline import analytic

FAMILIES = ("smollm-360m", "granite-moe-1b-a400m", "llava-next-34b",
            "hymba-1.5b", "rwkv6-1.6b", "whisper-tiny")


def test_token_pipeline_bitwise_jax():
    kw = dict(vocab_size=512, seq_len=33, global_batch=4, seed=3)
    jp = JTokenPipeline(JTokenPipelineConfig(**kw))
    tp = TokenPipeline(TokenPipelineConfig(**kw))
    for i in (0, 7, 123):
        jb, tb = jp.batch(i), tp.batch(i)
        assert set(jb) == set(tb) == {"tokens", "targets"}
        for k in jb:
            assert tb[k].dtype == jb[k].dtype == np.int32
            np.testing.assert_array_equal(tb[k], jb[k])
        on_dev = device_batch(tb, "cpu")
        assert on_dev["tokens"].dtype == torch.int32
        np.testing.assert_array_equal(on_dev["targets"].numpy(),
                                      jb["targets"])


def _bits(x):
    """The raw bits of a tensor or an array (bf16 as int16)."""
    if isinstance(x, torch.Tensor):
        return (x.view(torch.int16) if x.dtype == torch.bfloat16
                else x).numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype.itemsize == 2 else x


def test_checkpoint_jax_to_port_and_back(tmp_path):
    rng = np.random.default_rng(0)
    w = rng.standard_normal((3, 4)).astype(np.float32)
    e = rng.standard_normal((5, 2)).astype(np.float32)
    jtree = {"layers": {"w": jnp.asarray(w)},
             "embed": jnp.asarray(e, jnp.bfloat16),
             "step": jnp.asarray(7, jnp.int32)}
    d = str(tmp_path / "jax")
    j_save_pytree(jtree, d, step=5)
    raw = load_pytree(os.path.join(d, "step_5"))
    assert raw["embed"].dtype.kind == "V"     # numpy has no bf16
    template = {"layers": {"w": torch.empty((3, 4), device="meta")},
                "embed": torch.empty((5, 2), dtype=torch.bfloat16),
                "step": torch.empty((), dtype=torch.int32)}
    back = restore(template, os.path.join(d, "step_5"))
    assert back["embed"].dtype == torch.bfloat16
    for got, want in ((back["layers"]["w"], jtree["layers"]["w"]),
                      (back["embed"], jtree["embed"]),
                      (back["step"], jtree["step"])):
        np.testing.assert_array_equal(_bits(got), _bits(want))
    # the port's checkpoint (bf16 widened to float32) restores in JAX
    d2 = str(tmp_path / "port")
    save_pytree(back, d2, step=9, meta={"arch": "x"})
    assert load_pytree(os.path.join(d2, "step_9"))["embed"].dtype \
        == np.float32
    jback = j_restore(jtree, os.path.join(d2, "step_9"))
    assert jback["embed"].dtype == jnp.bfloat16
    for k in ("embed", "step"):
        np.testing.assert_array_equal(_bits(jback[k]), _bits(jtree[k]))
    np.testing.assert_array_equal(np.asarray(jback["layers"]["w"]), w)


def test_checkpoint_mismatch_missing_and_latest_step(tmp_path):
    d = str(tmp_path)
    assert latest_step(d) is None
    assert latest_step(str(tmp_path / "none")) is None
    save_pytree({"a": torch.zeros(2)}, d, step=3)
    save_pytree({"a": torch.ones(2)}, d, step=10)
    save_pytree({"a": torch.ones(2)}, d)              # "final": no step
    assert latest_step(d) == 10
    assert not [n for n in os.listdir(d) if n.startswith(".ckpt_tmp_")]
    with pytest.raises(ValueError, match="shape"):
        restore({"a": torch.zeros(3)}, os.path.join(d, "step_10"))
    with pytest.raises(KeyError, match="b"):
        restore({"b": torch.zeros(2)}, os.path.join(d, "step_10"))
    got = restore({"a": torch.zeros(2, dtype=torch.float64)},
                  os.path.join(d, "step_3"))["a"]
    assert got.dtype == torch.float64 and not got.any()


@pytest.mark.parametrize("peak,warmup,total,floor",
                         [(3e-4, 20, 100, 0.1), (1e-3, 0, 7, 0.0),
                          (2.5e-3, 5, 30, 0.25)])
def test_cosine_schedule_matches_jax(peak, warmup, total, floor):
    jlr = j_cosine_schedule(peak, warmup, total, floor)
    lr = cosine_schedule(peak, warmup, total, floor)
    steps = range(total + 6)
    got = np.array([lr(s).item() for s in steps], np.float32)
    want = np.array([float(jlr(jnp.asarray(s, jnp.int32))) for s in steps],
                    np.float32)
    # float32 both; cos may round its last bit apart
    np.testing.assert_allclose(got, want, rtol=2 ** -22, atol=0)
    assert lr(torch.tensor(3)).dtype == torch.float32


@pytest.mark.parametrize("arch", J_ARCH_IDS)
def test_roofline_estimate_matches_jax(arch):
    jcfg, cfg = j_get_config(arch), get_config(arch)
    assert analytic.non_embedding_params(cfg, active=True) \
        == j_analytic.non_embedding_params(jcfg, active=True)
    for name, shape in INPUT_SHAPES.items():
        jshape = J_INPUT_SHAPES[name]
        got, want = analytic.estimate(cfg, shape), j_analytic.estimate(
            jcfg, jshape)
        assert (got.flops, got.bytes, got.model_flops) \
            == (want.flops, want.bytes, want.model_flops), name


@pytest.mark.parametrize("arch", FAMILIES)
def test_abstract_params_and_batches_shaped_as_jax(arch):
    jmodel = j_build(j_get_config(arch).reduced())
    model = build(get_config(arch).reduced())
    jshapes = jax.tree.map(lambda s: tuple(s.shape),
                           jmodel.abstract_params())
    shapes = {}
    meta = model.abstract_params("float32")
    assert all(t.device.type == "meta" and t.dtype == torch.float32
               for t in tree_leaves(meta))

    def walk(tree, out):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, out.setdefault(k, {}))
            else:
                out[k] = tuple(v.shape)
    walk(meta, shapes)
    assert shapes == jshapes
    for kind in ("train", "prefill", "decode"):
        jshape = JInputShape("t", 48, 2, kind)
        jb = jmodel.make_batch(jax.random.PRNGKey(0), jshape)
        tb = model.make_batch(torch.Generator().manual_seed(0),
                              InputShape("t", 48, 2, kind), device="cpu")
        assert set(tb) == set(jb)
        for k in jb:
            assert tuple(tb[k].shape) == tuple(jb[k].shape), (kind, k)
        assert model.text_len(InputShape("t", 48, 2, kind)) \
            == jmodel.text_len(jshape)


def test_train_cli_cpu_saves_and_resumes(tmp_path, capsys):
    d = str(tmp_path / "ckpt")
    argv = ["--arch", "smollm-360m", "--reduced", "--device", "cpu",
            "--batch", "4", "--seq", "32", "--lr", "3e-3", "--warmup", "2",
            "--ckpt-dir", d, "--ckpt-every", "6", "--log-every", "6"]
    res = ttrain.train(ttrain.parse(argv + ["--steps", "12"]))
    assert len(res.losses) == 12 and res.losses[-1] < res.losses[0]
    assert sorted(os.listdir(d)) == ["step_12", "step_6"]
    saved = restore(res.params, os.path.join(d, "step_12"))
    for a, b in zip(tree_leaves(saved), tree_leaves(res.params)):
        assert torch.equal(a, b)
    capsys.readouterr()
    assert ttrain.main(argv + ["--steps", "20"]) == 0
    out = capsys.readouterr().out
    assert "[train] resumed from step 12" in out
    assert "[train] step    18 loss" in out and "[train] done" in out
    assert latest_step(d) == 20


def _guard_cases():
    """Each kernel entry with small valid CPU inputs; the first listed
    tensor is the one made to require grad."""
    g = torch.Generator().manual_seed(0)
    r = lambda *s: torch.randn(*s, generator=g)
    B, f, win = 2, 8, 4

    def probe_state(t=None):
        zq = r(B, f) if t is None else r(B, t, f)
        bnd = (torch.ones(B, dtype=torch.bool) if t is None
               else torch.ones(B, t, dtype=torch.bool))
        return (zq, zq.clone(), bnd)

    def slots():
        return (r(B, f), torch.zeros(B), torch.zeros(B, win),
                torch.zeros(B, dtype=torch.int32),
                torch.zeros(B, dtype=torch.bool),
                torch.full((B,), -1, dtype=torch.int32))

    pages = lambda: (r(3, 1, 4, 64), r(3, 1, 4, 64))
    table = torch.tensor([[1, 2], [2, 1]], dtype=torch.int32)
    valid = torch.ones(2, 8, dtype=torch.bool)
    return {
        "flash_attention": (flash_attention.flash_attention,
                            (r(1, 4, 2, 64), r(1, 4, 1, 64),
                             r(1, 4, 1, 64)), {}),
        "flash_decode": (flash_decode.flash_decode,
                         (r(2, 2, 64), r(2, 1, 8, 64), r(2, 1, 8, 64),
                          valid), {}),
        "paged_flash_decode": (paged_decode.paged_flash_decode,
                               (r(2, 2, 64), *pages(), table, valid), {}),
        "paged_flash_packed_chunk": (
            paged_chunk.paged_flash_packed_chunk,
            (r(4, 2, 64), *pages(), torch.tensor([0, 0, 1, 1],
                                                 dtype=torch.int32),
             table, valid), {}),
        "paged_flash_prefill_chunk": (
            paged_chunk.paged_flash_prefill_chunk,
            (r(2, 3, 2, 64), *pages(), table, valid), {}),
        "serving_probe_step": (
            probe_step.serving_probe_step,
            (*probe_state(), *slots(), 0.1, 0.5), dict(burn_in=1)),
        "serving_probe_spec_step": (
            probe_spec.serving_probe_spec_step,
            (*probe_state(3), torch.full((B,), 3, dtype=torch.int32),
             *slots(), 0.1, 0.5), dict(burn_in=1)),
        "wkv_scan": (rwkv6_scan.wkv_scan,
                     (r(1, 3, 2, 8), r(1, 3, 2, 8), r(1, 3, 2, 8),
                      torch.rand(1, 3, 2, 8, generator=g), r(2, 8),
                      torch.zeros(1, 2, 8, 8)), {}),
        "ttt_probe_batched": (
            ttt_scan.ttt_probe_batched,
            (r(2, 5, f), r(2, 5, f), torch.zeros(2, 5), torch.ones(2, 5),
             r(2, f), torch.zeros(2), torch.full((2,), 0.1)), {}),
    }


@pytest.mark.parametrize("entry", sorted(_guard_cases()))
def test_kernel_entries_refuse_grad(entry):
    fn, args, kw = _guard_cases()[entry]
    args = list(args)
    args[0] = args[0].clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match="forward only"):
        fn(*args, **kw)
    # a trained leaf served under no_grad passes and runs the plain
    # version
    with torch.no_grad():
        out = fn(*args, **kw)
    first = out[0] if isinstance(out, tuple) else out
    assert torch.isfinite(first).all() and not first.requires_grad
