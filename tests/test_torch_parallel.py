"""The port's multi-device layout and its one-process pieces held to the
JAX package, in this process (no process group): every config's logical
axes on every parameter leaf, the parameter specs under the train (dp_tp
and fsdp_tp) and serve rules, the batch, decode-state and probe-state
specs of every family, ``make_context``'s rules and flags at a (2, 2)
mesh (JAX's on 4 host devices in a subprocess), the blockwise attention
against the port's einsum and JAX's ``attn_prefill_blockwise`` (forward
and gradient; causal, windowed, several blocks, Sq != Sk), and the
production meshes' refusal at world size 1.

Specs are compared as tuples of entries, a one-axis tuple read as the
axis (JAX's ``PartitionSpec`` normalises ("data",) to "data").
Tolerances: the blockwise forward within 1e-5 and its gradients within
1e-4 of each input's largest gradient (f32 sums in another order)."""
import json
import os
import subprocess
import sys
import textwrap
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import InputShape, get_config
from repro_torch.configs.base import PORTED
from repro_torch.launch import shardings as SH
from repro_torch.launch.mesh import make_production_mesh, make_test_mesh
from repro_torch.models import attention as A
from repro_torch.models import build
from repro_torch.models.common import Param
from repro_torch.parallel import ParallelContext, use_parallel

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
ARCHS = tuple(get_config(name).name for name in PORTED)
SHAPES = {"train": InputShape("t", 1024, 8, "train"),
          "prefill": InputShape("p", 1024, 8, "prefill"),
          "decode": InputShape("d", 1024, 8, "decode"),
          "decode_b1": InputShape("d1", 1024, 1, "decode")}
MESH = types.SimpleNamespace(mesh_dim_names=("data", "model"), shape=(2, 2))
FWD_TOL = 1e-5
GRAD_TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _norm_entry(e):
    if isinstance(e, (tuple, list)):
        return e[0] if len(e) == 1 else tuple(e)
    return e


def _norm(spec):
    return tuple(_norm_entry(e) for e in spec)


def _leaves(tree, prefix=""):
    """{path: leaf} of nested dicts (and NamedTuples by field)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}{k}/"))
        return out
    if hasattr(tree, "_fields"):
        out = {}
        for k, v in zip(tree._fields, tree):
            out.update(_leaves(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _fields(shape):
    return (shape.name, shape.seq_len, shape.global_batch, shape.kind)


def _jax_model(arch):
    from repro.configs import get_config as j_get_config
    from repro.models import build as j_build
    return j_build(j_get_config(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_param_axes_and_specs_match_jax(arch):
    from repro.launch import shardings as JSH
    from repro.models.common import param_specs as j_param_specs
    jmodel = _jax_model(arch)
    model = build(get_config(arch))
    jdecls = {k: v for k, v in _leaves(jmodel.decls).items()}
    decls = _leaves(model.decls)
    assert set(decls) == set(jdecls)
    for key, p in decls.items():
        assert p.axes == jdecls[key].axes, key
        assert p.shape == jdecls[key].shape, key
    for rules in (JSH.train_rules(False, False), JSH.train_rules(False, True),
                  JSH.serve_rules(False), JSH.train_rules(True, True),
                  JSH.serve_rules(True)):
        ours = {k: _norm(v) for k, v in _leaves(model.specs(rules)).items()}
        want = {k: _norm(tuple(v)) for k, v in _leaves(
            j_param_specs(jmodel.decls, rules)).items()}
        assert ours == want


def test_param_asserts_axes_per_dim():
    with pytest.raises(AssertionError):
        Param((4, 8), ("embed",))
    assert Param((4, 8), ("embed", "mlp")).axes == ("embed", "mlp")


@pytest.mark.parametrize("arch", ARCHS)
def test_rules_and_state_specs_match_jax(arch):
    import jax
    from repro.configs import InputShape as JInputShape
    from repro.core.probe import ProbeConfig as JProbeConfig
    from repro.core.probe import init_outer as j_init_outer
    from repro.launch import shardings as JSH
    from repro.serving import init_probe_state as j_init_probe_state
    from repro_torch.core.probe import ProbeConfig, init_outer
    from repro_torch.serving.engine import init_probe_state

    from repro.models import build as j_build
    cfg = get_config(arch).reduced()
    jmodel, model = j_build(_jax_model(arch).cfg.reduced()), build(cfg)
    jcfg = jmodel.cfg
    for kind in ("train", "decode"):
        shape = InputShape("s", 64, 4, kind)
        jbatch = jax.eval_shape(lambda: jmodel.make_batch(
            jax.random.PRNGKey(0), JInputShape(*_fields(shape))))
        batch = model.make_batch(torch.Generator(), shape, device="cpu")
        for rules in (JSH.train_rules(False, False), JSH.serve_rules(True)):
            want = {k: _norm(tuple(v)) for k, v in _leaves(
                JSH.batch_spec_tree(jbatch, rules)).items()}
            got = {k: _norm(v) for k, v in _leaves(
                SH.batch_spec_tree(batch, rules)).items()}
            assert got == want, (kind, got, want)
    jstate = jax.eval_shape(lambda: jmodel.init_decode_state(4, 64))
    state = model.init_decode_state(4, 64, device="cpu")
    for flash in (False, True):
        rules = JSH.serve_rules(False)
        # by leaf name: hymba's JAX state nests {"kv", "mamba"}, the
        # port's is flat; the rules key on the leaf's name
        want = {k.split("/")[-1]: _norm(tuple(v)) for k, v in _leaves(
            JSH.decode_state_specs(jcfg, jstate, rules, flash)).items()}
        got = {k: _norm(v) for k, v in _leaves(
            SH.decode_state_specs(cfg, state, rules, flash)).items()}
        assert got == want, (flash, got, want)
    jst = j_init_probe_state(JProbeConfig(d_phi=8), j_init_outer(
        JProbeConfig(d_phi=8), jax.random.PRNGKey(0)), 4, 8)
    st = init_probe_state(ProbeConfig(d_phi=8), init_outer(
        ProbeConfig(d_phi=8), device="cpu"), 4, 8)
    rules = JSH.serve_rules(False)
    want = [_norm(tuple(v)) for v in JSH.probe_state_specs(jst, rules)]
    got = [_norm(v) for v in SH.probe_state_specs(st, rules)]
    assert got == want


def test_make_context_matches_jax_on_a_2x2_mesh():
    code = textwrap.dedent("""
    import json, jax
    from repro.configs import get_config, InputShape
    from repro.launch import shardings as SH
    mesh = jax.make_mesh((2, 2), ("data", "model"))
    shapes = %r
    out = {}
    for arch in %r:
        cfg = get_config(arch)
        for key, s in shapes.items():
            ctx = SH.make_context(cfg, mesh, InputShape(*s), multi_pod=False)
            out[arch + "/" + key] = dict(
                rules={k: (list(v) if isinstance(v, tuple) else v)
                       for k, v in ctx.rules.items()},
                data_axes=list(ctx.data_axes), model_axis=ctx.model_axis,
                ep_moe=ctx.ep_moe, flash_decode=ctx.flash_decode,
                attn_impl=ctx.attn_impl, remat=ctx.remat)
    print(json.dumps(out))
    """) % ({k: _fields(v) for k, v in SHAPES.items()}, ARCHS)
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr
    want = json.loads(proc.stdout.strip().splitlines()[-1])
    for arch in ARCHS:
        cfg = get_config(arch)
        for key, shape in SHAPES.items():
            ctx = SH.make_context(cfg, MESH, shape, multi_pod=False)
            got = dict(
                rules={k: (list(v) if isinstance(v, tuple) else v)
                       for k, v in ctx.rules.items()},
                data_axes=list(ctx.data_axes), model_axis=ctx.model_axis,
                ep_moe=ctx.ep_moe, flash_decode=ctx.flash_decode,
                attn_impl=ctx.attn_impl, remat=ctx.remat)
            assert got == want[f"{arch}/{key}"], (arch, key)


def _blockwise_inputs(b, sq, sk, h, kv, d, seed):
    rng = np.random.default_rng(seed)
    return [torch.tensor(rng.standard_normal(shp), dtype=torch.float32)
            for shp in ((b, sq, h, d), (b, sk, kv, d), (b, sk, kv, d))]


CASES = [  # (sq, sk, causal, window, q_block, kv_block)
    (64, 64, True, None, 16, 16),
    (64, 64, True, 24, 16, 32),
    (48, 48, False, None, 16, 16),
    (32, 48, False, None, 16, 16),
]


@pytest.mark.parametrize("differentiable", [False, True])
@pytest.mark.parametrize("case", CASES)
def test_blockwise_matches_einsum_and_jax(case, differentiable):
    import jax
    import jax.numpy as jnp
    from repro.models import attention as JA
    sq, sk, causal, window, qb, kb = case
    q, k, v = _blockwise_inputs(2, sq, sk, 6, 2, 16, 0)
    for t in (q, k, v):
        t.requires_grad_(True)
    got = A.attn_prefill_blockwise(q, k, v, causal=causal, window=window,
                                   q_block=qb, kv_block=kb,
                                   differentiable=differentiable)
    want = A.attn_prefill_einsum(q, k, v, causal=causal, window=window)
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(),
                               atol=FWD_TOL)
    cot = torch.randn(got.shape, generator=torch.Generator().manual_seed(1))
    g_got = torch.autograd.grad((got * cot).sum(), (q, k, v))
    g_want = torch.autograd.grad((want * cot).sum(), (q, k, v))
    for a, b in zip(g_got, g_want):
        assert (a - b).abs().max() <= GRAD_TOL * b.abs().max()
    if sq == sk:       # JAX's blockwise takes one length for q and k
        jq, jk, jv = (jnp.asarray(t.detach().numpy()) for t in (q, k, v))
        jout = JA.attn_prefill_blockwise(jq, jk, jv, causal=causal,
                                         window=window, q_block=qb,
                                         kv_block=kb,
                                         differentiable=differentiable)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(jout),
                                   atol=FWD_TOL)
        if not differentiable:   # JAX differentiates its static scan only
            return
        jg = jax.grad(lambda a, b, c: jnp.sum(JA.attn_prefill_blockwise(
            a, b, c, causal=causal, window=window, q_block=qb, kv_block=kb,
            differentiable=True) * jnp.asarray(cot.numpy())),
            argnums=(0, 1, 2))(jq, jk, jv)
        for a, b in zip(g_got, jg):
            b = np.asarray(b)
            assert np.abs(a.numpy() - b).max() <= GRAD_TOL * np.abs(b).max()


def test_training_attention_dispatch():
    """Under a context asking for blockwise, lengths dividing min(512, S)
    take it (differentiable under remat), others the einsum."""
    q, k, v = _blockwise_inputs(1, 40, 40, 4, 2, 8, 2)
    want = A.attn_prefill_einsum(q, k, v, causal=True)
    for remat in (False, True):
        ctx = ParallelContext(mesh=MESH, rules={}, attn_impl="blockwise",
                              remat=remat)
        with use_parallel(ctx):
            got = A.attn_prefill_train(q, k, v, causal=True)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=FWD_TOL)
    assert torch.equal(A.attn_prefill_train(q, k, v, causal=True), want)


def test_remat_recomputes_under_the_context_on_another_thread():
    """For CUDA tensors the backward, and with it remat's recomputation,
    runs on the autograd engine's device thread, where the context
    variable is unset.  A backward run on a thread of its own stands in
    for it: the recomputed layers take the forward's path (blockwise with
    per-block checkpoints, not the einsum), and the gradients equal the
    same loss's without remat."""
    import threading
    from repro_torch.launch import train as T
    mesh = types.SimpleNamespace(mesh_dim_names=("data", "model"),
                                 shape=(1, 1))
    cfg = get_config("smollm-360m").reduced()
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu",
                        dtype="float32")
    batch = model.make_batch(torch.Generator().manual_seed(1),
                             InputShape("t", 32, 2, "train"), device="cpu")
    grads = {}
    for remat in (False, True):
        ctx = ParallelContext(mesh=mesh, rules={}, attn_impl="blockwise",
                              remat=remat)
        leaves = [p.requires_grad_() for p in T.tree_leaves(params)]
        with use_parallel(ctx):
            loss, _ = model.loss(params, batch)
        out = []
        th = threading.Thread(target=lambda: out.append(
            torch.autograd.grad(loss, leaves, allow_unused=True)))
        th.start()
        th.join()
        assert out, "the backward raised on its thread"
        grads[remat] = out[0]
        for p in leaves:
            p.requires_grad_(False)
    for a, b in zip(grads[True], grads[False]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("multi_pod,need", [(False, 256), (True, 512)])
def test_production_mesh_raises_at_world_size_one(multi_pod, need):
    with pytest.raises(RuntimeError, match=f"need {need} ranks.*have 1"):
        make_production_mesh(multi_pod=multi_pod)
    with pytest.raises(RuntimeError, match="need 4 ranks, have 1"):
        make_test_mesh((2, 2), device_type="cpu")


def test_trainer_mesh_flag_raises_at_world_size_one(monkeypatch):
    from repro_torch.launch import train
    monkeypatch.delenv("RANK", raising=False)
    with pytest.raises(RuntimeError, match="need 256 ranks.*have 1"):
        train.main(["--arch", "smollm-360m", "--reduced", "--device", "cpu",
                    "--mesh", "single", "--steps", "1"])


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "hymba-1.5b",
                                  "whisper-tiny"])
def test_sharded_serving_of_the_recurrent_families_waits_for_a9b(arch):
    """Their sharded serving (states on heads and channels) is A9b: the
    serve step built under a decode context raises and names it; nothing
    runs them unsharded."""
    from repro_torch.core.probe import ProbeConfig, init_outer
    from repro_torch.serving import ServeConfig
    from repro_torch.serving.engine import make_serve_step
    cfg = get_config(arch).reduced()
    pc = ProbeConfig(d_phi=cfg.d_model)
    ctx = SH.make_context(cfg, MESH, InputShape("d", 64, 4, "decode"),
                          multi_pod=False)
    with use_parallel(ctx), pytest.raises(NotImplementedError,
                                          match="A9b"):
        make_serve_step(build(cfg), pc, init_outer(pc, device="cpu"),
                        ServeConfig())
