"""The port's multi-device paths on four CPU ranks (gloo, a (2, 2) data x
model mesh), held to the one-process port and to the JAX package.

One spawn (``launch.mesh.spawn_ranks``: fresh processes, a FileStore in a
temporary directory, two threads a rank, a deadline) runs every sharded
computation, and the tests read its results:

* the sequence-sharded decode (K6's plain version on each rank's half of
  the cache, merged over ``model``) at (d, G) (64, 3) and (64, 2), with
  and without the current token, with rows whose slice on one rank, or
  whose whole cache, is invalid: against the one-process ``attn_decode``
  and JAX's ``_decode_core`` within 1e-5;
* ``moe_ep`` of the reduced granite-moe-1b (4 experts, 2 a rank, top-2):
  at capacity factor 8.0 (nothing dropped) its output, aux and the
  gradient of every leaf and of x against ``moe_dense`` within 1e-5 of
  each tensor's largest magnitude; at the config's 1.25 (tokens dropped)
  its output against JAX's ``moe_ep`` on a 4-device ``jax.make_mesh((2,
  2))`` in a subprocess within 1e-5, the only tied scores in a rank's
  top-capacity selection being the -1.0 fillers;
* a train step of each family at ``.reduced()`` under ``make_context``'s
  train context (blockwise attention, remat; the MoE at capacity 8.0):
  the loss within 1e-5 relative and every gathered gradient within 1e-4
  of the leaf's largest magnitude (+1e-8: whisper's key biases are zero
  in exact arithmetic) of the one-process port's and of JAX's
  ``value_and_grad`` of ``model.loss``, each the mean over the two data
  halves (the MoE aux is averaged over the data ranks, as JAX's
  ``moe_ep`` does); the same gradients without remat; the parameters
  after one clipped Adam step within 1e-5;
* the sharded f32 serve step (serve rules: tensor-parallel weights, the
  cache sequence-sharded, the probe on each data rank's rows) of the
  reduced smollm-360m and granite-moe-1b (capacity 8.0) after a sharded
  prefill: tokens and stops equal to the one-process
  ``make_serve_step``'s, smoothed scores within 1e-5;
* the trainer's checkpoint under the mesh (whole arrays from rank 0)
  restored in one process bit for bit, and a one-process checkpoint
  restored into each rank's shards bit for bit.

Parameters are drawn with numpy at a quarter of the init's scale, as in
``tests/test_torch_train.py`` (at full scale f32 rounding is amplified
past 1e-4)."""
import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.configs import InputShape, get_config
from repro_torch.models import build
from repro_torch.models.convert import from_jax_params

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
ARCHS = ("smollm-360m", "granite-moe-1b-a400m", "llava-next-34b",
         "rwkv6-1.6b", "hymba-1.5b", "whisper-tiny")
SERVE_ARCHS = ("smollm-360m", "granite-moe-1b-a400m")
B, S = 4, 32                 # train batch: 2 rows a data rank
SERVE_PROMPT, SERVE_CACHE, SERVE_STEPS = 12, 64, 10
WEIGHT_SCALE = 0.25
DECODE_TOL = 1e-5
MOE_TOL = 1e-5
RTOL_LOSS = 1e-5
GRAD_TOL = 1e-4
GRAD_FLOOR = 1e-8
PARAM_TOL = 1e-5
SMOOTH_TOL = 1e-5
CLIP_NORM = 0.05             # below every gradient's norm: the clip acts
DEADLINE_S = 600


def _cfg(arch, capacity=8.0):
    cfg = get_config(arch).reduced()
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=capacity))
    return cfg


def _numpy_tree(decls, rng):
    if isinstance(decls, dict):
        return {k: _numpy_tree(v, rng) for k, v in decls.items()}
    shape = decls.shape
    if decls.init in ("zeros", "ones"):
        return np.full(shape, decls.init == "ones", np.float32)
    if decls.init == "normal":
        std = decls.scale / np.sqrt(shape[0] if len(shape) >= 2
                                    else max(shape[-1], 1))
    else:
        std = 0.02 * decls.scale
    if len(shape) >= 2:
        std *= WEIGHT_SCALE
    return (rng.standard_normal(shape) * std).astype(np.float32)


def _train_inputs(arch):
    cfg = _cfg(arch)
    model = build(cfg)
    tree = _numpy_tree(model.decls, np.random.default_rng(0))
    params = from_jax_params(tree, model, device="cpu", dtype="float32")
    batch = model.make_batch(torch.Generator().manual_seed(1),
                             InputShape("t", S, B, "train"), device="cpu")
    return model, tree, params, batch


def _halves(batch):
    return [{k: v[h * B // 2:(h + 1) * B // 2] for k, v in batch.items()}
            for h in range(2)]


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree.detach() if isinstance(
        tree, torch.Tensor) else tree, dtype=np.float64)}


# ---------------------------------------------------------------------------
# the ranks' side

def _decode_cases():
    """(G, with current token) -> inputs (B 4, KV 2, S 64, d 64)."""
    out = {}
    for g in (3, 2):
        gen = torch.Generator().manual_seed(g)
        b, kv, s, d = 4, 2, 64, 64
        q = torch.randn(b, kv * g, d, generator=gen)
        k = torch.randn(b, kv, s, d, generator=gen)
        v = torch.randn(b, kv, s, d, generator=gen)
        valid = torch.rand(b, s, generator=gen) > 0.3
        valid[:, 0] = True
        valid[1, s // 2:] = False         # model rank 1's slice empty
        valid[2, :s // 2] = False         # model rank 0's slice empty
        valid[3] = False                  # every slice empty
        kx = torch.randn(b, kv, d, generator=gen)
        vx = torch.randn(b, kv, d, generator=gen)
        out[g] = (q, k, v, valid, kx, vx)
    return out


def _moe_inputs(capacity):
    cfg = _cfg("granite-moe-1b-a400m", capacity)
    from repro_torch.models import moe
    tree = _numpy_tree(moe.moe_decls(cfg), np.random.default_rng(3))
    params = {k: torch.from_numpy(v) for k, v in tree.items()}
    x = np.random.default_rng(4).standard_normal((4, 16, cfg.d_model))
    # tokens leaning to expert 0: it is routed more tokens than a capacity
    # factor of 1.25 leaves it
    u = tree["router"][:, 0] / np.linalg.norm(tree["router"][:, 0])
    x = torch.from_numpy((x + 40.0 * u).astype(np.float32))
    return cfg, tree, params, x


def _serve_setup(arch):
    from repro_torch.core.probe import ProbeConfig, init_outer
    from repro_torch.serving import ServeConfig
    cfg = _cfg(arch)
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    pc = ProbeConfig(d_phi=cfg.d_model)
    theta = init_outer(pc, torch.Generator().manual_seed(2), device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (B, SERVE_PROMPT),
                         generator=torch.Generator().manual_seed(1),
                         dtype=torch.int32)
    return model, params, pc, theta, toks


def _serve(model, params, pc, theta, lam, toks):
    """Prefill ``toks`` and run SERVE_STEPS one-token serve steps:
    (tokens, smoothed, stopped), each (steps, rows)."""
    from repro_torch.serving import ServeConfig
    from repro_torch.serving.engine import init_probe_state, make_serve_step
    cfg = model.cfg
    cache, _, _ = model.prefill(cfg, params, {"tokens": toks}, SERVE_CACHE)
    st = init_probe_state(pc, theta, toks.shape[0], cfg.d_model)
    step = make_serve_step(model, pc, theta, ServeConfig(
        tokens_per_step=2, lam=lam, burn_in=1))
    tok = toks[:, -1].clone()
    pos = torch.full((toks.shape[0],), SERVE_PROMPT, dtype=torch.int32)
    out = []
    for _ in range(SERVE_STEPS):
        tok, cache, st = step(params, tok, cache, pos, st)
        pos = pos + 1
        out.append((tok.clone(), st.smoothed.clone(), st.stopped.clone()))
    return [torch.stack(x) for x in zip(*out)]


def _ranks(rank, world, lams, ckpt_dir):
    from repro_torch import parallel
    from repro_torch.launch import shardings as SH
    from repro_torch.launch import train as T
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import attention as A
    from repro_torch.models import moe
    from repro_torch.models.common import param_specs
    from repro_torch.optim import Adam

    mesh = make_test_mesh((2, 2), device_type="cpu")
    dr, mr = mesh.get_local_rank("data"), mesh.get_local_rank("model")
    rows = slice(dr * 2, dr * 2 + 2)
    res = {}
    # sequence-sharded decode
    ctx = parallel.ParallelContext(mesh=mesh, rules={"batch": "data",
                                                     "kv_seq": "model"},
                                   flash_decode=True)
    for g, (q, k, v, valid, kx, vx) in _decode_cases().items():
        seq = slice(mr * 32, mr * 32 + 32)
        with parallel.use_parallel(ctx):
            for extra in (False, True):
                res[f"decode/{g}/{extra}"] = A.attn_decode(
                    q[rows], {"k": k[rows, :, seq], "v": v[rows, :, seq]},
                    valid[rows, seq], torch.float32,
                    extra_kv=(kx[rows], vx[rows]) if extra else None)
    # expert-parallel MoE
    for capacity in (8.0, 1.25):
        cfg, _, params, x = _moe_inputs(capacity)
        # the small-MoE train rules: experts over model, d over data
        ctx = SH.make_context(cfg, mesh, InputShape("t", 16, 4, "train"),
                              multi_pod=False)
        decls = moe.moe_decls(cfg)
        specs = param_specs(decls, ctx.rules)
        local = SH.with_shardings(params, specs, mesh)
        xl = x[rows].clone().requires_grad_(True)
        for t in local.values():
            t.requires_grad_(True)
        with parallel.use_parallel(ctx):
            y, aux = moe.moe_ep(SH.compute_params(decls, local, ctx), xl,
                                cfg, ctx)
            loss = parallel.reduce_from(torch.sum(y.float() ** 2),
                                        "data") + aux
            grads = torch.autograd.grad(loss, [xl] + list(local.values()))
            gp = SH.reduce_grads(dict(zip(local, grads[1:])), specs, ctx)
        res[f"moe/{capacity}"] = dict(
            y=y.detach(), aux=aux.detach(), gx=grads[0],
            grads=SH.gathered(gp, specs, mesh))
    # a train step of each family
    for arch in ARCHS:
        model, _, params, batch = _train_inputs(arch)
        shape = InputShape("t", S, B, "train")
        ctx = SH.make_context(model.cfg, mesh, shape, multi_pod=False)
        specs = model.specs(ctx.rules)
        local = SH.with_shardings(params, specs, mesh)
        lb = SH.with_shardings(batch, SH.batch_spec_tree(batch, ctx.rules),
                               mesh)
        out = {"remat": ctx.remat, "attn_impl": ctx.attn_impl}
        for remat in (True, False):
            with parallel.use_parallel(dataclasses.replace(ctx, remat=remat)):
                loss, met, grads = T.loss_and_grads(model, local, lb)
            out[f"grads/{remat}"] = SH.gathered(grads, specs, mesh)
        out["loss"], out["aux"] = loss, met["aux"]
        opt = Adam(lr=1e-3, clip_norm=CLIP_NORM)
        step = T.make_train_step(model, opt)
        with parallel.use_parallel(ctx):
            local, _, _, _ = step(local, opt.init(local), lb)
        out["params"] = SH.gathered(local, specs, mesh)
        res[f"train/{arch}"] = out
    # the sharded serve step
    for arch in SERVE_ARCHS:
        model, params, pc, theta, toks = _serve_setup(arch)
        ctx = SH.make_context(model.cfg, mesh, InputShape(
            "d", SERVE_CACHE, B, "decode"), multi_pod=False)
        local = SH.with_shardings(params, model.specs(ctx.rules), mesh)
        parallel.reset_collectives()
        with parallel.use_parallel(ctx):
            res[f"serve/{arch}"] = _serve(model, local, pc, theta,
                                          lams[arch], toks[rows])
        res[f"serve/{arch}/collectives"] = parallel.collective_stats()
    # checkpoints under the mesh
    model, _, params, _ = _train_inputs("smollm-360m")
    ctx = SH.make_context(model.cfg, mesh, InputShape("t", S, B, "train"),
                          multi_pod=False)
    specs = model.specs(ctx.rules)
    local = SH.with_shardings(params, specs, mesh)
    T.save_sharded(local, specs, ctx, os.path.join(ckpt_dir, "mesh"), 3)
    back = T.restore_sharded(model.abstract_params("float32"), specs, ctx,
                             os.path.join(ckpt_dir, "one", "step_5"))
    want = SH.with_shardings(params, specs, mesh)
    res["restore_bitwise"] = all(
        torch.equal(a, b) for a, b in zip(_tensors(back), _tensors(want)))
    return res


def _tensors(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _tensors(v)]
    return [tree]


# ---------------------------------------------------------------------------
# the one-process side

def _serve_lams():
    """A threshold between the rows' peak smoothed scores past the
    burn-in in a run that never stops (the second score on, the 4th
    step), so the highest row stops and the lowest does not."""
    out = {}
    for arch in SERVE_ARCHS:
        model, params, pc, theta, toks = _serve_setup(arch)
        _, sm, _ = _serve(model, params, pc, theta, 1e9, toks)
        peak = sm[3:].max(0).values
        out[arch] = float((peak.min() + peak.max()) / 2)
    return out


@pytest.fixture(scope="module")
def dist(tmp_path_factory):
    from repro_torch.checkpoint import save_pytree
    from repro_torch.launch.mesh import spawn_ranks
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        ckpt = tmp_path_factory.mktemp("ckpt")
        _, _, params, _ = _train_inputs("smollm-360m")
        save_pytree(params, str(ckpt / "one"), step=5)
        lams = _serve_lams()
        res = spawn_ranks(_ranks, 4, (lams, str(ckpt)), backend="gloo",
                          device="cpu", timeout_s=DEADLINE_S, threads=2)
        return res, lams, ckpt, params
    finally:
        torch.set_num_threads(old)


def _rows(res, key):
    """The data ranks' rows of a batch-sharded result (ranks 0 and 2 hold
    data ranks 0 and 1), concatenated."""
    return np.concatenate([res[0][key], res[2][key]], axis=0)


@pytest.mark.parametrize("g", [3, 2])
@pytest.mark.parametrize("extra", [False, True])
def test_sharded_decode_matches_one_process_and_jax(dist, g, extra):
    from repro_torch.models import attention as A
    res = dist[0]
    q, k, v, valid, kx, vx = _decode_cases()[g]
    got = _rows(res, f"decode/{g}/{extra}")
    want = A.attn_decode(q, {"k": k, "v": v}, valid, torch.float32,
                         extra_kv=(kx, vx) if extra else None).numpy()
    np.testing.assert_allclose(got, want, atol=DECODE_TOL)
    for r in (1, 3):      # the model ranks' copies agree
        np.testing.assert_array_equal(
            res[r][f"decode/{g}/{extra}"], res[r - 1][f"decode/{g}/{extra}"])
    if not extra:
        import jax.numpy as jnp
        from repro.models.attention import _decode_core
        qg = q.reshape(4, 2, g, 64)
        jout = _decode_core(*(jnp.asarray(t.numpy()) for t in
                              (qg, k, v, valid)))
        np.testing.assert_allclose(
            got, np.asarray(jout).reshape(4, 2 * g, 64), atol=DECODE_TOL)
        assert np.all(got[3] == 0)       # no valid position, no token


def _close(got, want, tol, floor=0.0):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.abs(got - want).max() <= tol * np.abs(want).max() + floor


def test_moe_ep_without_drops_matches_dense(dist):
    from repro_torch.models import moe
    res = dist[0]
    cfg, _, params, x = _moe_inputs(8.0)
    for t in params.values():
        t.requires_grad_(True)
    xr = x.clone().requires_grad_(True)
    y = moe.moe_dense(params, xr, cfg)
    aux = sum(moe.moe_block(params, xr[h * 2:(h + 1) * 2], cfg)[1]
              for h in range(2)) / 2
    loss = torch.sum(y.float() ** 2) + aux
    grads = torch.autograd.grad(loss, [xr] + list(params.values()))
    _close(np.concatenate([res[0]["moe/8.0"]["y"], res[2]["moe/8.0"]["y"]]),
           y.detach(), MOE_TOL)
    np.testing.assert_allclose(res[0]["moe/8.0"]["aux"], float(aux.detach()),
                               rtol=RTOL_LOSS)
    _close(np.concatenate([res[0]["moe/8.0"]["gx"], res[2]["moe/8.0"]["gx"]]),
           grads[0], MOE_TOL)
    for name, g in zip(params, grads[1:]):
        _close(res[0]["moe/8.0"]["grads"][name], g, MOE_TOL)


def test_moe_ep_with_drops_matches_jax_moe_ep(dist):
    from repro_torch.models import moe
    res = dist[0]
    cfg, tree, params, x = _moe_inputs(1.25)
    got = np.concatenate([res[0]["moe/1.25"]["y"], res[2]["moe/1.25"]["y"]])
    dense = moe.moe_dense(params, x, cfg).numpy()
    assert np.abs(got - dense).max() > 1e-3      # tokens were dropped
    # the only ties in a rank's selection are the -1.0 fillers: no two
    # routed tokens of a data half share a gate for one expert
    for h in range(2):
        xt = x[h * 2:(h + 1) * 2].reshape(-1, cfg.d_model)
        _, _, gates, idx = moe._router(params, xt, cfg)
        for e in range(cfg.moe.n_experts):
            sc = gates[idx == e]
            assert len(torch.unique(sc)) == len(sc)
    code = textwrap.dedent(f"""
    import dataclasses, sys, numpy as np, jax, jax.numpy as jnp
    from repro.configs import get_config
    from repro.models import moe as M
    from repro.parallel import ParallelContext, use_parallel
    cfg = get_config("granite-moe-1b-a400m").reduced()
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=1.25))
    data = np.load(sys.argv[1])
    params = {{k: jnp.asarray(data[k]) for k in
              ("router", "w_gate", "w_up", "w_down")}}
    mesh = jax.make_mesh((2, 2), ("data", "model"))
    ctx = ParallelContext(mesh=mesh, rules={{"batch": ("data",)}},
                          data_axes=("data",), model_axis="model",
                          ep_moe=True)
    with use_parallel(ctx):
        y, aux = jax.jit(lambda p, x: M.moe_ep(p, x, cfg, ctx))(
            params, jnp.asarray(data["x"]))
    np.save(sys.argv[2], np.asarray(y, np.float32))
    """)
    tmp = dist[2]
    np.savez(tmp / "moe.npz", x=x.numpy(), **tree)
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    proc = subprocess.run([sys.executable, "-c", code, str(tmp / "moe.npz"),
                           str(tmp / "moe_y.npy")], capture_output=True,
                          text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr
    _close(got, np.load(tmp / "moe_y.npy"), MOE_TOL)


def _one_process(arch):
    """The one-process port's and JAX's loss and gradients, each the mean
    over the two data halves."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as j_get_config
    from repro.models import build as j_build
    from repro_torch.launch.train import loss_and_grads
    from repro_torch.optim.adam import tree_map
    model, tree, params, batch = _train_inputs(arch)
    jcfg = j_get_config(arch).reduced()
    if jcfg.moe is not None:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
            jcfg.moe, capacity_factor=8.0))
    jmodel = j_build(jcfg)
    jparams = jax.tree.map(jnp.asarray, tree)
    vg = jax.jit(jax.value_and_grad(lambda p, b: jmodel.loss(p, b)[0]))
    loss, jloss, grads, jgrads = 0.0, 0.0, None, None
    for half in _halves(batch):
        l, _, g = loss_and_grads(model, params, half)
        jl, jg = vg(jparams, {k: jnp.asarray(v.numpy())
                              for k, v in half.items()})
        loss += float(l) / 2
        jloss += float(jl) / 2
        grads = g if grads is None else tree_map(lambda a, b: (a + b) / 2,
                                                 grads, g)
        jg = _flat(jax.tree.map(np.asarray, jg))
        jgrads = jg if jgrads is None else {k: (jgrads[k] + jg[k]) / 2
                                            for k in jg}
    return loss, jloss, _flat(grads), jgrads


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_train_step_matches_one_process_and_jax(dist, arch):
    out = dist[0][0][f"train/{arch}"]
    assert out["remat"] and out["attn_impl"] == "blockwise"
    from repro_torch.optim import Adam
    from repro_torch.optim.adam import global_norm, tree_map
    loss, jloss, grads, jgrads = _one_process(arch)
    np.testing.assert_allclose(float(out["loss"]), loss, rtol=RTOL_LOSS)
    np.testing.assert_allclose(float(out["loss"]), jloss, rtol=RTOL_LOSS)
    for remat in (True, False):
        got = _flat(out[f"grads/{remat}"])
        assert set(got) == set(grads) == set(jgrads)
        for key, g in got.items():
            _close(g, grads[key], GRAD_TOL, GRAD_FLOOR)
            _close(g, jgrads[key], GRAD_TOL, GRAD_FLOOR)
    # the sharded Adam step (the clip's norm over the shards, the moments
    # sharded) against one-process Adam on the same, gathered gradients
    # (Adam's first step lr * g / (|g| + eps) magnifies a gradient's
    # rounding where |g| is near eps; the gradients are held above)
    _, _, params, _ = _train_inputs(arch)
    g_sh = tree_map(torch.from_numpy, out["grads/True"])
    assert float(global_norm(g_sh)) > CLIP_NORM
    opt = Adam(lr=1e-3, clip_norm=CLIP_NORM)
    upd, _ = opt.update(g_sh, opt.init(params), params)
    after = _flat(tree_map(lambda p, u: p + u, params, upd))
    for key, p in _flat(out["params"]).items():
        assert np.abs(p - after[key]).max() <= PARAM_TOL, key
    # every rank holds the same loss
    for r in range(1, 4):
        assert float(dist[0][r][f"train/{arch}"]["loss"]) == \
            float(out["loss"])


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_sharded_serve_step_matches_one_process(dist, arch):
    res, lams = dist[0], dist[1]
    model, params, pc, theta, toks = _serve_setup(arch)
    tk, sm, sp = _serve(model, params, pc, theta, lams[arch], toks)
    for r, rows in ((0, slice(0, 2)), (1, slice(0, 2)), (2, slice(2, 4)),
                    (3, slice(2, 4))):
        gtk, gsm, gsp = res[r][f"serve/{arch}"]
        np.testing.assert_array_equal(gtk, tk[:, rows].numpy())
        np.testing.assert_array_equal(gsp, sp[:, rows].numpy())
        np.testing.assert_allclose(gsm, sm[:, rows].numpy(), atol=SMOOTH_TOL)
    assert sp[-1].any() and not sp[-1].all()      # some rows stop
    stats = res[0][f"serve/{arch}/collectives"]
    assert stats["model/all_reduce_max"]["calls"] > 0   # the merge ran


def test_checkpoints_cross_between_mesh_and_one_process(dist):
    from repro_torch.checkpoint import restore
    res, _, ckpt, params = dist
    assert all(bool(r["restore_bitwise"]) for r in res)
    back = restore(params, str(ckpt / "mesh" / "step_3"))
    for a, b in zip(_flat(back).values(), _flat(params).values()):
        np.testing.assert_array_equal(a, b)
