"""Training held to the JAX package on the CPU: every family's
``Model.forward`` and ``Model.loss`` and their gradients against JAX's
``value_and_grad``, one Adam step under ``cosine_schedule``, and four
``make_train_step`` steps of the reduced smollm-360m against JAX's jitted
train step.

Each case draws one set of parameters with numpy from a seed, by JAX's
declarations (``_numpy_params``: ones, zeros and normals at JAX's
standard deviations, every leaf of two or more axes scaled by
``WEIGHT_SCALE``), gives them to JAX and, as float32 masters
(``from_jax_params(..., dtype="float32")``, the trainer's form), to the
port, and feeds both JAX's ``make_batch`` batch through numpy, at
``.reduced()`` (float32).  JAX's init draws the reduced stacks' matrices at std 1/sqrt(2) (the
fan-in rule reads the stacked layer axis), where attention saturates and
f32 rounding is amplified: there JAX's own jitted and eager gradients
differ by up to 1.3e-4 of a leaf's largest magnitude (the reduced
smollm-360m) and the port's by 6e-4; at half that scale a 1e-7 relative
change of whisper's parameters still moves its gradients by 3e-4.  At a
quarter every family's port sits within 7e-6 of JAX, as far as that
1e-7 change moves it, so the bounds below measure the port and not the
conditioning.
Tolerances: the loss, xent and aux within 1e-5 relative; every gradient
leaf within 1e-4 of that leaf's largest magnitude (sums in another order
than XLA's), plus 1e-8 for a leaf whose gradient is zero in exact
arithmetic (whisper's key biases: a softmax row does not move under a
shift), which holds only rounding near 1e-9; two Adam steps fed the same
gradients in both packages (JAX's, then a draw of global norm 4 that the
clip scales, so the moments mix two gradients), each update within 1e-5
relative (elementwise, or of the leaf's largest update where the moments
cancel) and the parameters after it within 1e-5 (on each package's own
gradients Adam's first step is lr * sign(g), and a gradient within
rounding of zero may take either sign: the four trainer steps hold the
port's own updates end to end); the four steps' losses within 1e-4."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import InputShape as JInputShape
from repro.configs import get_config as j_get_config
from repro.data import TokenPipeline as JTokenPipeline
from repro.data import TokenPipelineConfig as JTokenPipelineConfig
from repro.launch.train import make_train_step as j_make_train_step
from repro.models import build as j_build
from repro.optim import Adam as JAdam
from repro.optim import cosine_schedule as j_cosine_schedule

from repro_torch.configs import get_config
from repro_torch.launch.train import make_train_step
from repro_torch.models import build
from repro_torch.models.convert import from_jax_params
from repro_torch.optim import Adam, cosine_schedule
from repro_torch.optim.adam import tree_leaves

ARCHS = ("smollm-360m", "stablelm-3b", "granite-moe-1b-a400m",
         "llava-next-34b", "hymba-1.5b", "rwkv6-1.6b", "whisper-tiny")
B, S = 2, 32          # the model's sequence: the VLM's 16 patches and
                      # hymba's 8 meta tokens take part of it
RTOL_LOSS = 1e-5
GRAD_TOL = 1e-4       # of each leaf's largest magnitude
GRAD_FLOOR = 1e-8
PARAM_TOL = 1e-5
UPDATE_RTOL = 1e-5
CLIP_DRAW_NORM = 4.0  # above the clip norm of 1.0
STEP_LOSS_TOL = 1e-4
LR, WARMUP, TOTAL = 3e-4, 20, 100   # the CLI's defaults
WEIGHT_SCALE = 0.25


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
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree.detach() if isinstance(
        tree, torch.Tensor) else tree, dtype=np.float64)}


def _numpy_params(decls, rng):
    """A parameter tree drawn by JAX's declarations (``Param``'s init and
    scale, the fan-in rule of ``repro.models.common._leaf_init``) with
    numpy, float32."""
    if isinstance(decls, dict):
        return {k: _numpy_params(v, rng) for k, v in decls.items()}
    shape = decls.shape
    if decls.init in ("zeros", "ones"):
        return np.full(shape, decls.init == "ones", np.float32)
    if decls.init == "normal":
        fan_in = shape[0] if len(shape) >= 2 else max(shape[-1], 1)
        std = decls.scale / np.sqrt(fan_in)
    else:                                       # embed | small
        std = 0.02 * decls.scale
    if len(shape) >= 2:
        std *= WEIGHT_SCALE
    return (rng.standard_normal(shape) * std).astype(np.float32)


def _pair(arch):
    jmodel = j_build(j_get_config(arch).reduced())
    tree = _numpy_params(jmodel.decls, np.random.default_rng(0))
    model = build(get_config(arch).reduced())
    params = from_jax_params(tree, model, device="cpu", dtype="float32")
    return jmodel, jax.tree.map(jnp.asarray, tree), model, params


def _grads(model, params, batch):
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss, metrics = model.loss(params, batch)
    grads = torch.autograd.grad(loss, leaves)
    for p in leaves:
        p.requires_grad_(False)
    it = iter(grads)
    return loss, metrics, {k: next(it) for k in _flat(params)}


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_grads_and_adam_step_match_jax(arch):
    jmodel, jparams, model, params = _pair(arch)
    jbatch = jmodel.make_batch(jax.random.PRNGKey(1),
                               JInputShape("t", S, B, "train"))
    batch = {k: torch.from_numpy(np.array(v)) for k, v in jbatch.items()}
    jopt = JAdam(lr=j_cosine_schedule(LR, WARMUP, TOTAL), clip_norm=1.0)

    def jax_side(p):
        (loss, met), grads = jax.value_and_grad(
            lambda q: jmodel.loss(q, jbatch), has_aux=True)(p)
        upd, _ = jopt.update(grads, jopt.init(p), p)
        return loss, met, grads, upd

    jloss, jmet, jgrads, jupd = jax.jit(jax_side)(jparams)
    loss, met, grads = _grads(model, params, batch)
    for got, want in ((loss, jloss), (met["xent"], jmet["xent"]),
                      (met["aux"], jmet["aux"])):
        np.testing.assert_allclose(float(got.detach()), float(want),
                                   rtol=RTOL_LOSS)
    if model.cfg.moe is not None:
        assert float(met["aux"].detach()) > 0   # the routers' sum is there
    jflat = _flat(jax.tree.map(np.asarray, jgrads))
    assert set(jflat) == set(grads)
    for key, want in jflat.items():
        got = grads[key].double().numpy()
        scale = np.abs(want).max()
        assert scale > 0, key
        err = np.abs(got - want).max()
        assert err <= GRAD_TOL * scale + GRAD_FLOOR, (key, err, scale)
    # two Adam steps under the schedule on the same gradients in both
    # packages: JAX's, then a draw whose global norm is CLIP_DRAW_NORM (the
    # clip scales it, and the moments mix the two)
    jopt_state = jopt.init(jparams)
    opt = Adam(lr=cosine_schedule(LR, WARMUP, TOTAL), clip_norm=1.0)
    state = opt.init(params)
    rng = np.random.default_rng(2)
    draw = jax.tree.map(lambda g: rng.standard_normal(g.shape).astype(
        np.float32), jgrads)
    norm = np.sqrt(sum(np.sum(np.square(g, dtype=np.float64))
                       for g in jax.tree.leaves(draw)))
    draw = jax.tree.map(lambda g: g * np.float32(CLIP_DRAW_NORM / norm),
                        draw)
    jp, p = jparams, params
    for n, jg in enumerate((jgrads, jax.tree.map(jnp.asarray, draw)), 1):
        jupd, jopt_state = jax.jit(jopt.update)(jg, jopt_state, jp)
        jp = jax.tree.map(lambda q, u: q + u, jp, jupd)
        tgrads = from_jax_params(jax.tree.map(np.asarray, jg), model,
                                 device="cpu", dtype="float32")
        upd, state = opt.update(tgrads, state, p)
        assert state.step == n
        p = _apply(p, upd)
        got_u, want_u = _flat(upd), _flat(jax.tree.map(np.asarray, jupd))
        got_p, want_p = _flat(p), _flat(jax.tree.map(np.asarray, jp))
        for key, want in want_u.items():
            np.testing.assert_allclose(
                got_u[key], want, rtol=UPDATE_RTOL,
                atol=UPDATE_RTOL * np.abs(want).max(),
                err_msg=f"step {n} update {key}")
            np.testing.assert_allclose(got_p[key], want_p[key], rtol=0,
                                       atol=PARAM_TOL,
                                       err_msg=f"step {n} param {key}")


def _apply(params, updates):
    if isinstance(params, dict):
        return {k: _apply(params[k], updates[k]) for k in params}
    return params + updates


def test_train_steps_match_jax_losses():
    """Four trainer steps of the reduced smollm-360m on the token
    pipeline's batches: the port's ``make_train_step`` against JAX's."""
    jmodel, jparams, model, params = _pair("smollm-360m")
    pipe = JTokenPipeline(JTokenPipelineConfig(
        vocab_size=jmodel.cfg.vocab_size, seq_len=S, global_batch=B,
        seed=0))
    jopt = JAdam(lr=j_cosine_schedule(LR, 2, 4), clip_norm=1.0)
    opt = Adam(lr=cosine_schedule(LR, 2, 4), clip_norm=1.0)
    jstep = j_make_train_step(jmodel, jopt)
    step = make_train_step(model, opt)
    jstate, state = jopt.init(jparams), opt.init(params)
    jlosses, losses = [], []
    for i in range(4):
        batch = pipe.batch(i)
        jparams, jstate, jloss, _ = jstep(
            jparams, jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        params, state, loss, met = step(
            params, state, {k: torch.from_numpy(v.copy())
                            for k, v in batch.items()})
        jlosses.append(float(jloss))
        losses.append(float(loss))
        assert float(met["aux"]) == 0.0
    np.testing.assert_allclose(losses, jlosses, rtol=0, atol=STEP_LOSS_TOL)
    assert all(not p.requires_grad for p in tree_leaves(params))
