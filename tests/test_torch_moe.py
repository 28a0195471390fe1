"""The port's MoE block (``repro_torch.models.moe``) held to the JAX
package's ``repro.models.moe`` on the same numpy inputs, f32 on the CPU,
at granite-moe-1b's routing (32 experts, top-8) and phi3.5-moe's (16
experts, top-2) at a narrow width (d 64, d_ff 32, 40 tokens):

* ``_router``: the expert sets of every token equal, the gates and the
  probabilities within f32 rounding, and ``router_aux`` (load balance
  plus z-loss) against the aux loss JAX's router returns;
* ``moe_dense`` against JAX's ``moe_block`` (its outputs, the aux loss
  beside them through ``router_aux``); and in bf16, the port's order of
  precision (experts in bf16, the gates' combine in f32, one cast back)
  against JAX's bf16 block;
* ``from_jax_params`` on an MoE tree and ``Model.init`` keep the router
  float32 when the rest goes to bf16;
* the reduced granite-moe-1b and phi3.5-moe (2 layers, 4 experts, top-2)
  through the tree verify pass, dense and paged (the body of
  ``test_torch_tree.py``'s case run on them; the linear verify pass is
  the packed chunk with the LM head kept); their prefill, decode,
  chunks and fleets run in
  ``test_torch_model.py``, ``test_torch_chunked.py`` and
  ``test_torch_serve.py``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import build as j_build
from repro.models import moe as jmoe

from repro_torch.configs import get_config
from repro_torch.models import build
from repro_torch.models import moe as tmoe
from repro_torch.models.convert import from_jax_params
from tests import test_torch_tree as tree_tests
from tests.test_torch_serve import _models

MOE_ARCHS = ("granite-moe-1b-a400m", "phi3.5-moe-42b-a6.6b")
D, F, T = 64, 32, 40
# f32 on both sides, summed in another order: gates and probabilities are
# O(1), the outputs O(1) at these draws
ATOL = 2e-6
ATOL_OUT = 5e-6
# bf16: the two packages' bf16 products round alike but for the odd entry;
# at most this share of the outputs differs, each by at most one bf16 ulp
# (2^-7 of its value).  A bf16 combine of the gates in place of the f32
# one moves about 40% of them
BF16_SHARE = 0.01
BF16_RTOL = 2.0 ** -7
# the tree verify's logits, hidden states and K/V relative to the largest:
# twice the dense cases' 2e-5.  The reduced MoE stacks draw their experts
# at std 1/sqrt(L) (the fan-in rule reads the stacked layer axis) and sum
# k expert outputs a token, so their f32 rounding runs larger; the worst
# entry seen is 2.0e-5 of the largest (phi3.5-moe's logits)
RTOL_MOE = 4e-5


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _cfgs(arch):
    """Both packages' config of ``arch`` at the narrow width, with the
    full config's routing."""
    full, jfull = get_config(arch), j_get_config(arch)
    cfg = dataclasses.replace(full.reduced(), d_model=D, d_ff=F,
                              moe=full.moe)
    jcfg = dataclasses.replace(jfull.reduced(), d_model=D, d_ff=F,
                               moe=jfull.moe)
    return jcfg, cfg


def _inputs(cfg, seed=0):
    """Router and expert weights and 2 x 20 tokens: the router drawn wide
    enough that the top-k gates are far from uniform."""
    rng = np.random.default_rng(seed)
    E = cfg.moe.n_experts
    p = {"router": rng.standard_normal((D, E)) * 0.15,
         "w_gate": rng.standard_normal((E, D, F)) / 8,
         "w_up": rng.standard_normal((E, D, F)) / 8,
         "w_down": rng.standard_normal((E, F, D)) / 6}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.standard_normal((2, T // 2, D)).astype(np.float32)
    return p, x


def _both(p, x, dtype):
    """The inputs in both packages, the experts and x in ``dtype`` (the
    router stays f32, as the models keep it)."""
    jdt = {"f32": jnp.float32, "bf16": jnp.bfloat16}[dtype]
    tdt = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype]
    jp = {k: jnp.asarray(v) if k == "router" else jnp.asarray(v).astype(jdt)
          for k, v in p.items()}
    tp = {k: torch.from_numpy(v) if k == "router"
          else torch.from_numpy(v).to(tdt) for k, v in p.items()}
    return (jp, jnp.asarray(x).astype(jdt)), (tp, torch.from_numpy(x).to(tdt))


def _gate_matrix(idx, gates, E):
    """(T, E) with each token's gates at its experts."""
    out = np.zeros((idx.shape[0], E), np.float32)
    np.put_along_axis(out, np.asarray(idx), np.asarray(gates), axis=1)
    return out


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_router_matches_jax(arch):
    jcfg, cfg = _cfgs(arch)
    p, x = _inputs(cfg)
    (jp, jx), (tp, tx) = _both(p, x, "f32")
    jprobs, jgates, jidx, jaux = jmoe._router(jp, jx.reshape(T, D), jcfg)
    logits, probs, gates, idx = tmoe._router(tp, tx.reshape(T, D), cfg)
    aux = tmoe.router_aux(logits, probs, idx, cfg)
    E, k = cfg.moe.n_experts, cfg.moe.top_k
    assert idx.shape == (T, k) and gates.dtype == torch.float32
    # the same experts for every token, in the same order
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(
        _gate_matrix(idx.numpy(), gates.numpy(), E),
        _gate_matrix(np.asarray(jidx), np.asarray(jgates), E), rtol=0,
        atol=ATOL)
    np.testing.assert_allclose(gates.sum(-1).numpy(), 1.0, rtol=0, atol=ATOL)
    np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6, atol=0)
    # the draws route: every expert is someone's choice, gates not uniform
    assert len(np.unique(idx.numpy())) == E
    assert float(gates.max() - gates.min()) > 0.1 / k


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_dense_matches_jax(arch):
    jcfg, cfg = _cfgs(arch)
    p, x = _inputs(cfg, seed=1)
    (jp, jx), (tp, tx) = _both(p, x, "f32")
    jy, jaux = jmoe.moe_block(jp, jx, jcfg)
    y = tmoe.moe_dense(tp, tx, cfg)
    logits, probs, _, idx = tmoe._router(tp, tx.reshape(T, D), cfg)
    aux = tmoe.router_aux(logits, probs, idx, cfg)
    assert y.shape == x.shape and y.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0,
                               atol=ATOL_OUT)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6, atol=0)
    # the gates pick: the output is not every expert's mean
    ye = tmoe._expert_ffn(tp["w_gate"], tp["w_up"], tp["w_down"],
                          tx.reshape(T, D)).mean(0)
    assert float((y.reshape(T, D) - ye).abs().max()) > 0.1


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_dense_bf16_keeps_the_precision_order(arch):
    """x and the experts in bf16 (the router f32): the experts run in bf16,
    the gates combine their outputs in f32, the sum is cast back, as
    JAX's bf16 block does."""
    jcfg, cfg = _cfgs(arch)
    p, x = _inputs(cfg, seed=2)
    (jp, jx), (tp, tx) = _both(p, x, "bf16")
    jy, _ = jmoe.moe_dense(jp, jx, jcfg)
    y = tmoe.moe_dense(tp, tx, cfg)
    assert y.dtype == torch.bfloat16
    got = y.float().numpy()
    want = np.asarray(jy.astype(jnp.float32))
    diff = np.abs(got - want)
    assert (diff > 0).mean() <= BF16_SHARE, (diff > 0).mean()
    assert (diff <= BF16_RTOL * np.abs(want)).all(), diff.max()


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_from_jax_params_keeps_the_router_float32(arch):
    """The reduced model in bf16: the router leaf (L, d, E) arrives and is
    drawn float32, the experts (L, E, d, f) and (L, E, f, d) in bf16, each
    leaf equal to JAX's rounded once."""
    jcfg = dataclasses.replace(j_get_config(arch).reduced(), dtype="bfloat16")
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="bfloat16")
    jparams = j_build(jcfg).init(jax.random.PRNGKey(0))
    model = build(cfg)
    params = from_jax_params(jax.tree.map(np.asarray, jparams), model,
                             device="cpu")
    mlp, jmlp = params["layers"]["mlp"], jparams["layers"]["mlp"]
    L, d, f, E = cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.moe.n_experts
    assert set(mlp) == {"router", "w_gate", "w_up", "w_down"}
    assert mlp["router"].shape == (L, d, E)
    assert mlp["router"].dtype == torch.float32
    np.testing.assert_array_equal(mlp["router"].numpy(),
                                  np.asarray(jmlp["router"], np.float32))
    for name, shape in (("w_gate", (L, E, d, f)), ("w_up", (L, E, d, f)),
                        ("w_down", (L, E, f, d))):
        assert mlp[name].shape == shape and mlp[name].dtype == torch.bfloat16
        np.testing.assert_array_equal(
            mlp[name].float().numpy(),
            np.asarray(jnp.asarray(jmlp[name]).astype(jnp.bfloat16)
                       .astype(jnp.float32)))
    drawn = model.init(torch.Generator().manual_seed(0), "cpu")
    assert drawn["layers"]["mlp"]["router"].dtype == torch.float32
    assert drawn["layers"]["mlp"]["w_down"].dtype == torch.bfloat16
    # the router at the JAX "small" init (0.02), the experts at the fan-in
    # rule read from the stacked layer axis (1 / sqrt(L))
    assert abs(float(drawn["layers"]["mlp"]["router"].std()) - 0.02) < 0.002
    assert abs(float(drawn["layers"]["mlp"]["w_up"].float().std())
               - L ** -0.5) < 0.02


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_verify_packed_tree_matches_jax(monkeypatch, arch, paged):
    """The tree verify pass (test_torch_tree.py's case) on the reduced MoE
    model: logits and hidden states of every node, the chunk's K/V, the
    cache untouched."""
    monkeypatch.setattr(tree_tests, "RTOL_KV", RTOL_MOE)
    tree_tests.test_verify_packed_tree_matches_jax(
        monkeypatch, _models(None, arch), paged)
