"""K5's plain version (the offline TTT scan, ``kernels/ttt_scan.py``) held
to the JAX package's Pallas ``ttt_probe_batched``/``ttt_probe_scan``
(interpret mode) and to its jnp oracle ``kernels/ref.py:37``, on the same
numpy-made inputs; plus the ``core.ttt`` ``kernel=`` plumbing and the
wrapper's refusals."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.ttt_probe import ttt_probe_batched as j_batched
from repro.kernels.ttt_probe import ttt_probe_scan as j_scan

from repro_torch.core import ttt
from repro_torch.core.probe import ProbeConfig, init_outer
from repro_torch.kernels import ttt_scan

# scores, W_f, b_f: f32 sums in another order than XLA's, over up to 130
# dependent steps
ATOL = 2e-5


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _inputs(n, T, f, seed, *, labels=False, shared=False):
    """Ragged masks from a length vector (as ``generate`` makes them), a
    distinct or shared init, and c = 0 or 0/1 labels (the "true" inner
    label mode)."""
    rng = np.random.default_rng(seed)
    zq = rng.standard_normal((n, T, f)).astype(np.float32)
    zk = rng.standard_normal((n, T, f)).astype(np.float32)
    lengths = rng.integers(1, T + 1, n)
    lengths[0] = T
    m = (np.arange(T)[None, :] < lengths[:, None]).astype(np.float32)
    c = ((rng.random((n, T)) < 0.4).astype(np.float32) * m if labels
         else np.zeros((n, T), np.float32))
    if shared:
        w0 = (rng.standard_normal(f) / np.sqrt(f)).astype(np.float32)
        b0 = np.float32(0.3)
    else:
        w0 = (rng.standard_normal((n, f)) / np.sqrt(f)).astype(np.float32)
        b0 = rng.uniform(-1, 1, n).astype(np.float32)
    eta = np.float32(0.05)
    return zq, zk, c, m, w0, b0, eta


def _port(fn, args):
    return [t.numpy() for t in fn(*[torch.as_tensor(a) for a in args])]


def _close(port, refs):
    for ref in refs:
        for a, b, name in zip(port, ref, ("scores", "W_f", "b_f")):
            np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=ATOL,
                                       err_msg=name)


@pytest.mark.parametrize("n,T,f,labels", [
    (3, 37, 24, False),      # ragged masks, deployed mode (c = 0)
    (3, 37, 24, True),       # c = labels
    (2, 1, 16, True),        # T = 1
    (2, 130, 8, False),      # T not a multiple of the Pallas t_chunk 128
])
def test_batched_plain_matches_pallas_and_ref(n, T, f, labels):
    args = _inputs(n, T, f, seed=T, labels=labels)
    port = _port(ttt_scan.ttt_probe_batched, args)
    ja = [jnp.asarray(a) for a in args]
    _close(port, [j_batched(*ja, interpret=True),
                  jref.ttt_probe_batched_ref(*ja)])
    assert port[0].shape == (n, T)


@pytest.mark.parametrize("labels", [False, True])
def test_scan_shared_init_matches_pallas_and_ref(labels):
    args = _inputs(4, 21, 32, seed=5, labels=labels, shared=True)
    port = _port(ttt_scan.ttt_probe_scan, args)
    ja = [jnp.asarray(a) for a in args]
    _close(port, [j_scan(*ja, interpret=True), jref.ttt_probe_ref(*ja)])


def test_masked_steps_score_but_do_not_update():
    """A step with m = 0 still emits its score and leaves (W, b) alone: an
    all-masked trajectory ends where it started."""
    zq, zk, c, _, w0, b0, eta = _inputs(2, 9, 16, seed=1, labels=True)
    m = np.zeros((2, 9), np.float32)
    s, wf, bf = _port(ttt_scan.ttt_probe_batched, (zq, zk, c, m, w0, b0, eta))
    np.testing.assert_array_equal(wf, w0)
    np.testing.assert_array_equal(bf, b0)
    want = 1.0 / (1.0 + np.exp(-(np.einsum("ntf,nf->nt", zq, w0)
                                 + b0[:, None])))
    np.testing.assert_allclose(s, want, rtol=0, atol=1e-6)


def _theta(pc, seed=0):
    return init_outer(pc, torch.Generator().manual_seed(seed), "cpu")


def test_inner_unroll_kernel_equals_the_loop():
    """The adapter is a drop-in for the core inner loop (as the JAX
    package's ``test_ttt_kernel_plugs_into_core_unroll``)."""
    pc = ProbeConfig(d_phi=32, variant="qk", d_h=16)
    theta = _theta(pc)
    rng = np.random.default_rng(2)
    phis = torch.as_tensor(rng.standard_normal((20, 32)).astype(np.float32))
    labels = torch.as_tensor((rng.random(20) < 0.5).astype(np.float32))
    mask = torch.arange(20) < 15
    loop = ttt.inner_unroll(pc, theta, phis, labels, mask)
    kern = ttt.inner_unroll(pc, theta, phis, labels, mask,
                            kernel=ttt_scan.make_unroll_kernel())
    np.testing.assert_allclose(kern.scores.numpy(), loop.scores.numpy(),
                               rtol=0, atol=1e-6)
    for a, b in zip(kern.fast_final, loop.fast_final):
        np.testing.assert_allclose(a.numpy(), b.detach().numpy(), rtol=0,
                                   atol=1e-6)
    phis_b = phis[None].repeat(3, 1, 1)
    np.testing.assert_allclose(
        ttt.deployed_scores(pc, theta, phis_b,
                            kernel=ttt_scan.make_unroll_kernel()).numpy(),
        ttt.deployed_scores(pc, theta, phis_b).numpy(), rtol=0, atol=1e-6)


def test_other_devices_never_take_the_plain_version():
    """Only CPU tensors take the plain version: the meta device, which has
    no kernel, raises."""
    args = [torch.as_tensor(a, device="meta")
            for a in _inputs(2, 4, 8, seed=0)]
    for fn in (ttt_scan.ttt_probe_batched, ttt_scan.ttt_probe_scan):
        with pytest.raises(RuntimeError, match="no kernel for device"):
            fn(*args)


def test_forward_only_refuses_grad_on_every_device():
    args = [torch.as_tensor(a) for a in _inputs(2, 4, 8, seed=0)]
    args[4].requires_grad_(True)
    with pytest.raises(RuntimeError, match="forward only"):
        ttt_scan.ttt_probe_batched(*args)
    pc = ProbeConfig(d_phi=8)
    theta = {k: v.requires_grad_(True) for k, v in _theta(pc).items()}
    with pytest.raises(RuntimeError, match="forward only"):
        ttt.inner_unroll(pc, theta, args[0][0],
                         kernel=ttt_scan.make_unroll_kernel())
    # the label-free deployed pass detaches the slow weights itself
    s = ttt.deployed_scores(pc, theta, args[0])
    assert not s.requires_grad and s.shape == (2, 4)
