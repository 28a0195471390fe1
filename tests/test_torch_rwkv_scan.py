"""K8's plain version (the RWKV6 WKV recurrence, ``kernels/rwkv6_scan.py``)
held to the JAX package's Pallas ``wkv_scan`` (interpret mode) and to its
oracle ``kernels/ref.py:232 wkv_scan_ref``, on the same numpy-made inputs;
the state carried across calls, the in-place state update, the model's
``wkv_scan`` and the wrapper's refusals."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.rwkv6_scan import wkv_scan as j_wkv_scan

from repro_torch.kernels import rwkv6_scan as K8
from repro_torch.models import rwkv6

# out and state: f32 sums of d = 32 products in another order than XLA's,
# over up to 37 dependent steps; relative to the largest |value|
RTOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _inputs(B, T, H, d, seed, *, s0_zero=False):
    """r, k, v ~ N(0, 1); w in (0, 1) through the model's exp(-exp(.));
    u small; s0 zero or random."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, T, H, d)).astype(np.float32)
               for _ in range(3))
    w = np.exp(-np.exp(rng.standard_normal((B, T, H, d)) * 0.5)
               ).astype(np.float32)
    u = (rng.standard_normal((H, d)) * 0.5).astype(np.float32)
    s0 = (np.zeros((B, H, d, d), np.float32) if s0_zero
          else rng.standard_normal((B, H, d, d)).astype(np.float32))
    return r, k, v, w, u, s0


def _close(got, want):
    for a, b, name in zip(got, want, ("out", "state")):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=RTOL * np.abs(b).max(), err_msg=name)


def _port(fn, args, **kw):
    return [t.numpy() for t in fn(*[torch.as_tensor(a) for a in args], **kw)]


@pytest.mark.parametrize("T,s0_zero", [(1, False), (16, True), (16, False),
                                       (37, False)])
def test_plain_matches_pallas_and_ref(T, s0_zero):
    """T 37 pads the Pallas side's last chunk of 16 with w = 1."""
    args = _inputs(2, T, 3, 32, seed=T, s0_zero=s0_zero)
    port = _port(K8.wkv_scan, args)
    ja = [jnp.asarray(a) for a in args]
    _close(port, j_wkv_scan(*ja, ct=16, interpret=True))
    _close(port, jref.wkv_scan_ref(*ja))
    assert port[0].shape == (2, T, 3, 32)


def test_state_carried_across_two_calls_equals_one_call():
    r, k, v, w, u, s0 = _inputs(2, 37, 3, 32, seed=5)
    one = _port(K8.wkv_scan, (r, k, v, w, u, s0))
    cut = 21
    first = _port(K8.wkv_scan, (r[:, :cut], k[:, :cut], v[:, :cut],
                                w[:, :cut], u, s0))
    second = _port(K8.wkv_scan, (r[:, cut:], k[:, cut:], v[:, cut:],
                                 w[:, cut:], u, first[1]))
    _close((np.concatenate([first[0], second[0]], axis=1), second[1]), one)
    # and the JAX oracle, split the same way
    ja = [jnp.asarray(a) for a in (r, k, v, w, u, s0)]
    _close((np.concatenate([first[0], second[0]], axis=1), second[1]),
           jref.wkv_scan_ref(*ja))


def test_state_out_updates_in_place():
    r, k, v, w, u, s0 = (torch.as_tensor(a)
                         for a in _inputs(2, 4, 3, 32, seed=9))
    want_out, want_s = K8.wkv_scan(r, k, v, w, u, s0.clone())
    state = s0.clone()
    out, got_s = K8.wkv_scan(r, k, v, w, u, state, state_out=state)
    assert got_s is state
    torch.testing.assert_close(out, want_out, rtol=0, atol=0)
    torch.testing.assert_close(state, want_s, rtol=0, atol=0)


def test_model_wkv_scan_casts_to_f32_and_matches_ref():
    """The model's ``wkv_scan`` takes bf16 r/k/v (the compute dtype) and
    casts every input to f32, as the Pallas kernel casts them."""
    r, k, v, w, u, s0 = _inputs(2, 5, 3, 32, seed=3)
    bf = lambda a: torch.as_tensor(a).to(torch.bfloat16)
    out, state = rwkv6.wkv_scan(bf(r), bf(k), bf(v), torch.as_tensor(w),
                                torch.as_tensor(u), torch.as_tensor(s0))
    assert out.dtype == torch.float32 and state.dtype == torch.float32
    rounded = [bf(a).float().numpy() for a in (r, k, v)]
    ja = [jnp.asarray(a) for a in (*rounded, w, u, s0)]
    _close((out.numpy(), state.numpy()), jref.wkv_scan_ref(*ja))


def test_refusals():
    r, k, v, w, u, s0 = (torch.as_tensor(a)
                         for a in _inputs(1, 2, 2, 32, seed=1))
    with pytest.raises(RuntimeError, match="forward only"):
        K8.wkv_scan(r.clone().requires_grad_(), k, v, w, u, s0)
    meta = [t.to("meta") for t in (r, k, v, w, u, s0)]
    before = K8.wkv_scan.launches
    with pytest.raises(RuntimeError, match="no kernel for device"):
        K8.wkv_scan(*meta)
    K8.wkv_scan(r, k, v, w, u, s0)               # the CPU: plain, uncounted
    assert K8.wkv_scan.launches == before


@pytest.mark.parametrize("bad", ["d", "dtype", "contiguous", "shape"])
def test_kernel_checks_refuse_what_it_does_not_take(bad):
    """The card's argument checks, run on CPU tensors: d other than 64
    (named with the config), a w that is not f32 (r, k and v may be bf16,
    one dtype for the three), non-contiguous or misshapen inputs."""
    d = 32 if bad == "d" else 64
    r, k, v, w, u, s0 = (torch.as_tensor(a)
                         for a in _inputs(1, 2, 2, d, seed=2))
    if bad == "dtype":
        bf = [t.to(torch.bfloat16) for t in (r, k, v)]
        K8._check(*bf, w, u, s0, s0)                # bf16 r, k, v: taken
        with pytest.raises(ValueError, match="expected torch.bfloat16"):
            K8._check(bf[0], k, bf[2], w, u, s0, s0)  # mixed: refused
        w = w.to(torch.bfloat16)
    elif bad == "contiguous":
        v = v.transpose(1, 2).contiguous().transpose(1, 2)
    elif bad == "shape":
        u = u[:1]
    match = {"d": "rwkv6-1.6b", "dtype": "expected torch.float32",
             "contiguous": "not contiguous", "shape": "expected torch.float32"}
    with pytest.raises(ValueError, match=match[bad]):
        K8._check(r, k, v, w, u, s0, s0)
