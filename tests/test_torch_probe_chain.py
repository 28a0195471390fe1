"""The serving probe chain shared by K1 and K4: the instance policy, the
wrapper's shared-view detection, the refusals of the card's checks, and
the plain versions at the widths phases k1 and k4 time, held to the JAX
package's jnp oracles (``repro/kernels/ref.py`` serving_probe_step_ref and
serving_probe_spec_step_ref) on the same numpy-made inputs."""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref

from repro_torch.kernels import probe_spec as K4
from repro_torch.kernels import probe_step as K1

# s, W, b, ring, smoothed: f32 sums over up to 5120 features in another
# order than XLA's (phase k4's K4_TOL)
ATOL = 1e-5
FLOATS = ("s", "W", "b", "ring", "smoothed")
EXACT = ("n_scores", "stopped", "stop_step")


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


# ---------------------------------------------------------------------------
# the instance policy

def _built_instances():
    """The (threads, features a thread, zq is zk) of every PROBE_INSTANCE
    line of csrc/probe_spec.cu."""
    src = (Path(K1.__file__).resolve().parent.parent / "csrc"
           / "probe_spec.cu").read_text()
    return {tuple(int(x) for x in m.group(1).split(","))
            for m in re.finditer(r"^\s*PROBE_INSTANCE\(([\d,\s]+)\)\s*$",
                                 src, re.M)}


@pytest.mark.parametrize("same", [True, False])
def test_every_width_maps_to_one_built_instance(same):
    """Every f from 1 to MAX_F takes the instance of the first band that
    holds it, one the source builds, whose threads and features a thread
    cover f; K4 reads K1's policy (K1 is K4 at T = 1)."""
    assert K4.instance is K1.instance
    built = _built_instances()
    assert K1.BANDS[-1].f_max == K1.MAX_F
    assert [b.f_max for b in K1.BANDS] == sorted(b.f_max for b in K1.BANDS)
    for f in range(1, K1.MAX_F + 1):
        fig = K1.instance(f, same, 4)
        band = next(b for b in K1.BANDS if f <= b.f_max)
        assert fig[:2] == (band.threads, band.fpt)
        assert fig[0] * fig[1] >= f
        assert fig[2] == int(same)
        assert fig[3] == 0
        assert fig[:3] in built
    with pytest.raises(ValueError, match="exceeds"):
        K1.instance(K1.MAX_F + 1, same, 4)


@pytest.mark.parametrize("f", [1, 128, 130, 960, 2048, 5120, 7168])
def test_window_past_the_registers_takes_the_shared_window(f):
    """A window of up to REGISTER_WINDOW scores stays in registers; a
    wider one, up to MAX_WINDOW, takes the same band's instance with the
    window in shared memory (every PROBE_INSTANCE line builds both)."""
    for win in list(range(1, 65)) + [K1.MAX_WINDOW]:
        fig = K1.instance(f, True, win)
        assert fig[3] == int(win > K1.REGISTER_WINDOW)
        assert fig[:3] == K1.instance(f, True, 1)[:3]
        assert K1.smem_bytes(fig, win) <= K1.SMEM_BLOCK


def test_source_builds_exactly_the_instances_the_bands_name():
    named = {K1.instance(b.f_max, s, 4)[:3] for b in K1.BANDS
             for s in (True, False)}
    assert named == _built_instances()


def test_bands_fit_the_card():
    """Whole warps, a power-of-two count (the pairwise fold), 16-byte
    groups; the ring of two tokens' rows (two rows a token where zq is not
    zk) within the 227 KB of shared memory a block can use, and within
    the 48 KB that need no opt-in at the served widths."""
    for band in K1.BANDS:
        nw = band.threads // 32
        assert band.threads % 32 == 0 and nw & (nw - 1) == 0
        assert band.threads <= 1024 and band.fpt % 4 == 0
        ring = 2 * 2 * band.threads * band.fpt * 4
        assert ring == K1.smem_bytes(K1.instance(band.f_max, False, 4), 4)
        assert ring <= 227 * 1024
        if band.f_max <= 2048:
            assert ring <= 48 * 1024
        # the widest window beside the rows
        fig = K1.instance(band.f_max, False, K1.MAX_WINDOW)
        assert K1.smem_bytes(fig, K1.MAX_WINDOW) <= K1.SMEM_BLOCK
    fig = K1.instance(K1.MAX_F, False, K1.MAX_WINDOW + 1)
    assert K1.smem_bytes(fig, K1.MAX_WINDOW + 1) > K1.SMEM_BLOCK


# ---------------------------------------------------------------------------
# the shared view and the card's checks

def _views():
    z = torch.randn(4, 960)
    big = torch.randn(5, 960)
    wide = torch.randn(4, 1920)
    return {"same tensor": (z, z, True),
            "same view object twice": (z.view(4, 960), z.view(4, 960), True),
            "clone": (z, z.clone(), False),
            "offset view": (big[:4], big[1:], False),
            "other stride": (wide[:, :960], wide[:, :960].contiguous(),
                             False),
            "same pointer, other stride": (
                z, torch.as_strided(z, (4, 960), (0, 1)), False),
            "same pointer, other shape": (
                z.view(-1)[:960].view(1, 960), z.view(-1)[:1920].view(2, 960),
                False)}


@pytest.mark.parametrize("case", list(_views()))
def test_shared_view_detection(case):
    zq, zk, want = _views()[case]
    assert K1.shared_view(zq, zk) is want


def test_vector_rows_needs_16_bytes_and_a_multiple_of_4():
    z = torch.zeros(2, 964)
    assert K1.vector_rows(960, z) == 1
    assert K1.vector_rows(130, z) == 0
    assert K1.vector_rows(960, z.view(-1)[1:961]) == 0


def _state(B, f, win=4):
    return [torch.zeros(B, f), torch.zeros(B), torch.zeros(B, win),
            torch.zeros(B, dtype=torch.int32),
            torch.zeros(B, dtype=torch.bool),
            torch.full((B,), -1, dtype=torch.int32)]


@pytest.mark.parametrize("f,win", [(K1.MAX_F + 1, 4),
                                   (960, K1.MAX_WINDOW + 1), (960, 0)])
def test_card_checks_refuse_past_the_instances(f, win):
    """K1 now refuses f > MAX_F, as K4 does; both refuse a smoothing window
    the widest band's shared memory does not hold.  The checks run here on
    CPU tensors."""
    z = torch.zeros(2, f)
    with pytest.raises(ValueError, match="exceeds|window"):
        K1._check(z, z, torch.ones(2, dtype=torch.bool), *_state(2, f, win))
    z3 = torch.zeros(2, 1, f)
    with pytest.raises(ValueError, match="exceeds|window"):
        K4._check(z3, z3, torch.ones(2, 1, dtype=torch.bool),
                  torch.ones(2, dtype=torch.int32), *_state(2, f, win))


@pytest.mark.parametrize("f,win", [(K1.MAX_F, 4), (130, K1.MAX_WINDOW),
                                   (1, 1), (960, K1.REGISTER_WINDOW),
                                   (960, K1.REGISTER_WINDOW + 1),
                                   (K1.MAX_F, K1.MAX_WINDOW)])
def test_card_checks_take_the_widest_instance(f, win):
    z = torch.zeros(2, f)
    K1._check(z, z, torch.ones(2, dtype=torch.bool), *_state(2, f, win))
    z3 = torch.zeros(2, 3, f)
    K4._check(z3, z3, torch.ones(2, 3, dtype=torch.bool),
              torch.ones(2, dtype=torch.int32), *_state(2, f, win))


# ---------------------------------------------------------------------------
# the plain versions at the timed widths, against the jnp oracles

def _inputs(B, T, f, win=4, seed=0):
    """A warm state: slots past the burn-in with full rings, one stopped,
    high-bias slots that stop mid-chain, mixed boundaries and accepted
    lengths."""
    rng = np.random.default_rng(seed + f + 31 * T)
    zq = (rng.standard_normal((B, T, f)) / np.sqrt(f)).astype(np.float32)
    zk = (rng.standard_normal((B, T, f)) / np.sqrt(f)).astype(np.float32)
    boundary = rng.random((B, T)) < 0.75
    boundary[:, 0] = True
    accept = (np.arange(B) * 3 % (T + 1)).astype(np.int32)
    accept[0] = T
    W = (rng.standard_normal((B, f)) / np.sqrt(f)).astype(np.float32)
    b = np.resize(np.array([3.5, -2.0, 1.0, -0.5], np.float32), B)
    ring = np.repeat(1.0 / (1.0 + np.exp(-b))[:, None], win, 1) \
        .astype(np.float32)
    n = np.full(B, 2, np.int32)
    stopped = np.zeros(B, bool)
    stop_step = np.full(B, -1, np.int32)
    if B > 2:
        stopped[2], stop_step[2] = True, 2
    return dict(zq=zq, zk=zk, boundary=boundary, accept=accept, W=W, b=b,
                ring=ring, n_scores=n, stopped=stopped, stop_step=stop_step)


STATE = ("W", "b", "ring", "n_scores", "stopped", "stop_step")


def _torch_state(x):
    return [torch.from_numpy(x[k].copy()) for k in STATE]


def _close(port, ref, names_f, names_x):
    for name in names_f:
        np.testing.assert_allclose(np.asarray(getattr(port, name)),
                                   np.asarray(getattr(ref, name)), rtol=0,
                                   atol=ATOL, err_msg=name)
    for name in names_x:
        np.testing.assert_array_equal(np.asarray(getattr(port, name)),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)


@pytest.mark.parametrize("B,f", [(2, 5120), (4, 130), (4, 960)])
def test_plain_k1_matches_the_jnp_oracle(B, f):
    x = _inputs(B, 1, f)
    eta, lam, burn_in = 0.05, 0.6, 1
    zq, zk, bnd = x["zq"][:, 0], x["zk"][:, 0], x["boundary"][:, 0]
    port = K1.serving_probe_step_plain(
        torch.from_numpy(zq.copy()), torch.from_numpy(zk.copy()),
        torch.from_numpy(bnd.copy()), *_torch_state(x), eta, lam,
        burn_in=burn_in)
    ref = jref.serving_probe_step_ref(
        jnp.asarray(zq), jnp.asarray(zk), jnp.asarray(bnd),
        *(jnp.asarray(x[k]) for k in STATE), eta, lam, burn_in=burn_in)
    assert bool(np.asarray(ref.stopped).sum() > x["stopped"].sum())
    _close(port, ref, FLOATS, EXACT)


@pytest.mark.parametrize("B,T,f", [(2, 8, 5120), (4, 8, 130), (4, 4, 130)])
def test_plain_k4_matches_the_jnp_oracle(B, T, f):
    x = _inputs(B, T, f)
    eta, lam, burn_in = 0.05, 0.6, 1
    port = K4.serving_probe_spec_step_plain(
        *(torch.from_numpy(x[k].copy())
          for k in ("zq", "zk", "boundary", "accept")),
        *_torch_state(x), eta, lam, burn_in=burn_in)
    ref = jref.serving_probe_spec_step_ref(
        *(jnp.asarray(x[k]) for k in ("zq", "zk", "boundary", "accept")),
        *(jnp.asarray(x[k]) for k in STATE), eta, lam, burn_in=burn_in)
    # a stop fires inside the chain
    assert bool(np.asarray(ref.stopped).sum() > x["stopped"].sum())
    _close(port, ref, ("s", "smoothed_seq", "W", "b", "ring", "smoothed"),
           ("n_seq",) + EXACT)


@pytest.mark.parametrize("win,T,f", [(17, 24, 130), (40, 8, 960)])
def test_plain_k4_wide_window_matches_the_jnp_oracle(win, T, f):
    """A window wider than the kernel's registers hold (17, over a chain
    that pushes more scores than it holds, and 40) against the oracle."""
    x = _inputs(4, T, f, win=win)
    eta, lam, burn_in = 0.05, 0.6, 1
    port = K4.serving_probe_spec_step_plain(
        *(torch.from_numpy(x[k].copy())
          for k in ("zq", "zk", "boundary", "accept")),
        *_torch_state(x), eta, lam, burn_in=burn_in)
    ref = jref.serving_probe_spec_step_ref(
        *(jnp.asarray(x[k]) for k in ("zq", "zk", "boundary", "accept")),
        *(jnp.asarray(x[k]) for k in STATE), eta, lam, burn_in=burn_in)
    assert int(np.asarray(ref.n_seq).max()) > int(x["n_scores"].max())
    _close(port, ref, ("s", "smoothed_seq", "W", "b", "ring", "smoothed"),
           ("n_seq",) + EXACT)


@pytest.mark.parametrize("kernel", ["K1", "K4"])
@pytest.mark.parametrize("f", [130, 960])
def test_zq_twice_equals_zq_and_a_clone(kernel, f):
    """Passing zq as zk (the served no-QK view) and passing a clone give
    the same outputs and state bit for bit."""
    x = _inputs(4, 4, f)
    zq = torch.from_numpy(x["zq"])
    outs = []
    for zk in (zq, zq.clone()):
        st = _torch_state(x)
        if kernel == "K1":
            out = K1.serving_probe_step_plain(
                zq[:, 0], zk[:, 0], torch.from_numpy(x["boundary"][:, 0]),
                *st, 0.05, 0.6, burn_in=1)
        else:
            out = K4.serving_probe_spec_step_plain(
                zq, zk, torch.from_numpy(x["boundary"]),
                torch.from_numpy(x["accept"]), *st, 0.05, 0.6, burn_in=1)
        outs.append(out)
    assert K1.shared_view(zq, zq) and not K1.shared_view(zq, zq.clone())
    for a, b in zip(*outs):
        assert torch.equal(a, b)
