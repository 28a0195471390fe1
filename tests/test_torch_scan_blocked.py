"""The schedules of the two sequential-scan kernels, held to the JAX
package on the same numpy-made inputs:

* K5's L-step form (``kernels/ttt_scan.py ttt_probe_lookahead_plain``: one
  block reduction serves L steps of the rank-one update) against B6,
  ``repro.kernels.ttt_probe.ttt_probe_batched``/``ttt_probe_scan`` in
  interpret mode, and against ``kernels/ref.py:37``;
* K8's column split and chunked output sum
  (``kernels/rwkv6_scan.py wkv_scan_blocked_plain``) against B9,
  ``repro.kernels.rwkv6_scan.wkv_scan`` in interpret mode (ct 16), and
  against ``kernels/ref.py:232 wkv_scan_ref``;
* the launch policies both kernels read (K8's column split, K5's L per
  width), and the RWKV6 model handing bf16 r, k and v to the scan."""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.rwkv6_scan import wkv_scan as j_wkv_scan
from repro.kernels.ttt_probe import ttt_probe_batched as j_batched
from repro.kernels.ttt_probe import ttt_probe_scan as j_scan

from repro_torch.kernels import rwkv6_scan as K8
from repro_torch.kernels import ttt_scan as K5
from repro_torch.models import rwkv6

# K5: scores, W_f, b_f; f32 sums in another order than XLA's over up to 120
# dependent steps (tests/test_torch_ttt_scan.py's tolerance)
K5_ATOL = 2e-5
# K8: out and state relative to the largest |value|; f32 sums of d
# products in another order than XLA's (tests/test_torch_rwkv_scan.py's)
K8_RTOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


# ---------------------------------------------------------------------------
# K5: the L-step form

# (c = labels, shared init, zq is zk): each mode once with each init, both
# views and both label modes
K5_MODES = [(False, True, True), (True, False, True), (False, False, False),
            (True, True, False)]


def _k5_inputs(T, labels, shared, same, n=3, f=24):
    """Ragged masks (lengths drawn from a seed, the first full), c = 0 or
    0/1 labels, a shared or per-trajectory init, zq distinct from zk or
    the same array (the served no-QK view).  Features scaled so that the
    inner loop converges: the comparison is of the algebra, not of a
    chaotic run's rounding."""
    rng = np.random.default_rng(1000 + T)
    zk = (rng.standard_normal((n, T, f)) / np.sqrt(f)).astype(np.float32)
    zq = zk if same else (rng.standard_normal((n, T, f))
                          / np.sqrt(f)).astype(np.float32)
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
    return zq, zk, c, m, w0, b0, np.float32(0.5)


@pytest.fixture(scope="module")
def jax_k5():
    """B6 in interpret mode and the oracle on one input set, computed once
    per set for the module: every L is held to the same pair."""
    cache = {}

    def get(T, mode):
        if (T, mode) not in cache:
            args = _k5_inputs(T, *mode)
            ja = [jnp.asarray(a) for a in args]
            if mode[1]:
                refs = (j_scan(*ja, interpret=True), jref.ttt_probe_ref(*ja))
            else:
                refs = (j_batched(*ja, interpret=True),
                        jref.ttt_probe_batched_ref(*ja))
            cache[(T, mode)] = (args, [[np.asarray(x) for x in r]
                                       for r in refs])
        return cache[(T, mode)]
    return get


@pytest.mark.parametrize("mode", K5_MODES,
                         ids=["c0-shared-same", "labels-rows-same",
                              "c0-rows-qk", "labels-shared-qk"])
@pytest.mark.parametrize("T", [1, 7, 37, 120])
@pytest.mark.parametrize("L", [1, 2, 4, 8])
def test_lookahead_form_matches_pallas_and_ref(L, T, mode, jax_k5):
    """T 7 and 37 leave a short last block at L 2, 4 and 8."""
    args, refs = jax_k5(T, mode)
    zq, zk, c, m, w0, b0, eta = (torch.as_tensor(a) for a in args)
    if mode[2]:
        zq = zk                                    # one tensor, as served
    n, _, f = zk.shape
    if mode[1]:
        w0, b0 = w0.expand(n, f), b0.expand(n)
    got = K5.ttt_probe_lookahead_plain(zq, zk, c, m, w0, b0, eta, L)
    for ref in refs:
        for a, b, name in zip(got, ref, ("scores", "W_f", "b_f")):
            np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=K5_ATOL,
                                       err_msg=f"{name} L={L}")


def test_lookahead_masked_steps_score_but_do_not_update():
    """m = 0 everywhere: every step scores with the initial weights and
    the L-step form ends where it started, at every L."""
    zq, zk, c, _, w0, b0, eta = (torch.as_tensor(a) for a in
                                 _k5_inputs(9, True, False, False))
    m = torch.zeros_like(c)
    want = torch.sigmoid(torch.einsum("ntf,nf->nt", zq, w0) + b0[:, None])
    for L in (1, 2, 4, 8):
        s, wf, bf = K5.ttt_probe_lookahead_plain(zq, zk, c, m, w0, b0, eta,
                                                 L)
        torch.testing.assert_close(wf, w0, rtol=0, atol=0)
        torch.testing.assert_close(bf, b0, rtol=0, atol=0)
        torch.testing.assert_close(s, want, rtol=0, atol=1e-6)


def test_lookahead_table_covers_every_width():
    """Every width up to MAX_F has an instance, L in {1, 2, 4, 8}, never
    larger where zq is not zk (twice the rows and dots a thread holds);
    past MAX_F none."""
    assert K5.BANDS[-1][0] == K5.MAX_F
    widths = sorted({1, K5.MAX_F} | {b[0] for b in K5.BANDS}
                    | {b[0] + 1 for b in K5.BANDS[:-1]})
    for f in widths:
        same, distinct = K5.lookahead_steps(f, True), K5.lookahead_steps(
            f, False)
        assert same in (1, 2, 4, 8) and distinct in (1, 2, 4, 8)
        assert distinct <= same
    for band in K5.BANDS:
        # whole warps, at least two (the block reduction's two barriers)
        assert band.threads % 32 == 0 and 64 <= band.threads <= 1024
        assert band.threads * band.fpt >= band.f_max  # every feature owned
        assert band.in_flight in (1, 2)
    with pytest.raises(ValueError, match="exceeds"):
        K5.lookahead_steps(K5.MAX_F + 1, True)


def _built_instances():
    """The (threads, features a thread, L, zq is zk, blocks an SM, blocks
    in flight) of every TTT_INSTANCE line of csrc/ttt_scan.cu."""
    src = (Path(K5.__file__).resolve().parent.parent / "csrc"
           / "ttt_scan.cu").read_text()
    return {tuple(int(x) for x in m.group(1).split(","))
            for m in re.finditer(r"^\s*TTT_INSTANCE\(([\d,\s]+)\)\s*$", src,
                                 re.M)}


@pytest.mark.parametrize("same", [True, False])
def test_source_builds_every_instance_the_bands_name(same):
    """The launcher only runs the instance whose figures the wrapper
    passes: each band's instance, in both views, is one the source builds,
    and the source builds no other."""
    built = _built_instances()
    named = {K5.instance(b.f_max, s) for b in K5.BANDS for s in (True, False)}
    assert named == built
    for band in K5.BANDS:
        for f in (band.f_max, band.f_max - 1):
            assert K5.instance(f, same) in built


def test_long_trajectory_passes_the_card_checks():
    """c and m travel with the rows (nothing in the kernel is sized by T):
    the card's checks, run here on CPU tensors, take any T."""
    T = 40000
    zq = torch.zeros(1, T, 4)
    c = torch.zeros(1, T)
    K5._check(zq, zq, c, c, torch.zeros(1, 4), torch.zeros(1),
              torch.tensor(0.1), shared=False)


# ---------------------------------------------------------------------------
# K8: the column split and the chunked output sum

K8_DECAYS = {"near 0": 2.0, "mid": 0.0, "near 1": -6.0}


def _k8_inputs(T, decay, s0_zero, B=1, H=2, d=64):
    """chip_smoke.py's k8 inputs in numpy: r, k, v ~ N(0, 1); w =
    exp(-exp(x)) with x around 2, 0 or -6; u small; s0 zero or random."""
    rng = np.random.default_rng(7 + T)
    r, k, v = (rng.standard_normal((B, T, H, d)).astype(np.float32)
               for _ in range(3))
    x = K8_DECAYS[decay] + 0.5 * rng.standard_normal((B, T, H, d))
    w = np.exp(-np.exp(x)).astype(np.float32)
    u = (0.5 * rng.standard_normal((H, d))).astype(np.float32)
    s0 = (np.zeros((B, H, d, d), np.float32) if s0_zero
          else rng.standard_normal((B, H, d, d)).astype(np.float32))
    return r, k, v, w, u, s0


def _k8_close(got, want, what):
    for a, b, name in zip(got, want, ("out", "state")):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=K8_RTOL * np.abs(b).max(),
                                   err_msg=f"{name} {what}")


def _k8_T(kind, C):
    return {"1": 1, "C-1": C - 1, "C": C, "C+1": C + 1, "100": 100}[kind]


@pytest.mark.parametrize("kind", ["1", "C-1", "C", "C+1", "100"])
@pytest.mark.parametrize("C", [8, 32])
@pytest.mark.parametrize("n_col", [1, 2, 4])
def test_column_split_and_chunked_sum_match_pallas_and_ref(n_col, C, kind):
    """Every decay regime with s0 zero and random; T around the chunk (a
    chunk one short, exact, one over) and 100 (three chunks and a tail at
    C 32)."""
    T = _k8_T(kind, C)
    for decay in K8_DECAYS:
        for s0_zero in (True, False):
            args = _k8_inputs(T, decay, s0_zero)
            got = [t.numpy() for t in K8.wkv_scan_blocked_plain(
                *(torch.as_tensor(a) for a in args), n_col=n_col, chunk=C)]
            ja = [jnp.asarray(a) for a in args]
            what = f"{decay}, s0 {'zero' if s0_zero else 'random'}"
            _k8_close(got, j_wkv_scan(*ja, ct=16, interpret=True), what)
            _k8_close(got, jref.wkv_scan_ref(*ja), what)


def test_chunked_sum_is_the_same_whatever_chunk_a_step_falls_in():
    """The sum over row groups has one order for every step, so two calls
    cut at any step equal one call bit for bit, at every column split."""
    args = [torch.as_tensor(a) for a in _k8_inputs(40, "near 1", False)]
    r, k, v, w, u, s0 = args
    for n_col in (1, 2, 4):
        one = K8.wkv_scan_blocked_plain(*args, n_col=n_col, chunk=16)
        cut = 23
        a, st = K8.wkv_scan_blocked_plain(
            r[:, :cut], k[:, :cut], v[:, :cut], w[:, :cut], u, s0,
            n_col=n_col, chunk=16)
        b, st = K8.wkv_scan_blocked_plain(
            r[:, cut:], k[:, cut:], v[:, cut:], w[:, cut:], u, st,
            n_col=n_col, chunk=16)
        assert torch.equal(torch.cat([a, b], dim=1), one[0])
        assert torch.equal(st, one[1])


@pytest.mark.parametrize("B,H,want", [(1, 32, 4), (2, 32, 2), (3, 32, 2),
                                      (4, 32, 1), (24, 32, 1), (1, 2, 4),
                                      (64, 2, 1)])
def test_column_split_policy(B, H, want):
    """n_col is 1 once B H fills the card's 128 blocks, else 2 or 4; a (1,
    T) prompt of rwkv6-1.6b's 32 heads runs 128 blocks."""
    n_col = K8.col_split(B, H)
    assert n_col == want
    if B * H >= K8.FILL_BLOCKS:
        assert n_col == 1
    else:
        assert B * H * n_col >= min(K8.FILL_BLOCKS, 4 * B * H)
    assert K8.KERNEL_HEAD_DIM % n_col == 0


@pytest.mark.parametrize("T", [0, 1, 31, 32, 33, 2048])
def test_chunk_policy(T):
    C = K8.chunk_steps(T)
    assert 1 <= C <= K8.CHUNK_STEPS and (T == 0 or C <= T)


def test_model_hands_bf16_rkv_to_the_scan_bit_for_bit():
    """The RWKV6 model no longer casts r, k and v before the scan: bf16
    inputs give, bit for bit on the CPU, what the same call on the
    f32-cast inputs gives (the kernel widens bf16 on load, the plain
    version casts)."""
    r, k, v, w, u, s0 = _k8_inputs(5, "mid", False, B=2, H=3)
    bf = [torch.as_tensor(a).to(torch.bfloat16) for a in (r, k, v)]
    w, u, s0 = (torch.as_tensor(a) for a in (w, u, s0))
    got = rwkv6.wkv_scan(*bf, w, u, s0)
    want = rwkv6.wkv_scan(*(t.float() for t in bf), w, u, s0)
    assert got[0].dtype == torch.float32
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    # the kernel's checks take the bf16 tensors as the model passes them
    K8._check(*(t.contiguous() for t in bf), w, u, s0, s0)
