"""Port vs reference: the disagg_gram kernel layer.

On the CPU the port's gram assembly is its plain version
(``kernels/ref.py::disagg_gram``), held here against the reference's Pallas
kernel run in interpret mode at the shapes and tolerance of
tests/test_kernels.py.  The CUDA kernel itself runs only on a card: its
test is marked ``cuda`` and skips without one (``chip_smoke.py`` holds it
against the plain version on the H100 at the main path's shapes).
"""

import numpy as np
import pytest
import torch

from repro_torch.core.engine import EngineConfig, run_fleet_gram, synthetic_fleet
from repro_torch.kernels import disagg_solve as ds
from repro_torch.kernels import ops, ref


def _reference():
    """The reference's kernel layer, imported lazily so that the ``cuda``
    test runs where JAX is absent (``pytest --noconftest -m cuda``)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.core.disaggregation import solve_ridge
    from repro.kernels import disagg_solve as pallas
    from repro.kernels import ref as ref_kernels

    return jnp, pallas, ref_kernels, solve_ridge


GRAM_SHAPES = [(4, 300, 12), (1, 1000, 64), (2, 64, 5)]


@pytest.mark.parametrize("g,n,m", GRAM_SHAPES)
def test_plain_gram_vs_pallas_interpret(g, n, m):
    jnp, pallas, ref_kernels, _ = _reference()
    rng = np.random.default_rng(g * 1000 + m)
    c = np.abs(rng.standard_normal((g, n, m))).astype(np.float32)
    w = np.abs(rng.standard_normal((g, n))).astype(np.float32)
    gram, rhs = pallas.disagg_gram(jnp.asarray(c), jnp.asarray(w), n_block=128, interpret=True)
    pg, pr = ref.disagg_gram(torch.from_numpy(c), torch.from_numpy(w))
    np.testing.assert_allclose(pg.numpy(), np.asarray(gram), atol=2e-3, rtol=1e-4)
    np.testing.assert_allclose(pr.numpy(), np.asarray(rhs), atol=2e-3, rtol=1e-4)
    # The CPU dispatch is the plain version itself; the reference's own
    # jnp oracle agrees too, leading batch dims included.
    og, orhs = ops.disagg_gram(torch.from_numpy(c), torch.from_numpy(w))
    assert torch.equal(og, pg) and torch.equal(orhs, pr)
    rg, rr = ref_kernels.disagg_gram(jnp.asarray(c[None]), jnp.asarray(w[None]))
    bg, br = ref.disagg_gram(torch.from_numpy(c[None]), torch.from_numpy(w[None]))
    np.testing.assert_allclose(bg.numpy(), np.asarray(rg), atol=2e-3, rtol=1e-4)
    np.testing.assert_allclose(br.numpy(), np.asarray(rr), atol=2e-3, rtol=1e-4)


def test_disagg_solve_matches_reference():
    """Gram + Cholesky + clamp, against the reference's interpret-mode
    kernel path and its core ridge solver (tolerance of test_kernels.py)."""
    jnp, pallas, _, ref_solve_ridge = _reference()
    rng = np.random.default_rng(0)
    c = np.abs(rng.standard_normal((200, 10))).astype(np.float32)
    x_true = np.abs(rng.standard_normal(10)).astype(np.float32)
    w = c @ x_true
    want = pallas.disagg_solve(jnp.asarray(c), jnp.asarray(w), 1e-4, interpret=True)
    got = ds.disagg_solve(torch.from_numpy(c), torch.from_numpy(w), 1e-4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(ref_solve_ridge(jnp.asarray(c), jnp.asarray(w), 1e-4)), atol=1e-4
    )
    signed = ds.disagg_solve(torch.from_numpy(c), torch.from_numpy(w - 5.0), 1e-4, nonneg=False)
    want_signed = pallas.disagg_solve(jnp.asarray(c), jnp.asarray(w - 5.0), 1e-4, nonneg=False, interpret=True)
    np.testing.assert_allclose(signed.numpy(), np.asarray(want_signed), atol=1e-4)


def test_disagg_solve_nnls_matches_reference():
    """Batched (G, N, M) NNLS through the gram pass, at 1e-5 of the
    solution's scale (FISTA amplifies last-bit differences in the gram)."""
    jnp, pallas, _, _ = _reference()
    rng = np.random.default_rng(1)
    c = (np.abs(rng.standard_normal((3, 120, 8))) * (rng.random((3, 120, 8)) > 0.4)).astype(np.float32)
    x_true = np.abs(rng.standard_normal((3, 8))) * 20 + 2
    w = (np.einsum("gnm,gm->gn", c, x_true) + 0.1 * rng.standard_normal((3, 120))).astype(np.float32)
    want = np.asarray(pallas.disagg_solve_nnls(jnp.asarray(c), jnp.asarray(w), 1e-3, interpret=True))
    got = ds.disagg_solve_nnls(torch.from_numpy(c), torch.from_numpy(w), 1e-3).numpy()
    assert np.max(np.abs(got - want)) <= 1e-5 * max(1.0, np.abs(want).max())


def test_kernel_wrapper_refuses_cpu_tensors():
    """The CUDA wrapper never falls back: a CPU tensor raises, and so does
    the engine's explicit ``backend="kernel"`` on the CPU."""
    c, w = torch.ones(2, 5, 3), torch.ones(2, 5)
    before = ds.disagg_gram.launches
    with pytest.raises(ValueError, match="CUDA"):
        ds.disagg_gram(c, w)
    assert ds.disagg_gram.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        run_fleet_gram(
            synthetic_fleet(2, 2, 4, 3, device="cpu"), EngineConfig(backend="kernel"), device="cpu"
        )
    assert ds.default_backend(torch.device("cpu")) == "einsum"
    assert ds.default_backend(torch.device("cuda")) == "kernel"


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU or interpret mode")
    ds.build()
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize(
    "g,n,m",
    GRAM_SHAPES + [(1792, 60, 8), (64, 100, 8), (3, 1, 5), (5, 130, 17),
                   (64, 1800, 64), (8, 1000, 256), (7, 333, 7), (4, 300, 65), (2, 50, 33), (2, 1500, 8)],
)
def test_cuda_gram_vs_plain(g, n, m, cuda_device):
    """CUDA kernel vs the plain version on the card: rtol 1e-5 with an atol
    of 1e-6 * N * max|C| * max(|C|, |w|), the scale of an N-term fp32 sum
    taken in another order.  Both variants (M <= 16 and above, and a long
    N at M = 8), N * M not a multiple of 4 (333 * 7; M 65 and 33 with
    unaligned rows), and a second call gives the same bits."""
    rng = np.random.default_rng(n * 1000 + m)
    c = torch.from_numpy(np.abs(rng.standard_normal((g, n, m))).astype(np.float32)).to(cuda_device)
    w = torch.from_numpy(np.abs(rng.standard_normal((g, n))).astype(np.float32)).to(cuda_device)
    before = ds.disagg_gram.launches
    gram, rhs = ds.disagg_gram(c, w)
    torch.cuda.synchronize()
    assert ds.disagg_gram.launches == before + 1
    gram2, rhs2 = ds.disagg_gram(c, w)
    assert torch.equal(gram, gram2) and torch.equal(rhs, rhs2)
    pg, pr = ref.disagg_gram(c, w)
    scale = float(c.abs().max()) * max(float(c.abs().max()), float(w.abs().max()))
    torch.testing.assert_close(gram, pg, rtol=1e-5, atol=1e-6 * n * scale)
    torch.testing.assert_close(rhs, pr, rtol=1e-5, atol=1e-6 * n * scale)


# ---------------------------------------------------------------------------
# Attention and RMSNorm: the plain versions against the reference's Pallas
# kernels in interpret mode and its jnp oracles, in fp32 and bf16.
# fp32 tolerance: the reference's own 2e-5 (tests/test_kernels.py).  bf16:
# both sides compute in fp32 and round the output to bf16 once, so they
# differ by at most one bf16 step (2^-8 relative) where fp32 sums taken in
# another order straddle a rounding boundary; the reference's own bf16
# tolerances (2e-2 attention and RMSNorm, 3e-2 decode) cover that.
# ---------------------------------------------------------------------------

FLASH_CASES = [
    # b, s, t, h, hkv, d, causal
    (2, 64, 64, 4, 4, 32, True),      # GQA group 1
    (2, 64, 64, 8, 2, 64, False),     # group 4, not causal
    (1, 48, 112, 4, 2, 32, True),     # S < T: causal offset T - S
    (1, 37, 53, 4, 1, 16, True),      # ragged S and T, group 4
    (2, 45, 45, 4, 2, 16, False),     # ragged, not causal, group 2
]


def _np_dtype_pair(dtype):
    import jax.numpy as jnp

    return (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)


def _to_torch(x, tdtype):
    return torch.tensor(np.asarray(x, np.float32)).to(tdtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,t,h,hkv,d,causal", FLASH_CASES)
def test_plain_flash_vs_pallas_interpret(b, s, t, h, hkv, d, causal, dtype):
    jnp, _, ref_kernels, _ = _reference()
    from repro.kernels.flash_attention import flash_attention as pallas_flash

    jdt, tdt = _np_dtype_pair(dtype)
    rng = np.random.default_rng(s * 1000 + t + h)
    qn, kn, vn = (rng.standard_normal(shape).astype(np.float32)
                  for shape in ((b, s, h, d), (b, t, hkv, d), (b, t, hkv, d)))
    q, k, v = (jnp.asarray(x, jdt) for x in (qn, kn, vn))
    want = pallas_flash(q, k, v, causal=causal, q_block=16, kv_block=32, interpret=True)
    oracle = ref_kernels.attention_dense(q, k, v, causal=causal)
    got = ref.flash_attention(*(_to_torch(x, tdt) for x in (q, k, v)), causal, 16, 32)
    assert got.dtype == tdt and got.shape == (b, s, h, d)
    tol = 2e-5 if dtype == "float32" else 2e-2
    for other in (want, oracle):
        np.testing.assert_allclose(got.float().numpy(), np.asarray(other, np.float32), atol=tol, rtol=tol)
    # The blocked reference (the training path's forward) at divisible shapes.
    if s % 16 == 0 and t % 32 == 0:
        blocked = ref_kernels.flash_attention(q, k, v, causal, 16, 32)
        np.testing.assert_allclose(got.float().numpy(), np.asarray(blocked, np.float32), atol=tol, rtol=tol)
    # ops on CPU tensors is the plain version itself, block sizes and all.
    via_ops = ops.flash_attention(*(_to_torch(x, tdt) for x in (q, k, v)), causal=causal, q_block=16, kv_block=32)
    assert torch.equal(via_ops, got)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "b,s,h,hkv,d,lengths",
    [
        (3, 100, 8, 8, 32, [1, 100, 37]),      # length 1, full, mixed; group 1
        (2, 70, 4, 2, 16, [70, 1]),            # group 2
        (4, 64, 16, 4, 64, [1, 17, 64, 33]),   # group 4
    ],
)
def test_plain_decode_vs_pallas_interpret(b, s, h, hkv, d, lengths, dtype):
    jnp, _, ref_kernels, _ = _reference()
    from repro.kernels.decode_attention import decode_attention as pallas_decode

    jdt, tdt = _np_dtype_pair(dtype)
    rng = np.random.default_rng(s * 10 + h)
    q = jnp.asarray(rng.standard_normal((b, h, d)), jdt)
    k = jnp.asarray(rng.standard_normal((b, s, hkv, d)), jdt)
    v = jnp.asarray(rng.standard_normal((b, s, hkv, d)), jdt)
    lens = np.asarray(lengths, np.int32)
    want = pallas_decode(q, k, v, jnp.asarray(lens), kv_block=32, interpret=True)
    oracle = ref_kernels.decode_attention(q, k, v, jnp.asarray(lens))
    args = (_to_torch(q, tdt), _to_torch(k, tdt), _to_torch(v, tdt), torch.from_numpy(lens))
    got = ref.decode_attention(*args)
    assert got.dtype == tdt and got.shape == (b, h, d)
    tol = 2e-5 if dtype == "float32" else 3e-2
    for other in (want, oracle):
        np.testing.assert_allclose(got.float().numpy(), np.asarray(other, np.float32), atol=tol, rtol=tol)
    assert torch.equal(ops.decode_attention(*args), got)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(4, 7, 64), (101, 128), (3, 33), (1, 2048)])
def test_plain_rmsnorm_vs_pallas_interpret(shape, dtype):
    jnp, _, ref_kernels, _ = _reference()
    from repro.kernels.rmsnorm import rmsnorm as pallas_rmsnorm

    jdt, tdt = _np_dtype_pair(dtype)
    rng = np.random.default_rng(shape[0])
    x = jnp.asarray(rng.standard_normal(shape), jdt)
    g = rng.standard_normal(shape[-1]).astype(np.float32)
    want = pallas_rmsnorm(x, jnp.asarray(g), row_block=16, interpret=True)
    oracle = ref_kernels.rmsnorm(x, jnp.asarray(g))
    got = ref.rmsnorm(_to_torch(x, tdt), torch.from_numpy(g))
    assert got.dtype == tdt and got.shape == shape
    # fp32: the reference's own 1e-5 for RMSNorm (tests/test_kernels.py).
    tol = 1e-5 if dtype == "float32" else 2e-2
    for other in (want, oracle):
        np.testing.assert_allclose(got.float().numpy(), np.asarray(other, np.float32), atol=tol, rtol=tol)
    assert torch.equal(ops.rmsnorm(_to_torch(x, tdt), torch.from_numpy(g)), got)


def test_attention_kernel_wrappers_refuse_cpu_tensors():
    """Each CUDA wrapper raises on a CPU tensor and counts no launch; ops
    sends CPU tensors to the plain version and nothing else there."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rn

    q, kv = torch.ones(1, 4, 2, 16), torch.ones(1, 4, 1, 16)
    calls = [
        (fa.flash_attention, (q, kv, kv)),
        (da.decode_attention, (q[:, 0], kv, kv, torch.ones(1, dtype=torch.int32))),
        (rn.rmsnorm, (q, torch.ones(16))),
    ]
    for fn, args in calls:
        before = fn.launches
        with pytest.raises(ValueError, match="CUDA"):
            fn(*args)
        assert fn.launches == before


def test_ops_routes_by_device(monkeypatch):
    """A CPU tensor reaches the plain version; a CUDA tensor could only
    reach the kernel wrapper (checked by routing, with both stubbed)."""
    seen = []
    for name in ("flash_attention", "decode_attention", "rmsnorm"):
        monkeypatch.setattr(ref, name, lambda *a, _n=name, **k: seen.append(("plain", _n)) or "plain")
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rn

    for mod, name in ((fa, "flash_attention"), (da, "decode_attention"), (rn, "rmsnorm")):
        monkeypatch.setattr(mod, name, lambda *a, _n=name, **k: seen.append(("kernel", _n)) or "kernel")
    x = torch.ones(1, 2, 2, 16)
    assert ops.flash_attention(x, x, x) == "plain"
    assert ops.decode_attention(x[:, 0], x, x, torch.ones(1, dtype=torch.int32)) == "plain"
    assert ops.rmsnorm(x, torch.ones(16)) == "plain"
    meta = torch.ones(1, 2, 2, 16, device="meta")
    with pytest.raises(ValueError, match="no path"):
        ops.rmsnorm(meta, torch.ones(16, device="meta"))
    assert seen == [("plain", "flash_attention"), ("plain", "decode_attention"), ("plain", "rmsnorm")]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_flash_rows_without_live_keys(dtype):
    """Causal with S > T: rows before S - T see no key.  The plain version
    (as the CUDA kernels) gives them 0; every other row matches the Pallas
    kernel in interpret mode and the dense oracle.  (The reference's blocked
    versions give a dead row the mean of V over the kv slots they visit.)"""
    jnp, _, ref_kernels, _ = _reference()
    from repro.kernels.flash_attention import flash_attention as pallas_flash

    jdt, tdt = _np_dtype_pair(dtype)
    b, s, t, h, hkv, d = 2, 70, 40, 4, 2, 32
    rng = np.random.default_rng(7)
    q, k, v = (jnp.asarray(rng.standard_normal(shape), jdt) for shape in ((b, s, h, d), (b, t, hkv, d), (b, t, hkv, d)))
    got = ref.flash_attention(*(_to_torch(x, tdt) for x in (q, k, v)), True, 16, 32).float().numpy()
    want = np.asarray(pallas_flash(q, k, v, causal=True, q_block=16, kv_block=32, interpret=True), np.float32)
    oracle = np.asarray(ref_kernels.attention_dense(q, k, v, causal=True), np.float32)
    tol = 2e-5 if dtype == "float32" else 2e-2
    for other in (want, oracle):
        np.testing.assert_allclose(got[:, s - t:], other[:, s - t:], atol=tol, rtol=tol)
    assert not got[:, : s - t].any()


@pytest.mark.parametrize(
    "dtype,d,kind",
    [(torch.bfloat16, 128, "tc"), (torch.bfloat16, 64, "tc"), (torch.bfloat16, 32, "fma"),
     (torch.bfloat16, 16, "fma"), (torch.float32, 128, "fma"), (torch.float32, 64, "fma")],
)
def test_flash_variant_by_dtype_and_head_dim(dtype, d, kind):
    """bf16 at d 64 and 128 takes the tensor-core kernel, everything else
    the FMA kernel, and ``check_args`` returns the same choice."""
    from repro_torch.kernels import flash_attention as fa

    assert fa.variant(dtype, d) == kind
    q, kv = torch.zeros(1, 3, 4, d, dtype=dtype), torch.zeros(1, 5, 2, d, dtype=dtype)
    assert fa.check_args(q, kv, kv) == kind


@pytest.mark.parametrize(
    "q_shape,kv_shape,dtypes,match",
    [
        ((1, 4, 2, 128), (1, 4, 1, 128), (torch.bfloat16,) * 3, "CUDA"),             # CPU tensors
        ((1, 4, 2, 96), (1, 4, 1, 96), (torch.bfloat16,) * 3, "head_dim"),           # d 96
        ((1, 4, 2, 128), (1, 4, 1, 128), (torch.bfloat16, torch.float32, torch.bfloat16), "one of"),  # mixed
        ((1, 4, 2, 128), (1, 4, 1, 128), (torch.float16,) * 3, "one of"),            # fp16
        ((1, 4, 3, 64), (1, 4, 2, 64), (torch.bfloat16,) * 3, "GQA"),                 # H % Hkv
    ],
)
def test_flash_wrapper_refusals(q_shape, kv_shape, dtypes, match):
    """The wrapper raises before any launch and counts nothing; the
    tensor-core kernel refuses what it does not serve."""
    from repro_torch.kernels import flash_attention as fa

    q, k, v = (torch.zeros(shape, dtype=dt) for shape, dt in zip((q_shape, kv_shape, kv_shape), dtypes))
    before, before_tc = fa.flash_attention.launches, fa.flash_attention.launches_tc
    with pytest.raises(ValueError, match=match):
        fa.flash_attention(q, k, v)
    assert (fa.flash_attention.launches, fa.flash_attention.launches_tc) == (before, before_tc)
    with pytest.raises(ValueError, match="head_dim"):
        fa.tc_plan(1, 4, 4, 2, 1, 96)


@pytest.mark.parametrize(
    "b,s,t,h,hkv,d,causal",
    [(2, 4096, 4096, 16, 8, 128, True), (8, 512, 512, 16, 8, 128, True), (1, 100, 333, 16, 8, 128, True),
     (1, 300, 200, 16, 8, 128, True), (2, 150, 40, 4, 4, 64, True), (1, 130, 130, 4, 4, 64, False)],
)
def test_flash_tc_plan(b, s, t, h, hkv, d, causal):
    """The tensor-core launch's geometry: one block per 128-row query tile
    and head and batch, the key tiles each block walks (counted here pair
    by pair), tensor maps whose byte strides are the tensors' own, and
    shared memory for Q and a 3-stage K/V ring inside 227 KB."""
    from repro_torch.kernels import flash_attention as fa

    plan = fa.tc_plan(b, s, t, h, hkv, d, causal)
    nq = -(-s // 128)
    assert plan["grid"] == (nq, h, b) and plan["threads"] == 384
    tiles = []
    for qt in range(nq):
        rows = range(qt * 128, min(qt * 128 + 128, s))
        live = [kt for kt in range(-(-t // 128))
                if any((not causal or kt * 128 <= r + t - s) and kt * 128 < t for r in rows)]
        tiles.append(max(live) + 1 if live else 0)
    assert plan["key_tiles"] == tiles[::-1]  # longest first
    assert plan["key_tiles"] == sorted(plan["key_tiles"], reverse=True)
    for name, (seq, heads, rows) in {"q": (s, h, 128), "k": (t, hkv, 128), "v": (t, hkv, 128)}.items():
        m = plan["maps"][name]
        x = torch.empty(b, seq, heads, d, dtype=torch.bfloat16, device="meta")
        assert m["dims"] == (d, heads, seq, b)
        assert m["strides"] == tuple(2 * st for st in reversed(x.stride()[:3]))
        assert m["box"] == (64, 1, rows, 1) and m["box"][0] * 2 == 128  # one 128-byte swizzle row
    assert plan["smem_bytes"] == (d // 64) * 128 * 128 * (1 + 2 * 3) + 1024 <= 232448


@pytest.mark.parametrize(
    "dtype,d,kind",
    [(torch.bfloat16, 2048, "row"), (torch.bfloat16, 4096, "row"), (torch.float32, 2048, "row"),
     (torch.float32, 4096, "vector"), (torch.bfloat16, 128, "vector"), (torch.bfloat16, 33, "scalar"),
     (torch.float32, 6, "scalar")],
)
def test_rmsnorm_variant(dtype, d, kind):
    """Rows of 2048 (and 4096 in bf16) are held in registers, other
    16-byte rows loop over vectors, the rest over elements; the launch
    refuses CPU tensors."""
    from repro_torch.kernels import rmsnorm as rn

    assert rn.variant(dtype, d) == kind
    with pytest.raises(ValueError, match="CUDA"):
        rn.rmsnorm(torch.ones(2, d, dtype=dtype), torch.ones(d))


# ---------------------------------------------------------------------------
# The CUDA kernels against their plain versions, on the card only.
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_attention():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU or interpret mode")
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rn

    kbuild.compile_all(["flash_attention", "flash_attention_tc", "decode_attention", "rmsnorm"])
    for mod in (fa, da, rn):
        mod.build()
    return fa, da, rn


def _cuda_tol(dtype):
    # fp32: sums in another order than the plain version (2e-5, the
    # reference's fp32 tolerance); bf16: one bf16 step of outputs up to ~2.
    return 2e-5 if dtype == torch.float32 else 2e-2


def _assert_attention_close(got, want, dtype):
    """fp32: atol = rtol = 2e-5.  bf16: rtol 2e-2 with an atol of 2e-2 of
    the reference row's RMS over d, capped at 2e-2: a row over n keys has
    outputs ~1/sqrt(n) small, where a fixed 2e-2 would pass a wrong key
    tile."""
    tol = _cuda_tol(dtype)
    g, w = got.float(), want.float()
    if dtype == torch.float32:
        torch.testing.assert_close(g, w, atol=tol, rtol=tol)
        return
    atol = tol * w.square().mean(-1, keepdim=True).sqrt().clamp(max=1.0)
    bad = ~((g - w).abs() <= atol + tol * w.abs())
    assert not bad.any(), f"{int(bad.sum())} of {bad.numel()} elements off; max abs err {float((g - w).abs().max()):.3e}"


# Shapes that are awkward for the tensor-core kernel's 128-row query tiles
# and 128-key tiles (bf16 at d 64 and 128 takes it; fp32 the FMA kernel).
FLASH_CUDA_CASES = FLASH_CASES + [
    (1, 100, 333, 16, 8, 128, True),   # S < T, neither a tile multiple; B*H*ceil(S/128) = 16 blocks
    (2, 77, 77, 16, 8, 128, True),     # one partial query tile
    (1, 130, 130, 4, 4, 128, False),   # not causal, group 1
    (1, 200, 200, 8, 4, 64, True),     # d 64, group 2, diagonal inside a tile
    (1, 300, 200, 16, 8, 128, True),   # S > T: the first 100 rows have no live key
    (2, 150, 40, 4, 4, 64, True),      # S > T by more than one warpgroup's 64 rows, group 1
    (1, 300, 200, 8, 2, 64, False),    # S > T not causal, group 4
    (1, 1000, 1000, 16, 4, 128, True), # 8 key tiles: the 3-stage ring wraps, group 4
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,t,h,hkv,d,causal", FLASH_CUDA_CASES)
def test_cuda_flash_vs_plain(b, s, t, h, hkv, d, causal, dtype, cuda_attention):
    fa = cuda_attention[0]
    rng = np.random.default_rng(s + t)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to("cuda", dtype)
               for shape in ((b, s, h, d), (b, t, hkv, d), (b, t, hkv, d)))
    before, before_tc = fa.flash_attention.launches, fa.flash_attention.launches_tc
    got = fa.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    assert fa.flash_attention.launches_tc == before_tc + (fa.variant(dtype, d) == "tc")
    want = ref.flash_attention(q, k, v, causal)
    _assert_attention_close(got, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "b,s,h,hkv,d,lengths",
    [(3, 100, 8, 8, 32, [1, 100, 37]), (2, 70, 4, 2, 16, [70, 1]), (8, 600, 16, 8, 128, [575, 1, 64, 65, 600, 2, 300, 128]),
     (2, 4112, 16, 8, 128, [4111, 0]),   # a sequence of length 0, and a cluster of 8 slices
     (1, 4112, 16, 8, 128, [4111]),      # one sequence: still a cluster of 8, the portable limit
     (4, 300, 16, 4, 64, [300, 0, 17, 299]),  # G 4
     (3, 900, 8, 8, 128, [900, 450, 0]),  # G 1
     (2, 129, 12, 4, 64, [129, 64]),     # G 3: a register group of 4 with one head unused
     (1, 257, 16, 1, 32, [257])],         # G 16: two head chunks of 8
)
def test_cuda_decode_vs_plain(b, s, h, hkv, d, lengths, dtype, cuda_attention):
    da = cuda_attention[1]
    rng = np.random.default_rng(s)
    q = torch.from_numpy(rng.standard_normal((b, h, d)).astype(np.float32)).to("cuda", dtype)
    k, v = (torch.from_numpy(rng.standard_normal((b, s, hkv, d)).astype(np.float32)).to("cuda", dtype)
            for _ in range(2))
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    plan = da.decode_plan(b, h, hkv, s, d, q.element_size(), da.sm_count(q.device))
    assert plan["cluster"] <= da.MAX_CLUSTER and (s < 4000 or plan["cluster"] == da.MAX_CLUSTER)
    before = da.decode_attention.launches
    got = da.decode_attention(q, k, v, lens)
    again = da.decode_attention(q, k, v, lens)
    torch.cuda.synchronize()
    assert da.decode_attention.launches == before + 2
    assert torch.equal(got, again)  # the in-launch merge runs in a fixed order
    # A sequence of length 0 gives 0 (the plain version spreads its softmax
    # over every cache slot instead); every other row is held to the plain one.
    live = lens > 0
    _assert_attention_close(got[live], ref.decode_attention(q, k, v, lens)[live], dtype)
    assert not got[~live].any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "shape",
    # d 2048 and 4096 take the row-in-registers loop (bf16; fp32 at 2048);
    # 4097 and 1001 rows are not multiples of a block's 8 rows.
    [(4, 7, 64), (101, 128), (3, 33), (4097, 2048), (9, 2048), (1001, 4096)],
)
def test_cuda_rmsnorm_vs_plain(shape, dtype, cuda_attention):
    rn = cuda_attention[2]
    rng = np.random.default_rng(shape[0])
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to("cuda", dtype)
    g = torch.from_numpy(rng.standard_normal(shape[-1]).astype(np.float32)).cuda()
    before = rn.rmsnorm.launches
    got = rn.rmsnorm(x, g)
    torch.cuda.synchronize()
    assert rn.rmsnorm.launches == before + 1
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), ref.rmsnorm(x, g).float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
def test_cuda_flash_tc_smem_matches_plan(d, cuda_attention):
    """The built kernel asks for the dynamic shared memory ``tc_plan``
    computes, within the card's 227 KB per block."""
    fa = cuda_attention[0]
    assert fa.tc_smem_bytes(d) == fa.tc_plan(1, 128, 128, 1, 1, d)["smem_bytes"] <= 232448


def test_build_names_libraries_by_source_headers_and_flags(tmp_path, monkeypatch):
    """A library is named by a hash of its source, the shared headers and
    the flags: an edited header renames (so rebuilds) every kernel, and an
    unchanged tree keeps its name.  Without nvcc the build says so."""
    from repro_torch.kernels import KERNELS
    from repro_torch.kernels import build as kbuild

    for name in KERNELS:
        (tmp_path / f"{name}.cu").write_bytes((kbuild.CSRC_DIR / f"{name}.cu").read_bytes())
    (tmp_path / "convert.cuh").write_bytes((kbuild.CSRC_DIR / "convert.cuh").read_bytes())
    monkeypatch.setattr(kbuild, "CSRC_DIR", tmp_path)
    monkeypatch.setattr(kbuild, "BUILD_DIR", tmp_path / "build")
    before = {n: kbuild.library_path(n) for n in KERNELS}
    assert before == {n: kbuild.library_path(n) for n in KERNELS}
    assert all(p.parent == tmp_path / "build" and p.name.startswith(n + "_") for n, p in before.items())
    with open(tmp_path / "convert.cuh", "a") as f:
        f.write("// edited\n")
    assert all(kbuild.library_path(n) != before[n] for n in KERNELS)
    monkeypatch.setattr(kbuild.shutil, "which", lambda _: None)
    monkeypatch.setattr(kbuild.os.path, "exists", lambda _: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kbuild.compile_library("rmsnorm")
    with pytest.raises(RuntimeError, match="launch failed: cudaError 9"):
        kbuild.check_launch("rmsnorm", 9)
    kbuild.check_launch("rmsnorm", 0)


@pytest.mark.parametrize("b,hkv,s_max", [(8, 8, 576), (2, 8, 4112), (1, 8, 4112), (3, 8, 100), (1, 1, 1),
                                         (64, 8, 100_000)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("sms", [132, 114])  # H100 SXM, H100 PCIe
def test_decode_split_plan(b, hkv, s_max, dtype, sms):
    """The one-launch split-KV plan: slices are the fewest whole tiles that
    cover the cache, a cluster is a power of two within the portable limit
    of 8, the shared memory fits in 227 KB, and there is one block per
    (sequence, KV head) when those pairs already fill the card."""
    from repro_torch.kernels import decode_attention as da

    h, d = 2 * hkv, 128
    elem = torch.empty((), dtype=dtype).element_size()
    plan = da.decode_plan(b, h, hkv, s_max, d, elem, sms)
    splits, chunk, tile = plan["cluster"], plan["chunk"], plan["tile"]
    assert plan["grid"] == (splits, hkv, b) and plan["threads"] == da.THREADS
    assert tile == da.tile_keys(d, elem) and chunk % tile == 0
    assert splits * chunk >= s_max and chunk - tile < -(-max(s_max, 1) // splits)  # the least whole tiles
    assert splits & (splits - 1) == 0 and 1 <= splits <= da.MAX_CLUSTER == 8
    if b * hkv * da.MAX_CLUSTER <= da.BLOCKS_PER_SM * sms and s_max >= da.MAX_CLUSTER * da.MIN_SLICE_TILES * tile:
        assert splits == da.MAX_CLUSTER  # few pairs and a long cache: the largest cluster
    assert plan["smem_bytes"] <= 232448
    assert 2 * tile * d * elem == da.STAGE_TARGET or tile == da.MAX_TILE  # a 16 KB stage
    if b * hkv >= da.BLOCKS_PER_SM * sms:
        assert splits == 1
    if splits > 1:
        assert chunk >= da.MIN_SLICE_TILES * tile and b * hkv * splits <= 2 * da.BLOCKS_PER_SM * sms


@pytest.mark.parametrize("g", [1, 2, 3, 4, 6, 8, 12, 16, 32])
def test_decode_head_chunks(g):
    """A block serves at most MAX_GROUP query heads: G splits into as few
    chunks as will do, each within a power-of-two register group."""
    from repro_torch.kernels import decode_attention as da

    nchunk, gchunk, group = da.head_chunks(g)
    assert nchunk * gchunk >= g > (nchunk - 1) * gchunk
    assert gchunk <= group <= da.MAX_GROUP and group & (group - 1) == 0 and group < 2 * gchunk
    assert nchunk == -(-g // da.MAX_GROUP)
    plan = da.decode_plan(2, g * 8, 8, 4112, 64, 2, 132)
    assert plan["grid"][1] == 8 * nchunk and plan["heads_per_block"] == gchunk and plan["group"] == group


@pytest.mark.parametrize("b,h,hkv,s_max,lengths", [(2, 16, 8, 4112, [4111, 0]), (8, 4, 2, 576, [575, 1, 64, 65, 300, 2, 576, 129]),
                                                    (3, 6, 2, 1000, [1, 999, 500])])
def test_decode_plan_slices_merge_to_plain(b, h, hkv, s_max, lengths):
    """The kernel's arithmetic in torch on the CPU: each cluster rank's
    slice of the plan (clipped at the length) as an unnormalised log2-domain
    softmax state, merged in rank order, equals the plain version (fp32,
    2e-5); an empty sequence gives 0, as the kernel does."""
    from repro_torch.kernels import decode_attention as da

    d = 64
    rng = np.random.default_rng(b * 100 + h)
    q = torch.from_numpy(rng.standard_normal((b, h, d)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((b, s_max, hkv, d)).astype(np.float32)) for _ in range(2))
    lens = torch.tensor(lengths, dtype=torch.int32)
    plan = da.decode_plan(b, h, hkv, s_max, d, 4, 132)
    assert plan["cluster"] > 1
    g = h // hkv
    qs = q.reshape(b, hkv, g, d) * (d ** -0.5 * 1.4426950408889634)
    out = torch.zeros(b, hkv, g, d)
    for bi in range(b):
        states = []
        for r in range(plan["cluster"]):
            lo, hi = r * plan["chunk"], min(int(lens[bi]), (r + 1) * plan["chunk"])
            if hi <= lo:
                states.append((torch.full((hkv, g), -1e30), torch.zeros(hkv, g), torch.zeros(hkv, g, d)))
                continue
            s2 = torch.einsum("hgd,khd->hgk", qs[bi], k[bi, lo:hi])
            m = s2.amax(-1)
            p = torch.exp2(s2 - m[..., None])
            states.append((m, p.sum(-1), torch.einsum("hgk,khd->hgd", p, v[bi, lo:hi])))
        mx = torch.stack([st[0] for st in states]).amax(0)
        acc, l = torch.zeros(hkv, g, d), torch.zeros(hkv, g)
        for m, ls, a in states:
            wt = torch.exp2(m - mx)
            acc, l = acc + a * wt[..., None], l + ls * wt
        out[bi] = acc / l.clamp(min=1e-30)[..., None]
    want = ref.decode_attention(q, k, v, lens)
    live = lens > 0  # the plain version spreads an empty sequence's softmax over every slot
    torch.testing.assert_close(out.reshape(b, h, d)[live], want[live], atol=2e-5, rtol=2e-5)
    assert not out[~live].any()


@pytest.mark.parametrize(
    "q_shape,kv_shape,dtypes,lengths,match",
    [
        ((2, 4, 128), (2, 8, 2, 128), (torch.bfloat16,) * 3, [3, 4], "CUDA"),                      # CPU tensors
        ((2, 4, 96), (2, 8, 2, 96), (torch.bfloat16,) * 3, [3, 4], "head_dim"),                     # d 96
        ((2, 4, 128), (2, 8, 2, 128), (torch.bfloat16, torch.float32, torch.bfloat16), [3, 4], "one of"),  # mixed
        ((2, 4, 128), (2, 8, 2, 128), (torch.float16,) * 3, [3, 4], "one of"),                      # fp16
        ((2, 3, 64), (2, 8, 2, 64), (torch.float32,) * 3, [3, 4], "GQA"),                           # H % Hkv
        ((2, 4, 64), (2, 8, 2, 64), (torch.float32,) * 3, [3], "lengths"),                          # lengths (1,)
    ],
)
def test_decode_wrapper_refusals(q_shape, kv_shape, dtypes, lengths, match):
    """The decode wrapper raises before any launch and counts nothing."""
    from repro_torch.kernels import decode_attention as da

    q, k, v = (torch.zeros(shape, dtype=dt) for shape, dt in zip((q_shape, kv_shape, kv_shape), dtypes))
    before = da.decode_attention.launches
    with pytest.raises(ValueError, match=match):
        da.decode_attention(q, k, v, torch.tensor(lengths, dtype=torch.int32))
    assert da.decode_attention.launches == before


@pytest.mark.parametrize(
    "c_shape,w_shape,dtype,match",
    [((4, 60, 8), (4, 60), torch.float32, "CUDA"),     # CPU tensors
     ((4, 60, 8), (4, 61), torch.float32, "need c"),   # N mismatch
     ((60,), (60,), torch.float32, "need c"),           # no M axis
     ((4, 60, 8), (4, 60), torch.int32, "floating")],  # integer inputs
)
def test_gram_wrapper_refusals(c_shape, w_shape, dtype, match):
    """The gram wrapper raises before any launch and counts nothing."""
    c, w = torch.ones(c_shape, dtype=dtype), torch.ones(w_shape, dtype=dtype)
    before = ds.disagg_gram.launches
    with pytest.raises(ValueError, match=match):
        ds.disagg_gram(c, w)
    assert ds.disagg_gram.launches == before


@pytest.mark.parametrize(
    "g,n,m,kind",
    [(1792, 60, 8, "warp"), (64, 100, 8, "warp"), (4, 1, 5, "warp"), (16, 130, 16, "warp"), (16, 130, 17, "tiled"),
     (2, 50, 33, "tiled"), (64, 1800, 64, "tiled"), (8, 1000, 256, "tiled"), (1, 10, 300, "tiled"),
     (1, 1024, 8, "warp"), (1, 5000, 8, "tiled")],
)
def test_gram_plan(g, n, m, kind):
    """The variant is chosen by M and N (one warp walks at most WARP_MAX_N
    rows); the warp variant's chunks cover N
    and fit a 1024-float stage, its grid spreads G over the SMs; the tiled
    variant walks the upper-triangle tiles once each and splits N into
    whole slabs that cover it, in a cluster within the portable limit."""
    sms = 132
    plan = ds.gram_plan(g, n, m, sms)
    assert ds.variant(m, n) == kind == plan["variant"]
    if kind == "warp":
        rows, warps = plan["rows"], plan["warps"]
        assert 1 <= rows <= min(n, ds.WARP_MAX_ROWS) and (rows * m <= ds.WARP_STAGE_FLOATS or rows == 1)
        assert plan["chunks"] * rows >= n > (plan["chunks"] - 1) * rows
        assert 1 <= warps <= ds.MAX_WARPS and plan["threads"] == 32 * warps
        assert plan["grid"][0] <= ds.BLOCKS_PER_SM * sms
        assert plan["grid"][0] * warps >= g or plan["grid"][0] == ds.BLOCKS_PER_SM * sms
        assert plan["smem_bytes"] <= 232448
        if g <= sms:
            assert warps == 1 and plan["grid"][0] == g  # one warp on each of G SMs
        return
    tile, tiles, splits = plan["tile"], plan["tiles"], plan["splits"]
    nt = -(-m // tile)
    assert tile == (32 if m <= 128 else 64)
    assert sorted(tiles) == list(tiles) and len(tiles) == nt * (nt + 1) // 2 == len(set(tiles))
    assert all(i <= j < nt for i, j in tiles)
    covered = {(i, j) for i, j in tiles} | {(j, i) for i, j in tiles}
    assert covered == {(i, j) for i in range(nt) for j in range(nt)}
    assert plan["grid"] == (splits, g, len(tiles)) and splits & (splits - 1) == 0 and splits <= ds.MAX_CLUSTER
    assert plan["rows"] % ds.SLAB_ROWS == 0 and splits * plan["rows"] >= n > (splits - 1) * plan["rows"] - ds.SLAB_ROWS


@pytest.mark.parametrize("g,n,m", [(16, 130, 17), (2, 50, 33), (3, 130, 64), (1, 300, 100), (2, 1500, 8)])
def test_gram_plan_tiles_sum_to_plain(g, n, m):
    """The tiled variant's arithmetic in torch on the CPU: each cluster
    rank's N slice of each upper tile, added in rank order and mirrored,
    with rhs from the diagonal tiles, equals the plain version (rtol 1e-5,
    atol 1e-6 * N, the scale of an N-term fp32 sum in another order)."""
    rng = np.random.default_rng(n + m)
    c = torch.from_numpy(np.abs(rng.standard_normal((g, n, m))).astype(np.float32))
    w = torch.from_numpy(np.abs(rng.standard_normal((g, n))).astype(np.float32))
    plan = ds.gram_plan(g, n, m, 132)
    tile, rows = plan["tile"], plan["rows"]
    gram, rhs = torch.full((g, m, m), float("nan")), torch.full((g, m), float("nan"))
    for i, j in plan["tiles"]:
        ri, rj = slice(i * tile, (i + 1) * tile), slice(j * tile, (j + 1) * tile)
        block = torch.zeros(g, len(range(m)[ri]), len(range(m)[rj]))
        part_rhs = torch.zeros(g, len(range(m)[ri]))
        for r in range(plan["splits"]):
            cs = c[:, r * rows:(r + 1) * rows]
            block = block + cs[:, :, ri].mT @ cs[:, :, rj]
            if i == j:
                part_rhs = part_rhs + (cs[:, :, ri] * w[:, r * rows:(r + 1) * rows, None]).sum(1)
        gram[:, ri, rj] = block
        gram[:, rj, ri] = block.mT
        if i == j:
            rhs[:, ri] = part_rhs
    pg, pr = ref.disagg_gram(c, w)
    scale = float(c.max()) * max(float(c.max()), float(w.max()))
    torch.testing.assert_close(gram, pg, rtol=1e-5, atol=1e-6 * n * scale)
    torch.testing.assert_close(rhs, pr, rtol=1e-5, atol=1e-6 * n * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("group", [1, 2, 4, 8])
def test_cuda_decode_geometry_matches_plan(d, dtype, group, cuda_attention):
    """The built decode kernel's tile and dynamic shared memory are the
    plan's, within the card's 227 KB per block."""
    da = cuda_attention[1]
    elem = torch.empty((), dtype=dtype).element_size()
    assert da.kernel_geometry(d, elem, group) == (da.tile_keys(d, elem), da.smem_bytes(d, elem, group))
    assert da.smem_bytes(d, elem, group) <= 232448
