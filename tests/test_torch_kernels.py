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
@pytest.mark.parametrize("g,n,m", GRAM_SHAPES + [(1792, 60, 8), (64, 100, 8), (3, 1, 5), (5, 130, 17)])
def test_cuda_gram_vs_plain(g, n, m, cuda_device):
    """CUDA kernel vs the plain version on the card: rtol 1e-5 with an atol
    of 1e-6 * N * max|C| * max(|C|, |w|), the scale of an N-term fp32 sum
    taken in another order."""
    rng = np.random.default_rng(n * 1000 + m)
    c = torch.from_numpy(np.abs(rng.standard_normal((g, n, m))).astype(np.float32)).to(cuda_device)
    w = torch.from_numpy(np.abs(rng.standard_normal((g, n))).astype(np.float32)).to(cuda_device)
    before = ds.disagg_gram.launches
    gram, rhs = ds.disagg_gram(c, w)
    torch.cuda.synchronize()
    assert ds.disagg_gram.launches == before + 1
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

    kbuild.compile_all(["flash_attention", "decode_attention", "rmsnorm"])
    for mod in (fa, da, rn):
        mod.build()
    return fa, da, rn


def _cuda_tol(dtype):
    # fp32: sums in another order than the plain version (2e-5, the
    # reference's fp32 tolerance); bf16: one bf16 step of outputs up to ~2.
    return 2e-5 if dtype == torch.float32 else 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "b,s,t,h,hkv,d,causal",
    FLASH_CASES + [(1, 100, 333, 16, 8, 128, True), (2, 77, 77, 16, 8, 128, True), (1, 130, 130, 4, 4, 128, False)],
)
def test_cuda_flash_vs_plain(b, s, t, h, hkv, d, causal, dtype, cuda_attention):
    fa = cuda_attention[0]
    rng = np.random.default_rng(s + t)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to("cuda", dtype)
               for shape in ((b, s, h, d), (b, t, hkv, d), (b, t, hkv, d)))
    before = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    want = ref.flash_attention(q, k, v, causal)
    tol = _cuda_tol(dtype)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "b,s,h,hkv,d,lengths",
    [(3, 100, 8, 8, 32, [1, 100, 37]), (2, 70, 4, 2, 16, [70, 1]), (8, 600, 16, 8, 128, [575, 1, 64, 65, 600, 2, 300, 128])],
)
def test_cuda_decode_vs_plain(b, s, h, hkv, d, lengths, dtype, cuda_attention):
    da = cuda_attention[1]
    rng = np.random.default_rng(s)
    q = torch.from_numpy(rng.standard_normal((b, h, d)).astype(np.float32)).to("cuda", dtype)
    k, v = (torch.from_numpy(rng.standard_normal((b, s, hkv, d)).astype(np.float32)).to("cuda", dtype)
            for _ in range(2))
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    before = da.decode_attention.launches
    got = da.decode_attention(q, k, v, lens)
    torch.cuda.synchronize()
    assert da.decode_attention.launches == before + 1
    tol = _cuda_tol(dtype)
    torch.testing.assert_close(got.float(), ref.decode_attention(q, k, v, lens).float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(4, 7, 64), (101, 128), (3, 33), (4097, 2048)])
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


@pytest.mark.parametrize("b,hkv,s_max", [(8, 8, 576), (2, 8, 4112), (3, 8, 100), (1, 1, 1), (64, 8, 100_000)])
def test_decode_split_plan(b, hkv, s_max):
    """The split-KV grid: slices are whole tiles of at least MIN_SLICE keys,
    cover the cache, and stop at about BLOCKS_PER_SM blocks per SM (or one
    slice when the (sequence, KV head) pairs already fill the card)."""
    from repro_torch.kernels import decode_attention as da

    sms = 132
    splits, chunk = da.split_plan(b, hkv, s_max, sms)
    assert chunk % da.TILE == 0 and chunk >= da.MIN_SLICE
    assert splits * chunk >= s_max and (splits - 1) * chunk < s_max
    if b * hkv >= da.BLOCKS_PER_SM * sms:
        assert splits == 1
    assert splits <= max(1, -(-da.BLOCKS_PER_SM * sms // (b * hkv)))
