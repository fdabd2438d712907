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
