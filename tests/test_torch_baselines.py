"""Port vs reference: the baseline profilers of ``core/baselines.py``.

Mirrors the baseline cases of tests/test_misc_core.py and holds every
function against the reference's on the same seeded numpy inputs at 1e-5
of the output's scale (``max|port - ref| <= 1e-5 * max(1, max|ref|)``):
each baseline is a few float32 reductions, whose order may differ between
XLA and torch.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import baselines as ref_baselines
from repro_torch.core import baselines

CPU = dict(device="cpu")


def _scaled(port, ref, rel=1e-5) -> bool:
    port, ref = np.asarray(port.numpy(), np.float64), np.asarray(ref, np.float64)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    return float(np.max(np.abs(port - ref), initial=0.0)) <= rel * max(1.0, float(np.abs(ref).max(initial=0.0)))


def _inputs(seed, t=2000, m=6, busy=0.3):
    rng = np.random.default_rng(seed)
    activity = ((rng.random((t, m)) < busy) * rng.integers(1, 4, (t, m))).astype(np.float32)
    chip = (60.0 + 40.0 * rng.random(t)).astype(np.float32)
    inv = rng.integers(0, 300, m).astype(np.float32)
    inv[0] = 0.0  # a function never invoked: the count clamps at 1
    lat = rng.random(m).astype(np.float32)
    return activity, chip, inv, lat


def test_direct_attribution_splits_evenly():
    act = torch.ones(10, 2)
    chip = torch.full((10,), 100.0)
    e = baselines.direct_attribution(act, chip, 0.1, torch.ones(2), torch.ones(2), **CPU)
    np.testing.assert_allclose(e.numpy(), [50.0, 50.0], rtol=1e-5)


def test_model_only_ignores_measurement():
    c = torch.tensor([[1.0, 0.0], [0.0, 2.0]])
    e = baselines.model_only_attribution(c, 1.0, torch.tensor(30.0), torch.tensor([1.0, 2.0]), torch.ones(2), **CPU)
    np.testing.assert_allclose(e.numpy(), [30.0, 60.0])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_direct_attribution_matches_reference(seed):
    activity, chip, inv, lat = _inputs(seed)
    activity[::7] = 0.0  # idle samples: no share anywhere
    activity[3, :] = 0.25  # fractional activity below one: divided by 1
    want = ref_baselines.direct_attribution(
        jnp.asarray(activity), jnp.asarray(chip), 0.01, jnp.asarray(lat), jnp.asarray(inv)
    )
    got = baselines.direct_attribution(activity, chip, 0.01, lat, inv, **CPU)
    assert got.dtype == torch.float32 and _scaled(got, want)


@pytest.mark.parametrize(
    "sample_bins,stale_bins,resident_bins",
    [(50, 0, 500), (50, 120, 500), (10, 35, 40), (25, 0, 10_000), (7, 3, 14)],
)
def test_scaphandre_like_matches_reference(sample_bins, stale_bins, resident_bins):
    """Coarse sampling, stale readings, resident-container even split, a
    keep-alive window longer than the trace, and a trace that is not a
    whole number of sampling windows (T = 2003)."""
    activity, chip, inv, _ = _inputs(sample_bins + stale_bins, t=2003, busy=0.05)
    activity[:400, 2] = 0.0  # a container that becomes resident late
    activity[900:, 4] = 0.0  # and one whose keep-alive runs out
    kw = dict(sample_bins=sample_bins, stale_bins=stale_bins, resident_bins=resident_bins)
    want = ref_baselines.scaphandre_like(
        jnp.asarray(activity), jnp.asarray(chip), 0.01, jnp.asarray(inv), **kw
    )
    got = baselines.scaphandre_like(activity, chip, 0.01, inv, **kw, **CPU)
    assert got.dtype == torch.float32 and _scaled(got, want)


def test_scaphandre_like_degrades_from_direct():
    """The faithful model departs from the perfect-sampling bound: the
    even split over resident containers hands idle ones energy."""
    activity, chip, inv, lat = _inputs(5, busy=0.02)
    direct = baselines.direct_attribution(activity, chip, 0.01, lat, inv, **CPU)
    scaph = baselines.scaphandre_like(activity, chip, 0.01, inv, **CPU)
    assert torch.isfinite(scaph).all() and not torch.allclose(direct, scaph, rtol=0.05)


@pytest.mark.parametrize("watts", ["scalar", "per_fn"])
def test_model_only_attribution_matches_reference(watts):
    rng = np.random.default_rng(7)
    c = (rng.random((300, 6)) * (rng.random((300, 6)) > 0.5)).astype(np.float32)
    inv = rng.integers(0, 50, 6).astype(np.float32)
    lat = rng.random(6).astype(np.float32)
    w = np.float32(35.0) if watts == "scalar" else (rng.random(6) * 80.0).astype(np.float32)
    want = ref_baselines.model_only_attribution(
        jnp.asarray(c), 1.0, jnp.asarray(w), jnp.asarray(lat), jnp.asarray(inv)
    )
    got = baselines.model_only_attribution(c, 1.0, w, lat, inv, **CPU)
    assert _scaled(got, want)


def test_baselines_default_to_the_card():
    """No device= means the card; without one the call raises instead of
    quietly running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    activity, chip, inv, lat = _inputs(0, t=100)
    for call in (
        lambda: baselines.direct_attribution(activity, chip, 0.01, lat, inv),
        lambda: baselines.scaphandre_like(activity, chip, 0.01, inv),
        lambda: baselines.model_only_attribution(activity, 1.0, 30.0, lat, inv),
    ):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
