"""Port vs reference: the chunked SSD core (``models/ssm.py``) and the xLSTM
blocks (``models/xlstm.py``) on the reduced xlstm-350m config in fp32.

The reference's parameters come over with ``convert.params_from_numpy``
(the stacked "pairs"); the same seeded numpy inputs go through both
packages.  Everything is pinned at ``max|port - ref| <= 1e-5 * max(1,
max|ref|)``: both frameworks take the same fp32 sums in other orders.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.xlstm_350m import REDUCED as REF_REDUCED
from repro.models import build as r_build
from repro.models import ssm as r_ssm
from repro.models import xlstm as r_xl
from repro.models.common import materialize as r_materialize
from repro_torch.configs.xlstm_350m import REDUCED
from repro_torch.convert import params_from_numpy
from repro_torch.models import ssm as t_ssm
from repro_torch.models import xlstm as t_xl

B, S = 2, 40


def close(got, want, rel=1e-5):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.max(np.abs(got - want)))
    assert err <= rel * max(1.0, float(np.max(np.abs(want)))), err


def _ssd_inputs(rng, b, s, h, p, n):
    f32 = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    dt = np.exp(np.clip(f32(b, s, h), -8, 8)).astype(np.float32) * 0.1
    da = -np.log1p(np.exp(-f32(b, s, h))).astype(np.float32)  # log sigmoid: log-decays <= 0
    return f32(b, s, h, p), dt, da, f32(b, s, h, n) * 0.3, f32(b, s, h, n)


@pytest.mark.parametrize("s,chunk,with_h0", [(64, 16, False), (50, 16, True), (7, 16, True), (33, 8, False)])
def test_ssd_chunked_matches(s, chunk, with_h0):
    """Chunk multiples and ragged tails (S % chunk != 0, S < chunk), with
    and without an initial state."""
    rng = np.random.default_rng(s)
    b, h, p, n = 2, 3, 5, 4
    args = _ssd_inputs(rng, b, s, h, p, n)
    h0 = rng.standard_normal((b, h, p, n)).astype(np.float32) if with_h0 else None
    y_r, hf_r = r_ssm.ssd_chunked(*map(jnp.asarray, args), chunk, None if h0 is None else jnp.asarray(h0))
    y_t, hf_t = t_ssm.ssd_chunked(*map(torch.tensor, args), chunk, None if h0 is None else torch.tensor(h0))
    close(y_t, y_r)
    close(hf_t, hf_r)


@pytest.fixture(scope="module")
def blocks():
    rcfg = dataclasses.replace(REF_REDUCED, compute_dtype="float32", ssm_chunk=16)
    tcfg = dataclasses.replace(REDUCED, compute_dtype="float32", ssm_chunk=16)
    r_params = r_materialize(r_build(rcfg).params_def, jax.random.PRNGKey(0))
    t_params = params_from_numpy(jax.tree.map(np.asarray, r_params), tcfg, device="cpu")
    assert len(t_params["pairs"]) == tcfg.num_layers // 2
    pair_r = jax.tree.map(lambda a: a[0], r_params["pairs"])
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, S, tcfg.d_model)).astype(np.float32)
    x1 = rng.standard_normal((B, 1, tcfg.d_model)).astype(np.float32)
    return rcfg, tcfg, pair_r, t_params["pairs"][0], x, x1


def test_mlstm_apply_and_decode_match(blocks):
    rcfg, tcfg, pr, pt, x, x1 = blocks
    assert pt["m"]["b_if"].dtype == torch.float32
    y_r, st_r = r_xl.mlstm_apply(pr["m"], jnp.asarray(x), rcfg, return_state=True)
    y_t, st_t = t_xl.mlstm_apply(pt["m"], torch.tensor(x), tcfg, return_state=True)
    close(y_t, y_r)
    close(st_t, st_r)
    close(t_xl.mlstm_apply(pt["m"], torch.tensor(x), tcfg), y_r)
    # a ragged tail (S % chunk != 0) carried on from that state
    y2_r, st2_r = r_xl.mlstm_apply(pr["m"], jnp.asarray(x[:, :21]), rcfg, state=st_r, return_state=True)
    y2_t, st2_t = t_xl.mlstm_apply(pt["m"], torch.tensor(x[:, :21]), tcfg, state=st_t, return_state=True)
    close(y2_t, y2_r)
    close(st2_t, st2_r)
    d_r, dst_r = r_xl.mlstm_decode(pr["m"], jnp.asarray(x1), st2_r, rcfg)
    state = st2_t.clone()
    d_t, dst_t = t_xl.mlstm_decode(pt["m"], torch.tensor(x1), state, tcfg)
    assert dst_t is state  # updated in place
    close(d_t, d_r)
    close(dst_t, dst_r)


def test_slstm_apply_and_decode_match(blocks):
    rcfg, tcfg, pr, pt, x, x1 = blocks
    assert pt["s"]["r"].dtype == torch.float32 and pt["s"]["gamma"].dtype == torch.float32
    y_r, st_r = r_xl.slstm_apply(pr["s"], jnp.asarray(x), rcfg, return_state=True)
    y_t, st_t = t_xl.slstm_apply(pt["s"], torch.tensor(x), tcfg, return_state=True)
    close(y_t, y_r)
    for a, b in zip(st_t, st_r):
        close(a, b)
    d_r, dst_r = r_xl.slstm_decode(pr["s"], jnp.asarray(x1), st_r, rcfg)
    d_t, dst_t = t_xl.slstm_decode(pt["s"], torch.tensor(x1), st_t, tcfg)
    close(d_t, d_r)
    for a, b in zip(dst_t, dst_r):
        close(a, b)
