"""The reference's parameters that the port takes with their meaning
(ROADMAP item 16), each against the reference where it has one:

- ``fleet_stream_init(x0, n_w, config)``: the reference's own positional
  call (``tests/test_streaming_engine.py``'s warm handoff) runs, and its
  stream ends where the reference's does;
- ``attention_decode(..., use_rope=False)``: no rotary positions on q or
  the new K row, against the reference's at 1e-5 of scale, and unlike the
  default;
- ``prefetch_iterator(it, transfer=...)``: ``transfer`` runs on the
  producer thread, its result is what the consumer sees, and its
  exception re-raises at the consumer, as the reference's does;
- ``init_cache(api, shape, shardings=...)``: each leaf placed as
  ``sharding.place`` places it, on a fake 2-rank ("data", "model") mesh;
- ``ServeEngine.generate(..., greedy=False)``: the argmax either way, as
  in the reference; ``MeteredServer(profiler_config)`` kept;
- ``launch.mesh.ICI_LINK_BW``: the roofline's collective link.
"""

import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.internlm2_1_8b import REDUCED as REF_REDUCED
from repro.core.engine import EngineConfig as RefEngineConfig
from repro.core.engine import run_fleet_stream as ref_run_fleet_stream
from repro.core.engine import synthetic_fleet as ref_synthetic_fleet
from repro.core.profiler import ProfilerConfig as RefProfilerConfig
from repro.data.pipeline import prefetch_iterator as ref_prefetch_iterator
from repro.models import attention as r_attn
from repro.models import build as r_build
from repro.models.common import materialize as r_materialize
from repro.serving.control_plane import MeteredServer as RefMeteredServer
from repro_torch.configs.internlm2_1_8b import REDUCED
from repro_torch.configs.shapes import ShapeConfig
from repro_torch.convert import fleet_inputs_from_numpy, params_from_numpy
from repro_torch.core.engine import (
    EngineConfig,
    fleet_initial_estimate,
    fleet_step,
    fleet_stream_init,
    fleet_ticks,
    run_fleet_stream,
)
from repro_torch.core.profiler import ProfilerConfig
from repro_torch.data.pipeline import prefetch_iterator
from repro_torch.distributed import sharding as shd
from repro_torch.launch import mesh as meshlib
from repro_torch.models import attention as t_attn
from repro_torch.models import build
from repro_torch.models.common import materialize
from repro_torch.serving.control_plane import MeteredServer
from repro_torch.serving.engine import ServeEngine
from repro_torch.serving.kv_cache import init_cache


def _scaled_err(got, want) -> tuple[float, float]:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max()), max(1.0, float(np.abs(want).max()))


def test_fleet_stream_init_takes_config_positionally():
    """The reference's warm handoff, as its own test writes it: the stream
    state made by ``fleet_stream_init(x0, n_w, cfg)``, half the ticks, the
    carried state handed on, the rest; the end equals the port's
    ``run_fleet_stream`` bitwise and the reference's at 1e-5 of scale."""
    b, s, n_w, m = 2, 6, 8, 5
    ref_in = ref_synthetic_fleet(b, s, n_w, m, seed=7)
    inputs = fleet_inputs_from_numpy(*(None if x is None else np.asarray(x) for x in ref_in), device="cpu")
    cfg = EngineConfig()
    x0 = fleet_initial_estimate(inputs.c, inputs.w, cfg)
    state = fleet_stream_init(x0, n_w, cfg, device="cpu")
    ticks = fleet_ticks(inputs)
    for t in range(s * n_w):
        state, _ = fleet_step(state, ticks.at(t), cfg)
    assert torch.equal(state.kalman.x, run_fleet_stream(inputs, cfg, device="cpu").x_final)
    err, scale = _scaled_err(state.kalman.x.numpy(), ref_run_fleet_stream(ref_in, RefEngineConfig()).x_final)
    assert err <= 1e-5 * scale, err


@pytest.fixture(scope="module")
def internlm2():
    """fp32 reduced internlm2 in both packages, on the reference's weights."""
    rcfg = dataclasses.replace(REF_REDUCED, compute_dtype="float32")
    tcfg = dataclasses.replace(REDUCED, compute_dtype="float32")
    r_params = r_materialize(r_build(rcfg).params_def, jax.random.PRNGKey(0))
    t_params = params_from_numpy(jax.tree.map(np.asarray, r_params), tcfg, device="cpu")
    return rcfg, tcfg, r_params, t_params


def test_attention_decode_without_rope_matches_reference(internlm2):
    rcfg, tcfg, r_params, t_params = internlm2
    rng = np.random.default_rng(5)
    b, s_max, pos = 2, 12, 7
    x = rng.standard_normal((b, 1, tcfg.d_model)).astype(np.float32)
    kc, vc = (rng.standard_normal((b, s_max, tcfg.num_kv_heads, tcfg.head_dim)).astype(np.float32) for _ in range(2))
    p_ref = jax.tree.map(lambda a: a[0], r_params["layers"])["attn"]
    y_r, kc_r, vc_r = r_attn.attention_decode(p_ref, jnp.asarray(x), jnp.asarray(pos, jnp.int32), jnp.asarray(kc),
                                              jnp.asarray(vc), rcfg, use_rope=False)
    p = t_params["layers"][0]["attn"]
    y_t, kc_t, vc_t = t_attn.attention_decode(p, torch.tensor(x), pos, torch.tensor(kc), torch.tensor(vc), tcfg,
                                              use_rope=False)
    for got, want in ((y_t, y_r), (kc_t, kc_r), (vc_t, vc_r)):
        err, scale = _scaled_err(got.numpy(), want)
        assert err <= 1e-5 * scale, err
    y_rope, kc_rope, _ = t_attn.attention_decode(p, torch.tensor(x), pos, torch.tensor(kc), torch.tensor(vc), tcfg)
    assert not torch.allclose(kc_rope[:, pos], kc_t[:, pos]) and not torch.allclose(y_rope, y_t)


def test_prefetch_transfer_runs_on_the_producer_thread():
    threads = []

    def transfer(x):
        threads.append(threading.current_thread())
        return torch.as_tensor(x) * 2

    items = [np.full(3, i, np.float32) for i in range(5)]
    got = list(prefetch_iterator(iter(items), 2, transfer=transfer))
    want = list(ref_prefetch_iterator(iter(items), 2, transfer=lambda x: np.asarray(x) * 2))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    assert len(threads) == 5 and all(t.name == "prefetch-producer" for t in threads)
    assert threading.current_thread() not in threads

    def failing(x):
        if float(x[0]) == 2:
            raise ValueError("transfer failed at 2")
        return x

    it = prefetch_iterator(iter(items), 2, transfer=failing)
    assert float(next(it)[0]) == 0 and float(next(it)[0]) == 1
    with pytest.raises(ValueError, match="transfer failed at 2"):
        next(it)


def test_init_cache_places_each_leaf_on_its_sharding():
    """On a fake 2-rank ("data", "model") = (1, 2) mesh under the serve
    rules: every leaf of the cache is its ``sharding_for`` placement of the
    zeros (``place``'s block), reduced internlm2's Hkv 2 split on "model"."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor

    api = build(REDUCED)
    shape = ShapeConfig("d", 16, 2, "decode")
    specs = api.cache_spec(shape)
    with meshlib.fake_process_group(2):
        mesh = init_device_mesh("cpu", (1, 2), mesh_dim_names=("data", "model"))
        shardings = {k: shd.sharding_for(s.axes, s.shape, mesh, shd.SERVE_RULES) for k, s in specs.items()}
        cache = init_cache(api, shape, shardings=shardings, device="cpu")
        assert set(cache) == set(specs)
        for k, leaf in cache.items():
            assert isinstance(leaf, DTensor) and tuple(leaf.placements) == tuple(shardings[k].placements), k
            want = shd.place(torch.zeros(specs[k].shape, dtype=specs[k].dtype), shardings[k])
            assert leaf.to_local().shape == want.to_local().shape and not leaf.to_local().any(), k
            assert leaf.to_local().dtype == specs[k].dtype
        assert cache["k"].to_local().shape[3] == REDUCED.num_kv_heads // 2  # (L, B, S, Hkv, hd) on "model"
    plain = init_cache(api, shape, device="cpu")
    assert all(not isinstance(v, DTensor) and v.shape == specs[k].shape for k, v in plain.items())


def test_generate_greedy_flag_and_metered_server_profiler_config():
    """``greedy=False`` gives the argmax tokens, as the reference's
    ``generate`` does whatever the flag; ``MeteredServer`` keeps its
    ``profiler_config`` as the reference's does."""
    api = build(dataclasses.replace(REDUCED, compute_dtype="float32"))
    params = materialize(api.params_def, torch.Generator().manual_seed(0), torch.float32)
    shape = ShapeConfig("g", 8, 2, "prefill")
    tokens = torch.as_tensor(np.random.default_rng(0).integers(0, REDUCED.vocab_size, (2, 8)), dtype=torch.int32)
    engine = ServeEngine(api, shape, params)
    greedy = engine.generate({"tokens": tokens}, 4)
    assert torch.equal(engine.generate({"tokens": tokens}, 4, greedy=False), greedy)
    config = ProfilerConfig()
    assert MeteredServer(config).profiler_config is config and MeteredServer().profiler_config is None
    ref_config = RefProfilerConfig()
    assert RefMeteredServer(ref_config).profiler_config is ref_config


def test_ici_link_bw_is_the_roofline_link():
    from repro.launch import mesh as r_mesh

    assert meshlib.ICI_LINK_BW == meshlib.LINK_BW == 50e9
    assert r_mesh.ICI_LINK_BW == 50e9  # the reference's TPU figure happens to be the same rate
