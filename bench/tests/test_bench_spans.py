"""The readers of the port's spans (``bench/spans.py`` and the metrics
``optimizer_ms.train``, ``norm_ms.score``, ``rope_ms.score`` and
``launches_per_inv.score``) on hand-made slices: None where the slice holds
no device operation or no span of the reader's name, and the right sums
and counts where it does, counting only what was launched under the span
on the launching operator's own thread."""

import pytest
import torch

from bench import harness, spans, tracing

METRICS = {"optimizer_ms.train": "train.optimizer", "norm_ms.score": "model.norm", "rope_ms.score": "model.rope",
           "launches_per_inv.score": "serve.prefill"}


class Slice:
    """The part of ``tracing.Window`` the readers use."""

    def __init__(self, host: list, launches: list, units: int):
        self.units = units
        self.ops = [tracing.HostOp(name, s, e, tid, None, None, None) for name, s, e, tid in host]
        tracing._parents(self.ops)
        by_name = {(op.name, op.start): op for op in self.ops}
        self.device = [tracing.DeviceOp(k, t, t + length, by_name[key].operator())
                       for k, (key, t, length) in enumerate(launches)]


#: Two invocations on thread 1, the second's model work on thread 1 too; a
#: norm span open on thread 1 while thread 2 launches; the benchmark's own
#: operation after the call.
HOST = [
    ("bench::invocation", 0, 1000, 1),
    ("serve.prefill", 10, 990, 1),
    ("model.embed", 20, 40, 1), ("aten::embedding", 21, 39, 1),
    ("model.norm", 50, 150, 1), ("aten::mul", 60, 80, 1), ("aten::_to_copy", 90, 140, 1),
    ("aten::copy_", 100, 130, 1),
    ("model.attention", 200, 600, 1), ("model.rope", 210, 300, 1), ("aten::sin", 220, 230, 1),
    ("aten::cat", 240, 290, 1), ("aten::mm", 310, 400, 1), ("repro_torch::flash_attention", 410, 500, 1),
    ("serve.sync", 900, 980, 1), ("cudaDeviceSynchronize", 901, 979, 1),
    ("aten::add", 992, 998, 1),
    ("aten::mm", 55, 145, 2),
]
LAUNCHES = [
    (("aten::embedding", 21), 2000, 100),
    (("aten::mul", 60), 2100, 1000),
    (("aten::copy_", 100), 3100, 2000),     # tied to aten::copy_, its parent _to_copy, under model.norm
    (("aten::sin", 220), 5100, 300),
    (("aten::cat", 240), 5400, 30),
    (("aten::mm", 310), 5430, 5000),
    (("repro_torch::flash_attention", 410), 10430, 7000),
    (("aten::add", 992), 17430, 11),        # the benchmark's, outside serve.prefill
    (("aten::mm", 55), 17441, 13),          # thread 2, inside model.norm's interval only by the clock
]


def _slice(units=2):
    return Slice(HOST, LAUNCHES, units)


@pytest.mark.parametrize("metric", sorted(METRICS))
def test_none_without_device_operations(metric):
    s = _slice()
    s.device = []
    assert harness.reader(metric)(s) is None


@pytest.mark.parametrize("metric", sorted(METRICS))
def test_none_without_the_span(metric):
    host = [h for h in HOST if h[0] != METRICS[metric]]
    assert harness.reader(metric)(Slice(host, LAUNCHES, 2)) is None


@pytest.mark.parametrize("metric,want", [
    ("norm_ms.score", 1e-6 * (1000 + 2000) / 2),
    ("rope_ms.score", 1e-6 * (300 + 30) / 2),
    ("launches_per_inv.score", 7 / 2),
])
def test_sums_and_counts(metric, want):
    assert harness.reader(metric)(_slice()) == pytest.approx(want, rel=1e-12)


def test_launches_only_under_the_call():
    """The operations of the call, in its order: not the benchmark's own
    after it, not thread 2's."""
    got = spans.launched_under(_slice(), "serve.prefill")
    assert [d.name for d in got] == list(range(7))
    assert [d.name for d in spans.launched_under(_slice(), "model.norm")] == [1, 2]


def test_optimizer_ms_of_a_step():
    """A step whose backward runs on the autograd engine's thread: only the
    optimizer's operations count, a step at a time."""
    host = [("bench::train_step", 0, 1000, 1), ("train.forward", 10, 300, 1), ("aten::mm", 20, 30, 1),
            ("train.backward", 310, 600, 1), ("MmBackward0", 320, 400, 3), ("aten::mm", 330, 390, 3),
            ("train.optimizer", 610, 990, 1), ("aten::sqrt", 620, 630, 1), ("aten::mul", 640, 650, 1),
            ("aten::_local_scalar_dense", 995, 999, 1)]
    launches = [(("aten::mm", 20), 100, 50), (("aten::mm", 330), 200, 70), (("aten::sqrt", 620), 300, 400),
                (("aten::mul", 640), 700, 600), (("aten::_local_scalar_dense", 995), 1300, 5)]
    assert harness.reader("optimizer_ms.train")(Slice(host, launches, 4)) == pytest.approx(1e-6 * 1000 / 4)
    assert spans.ms_per_unit(Slice(host, launches, 4), "train.backward") == pytest.approx(0.0)


def test_real_cpu_trace_reads_none():
    """A CPU trace of a prefill of the REDUCED model under the benchmark's
    spans: the port's spans are in the slice, pass unseen by
    ``HostOp.operator``, and every reader reads None (no device
    operation)."""
    from bench.tests.conftest import small_cell
    from repro_torch.configs.shapes import ShapeConfig
    from repro_torch.serving.engine import ServeEngine

    cell = small_cell("internlm2-1.8b.score_16x1k")
    device = torch.device("cpu")
    api, weights, prompts, _ = cell.driver.inputs(cell, 5, device)
    from bench import system

    t = cell.traffic
    engine = ServeEngine(api, ShapeConfig("s", t["prompt_tokens"], t["batch"], "prefill"),
                         system.port_params(weights, torch.bfloat16))
    with tracing.traced(True, device) as prof:
        with torch.profiler.record_function("bench::invocation"):
            engine.prefill({"tokens": prompts[0]})
    window = tracing.Window(prof, units=1, rate=1.0, unit_ops=[], cell=cell.facts(device))
    names = {op.name for op in window.ops}
    assert set(METRICS.values()) - {"train.optimizer"} <= names
    for op in window.ops:
        if op.name in METRICS.values():
            assert op.operator() is not op and op.operator().name == "bench::invocation"
    assert window.device == []
    for metric in METRICS:
        assert harness.reader(metric)(window) is None
