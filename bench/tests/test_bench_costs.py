"""The frozen FLOP and byte arithmetic against
``torch.utils.flop_counter.FlopCounterMode`` at small shapes."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from bench import costs, harness
from bench.tests.conftest import SMALL

MODEL = {**SMALL, "as_run": {"rope_theta": 10000.0, "rms_norm_eps": 1e-5}}
dense = harness.load("families", "dense")
ref = harness.load("reference", "dense")
score, train = harness.load("drivers", "score"), harness.load("drivers", "train")


def _weights(vocab_rows):
    m = dense.dims(MODEL)
    d, q, kv, f, n = m["d"], m["heads"] * m["head_dim"], m["kv_heads"] * m["head_dim"], m["ff"], m["layers"]
    g = torch.Generator().manual_seed(0)
    r = lambda *s: torch.randn(*s, generator=g) * 0.1
    return {"embed": r(vocab_rows, d), "ln_f": torch.ones(d), "unembed": r(d, vocab_rows),
            "layers": {"ln1": torch.ones(n, d), "ln2": torch.ones(n, d),
                       "attn": {"wq": r(n, d, q), "wk": r(n, d, kv), "wv": r(n, d, kv), "wo": r(n, q, d)},
                       "mixer": {"w_gate": r(n, d, f), "w_up": r(n, d, f), "w_down": r(n, f, d)}}}


def _count(fn):
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


@pytest.mark.parametrize("batch,seq", [(1, 16), (3, 40)])
def test_prefill_and_train_flops(batch, seq):
    m = dense.dims(MODEL)
    tokens = torch.randint(0, m["vocab"], (batch, seq))
    counted = _count(lambda: ref.prefill(_weights(300), tokens, MODEL))
    full_attention = dense.attention_flops(MODEL, batch, seq, seq, False)
    # the reference forms every score; the yardstick counts the causal half
    traffic = {"batch": batch, "prompt_tokens": seq, "seq": seq}
    assert counted == score.unit_flops(dense, MODEL, traffic) + full_attention / 2
    layer_products = counted - full_attention - 2 * m["d"] * m["vocab"] * batch
    assert layer_products == 2 * dense.product_weights(MODEL) * batch * seq
    causal = dense.attention_flops(MODEL, batch, seq, seq, True)
    assert train.unit_flops(dense, MODEL, traffic) == 3 * (layer_products + 2 * m["d"] * m["vocab"] * batch * seq) \
        + 3 * causal


@pytest.mark.parametrize("op,shapes", [
    ("aten::mm", [[64, 48], [48, 80]]),
    ("aten::addmm", [[80], [64, 48], [48, 80]]),
    ("aten::bmm", [[3, 64, 48], [3, 48, 80]]),
])
def test_product_work(op, shapes):
    x = [torch.randn(*s) for s in shapes]
    fn = {"aten::mm": torch.mm, "aten::addmm": torch.addmm, "aten::bmm": torch.bmm}[op]
    flops, nbytes, dt = costs.product_work(op, shapes, ["float"] * len(shapes))
    assert flops == _count(lambda: fn(*x))
    out = fn(*x)
    assert nbytes == 4 * (sum(t.numel() for t in x) + out.numel()) and dt == "float"


@pytest.mark.parametrize("causal", [True, False])
def test_flash_work_matches_the_ops_counter(causal):
    import repro_torch.kernels.ops  # noqa: F401  (registers the ops and their FLOP formulas)
    from torch._subclasses.fake_tensor import FakeTensorMode

    b, s, h, hkv, d = 2, 128, 8, 2, 64
    with FakeTensorMode():
        q = torch.empty(b, s, h, d, dtype=torch.bfloat16)
        k = torch.empty(b, s, hkv, d, dtype=torch.bfloat16)
        counted = _count(lambda: torch.ops.repro_torch.flash_attention(q, k, k, causal))
        out, lse = torch.ops.repro_torch.flash_attention_lse(q, k, k, causal)
        back = _count(lambda: torch.ops.repro_torch.flash_attention_bwd(q, k, k, out, lse, out, causal))
    shapes, dts = [[b, s, h, d], [b, s, hkv, d], [b, s, hkv, d]], ["c10::BFloat16"] * 3
    fwd, fbytes, _ = costs.flash_work("repro_torch::flash_attention", shapes, dts, causal)
    bwd, bbytes, _ = costs.flash_work("repro_torch::flash_attention_bwd", shapes, dts, causal)
    assert (fwd, bwd) == (counted, back)
    qn, kn = b * s * h * d, b * s * hkv * d
    assert fbytes == 2 * (2 * qn + 2 * kn)
    assert bbytes == 2 * (4 * qn + 4 * kn) + 4 * b * s * h


def test_bound_takes_the_larger_term():
    peaks = costs.PEAKS["NVIDIA H100 80GB HBM3"]
    assert costs.bound_seconds(989e12, 1.0, "c10::BFloat16", peaks) == pytest.approx(1.0)
    assert costs.bound_seconds(1.0, 3.35e12, "c10::BFloat16", peaks) == pytest.approx(1.0)
    assert costs.bound_seconds(67e12, 1.0, "float", peaks) == pytest.approx(1.0)
