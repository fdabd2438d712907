"""The MoE block's expert-parallel path and its two all-to-alls on a
one-rank process group in this process: NCCL on the card (marked ``cuda``,
skipped without one), gloo on the CPU.

- EP (``moe_apply`` under ``use_rules`` on the local mesh (1, 1)) against
  the capacity path (no rule context) at olmoe-1b-7b's full width on the
  card (d 2048, 64 experts top-8, expert d_ff 1024, tokens 8 x 512) and
  reduced on the CPU: outputs, aux and the gradients of x and the three
  expert weights, bitwise in fp32 and in bf16 (one rank: the same
  operations, no exchange);
- the int8 all-to-all's forward and backward against its row
  quantize-dequantize, and the exact one against the identity, bitwise, at
  (64, cap, 2048) bf16 on the card.

These are ``chip_smoke.py``'s distributed checks (b) and (c) as tests; on
the card run them with ``pytest --noconftest -m cuda``.
"""

import contextlib
import dataclasses

import pytest
import torch

from repro_torch.configs.registry import get_config
from repro_torch.distributed import sharding as shd
from repro_torch.models import moe
from repro_torch.models.common import materialize


@pytest.fixture(params=["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def local_mesh(request):
    """A one-rank group (an in-process store) and the mesh (1, 1) over it."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    device = request.param
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: NCCL runs only on the card")
    dist.init_process_group("nccl" if device == "cuda" else "gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield device, init_device_mesh(device, (1, 1), mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ep_equals_capacity_on_one_rank(local_mesh, dtype):
    device, mesh = local_mesh
    full = device == "cuda"
    cfg = get_config("olmoe-1b-7b", reduced=not full)
    cfg = dataclasses.replace(cfg, compute_dtype="float32" if dtype == torch.float32 else "bfloat16")
    b, s = (8, 512) if full else (2, 16)
    gen = torch.Generator(device=device).manual_seed(0)
    base = materialize(moe.moe_params(cfg), gen, torch.float32).to_tree()
    x0 = torch.randn(b, s, cfg.d_model, generator=gen, device=device) * 0.3
    cot = torch.randn(b, s, cfg.d_model, generator=gen, device=device)
    names = ("w_gate", "w_up", "w_down")

    def run(ctx):
        p = {k: v.to(torch.float32 if k == "router" else dtype).clone().requires_grad_() for k, v in base.items()}
        x = x0.to(dtype).clone().requires_grad_()
        with ctx:
            y, aux = moe.moe_apply(p, x, cfg)
        return [y, aux, *torch.autograd.grad((y.float() * cot).sum(), [x] + [p[n] for n in names])]

    ep, cap = run(shd.use_rules(mesh, shd.TRAIN_RULES)), run(contextlib.nullcontext())
    assert moe._ep_mesh(cfg) is None
    for a, w in zip(ep, cap):
        assert torch.equal(a, w)


def _qdq_rows(x):
    scale = torch.clamp(torch.amax(torch.abs(x), dim=-1, keepdim=True), min=1e-8) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return (q.to(torch.float32) * scale.to(torch.float32)).to(x.dtype)


@pytest.mark.parametrize("kind", ["int8", "bf16"])
def test_all_to_alls_on_one_rank(local_mesh, kind):
    device, mesh = local_mesh
    e, d = (64, 2048) if device == "cuda" else (8, 64)
    cap = moe._capacity(get_config("olmoe-1b-7b"), 8 * 512) if device == "cuda" else 12
    gen = torch.Generator(device=device).manual_seed(1)
    buf = torch.randn(e, cap, d, generator=gen, device=device).to(torch.bfloat16).requires_grad_()
    cot = torch.randn(e, cap, d, generator=gen, device=device).to(torch.bfloat16)
    y = moe._a2a(buf, mesh.get_group("model"), 0, 1, kind)
    (g,) = torch.autograd.grad(y, buf, cot)
    want_y, want_g = (_qdq_rows(buf.detach()), _qdq_rows(cot)) if kind == "int8" else (buf.detach(), cot)
    assert torch.equal(y.detach(), want_y) and torch.equal(g, want_g)
