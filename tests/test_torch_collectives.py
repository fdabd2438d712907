"""The port's collectives on 4 gloo ranks against the reference's under
``jax.vmap(..., axis_name=...)``.

- ``compressed_psum`` with a different x on each rank, against
  ``repro.distributed.collectives.compressed_psum`` at 1e-6;
- ``make_compressed_pod_mean`` over a tree on a 4-rank "pod" mesh, and its
  bound when every rank holds the same x (the reference's own test);
- the MoE block's int8 all-to-all (``_Int8AllToAll``) forward against the
  reference's ``_int8_all_to_all`` under vmap, bitwise, and its backward
  against ``_q_a2a`` with split and concat swapped (the reference's
  ``_int8_a2a_bwd``; its ``custom_vjp`` cannot be differentiated under
  vmap);
- the exact all-to-all and its transpose against ``jax.lax.all_to_all``
  (tiled), bitwise.

The ranks are ``python -c`` subprocesses meeting at a ``FileStore`` in a
temporary directory (no TCP port), launched once for the module under a
timeout of their own; each writes its results to an ``.npz`` that the
tests read, waits at a barrier for the others, destroys its group and
leaves without the interpreter's teardown (``run_ranks``).
"""

import os
import pathlib
import subprocess
import sys
import textwrap
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.distributed.collectives import compressed_psum as r_compressed_psum
from repro.models import moe as r_moe

ROOT = pathlib.Path(__file__).resolve().parent.parent
N = 4
E, C, D = 8, 3, 16  # (E, C, d) dispatch buffers: E_loc = 2 per rank


#: Appended to every rank's code, after its results are written and its
#: group destroyed: leave without the interpreter's teardown.  There, torch's
#: gloo objects that the rank's globals still hold (the mesh, its groups)
#: are destroyed while gloo's own threads run, and about one rank group in
#: 60-150 under load died of SIGABRT ("terminate called without an active
#: exception", raised in a C++ thread while the main thread had no Python
#: frame left) after every collective had completed.
RANK_EXIT = """
import os as _os, sys as _sys
_sys.stdout.flush()
_sys.stderr.flush()
_os._exit(0)
"""


def run_ranks(code: str, n: int, tmp: pathlib.Path, timeout: float = 240.0) -> None:
    """Run ``code`` as ``n`` gloo ranks (argv: rank, world, tmp dir),
    followed by ``RANK_EXIT``.

    Each rank runs with ``faulthandler`` on (a fatal signal prints its
    Python stack) and writes its output to ``tmp/rank{r}.log``, a file, so
    no rank can block on a full pipe while this process waits on another.
    The group fails, with every rank's exit code and the end of its log,
    when a rank exits non-zero (the others are stopped at once) or when it
    is still running ``timeout`` seconds after the start."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
    paths = [tmp / f"rank{r}.log" for r in range(n)]
    procs = []
    try:
        for r, path in enumerate(paths):
            with open(path, "w") as out:
                procs.append(subprocess.Popen(
                    [sys.executable, "-X", "faulthandler", "-c", textwrap.dedent(code) + RANK_EXIT, str(r), str(n),
                     str(tmp)], cwd=ROOT, env=env, stdout=out, stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout
        while any(p.poll() is None for p in procs) and not any(p.poll() for p in procs):
            if time.monotonic() > deadline:
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    report = [(p.returncode, path.read_text()[-3000:]) for p, path in zip(procs, paths)]
    assert all(rc == 0 for rc, _ in report), report


RANK_CODE = """
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.distributed.collectives import compressed_psum, make_compressed_pod_mean
    from repro_torch.models import moe

    rank, world, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(f"{tmp}/store", world), rank=rank, world_size=world)
    inp = np.load(f"{tmp}/inputs.npz")
    out = {}
    x = torch.from_numpy(inp["x"][rank])
    out["psum"] = compressed_psum(x).numpy()
    mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("pod",))
    mean = make_compressed_pod_mean(mesh, "pod")
    tree = mean({"a": x, "b": {"c": torch.from_numpy(inp["y"][rank])}})
    out["mean_a"], out["mean_c"] = tree["a"].numpy(), tree["b"]["c"].numpy()
    out["same"] = mean({"g": torch.from_numpy(inp["x"][0])})["g"].numpy()
    group = mesh.get_group("pod")
    for name, dtype in (("int8", "int8"), ("exact", "float32")):
        buf = torch.from_numpy(inp["buf"][rank]).requires_grad_()
        y = moe._a2a(buf, group, 0, 1, dtype)
        (g,) = torch.autograd.grad(y, buf, torch.from_numpy(inp["cot"][rank]))
        home = moe._a2a(y.detach(), group, 1, 0, dtype)
        out[f"{name}_fwd"], out[f"{name}_bwd"], out[f"{name}_home"] = y.detach().numpy(), g.numpy(), home.numpy()
    np.savez(f"{tmp}/rank{rank}.npz", **out)
    dist.barrier()  # no rank tears its group down while a peer's last exchange is in flight
    dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("collectives")
    rng = np.random.default_rng(0)
    inputs = {
        "x": rng.standard_normal((N, 4, 64)).astype(np.float32) * np.arange(1, N + 1, dtype=np.float32)[:, None, None],
        "y": rng.standard_normal((N, 33)).astype(np.float32),
        "buf": rng.standard_normal((N, E, C, D)).astype(np.float32),
        "cot": rng.standard_normal((N, E // N, N * C, D)).astype(np.float32),
    }
    np.savez(tmp / "inputs.npz", **inputs)
    run_ranks(RANK_CODE, N, tmp)
    return inputs, [dict(np.load(tmp / f"rank{r}.npz")) for r in range(N)]


def _vmap(fn, *xs):
    return np.asarray(jax.vmap(fn, axis_name="pod")(*(jnp.asarray(x) for x in xs)))


def test_compressed_psum_matches_reference(ranks):
    inputs, outs = ranks
    want = _vmap(lambda v: r_compressed_psum(v, "pod"), inputs["x"])
    scale = max(1.0, float(np.abs(want).max()))
    for r in range(N):
        np.testing.assert_allclose(outs[r]["psum"], want[r], rtol=0, atol=1e-6 * scale)
        np.testing.assert_array_equal(outs[r]["psum"], outs[0]["psum"])


def test_compressed_pod_mean_matches_reference(ranks):
    inputs, outs = ranks
    for key, name in (("x", "mean_a"), ("y", "mean_c")):
        want = _vmap(lambda v: r_compressed_psum(v, "pod") / N, inputs[key])
        for r in range(N):
            np.testing.assert_allclose(outs[r][name], want[r], rtol=0, atol=1e-6 * max(1.0, float(np.abs(want).max())))
    # every rank holding the same x: the mean is x within one scale step
    x = inputs["x"][0]
    bound = float(np.abs(x).max()) / 127.0 + 1e-6
    for r in range(N):
        assert float(np.abs(outs[r]["same"] - x).max()) <= bound


def test_int8_all_to_all_forward_matches_reference(ranks):
    inputs, outs = ranks
    want = _vmap(lambda v: r_moe._int8_all_to_all(v, "pod", 0, 1), inputs["buf"])
    assert want.shape == (N, E // N, N * C, D)
    for r in range(N):
        np.testing.assert_array_equal(outs[r]["int8_fwd"], want[r])


def test_int8_all_to_all_backward_matches_reference(ranks):
    inputs, outs = ranks
    want = _vmap(lambda g: r_moe._q_a2a(g, "pod", 1, 0), inputs["cot"])
    assert want.shape == (N, E, C, D)
    for r in range(N):
        np.testing.assert_array_equal(outs[r]["int8_bwd"], want[r])
    # the home trip is the int8 exchange with the axes swapped
    home = _vmap(lambda v: r_moe._q_a2a(v, "pod", 1, 0),
                 np.stack([outs[r]["int8_fwd"] for r in range(N)]))
    for r in range(N):
        np.testing.assert_array_equal(outs[r]["int8_home"], home[r])


def test_exact_all_to_all_matches_reference(ranks):
    inputs, outs = ranks
    fwd = _vmap(lambda v: jax.lax.all_to_all(v, "pod", 0, 1, tiled=True), inputs["buf"])
    bwd = _vmap(lambda g: jax.lax.all_to_all(g, "pod", 1, 0, tiled=True), inputs["cot"])
    for r in range(N):
        np.testing.assert_array_equal(outs[r]["exact_fwd"], fwd[r])
        np.testing.assert_array_equal(outs[r]["exact_bwd"], bwd[r])
        np.testing.assert_array_equal(outs[r]["exact_home"], inputs["buf"][r])  # its own inverse
