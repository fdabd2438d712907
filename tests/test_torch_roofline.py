"""The port's roofline (``repro_torch.launch.roofline``) against the
reference's ``repro.launch.roofline``, term for term.

With ``launch.mesh``'s H100 constants monkeypatched to the reference's v5e
figures (197e12 FLOP/s, 819e9 B/s, a 50e9 B/s link, 16 GiB a chip), the
port's ``analyze_record`` returns the reference's dict, exactly, for a
record of every runnable cell on both meshes -- with the structured
collective bytes the port's dry run writes (an empty "body"), with a
non-empty body (the reference's trip multiplier), and without the
structured bytes.  ``to_markdown``, ``load_records`` and the CLI agree too,
and under the H100's own constants the denominators are the card's:
989e12 FLOP/s, 3.35e12 B/s, one 50e9 B/s inter-node port, 80 GB.
"""

import json

import pytest

from repro.configs.registry import get_config as r_get_config
from repro.configs.registry import get_shape as r_get_shape
from repro.launch import mesh as r_mesh
from repro.launch import roofline as r_roofline
from repro_torch.configs.registry import get_config, get_shape, runnable_cells
from repro_torch.launch import mesh as meshlib
from repro_torch.launch import roofline

V5E = dict(PEAK_FLOPS_BF16=197e12, HBM_BW=819e9, LINK_BW=50e9)


@pytest.fixture
def v5e(monkeypatch):
    for name, value in V5E.items():
        monkeypatch.setattr(meshlib, name, value)
    monkeypatch.setattr(roofline, "HBM_PER_CHIP", r_roofline.HBM_PER_CHIP)
    assert (r_mesh.PEAK_FLOPS_BF16, r_mesh.HBM_BW, r_mesh.ICI_LINK_BW) == tuple(V5E.values())


def _record(arch, shape, multi_pod, structured, k=1) -> dict:
    coll = {"all-gather": 3_000_000_000 * k, "reduce-scatter": 900_000_000 * k, "all-reduce": 12_345}
    coll["total"] = sum(coll.values())
    rec = {
        "arch": arch, "shape": shape, "kind": {"train_4k": "train", "prefill_32k": "prefill"}.get(shape, "decode"),
        "mesh": "2x16x16" if multi_pod else "16x16", "devices": 512 if multi_pod else 256, "accum_steps": 1,
        "cast_params": False, "rules": "train", "cfg_overrides": {}, "lower_s": 1.0, "compile_s": 2.0,
        "flops_per_device": 1.25e14 * k, "bytes_per_device": 3.5e12, "collective_bytes": coll,
        "memory": {"argument_bytes": 9 * 2**30, "output_bytes": 8 * 2**30, "temp_bytes": int(k * 7.5 * 2**30),
                   "alias_bytes": 8 * 2**30, "peak_bytes_est": int((9 + k * 7.5) * 2**30)},
        "model_flops": 1.0, "param_count": 1,
    }
    if structured == "top":
        rec["collective_bytes_structured"] = {"top": coll, "body": {}}
    elif structured == "body":
        rec["collective_bytes_structured"] = {"top": {"total": 1000}, "body": {"all-gather": 77_000, "total": 77_000}}
    return rec


@pytest.mark.parametrize("structured", ["top", "body", None])
@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize(("arch", "shape"), runnable_cells())
def test_analyze_record_equals_reference_under_its_constants(v5e, arch, shape, multi_pod, structured):
    for k in (1, 4):  # a peak below and above the 16 GiB of a v5e chip
        rec = _record(arch, shape, multi_pod, structured, k)
        assert roofline.analyze_record(rec) == r_roofline.analyze_record(rec)


def test_overrides_and_accumulation_equal_reference(v5e):
    rec = {**_record("granite-3-8b", "train_4k", False, "body"), "accum_steps": 4,
           "cfg_overrides": {"num_layers": 8, "remat": "dots"}}
    assert roofline.analyze_record(rec) == r_roofline.analyze_record(rec)


def test_markdown_and_loading_equal_reference(v5e, tmp_path):
    for multi_pod in (False, True):
        for arch, shape in runnable_cells()[:6]:
            rec = _record(arch, shape, multi_pod, "top")
            (tmp_path / f"{arch}_{shape}_{rec['mesh']}.json").write_text(json.dumps(rec))
    for mesh in ("16x16", "2x16x16"):
        recs = roofline.load_records(str(tmp_path), mesh)
        assert recs == r_roofline.load_records(str(tmp_path), mesh) and len(recs) == 6
        rows = [roofline.analyze_record(r) for r in recs]
        assert roofline.to_markdown(rows) == r_roofline.to_markdown([r_roofline.analyze_record(r) for r in recs])


def test_advice_equals_reference():
    for arch in ("granite-3-8b", "olmoe-1b-7b"):
        cfg = get_config(arch)
        for dominant in ("compute", "memory", "collective"):
            for shape in ("train_4k", "decode_32k"):
                assert roofline._advice(dominant, cfg, get_shape(shape)) == r_roofline._advice(
                    dominant, r_get_config(arch), r_get_shape(shape))


def test_h100_denominators(tmp_path, capsys):
    """Under the card's own constants: the terms over 989e12, 3.35e12 and
    one 50e9 B/s port, and the fit against the H100's 80 GB."""
    assert (meshlib.PEAK_FLOPS_BF16, meshlib.HBM_BW, meshlib.LINK_BW) == (989e12, 3.35e12, 50e9)
    assert roofline.HBM_PER_CHIP == meshlib.HBM_BYTES and 79 * 2**30 < meshlib.HBM_BYTES < 80 * 2**30
    rec = _record("internlm2-1.8b", "train_4k", False, "top", k=12)
    row = roofline.analyze_record(rec)
    assert row["t_collective_s"] == rec["collective_bytes"]["total"] / 50e9
    assert row["fits_hbm"] is False and row["peak_mem_gib"] == (9 + 12 * 7.5)
    (tmp_path / "internlm2-1.8b_train_4k_16x16.json").write_text(json.dumps(rec))
    out = tmp_path / "roofline.md"
    roofline.main(["--dryrun", str(tmp_path), "--mesh", "16x16", "--out", str(out)])
    assert "| internlm2-1.8b | train_4k | 16x16 |" in capsys.readouterr().out
    assert json.loads(out.with_suffix(".json").read_text())[0]["dominant"] == row["dominant"]
