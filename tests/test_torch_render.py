"""The port's record (winograd_tpu_torch/bench/render.py, roofline.py)
against winograd_tpu/bench/render.py and tools/design_tables.py, and the
committed record against its artifact.

render_row: a port CLI row, its keys mapped to the JAX CLI's ("cuda" ->
"pallas", "cudnn" -> "xla"), renders the same cells as the JAX render_row
in every column (the JAX footnote marks, † on modes 11 and 12 and ‡ on 27
and 28, are TPU findings the port does not carry, so they are stripped
from the JAX cells). update/check round-trip on a temporary README, a
dropped mode and a drifted cell are refused and named, rows that are not
one card's parity_ok CUDA rows are refused. roofline: its f32 bytes equal
tools/design_tables.py::weight_act_bytes for every mode of CASES (the file
loaded by path: tools/ is no package), the share guard trips, and the
committed README table and PERF.md roofline block are the renders of
H100_CLI_SWEEP.json."""

import importlib.util
import json
import pathlib
import sys

import pytest

from winograd_tpu.bench.render import render_row as jax_render_row
from winograd_tpu.config import CASES as JAX_CASES
from winograd_tpu_torch.bench import render, roofline
from winograd_tpu_torch.config import CASES

ROOT = pathlib.Path(__file__).resolve().parent.parent
ARTIFACT = ROOT / "H100_CLI_SWEEP.json"

ROW = {
    "mode": 0, "name": "winograd3x3_128", "backend": "cuda",
    "device_name": "NVIDIA H100 80GB HBM3", "power_limit_w": 700.0, "tf32": False,
    "parity_ok": True, "flops": 925_368_320,
    "cuda_device_us": 15.0412, "direct_device_us": 21.93, "winograd_f43_device_us": 15.2,
    "pre_device_us": None, "bf16w_device_us": 12.44, "int8_device_us": 10.02,
    "mfu_cuda": 0.0622, "cudnn_device_us": 47.133, "max_error_cuda": 1.62e-05,
}

# Rows covering every kind of cell: alternates, the stem's s2d label, the
# pre and grad columns, a time past 1 ms, missing MFU and reference cells,
# and the modes the JAX table footnotes.
ROWS = [
    ROW,
    dict(ROW, mode=1, name="winograd3x3_256", cuda_device_us=16.93, winograd_f43_device_us=None),
    dict(ROW, mode=11, name="transition_conv3_to_4", direct_device_us=None,
         winograd_f43_device_us=None, cuda_device_us=68.01),
    dict(ROW, mode=13, name="resnet50_backbone_13", direct_device_us=None,
         winograd_f43_device_us=None, cuda_device_us=1301.44, mfu_cuda=None),
    dict(ROW, mode=16, name="resnet50_full", direct_device_us=None,
         winograd_f43_device_us=None, pre_device_us=186.73),
    dict(ROW, mode=19, name="resnet50_full_trainstep", direct_device_us=None,
         winograd_f43_device_us=None, int8_device_us=None, train_grad_rel_error=6.45e-07),
    dict(ROW, mode=22, name="resnet50_stem", winograd_f43_device_us=None, pre_device_us=18.3),
    dict(ROW, mode=27, name="resnet50_full_b32", direct_device_us=None,
         winograd_f43_device_us=None, cuda_device_us=10511.8, pre_device_us=10486.3),
]

JAX_KEYS = {"cuda_device_us": "pallas_device_us", "mfu_cuda": "mfu_pallas",
            "cudnn_device_us": "xla_device_us", "max_error_cuda": "max_error_pallas"}


def _cells(line):
    return [c.strip() for c in line.strip().strip("|").split("|")]


@pytest.mark.parametrize("row", ROWS, ids=[str(r["mode"]) for r in ROWS])
def test_render_row_matches_jax_cell_by_cell(row):
    jax_row = {JAX_KEYS.get(k, k): v for k, v in row.items()}
    want = [c.rstrip("†‡") for c in _cells(jax_render_row(jax_row))]
    assert _cells(render.render_row(row)) == want
    header = _cells(render.HEADER.splitlines()[0])
    assert len(header) == len(want)
    assert header[2] == "CUDA f32 (µs)" and header[7] == "cuDNN f32 (µs)"


def test_render_has_the_card_line_and_sorts():
    out = render.render([ROWS[2], ROWS[0]]).splitlines()
    assert out[0] == ("NVIDIA H100 80GB HBM3, power limit 700.00 W; device µs a call "
                      "(CUDA-graph replays), TF32 off.")
    assert out[2:4] == render.HEADER.splitlines()
    assert out[4].startswith("| 0 |") and out[5].startswith("| 11 |")


@pytest.mark.parametrize("bad", [
    {"backend": "cpu"}, {"parity_ok": False}, {"parity_ok": None}, {"tf32": True},
    {"device_name": None}, {"power_limit_w": 450.0}, {"device_name": "NVIDIA H100 PCIe"},
], ids=lambda b: next(iter(b)) + "=" + str(next(iter(b.values()))))
def test_render_refuses_rows_not_of_one_cards_cuda_parity(bad):
    with pytest.raises(ValueError):
        render.render([ROWS[0], dict(ROWS[1], **bad)])


def test_update_and_check_round_trip(tmp_path):
    md = tmp_path / "README.md"
    md.write_text("# x\n\n" + render.TABLE_START + "\n| 0 | old | row |\n" + render.TABLE_END
                  + "\ntail\n")
    render.update_readme(str(md), ROWS)
    render.check_readme(str(md), ROWS)
    text = md.read_text()
    assert "**15.04** (direct 21.9; F(4,3) 15.2)" in text
    assert "old" not in text and text.endswith("tail\n")
    # A narrower artifact may not drop a published mode.
    with pytest.raises(SystemExit, match=r"missing modes \['1'"):
        render.update_readme(str(md), ROWS[:1])
    bare = tmp_path / "bare.md"
    bare.write_text("no markers here\n")
    with pytest.raises(SystemExit):
        render.update_readme(str(bare), ROWS)
    with pytest.raises(SystemExit):
        render.check_readme(str(bare), ROWS)


def test_check_names_a_drifted_cell_and_a_ghost_row(tmp_path):
    md = tmp_path / "README.md"
    md.write_text(render.TABLE_START + "\n" + render.TABLE_END + "\n")
    render.update_readme(str(md), ROWS)
    drifted = [dict(ROWS[0], cudnn_device_us=9.99)] + ROWS[1:]
    with pytest.raises(SystemExit) as e:
        render.check_readme(str(md), drifted)
    assert "mode 0 [cuDNN f32 (µs)]" in str(e.value) and "9.99" in str(e.value)
    with pytest.raises(SystemExit, match="mode 1: published but not in artifact"):
        render.check_readme(str(md), [r for r in ROWS if r["mode"] != 1])
    with pytest.raises(SystemExit, match="card line or header differs"):
        render.check_readme(str(md), [dict(r, power_limit_w=450.0) for r in ROWS])


def _design_tables():
    spec = importlib.util.spec_from_file_location("design_tables", ROOT / "tools/design_tables.py")
    module = importlib.util.module_from_spec(spec)
    path = list(sys.path)
    try:
        spec.loader.exec_module(module)
    finally:
        sys.path[:] = path
    return module


@pytest.fixture(scope="module")
def design_tables():
    return _design_tables()


@pytest.mark.parametrize("mode", sorted(CASES))
def test_roofline_bytes_equal_design_tables(design_tables, mode):
    want = design_tables.weight_act_bytes(JAX_CASES[mode])
    assert roofline.streamed_bytes(CASES[mode]) == want
    assert want is not None
    w, a = roofline.weight_act_counts(CASES[mode])
    assert roofline.streamed_bytes(CASES[mode], 1) == w + 4 * a


def test_roofline_share_guard_trips():
    fast = dict(ROW, cuda_device_us=1e-3)
    with pytest.raises(ValueError, match="mode 0 f32: bound"):
        roofline.render_table([fast])
    bound, by = roofline.bound_us(CASES[0], ROW["flops"], "f32")
    assert by == "ops" and bound == pytest.approx(3 * ROW["flops"] / 495e12 * 1e6)


def _artifact():
    with open(ARTIFACT) as f:
        return json.load(f)


def test_committed_sweep_covers_every_mode_from_one_card():
    rows = _artifact()
    assert sorted(r["mode"] for r in rows) == sorted(CASES)
    render.card_line(rows)   # one card, backend "cuda", parity_ok, TF32 off
    assert all("H100" in r["device_name"] for r in rows)


def test_committed_readme_table_matches_the_sweep():
    render.check_readme(str(ROOT / "README.md"), _artifact())


def test_committed_perf_roofline_matches_the_sweep():
    rows = _artifact()
    roofline.check(str(ROOT / "PERF.md"), rows, ARTIFACT.name)
    for line in roofline.render_table(rows).splitlines()[2:]:
        for cell in _cells(line):
            if cell.endswith("%"):
                assert float(cell[:-1]) <= 100 * roofline.SHARE_LIMIT
