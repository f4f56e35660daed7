"""The H100 roofline of every CLI mode, rendered from a sweep artifact into
PERF.md.

The twin of tools/design_tables.py, on the H100:

    python -m winograd_tpu_torch.bench.roofline H100_CLI_SWEEP.json
    python -m winograd_tpu_torch.bench.roofline --update PERF.md H100_CLI_SWEEP.json
    python -m winograd_tpu_torch.bench.roofline --check PERF.md H100_CLI_SWEEP.json

For each mode and serving tier it gives the bytes the mode's in-house path
must stream (weights read once plus the boundary activations, f32; the
weights at 2 bytes in the bf16w tier and 1 in the int8 tier; what the
fused kernels keep on chip excluded), the bound those bytes and the CLI's
nominal FLOPs imply, the device time the sweep measured and the share of
the bound (bound / measured). The bound is the larger of two floors: the
bytes at the HBM rate, and the FLOPs at the tier's tensor-core rate, f32
counted as three TF32 passes (the 3xTF32 split), bf16w as two BF16 passes
(the activation split hi/lo), int8 as one pass: PERF.md §6's conventions.
A share above SHARE_LIMIT raises: the count would be wrong. The table goes
between the h100_roofline markers, headed by the artifact's name and its
card (bench/render.py::card_line, which refuses rows that are not one
card's parity_ok CUDA rows).
"""

from __future__ import annotations

import json
import re
import sys

from winograd_tpu_torch.bench.render import card_line
from winograd_tpu_torch.config import (
    CASES,
    BackboneConfig,
    BasicNetConfig,
    BlockConfig,
    LayerConfig,
    ResNet50Config,
    StemConfig,
    TransitionConfig,
)

# H100 SXM data sheet, dense: HBM3 bytes/s, and the tensor-core rates.
HBM_BYTES_S = 3.35e12
TF32_FLOPS = 495e12
BF16_FLOPS = 989e12
INT8_OPS = 1979e12

# tier: (CLI key of its device µs, bytes a weight, passes over the FLOPs, rate)
TIERS = {
    "f32": ("cuda_device_us", 4, 3, TF32_FLOPS),
    "bf16w": ("bf16w_device_us", 2, 2, BF16_FLOPS),
    "int8": ("int8_device_us", 1, 1, INT8_OPS),
}
SHARE_LIMIT = 1.05

BEGIN = "<!-- h100_roofline:begin -->"
END = "<!-- h100_roofline:end -->"


def _layer(cin, cout, hw, k=9, batch=1):
    """(weights, activations) of one fused conv layer: the offline weight
    matrix and the activation in and out at the layer boundary."""
    return k * cin * cout, batch * hw * hw * (cin + cout)


def _stages(stages):
    """Weights of a run of bottleneck stages entered through transitions."""
    total, prev = 0, None
    for c_io, c_mid, _hw, blocks in stages:
        if prev is not None:
            total += prev * c_mid + 9 * c_mid * c_mid + c_mid * c_io + prev * c_io
        total += blocks * (2 * c_io * c_mid + 9 * c_mid * c_mid)
        prev = c_io
    return total


def weight_act_counts(cfg):
    """(weight elements, activation elements) a mode's in-house path streams
    (weights once an inference, the boundary activations; intermediates the
    fused kernels keep on chip excluded): tools/design_tables.py::
    weight_act_bytes's counts, split in two."""
    if isinstance(cfg, LayerConfig):
        # F(2,3)'s (16, Cin, Cout) transformed filter, as the JAX table counts.
        return _layer(cfg.cin, cfg.cout, cfg.hw, 16 if cfg.kind == "winograd3x3" else 1)
    if isinstance(cfg, TransitionConfig):
        ho = -(-cfg.hw // 2)
        w = (cfg.c_in * cfg.c_mid + 9 * cfg.c_mid * cfg.c_mid
             + cfg.c_mid * cfg.c_out + cfg.c_in * cfg.c_out)
        return w, cfg.batch * (cfg.hw * cfg.hw * cfg.c_in + ho * ho * cfg.c_out)
    if isinstance(cfg, BlockConfig):
        w = cfg.blocks * (2 * cfg.c_io * cfg.c_mid + 9 * cfg.c_mid * cfg.c_mid)
        return w, cfg.batch * cfg.hw * cfg.hw * 2 * cfg.c_io
    if isinstance(cfg, BasicNetConfig):
        w, prev = cfg.stem_c * 3 * 49, cfg.stem_c
        for c, _hw, blocks in cfg.stages:
            if prev != c:
                w += 9 * prev * c + 9 * c * c + prev * c
                blocks -= 1
            w += blocks * 2 * 9 * c * c
            prev = c
        w += cfg.stages[-1][0] * cfg.num_classes
        return w, cfg.batch * (cfg.img ** 2 * 3 + cfg.stages[-1][0])
    if isinstance(cfg, ResNet50Config):
        c_io0, c_mid0, _hw0, _blocks0 = cfg.stages[0]
        w = cfg.stem_c * 3 * 49
        w += cfg.stem_c * c_mid0 + 9 * c_mid0 * c_mid0 + c_mid0 * c_io0 + cfg.stem_c * c_io0
        w += _stages(cfg.stages) + cfg.stages[-1][0] * cfg.num_classes
        return w, cfg.batch * (cfg.img ** 2 * 3 + cfg.num_classes)
    if isinstance(cfg, BackboneConfig):
        c_io, _c_mid, hw, _blocks = cfg.stages[0]
        return _stages(cfg.stages), cfg.batch * hw * hw * c_io
    if isinstance(cfg, StemConfig):
        return 49 * cfg.cin * cfg.cout, cfg.batch * (
            cfg.img ** 2 * cfg.cin + (cfg.img // 4) ** 2 * cfg.cout)
    raise TypeError(f"no byte count for {type(cfg).__name__}")


def streamed_bytes(cfg, weight_bytes: int = 4):
    """The bytes of weight_act_counts: weights at weight_bytes, activations
    f32 (at the default, tools/design_tables.py::weight_act_bytes)."""
    weights, acts = weight_act_counts(cfg)
    return weight_bytes * weights + 4 * acts


def bound_us(cfg, flops: int, tier: str):
    """(bound µs, "bytes" or "ops") of a mode's tier on the H100."""
    _, weight_bytes, passes, rate = TIERS[tier]
    bytes_us = streamed_bytes(cfg, weight_bytes) / HBM_BYTES_S * 1e6
    ops_us = passes * flops / rate * 1e6
    return (ops_us, "ops") if ops_us >= bytes_us else (bytes_us, "bytes")


def render_table(rows) -> str:
    head = "| mode | case |"
    for tier in TIERS:
        head += f" {tier} MiB | {tier} bound µs | {tier} µs | {tier} share |"
    out = [head, "|" + "---|" * (2 + 4 * len(TIERS))]
    for r in sorted(rows, key=lambda r: r["mode"]):
        cfg = CASES[r["mode"]]
        cells = [str(r["mode"]), r["name"]]
        for tier, (key, weight_bytes, _, _) in TIERS.items():
            measured = r.get(key)
            if measured is None:
                cells += ["—"] * 4
                continue
            bound, by = bound_us(cfg, r["flops"], tier)
            share = bound / measured
            if share > SHARE_LIMIT:
                raise ValueError(
                    f"mode {r['mode']} {tier}: bound {bound:.2f} µs over the measured "
                    f"{measured:.2f} µs (share {share:.2f} > {SHARE_LIMIT}): the count is wrong")
            cells += [f"{streamed_bytes(cfg, weight_bytes) / 2**20:.2f}",
                      f"{bound:.2f} ({by})", f"{measured:.1f}", f"{share * 100:.1f}%"]
        out.append("| " + " | ".join(cells) + " |")
    return "\n".join(out)


def render(rows, artifact: str) -> str:
    """The block between the markers: the source line and the table."""
    return (f"_Source: `{artifact}` ({card_line(rows)}) H100 SXM peaks: {HBM_BYTES_S / 1e12} TB/s, "
            f"{TF32_FLOPS / 1e12:.0f} TF32, {BF16_FLOPS / 1e12:.0f} BF16, "
            f"{INT8_OPS / 1e12:.0f} INT8 T/s._\n\n" + render_table(rows))


def _block(path: str):
    with open(path) as f:
        text = f.read()
    m = re.search(re.escape(BEGIN) + r"\n(.*?)\n?" + re.escape(END), text, flags=re.S)
    if m is None:
        raise SystemExit(f"{path} has no {BEGIN}/{END} markers")
    return text, m


def update(path: str, rows, artifact: str) -> None:
    """Write the rendered block between the markers of `path`."""
    text, m = _block(path)
    with open(path, "w") as f:
        f.write(text[:m.start()] + BEGIN + "\n" + render(rows, artifact) + "\n" + END
                + text[m.end():])


def check(path: str, rows, artifact: str) -> None:
    """Raise SystemExit unless the block in `path` is the artifact's render."""
    _, m = _block(path)
    if m.group(1).strip() != render(rows, artifact).strip():
        want = render(rows, artifact).splitlines()
        have = m.group(1).strip().splitlines()
        diff = [f"  PERF.md: {h!r}\n  render:  {w!r}" for h, w in zip(have, want) if h != w]
        raise SystemExit(f"{path} roofline block drifted from {artifact}:\n" + "\n".join(
            diff[:10] or [f"  {len(have)} lines against {len(want)}"]))


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    mode = path = None
    if argv and argv[0] in ("--update", "--check"):
        if len(argv) < 2:
            print(f"{argv[0]} needs a PERF.md path", file=sys.stderr)
            return 2
        mode, path, argv = argv[0], argv[1], argv[2:]
    if len(argv) != 1:
        print("usage: python -m winograd_tpu_torch.bench.roofline "
              "[--update PERF.md | --check PERF.md] SWEEP.json", file=sys.stderr)
        return 2
    artifact = argv[0]
    with open(artifact) as f:
        rows = json.load(f)
    name = artifact.rsplit("/", 1)[-1]
    if mode == "--update":
        update(path, rows, name)
        check(path, rows, name)
        print(f"updated the roofline block in {path} ({len(rows)} rows)", file=sys.stderr)
    elif mode == "--check":
        check(path, rows, name)
        print(f"{path} roofline block matches {name}", file=sys.stderr)
    else:
        print(render(rows, name))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
