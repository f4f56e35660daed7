"""Render the README's H100 results table from a CLI sweep artifact.

The twin of winograd_tpu/bench/render.py. The table is a pure function of
the artifact, so no published cell can be hand-edited away from the
measurement it cites:

    python -m winograd_tpu_torch.bench.render H100_CLI_SWEEP.json
    python -m winograd_tpu_torch.bench.render --update README.md H100_CLI_SWEEP.json
    python -m winograd_tpu_torch.bench.render --check README.md H100_CLI_SWEEP.json

The artifact is the port CLI's rows (`python -m winograd_tpu_torch.bench
all --json --resume FILE`, bench/cli.py::run_case's keys). The table sits
between its own markers in the README's port section, apart from the JAX
package's TPU table. --update refuses to drop a mode the README already
publishes; --check names every cell that differs from the artifact's
render. Rows must come from one card, in house on CUDA ("backend"
"cuda"), with parity_ok and TF32 off.

Reference frame: the "TITAN X" column carries the reference repo's own
custom-kernel latencies on a TITAN X for its six layer cases (BASELINE.md):
cross-hardware context, not a kernel-against-kernel claim. bench_table.py's
table of the JAX package is this table without the pre and grad columns,
so it has no twin of its own.
"""

from __future__ import annotations

import json
import sys

# The reference's custom-kernel TITAN X latencies for its six cases
# (BASELINE.md).
REF_TITAN_X_US = {0: 59, 1: 117, 2: 58, 3: 55, 4: 186, 5: 181}

# Case-column annotations for the composed modes.
CASE_NOTES = {
    7: "(N=8)",
    14: "(N=8)",
    15: "(full ResNet-50 trunk)",
    16: "(COMPLETE classifier, image → logits)",
    17: "(fwd+bwd)",
    18: "(classifier, N=8)",
    19: "(image → logits fwd+bwd)",
    20: "(ResNet-101, image → logits)",
    21: "(ResNet-152, image → logits)",
    22: "(stem: 7×7/2 conv+BN+ReLU+maxpool)",
    25: "(fwd+bwd)",
    26: "(ResNet-18, N=8)",
    27: "(classifier, N=32)",
    28: "(ResNet-18, N=32)",
}

# What the generic "direct" alternate-algorithm slot means per mode (the
# stem's alternate is the space-to-depth patch-matrix route).
DIRECT_LABEL = {22: "s2d"}

TABLE_START = "<!-- H100_TABLE_START -->"
TABLE_END = "<!-- H100_TABLE_END -->"

HEADER = (
    "| Mode | Case | CUDA f32 (µs) | pre (µs) | bf16w (µs) | int8 (µs) "
    "| MFU (of 989 TFLOP/s) | cuDNN f32 (µs) | ref TITAN X (µs) | max err | grad err |\n"
    "|---|---|---|---|---|---|---|---|---|---|---|"
)


def _us(v, digits=2):
    if v is None:
        return "—"
    if v >= 1000:
        return f"{v:.1f}"
    return f"{v:.{digits}f}"


def render_row(r: dict) -> str:
    mode = r["mode"]
    f32 = f"**{_us(r['cuda_device_us'])}**"
    # Alternate in-house f32 algorithms, where the case ran them.
    alts = []
    if r.get("direct_device_us") is not None:
        label = DIRECT_LABEL.get(mode, "direct")
        alts.append(f"{label} {_us(r['direct_device_us'], 1)}")
    if r.get("winograd_f43_device_us") is not None:
        alts.append(f"F(4,3) {_us(r['winograd_f43_device_us'], 1)}")
    if alts:
        f32 += f" ({'; '.join(alts)})"
    mfu = r.get("mfu_cuda")
    name = r["name"]
    if mode in CASE_NOTES:
        name += f" {CASE_NOTES[mode]}"
    grad = r.get("train_grad_rel_error")
    cells = [
        str(mode),
        name,
        f32,
        # The prepared-input serving contract (stem_prepare_input), where
        # measured.
        _us(r.get("pre_device_us"), 1),
        _us(r.get("bf16w_device_us"), 1),
        _us(r.get("int8_device_us"), 1),
        f"{mfu * 100:.1f}%" if mfu is not None else "—",
        _us(r.get("cudnn_device_us")),
        str(REF_TITAN_X_US.get(mode, "—")),
        f"{r['max_error_cuda']:.1e}",
        f"{grad:.1e}" if grad is not None else "—",
    ]
    return "| " + " | ".join(cells) + " |"


def card_line(rows: list[dict]) -> str:
    """The caption: the one card every row ran on, refusing rows that are
    not the port's in-house CUDA rows with parity_ok and TF32 off, or that
    disagree on the card."""
    cards = set()
    for r in rows:
        if r.get("backend") != "cuda":
            raise ValueError(f"mode {r.get('mode')}: backend {r.get('backend')!r}, not 'cuda'")
        if r.get("parity_ok") is not True:
            raise ValueError(f"mode {r['mode']}: no parity_ok")
        if r.get("tf32"):
            raise ValueError(f"mode {r['mode']}: run with TF32 on")
        if r.get("device_name") is None or r.get("power_limit_w") is None:
            raise ValueError(f"mode {r['mode']}: no device_name or power_limit_w")
        cards.add((r["device_name"], float(r["power_limit_w"])))
    if len(cards) != 1:
        raise ValueError(f"the rows come from {len(cards)} cards: {sorted(cards)}")
    name, limit = cards.pop()
    return (f"{name}, power limit {limit:.2f} W; device µs a call (CUDA-graph replays), "
            "TF32 off.")


def render(rows: list[dict]) -> str:
    lines = [card_line(rows), "", HEADER]
    lines += [render_row(r) for r in sorted(rows, key=lambda r: r["mode"])]
    return "\n".join(lines)


def _table(path: str) -> tuple[str, int, int]:
    with open(path) as f:
        text = f.read()
    if TABLE_START not in text or TABLE_END not in text:
        raise SystemExit(f"{path} has no {TABLE_START}/{TABLE_END} markers")
    return text, text.index(TABLE_START) + len(TABLE_START), text.index(TABLE_END)


def _rows(lines) -> dict:
    """Table rows by mode."""
    return {
        l.split("|")[1].strip(): l
        for l in lines
        if l.strip().startswith("|") and l.split("|")[1].strip().isdigit()
    }


def update_readme(readme_path: str, rows: list[dict]) -> None:
    """Replace the table between the H100_TABLE markers. Refuses to drop
    modes: every mode the README's table publishes must be in the
    artifact."""
    text, start, end = _table(readme_path)
    have = set(_rows(text[start:end].splitlines()))
    got = {str(r["mode"]) for r in rows}
    if have - got:
        raise SystemExit(
            f"artifact is missing modes {sorted(have - got, key=int)} that the README table "
            "already publishes; run the full sweep first")
    with open(readme_path, "w") as f:
        f.write(text[:start] + "\n" + render(rows) + "\n" + text[end:])


def check_readme(readme_path: str, rows: list[dict]) -> None:
    """Hold the README's published table to the artifact cell by cell.
    Raises SystemExit naming every cell that disagrees."""
    text, start, end = _table(readme_path)
    published = text[start:end].strip().splitlines()
    expected = render(rows).splitlines()
    mismatches = []
    n_head = 2 + len(HEADER.splitlines())   # the card line, a blank, the header
    if published[:n_head] != expected[:n_head]:
        mismatches.append("card line or header differs")
    pub_rows, exp_rows = _rows(published[n_head:]), _rows(expected[n_head:])
    cols = [c.strip() for c in HEADER.splitlines()[0].strip("|").split("|")]
    for mode in sorted(set(pub_rows) | set(exp_rows), key=int):
        p, e = pub_rows.get(mode), exp_rows.get(mode)
        if p is None:
            mismatches.append(f"mode {mode}: in artifact but not published")
        elif e is None:
            mismatches.append(f"mode {mode}: published but not in artifact")
        elif p != e:
            pc = [c.strip() for c in p.strip().strip("|").split("|")]
            ec = [c.strip() for c in e.strip().strip("|").split("|")]
            for i, col in enumerate(cols):
                if i < len(pc) and i < len(ec) and pc[i] != ec[i]:
                    mismatches.append(f"mode {mode} [{col}]: README has {pc[i]!r}, "
                                      f"artifact renders {ec[i]!r}")
    if mismatches:
        raise SystemExit(
            f"{readme_path} table drifted from the artifact ({len(mismatches)} cell(s)):\n  "
            + "\n  ".join(mismatches))


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    update = check = None
    if argv and argv[0] in ("--update", "--check"):
        if len(argv) < 2:
            print(f"{argv[0]} needs a README path", file=sys.stderr)
            return 2
        update, check = (argv[1], None) if argv[0] == "--update" else (None, argv[1])
        argv = argv[2:]
    if len(argv) != 1:
        print("usage: python -m winograd_tpu_torch.bench.render "
              "[--update README.md | --check README.md] SWEEP.json", file=sys.stderr)
        return 2
    with open(argv[0]) as f:
        rows = json.load(f)
    if update:
        update_readme(update, rows)
        check_readme(update, rows)  # regeneration must round-trip
        print(f"updated table in {update} ({len(rows)} rows)", file=sys.stderr)
    elif check:
        check_readme(check, rows)
        print(f"{check} table matches the artifact", file=sys.stderr)
    else:
        print(render(rows))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
