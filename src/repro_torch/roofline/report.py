"""Report generator: measured-window, dry-run and roofline JSON records
-> EXPERIMENTS.md sections (markdown tables), against the port's target
card (``hw.HW_H100``). Pure Python over the records:

  PYTHONPATH=src python -m repro_torch.roofline.report

The measured section renders the ``WindowCapture`` records that
``--save-measured`` (serve, train) writes under ``experiments/measured/``;
the dry-run, roofline and timing sections render only where the sharding
slice's records (``experiments/dryrun/``, ``experiments/roofline/``)
exist.
"""
from __future__ import annotations

import glob
import json
import pathlib

from repro_torch.roofline.hw import HW_H100

ARCH_ORDER = ["qwen3-moe-30b-a3b", "mixtral-8x7b", "internlm2-20b",
              "glm4-9b", "command-r-35b", "granite-8b", "whisper-small",
              "recurrentgemma-2b", "internvl2-1b", "falcon-mamba-7b"]
SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def _load(pattern):
    out = {}
    for f in glob.glob(pattern):
        r = json.load(open(f))
        out[(r["arch"], r["shape"], r.get("mesh", "16x16"))] = r
    return out


def _fmt_bytes(b):
    if b >= 1e12:
        return f"{b/1e12:.2f}T"
    if b >= 1e9:
        return f"{b/1e9:.2f}G"
    if b >= 1e6:
        return f"{b/1e6:.1f}M"
    return f"{b/1e3:.0f}K"


def dryrun_section(dryruns) -> str:
    lines = [
        "### §Dry-run — every (arch x shape) lowered AND compiled on both "
        "production meshes",
        "",
        "Mesh 16x16 = 256 devices (`data` x `model`); 2x16x16 adds "
        "the `pod` axis (512 devices). `coll/dev` is effective wire bytes per "
        "device per step from the compiled HLO (while-loop trip counts "
        "applied); `state/dev` is the analytic parameter(+opt/cache) "
        "footprint per device.",
        "",
        "| arch | shape | mesh | status | compile s | HLO flops/dev | "
        "coll/dev | state/dev |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for arch in ARCH_ORDER:
        for shape in SHAPE_ORDER:
            for mesh in ("16x16", "2x16x16"):
                r = dryruns.get((arch, shape, mesh))
                if r is None:
                    continue
                if r["status"] != "ok":
                    reason = "skip (full attention @500k)" \
                        if r["status"] == "skipped" else r["status"]
                    lines.append(
                        f"| {arch} | {shape} | {mesh} | {reason} | | | | |")
                    continue
                lines.append(
                    f"| {arch} | {shape} | {mesh} | ok "
                    f"| {r['compile_s']:.1f} "
                    f"| {r['cost_analysis']['flops']:.2e} "
                    f"| {_fmt_bytes(r['collectives']['total_effective_bytes'])} "
                    f"| {_fmt_bytes(r['analytic']['state_bytes_per_device'])} |")
    return "\n".join(lines)


def _targets(hw=HW_H100) -> str:
    return (f"{hw.name} targets ({hw.peak_flops_bf16 / 1e12:.0f} TF bf16, "
            f"{hw.hbm_bw / 1e9:.0f} GB/s HBM, "
            f"{hw.ici_link_bw / 1e9:.0f} GB/s/link x {hw.ici_links})")


def roofline_section(rooflines) -> str:
    lines = [
        "### §Roofline — per (arch x shape), single-pod 16x16 mesh, "
        + _targets(),
        "",
        "Terms are seconds/step/device from the Scale-Down composition "
        "(per-period dry-runs x depth + embed/head + optimizer; see "
        "DESIGN.md). C = compute, M = memory (analytic fusion floor; "
        "M_hlo = raw counted-bytes ceiling), K = collective (links, ring "
        "factors). `useful` = MODEL_FLOPS / HLO_FLOPS (6ND vs compiled; "
        "catches remat/redundant compute — and flags cells where the S^2 "
        "attention term, absent from 6ND, is a real fraction of work). "
        "`roofline` = (MODEL_FLOPS/chips/peak) / max(C, M, K).",
        "",
        "| arch | shape | C (ms) | M (ms) | M_hlo (ms) | K (ms) | dominant "
        "| useful | roofline | kernel-adj | bottleneck note |",
        "|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    notes = {
        "compute": "tensor-core-bound; gains need sharding/kernel changes",
        "memory": "HBM-bound; gains need fusion/layout/cache residency",
        "collective": "link-bound; gains need sharding/collective schedule",
    }
    for arch in ARCH_ORDER:
        for shape in SHAPE_ORDER:
            r = rooflines.get((arch, shape, "16x16"))
            if r is None:
                continue
            if r["status"] != "ok":
                lines.append(f"| {arch} | {shape} | skipped ||||||||")
                continue
            ka = r.get("roofline_fraction_kernel", r["roofline_fraction"])
            lines.append(
                f"| {arch} | {shape} "
                f"| {r['compute_s']*1e3:.1f} | {r['memory_s']*1e3:.1f} "
                f"| {r['memory_s_hlo']*1e3:.1f} "
                f"| {r['collective_s']*1e3:.1f} | {r['dominant']} "
                f"| {r['useful_ratio']*100:.0f}% "
                f"| {r['roofline_fraction']*100:.1f}% "
                f"| {ka*100:.1f}% "
                f"| {notes[r['dominant']]} |")
    return "\n".join(lines)


def timing_section(rooflines) -> str:
    """Event-driven timing co-emulation (DESIGN C4): predicted step time
    under the async-collective overlap model vs fully serialized."""
    from repro_torch.core.timing import Timeline
    ov = Timeline(overlap=True)
    ser = Timeline(overlap=False)
    lines = [
        "### §Timing co-emulation — predicted step time (overlap model)",
        "",
        "The VPS-style timing model (core/timing.py) consumes each cell's "
        "roofline terms: `overlap` models async collectives hiding "
        "behind the compute/memory stream; `serial` is the no-overlap "
        "bound. The gap is what compute/comm overlap buys per step.",
        "",
        "| arch | shape | t_overlap (ms) | t_serial (ms) | overlap gain |",
        "|---|---|---|---|---|",
    ]
    for arch in ARCH_ORDER:
        for shape in SHAPE_ORDER:
            r = rooflines.get((arch, shape, "16x16"))
            if r is None or r.get("status") != "ok":
                continue
            g = [{"compute_s": r["compute_s"], "memory_s": r["memory_s"],
                  "collective_s": r["collective_s"]}]
            a = ov.simulate(g)["total_s"]
            b = ser.simulate(g)["total_s"]
            lines.append(f"| {arch} | {shape} | {a*1e3:.1f} | {b*1e3:.1f} "
                         f"| {b/max(a,1e-12):.2f}x |")
    return "\n".join(lines)


def measured_section(measured) -> str:
    """Measured clock-gated windows (``roofline.WindowCapture`` records
    saved by ``capture.save_measured``) next to the static composition:
    per (arch x source) wall and device seconds a step and, where the
    capture carried a cost, achieved rates against the card's peaks."""
    lines = [
        "### §Measured windows — WindowCapture records (train / serve / "
        "farm runs), " + _targets(),
        "",
        "`s/step` is pipelined wall (drain of window *i* lands while "
        "window *i+1* is in flight), so achieved rates are a LOWER bound "
        "on device throughput; `device s/step` is the card's own time "
        "(CUDA events around each window's enqueue; n/a on the host). "
        "The cost is one engine call counted on fake tensors "
        "(`roofline/cost.py`); rows without cost columns came from a "
        "capture with no cost source. Shares are of the bf16 peak.",
        "",
        "| arch | source | windows | steps | s/step | device s/step "
        "| achieved TF/s | peak flops | peak HBM |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for (arch, source) in sorted(measured):
        r = measured[(arch, source)]
        sps = r.get("s_per_step")
        dps = r.get("device_s_per_step")
        af = r.get("achieved_flops_s")
        row = (f"| {arch} | {source} | {r.get('windows', 0)} "
               f"| {r.get('steps', 0)} "
               f"| {f'{sps:.4f}' if sps is not None else 'n/a'} "
               f"| {f'{dps:.4f}' if dps is not None else 'n/a'} ")
        if af is not None:
            row += (f"| {af/1e12:.3f} "
                    f"| {r['peak_flops_fraction']*100:.2f}% "
                    f"| {r['peak_hbm_fraction']*100:.2f}% |")
        else:
            row += "| | | |"
        lines.append(row)
    return "\n".join(lines)


def pick_hillclimb_cells(rooflines):
    """worst roofline fraction / most collective-bound / most representative
    (per the assignment)."""
    ok = [r for r in rooflines.values()
          if r.get("status") == "ok" and r.get("mesh", "16x16") == "16x16"]
    worst = min(ok, key=lambda r: r["roofline_fraction"])
    coll = max(ok, key=lambda r: r["collective_s"]
               / max(r["step_time_bound_s"], 1e-30)
               * (r["collective_s"]))
    return worst, coll


def _load_measured(pattern="experiments/measured/*.json"):
    out = {}
    for f in glob.glob(pattern):
        r = json.load(open(f))
        out[(r["arch"], r["source"])] = r
    return out


def main():
    dryruns = _load("experiments/dryrun/*.json")
    rooflines = _load("experiments/roofline/*.json")
    measured = _load_measured()
    out = ["<!-- generated by repro_torch.roofline.report -->"]
    if measured:
        out += ["", measured_section(measured)]
    if dryruns:
        out += ["", dryrun_section(dryruns)]
    if rooflines:
        out += ["", roofline_section(rooflines), "",
                timing_section(rooflines)]
    path = pathlib.Path("experiments/tables.md")
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text("\n".join(out))
    print(f"wrote {path}")
    if rooflines:
        worst, coll = pick_hillclimb_cells(rooflines)
        print(f"worst roofline: {worst['arch']} x {worst['shape']} "
              f"({worst['roofline_fraction']*100:.2f}%)")
        print(f"most collective-bound: {coll['arch']} x {coll['shape']} "
              f"(K={coll['collective_s']*1e3:.0f}ms)")


if __name__ == "__main__":
    main()
