#!/usr/bin/env python3
"""Profile encode()/decode() on CIF300 on the GPU and reduce the trace to
per-stage device time.

    python tools/capture_trace.py [--out DIR]

Times encode() and decode() of 300 CIF frames (all-intra and period 10,
fast precision), then traces one call of each with jax.profiler and writes
the trace and a summary.json under DIR (default: traces/ in the
checkout).  The reduction sums the device time of every kernel by the
codec stage it belongs to (the jax.named_scope names in engine/ and
codec.py, read from the op metadata of the optimized HLO, which XLA dumps
under DIR/hlo) and reports the device's busy and idle share of the traced
window.  Every program is compiled afresh (no persistent cache) so that each one
is dumped, and XLA's command buffers are off so that every kernel in the
trace names its HLO op; wall times here are therefore not those of a
default run.  Exits non-zero where JAX finds no GPU.
"""
import argparse
import collections
import json
import os
import pathlib
import re
import sys
import time

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from chip_smoke import card_info, content, require_gpu  # noqa: E402

# named scopes of the codec's stages; the innermost one on a path wins
STAGES = ("dc_chain", "mv_chain", "entropy_items", "me_mc", "mc", "luma_chain",
          "chroma_chain", "intra_wavefront", "luma_inverse", "chroma_inverse")
NF, W, H = 300, 352, 288


def op_stages(hlo_dir: pathlib.Path) -> dict:
    """(HLO module name, instruction name) -> codec stage, from the op_name
    metadata (the jax.named_scope path) of every optimized HLO dump."""
    out = {}
    for f in hlo_dir.glob("*after_optimizations.txt"):
        text = f.read_text()
        head = re.search(r"^HloModule ([\w.\-]+)", text, re.M)
        module = head.group(1) if head else ""
        for m in re.finditer(r'^\s*(?:ROOT )?%?([\w.\-]+) = [^\n]*?op_name="([^"]*)"',
                             text, re.M):
            for part in reversed(m.group(2).split("/")):
                if part in STAGES:
                    out[(module, m.group(1))] = part
                    break
    return out


def reduce_trace(trace_dir: pathlib.Path, stages: dict) -> dict:
    """Per-stage device time, and the device's busy and idle share of the
    window from its first kernel's start to its last kernel's end."""
    import jax

    path = sorted(trace_dir.rglob("*.xplane.pb"))[-1]
    data = jax.profiler.ProfileData.from_file(str(path))
    per_stage, per_module, unmapped = (collections.Counter() for _ in range(3))
    intervals, lines = [], {}
    for plane in data.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            events = list(line.events)
            lines[f"{plane.name} {line.name}"] = [len(events)] + [
                (ev.name, {k: str(v)[:80] for k, v in ev.stats}) for ev in events[:2]]
            for ev in events:
                stats = {k: str(v) for k, v in ev.stats}
                if "hlo_op" not in stats:
                    continue
                module, op, dur = stats.get("hlo_module", ""), stats["hlo_op"], ev.duration_ns
                intervals.append((ev.start_ns, ev.start_ns + dur))
                per_module[module] += dur
                if "pack_frames_dev" in module:
                    stage = "bit_pack"
                else:
                    stage = stages.get((module, op), "other")
                if stage == "other":
                    unmapped[f"{module}:{op}"] += dur
                per_stage[stage] += dur
    if not intervals:
        return {"error": f"no device kernel with an hlo_op stat in {path}", "lines": lines}
    intervals.sort()
    busy, end = 0, intervals[0][0]
    for s, e in intervals:
        busy += max(0, e - max(s, end))
        end = max(end, e)
    window = intervals[-1][1] - intervals[0][0]
    ms = lambda c, n=None: {k: v / 1e6 for k, v in c.most_common(n)}
    return {
        "window_ms": window / 1e6,
        "device_busy_ms": busy / 1e6,
        "device_idle_share": 1 - busy / window,
        "kernels": len(intervals),
        "stage_ms": ms(per_stage),
        "module_ms": ms(per_module, 12),
        "top_unmapped_ms": ms(unmapped, 8),
        "lines": lines,
    }


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=str(REPO / "traces"))
    args = ap.parse_args()
    out = pathlib.Path(args.out).resolve()
    hlo_dir = out / "hlo"
    # command buffers (CUDA graphs) off: inside one, the trace names the
    # graph and not the HLO op of each kernel, so no stage can be read
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "") + f" --xla_dump_to={hlo_dir} --xla_dump_hlo_as_text"
        + " --xla_gpu_enable_command_buffer="
    ).strip()
    require_gpu()
    import jax

    jax.config.update("jax_enable_compilation_cache", False)
    from icspcodec import codec
    from icspcodec.config import CodecConfig

    y, cb, cr = content("benchA", NF, W, H)
    cfgs = {p: CodecConfig(qp_dc=16, qp_ac=16, intra_period=p, precision="fast")
            for p in (0, 10)}
    result = {"card": card_info(), "device_kind": jax.devices()[0].device_kind,
              "wall_ms": {}}
    bits = {}
    for p, cfg in cfgs.items():
        for _ in range(2):                       # compile, then warm
            bits[p], _ = codec.encode(y, cb, cr, cfg, return_recon=False)
            codec.decode(bits[p], NF, precision="fast")
        t0 = time.perf_counter()
        codec.encode(y, cb, cr, cfg, return_recon=False)
        t1 = time.perf_counter()
        codec.decode(bits[p], NF, precision="fast")
        t2 = time.perf_counter()
        result["wall_ms"][f"encode_p{p}"] = (t1 - t0) * 1e3
        result["wall_ms"][f"decode_p{p}"] = (t2 - t1) * 1e3

    stages = op_stages(hlo_dir)
    for p, cfg in cfgs.items():
        tdir = out / f"p{p}"
        with jax.profiler.trace(str(tdir)):
            codec.encode(y, cb, cr, cfg, return_recon=False)
            codec.decode(bits[p], NF, precision="fast")
        result[f"trace_p{p}"] = reduce_trace(tdir, stages)
    (out / "summary.json").write_text(json.dumps(result, indent=1))
    print(json.dumps(result, indent=1))


if __name__ == "__main__":
    main()
