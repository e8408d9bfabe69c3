"""Program spans and device kernels on one clock, on the card.

    python3 tools/trace_clock_check.py [--seed N] [--runs 3] [--slack-ms 50]

Runs the `vo-clip257` cell's program (BENCHMARK.json's `kitti-vo`
configuration on its 257-frame clip, chunks of 32) `--runs` times with the
port's tracer on and torch.profiler recording CUDA activity, moves the
kernels onto `time.perf_counter_ns`'s clock as the benchmark does
(`benchmark/trace.py`), and checks every launch of kernel K1
(`corner_kernel`): it starts after the start of the `vo.detect` span that
enqueued it and before the end of the `vo.chunk` span around that span,
plus the slack. Prints one JSON line: launches, spans, the largest lags
(ms) and whether every launch passed. Exits 1 if one did not.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

KERNEL = "corner_kernel"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=2**31 + 7)
    p.add_argument("--runs", type=int, default=3)
    p.add_argument("--slack-ms", type=float, default=50.0)
    args = p.parse_args(argv)

    import torch

    from benchmark import harness, programs, settings, trace
    from slamtpu_torch.utils import metrics

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    spec = settings.spec()
    cell = settings.cell(spec, "vo-clip257")
    config, traffic = settings.config_file(spec, cell["config"]), settings.traffic_file(cell["traffic"])
    scene = harness.make_scene(config, traffic, args.seed)
    prog = programs.port()
    vo = settings.build(prog.VoConfig, config["vo"])
    cam = prog.CameraIntrinsics(**config["camera"])
    frames = scene.frames[: traffic["clip_frames"]]

    def request(i):
        return prog.run_vo(frames, cam, vo, chunk_size=traffic["chunk_size"], seed=programs.request_seed(args.seed, i),
                           device="cuda")

    request(-1)  # warm: the kernels' build and every shape
    torch.cuda.synchronize()
    metrics.records()
    with metrics.tracing():
        profiler = trace.Profiler().__enter__()
        for i in range(args.runs):
            request(i)
        torch.cuda.synchronize()
        profiler.__exit__(None, None, None)
    rec = metrics.records()
    device = profiler.collect()

    by_id = {s.id: s for s in rec.spans}
    detects = sorted((s for s in rec.spans if s.name == "vo.detect"), key=lambda s: s.start_ns)
    starts = np.array([s.start_ns for s in detects], np.int64)
    k1 = np.sort(device.start[device.select(kind="kernel", contains=KERNEL)])
    slack = int(args.slack_ms * 1e6)
    after_detect, past_chunk, failed = [], [], 0
    for t in k1.tolist():
        i = int(np.searchsorted(starts, t, side="right")) - 1
        if i < 0:
            failed += 1
            continue
        d = detects[i]
        chunk = by_id[d.parent]
        after_detect.append((t - d.start_ns) / 1e6)
        past_chunk.append((t - chunk.end_ns) / 1e6)
        failed += int(chunk.name != "vo.chunk" or t > chunk.end_ns + slack)
    out = {"card": harness.power_limit(), "runs": args.runs, "k1_launches": int(len(k1)),
           "detect_spans": len(detects), "max_ms_after_detect_start": max(after_detect, default=None),
           "max_ms_past_chunk_end": max(past_chunk, default=None), "slack_ms": args.slack_ms,
           "failed": failed, "ok": failed == 0 and len(k1) == len(detects) > 0}
    print(json.dumps(out))
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
