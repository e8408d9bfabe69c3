#!/usr/bin/env python3
"""What each phase of kernel K1 costs on the GPU: the kernel timed whole and
with one phase left out at a time.

    python3 tools/k1_phase_costs.py [--reps 6]

Copies slamtpu_torch/csrc/corner_response.cu into build/k1_phase_costs/,
wraps each phase of the kernel's tile loop in a preprocessor switch, builds
the full kernel and one variant per phase (one nvcc each, in parallel, with
the package's flags), and times each on the first 32-frame chunk of
the VO cells' 1241x376 clip (8 levels) with tools/time_kernels.py's
method (CUDA events around the replay of a CUDA graph of back-to-back
launches). A
variant's outputs are wrong by construction; only its time is read, and
the time saved by leaving a phase out is that phase's cost where the others
do not hide it. Phases:
  compass_and_trees  the compass pre-test and compaction (no survivors, so
                     no FAST trees either)
  trees              the FAST trees on the survivors
  harris_columns     Sobel, gradient products and vertical sums
  row_walk           horizontal sums, Harris, NMS and staging
  store              the staged results to global memory
Prints one JSON line with the times in ms, ptxas's register count per
build, and the card's name and power limit. Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
OUT = ROOT / "build" / "k1_phase_costs"

# phase -> (first line, line it ends before), matched as whole stripped lines' prefixes.
PHASES = {
    "compass_and_trees": ("if (k >= 4 && k - 4 < ring_rows) {", "const float sx = __fsub_rn("),
    "trees": ("for (int j = lane; j < n_cand; j += 32) {", "__syncthreads();  // scores and vertical sums complete"),
    "harris_columns": ("const float sx = __fsub_rn(", "a0 = b0, a1 = b1, a2 = b2;"),
    "row_walk": ("// Row walk: horizontal 7-sums", "prev = cur;"),
    "store": ("if (prev.level >= 0) store_tile(", "// Column walk: Sobel"),
}


def switched_source(text: str) -> str:
    """The kernel source with `#ifndef SKIP_<PHASE>` around each phase."""
    lines = text.split("\n")
    inserts = []
    for name, (first, before) in PHASES.items():
        starts = [i for i, l in enumerate(lines) if l.strip().startswith(first)]
        if len(starts) != 1:
            raise RuntimeError(f"phase {name}: {len(starts)} lines start with {first!r}")
        end = next(i for i in range(starts[0] + 1, len(lines)) if lines[i].strip().startswith(before))
        inserts += [(starts[0], 0, f"#ifndef SKIP_{name.upper()}"), (end, 1, "#endif")]
    for i, order, text_line in sorted(inserts, key=lambda x: (-x[0], x[1])):
        lines.insert(i, text_line)
    return "\n".join(lines)


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=6)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k1_phase_costs: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from slamtpu_torch import _build
    from slamtpu_torch.feature.detector import OrbConfig
    from slamtpu_torch.io.synthetic import render_sequence_cached
    from slamtpu_torch.odometry.camera import CameraIntrinsics
    from slamtpu_torch.ops import corner
    from slamtpu_torch.ops.pyramid import build_pyramid
    from tools.time_kernels import device_ms, gpu_name_and_power

    OUT.mkdir(parents=True, exist_ok=True)
    src = OUT / "corner_response_switched.cu"
    src.write_text(switched_source((_build.CSRC / "corner_response.cu").read_text()))
    variants = {"whole": []} | {f"without_{n}": [f"-DSKIP_{n.upper()}"] for n in PHASES}
    nvcc = _build._nvcc()
    procs = {name: subprocess.Popen([nvcc, *_build.NVCC_FLAGS, *flags, "-o", str(OUT / f"lib{name}.so"), str(src)],
                                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for name, flags in variants.items()}
    registers = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        registers[name] = [line.split("Used ")[1] for line in log.splitlines() if "Used " in line]

    cfg = OrbConfig()
    subpix = [lv <= cfg.subpixel_max_octave for lv in range(cfg.n_levels)]
    scene = render_sequence_cached(n_frames=257, height=376, width=1241, n_points=4000, step=0.8,
                                   intrinsics=CameraIntrinsics.kitti(), seed=0, noise=2.0)
    base = torch.as_tensor(scene.frames[:32]).cuda().float()
    pyramids = [[x.contiguous() for x in build_pyramid(base + 0.25 * i, cfg.n_levels, cfg.scale_factor)]
                for i in range(5)]

    times = {}
    for name in variants:
        launch = ctypes.CDLL(str(OUT / f"lib{name}.so")).launch_corner_levels
        launch.argtypes, launch.restype = corner._ARGTYPES, ctypes.c_int

        def call(levels, launch=launch):
            n = len(levels)
            outs = [(torch.empty_like(x), torch.empty_like(x) if f else None) for x, f in zip(levels, subpix)]
            ptrs = (ctypes.c_uint64 * (3 * n))()
            dims = (ctypes.c_int * (2 * n))()
            for i, (img, (rk, hr)) in enumerate(zip(levels, outs)):
                ptrs[3 * i], ptrs[3 * i + 1], ptrs[3 * i + 2] = img.data_ptr(), rk.data_ptr(), hr.data_ptr() if hr is not None else 0
                dims[2 * i], dims[2 * i + 1] = img.shape[1], img.shape[2]
            err = launch(n, ptrs, dims, levels[0].shape[0], cfg.fast_threshold, torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"launch failed with CUDA error {err}")
            return outs

        times[name] = device_ms(torch, call, pyramids, args.reps)
    saved = {name[len("without_"):]: times["whole"] - t for name, t in times.items() if name != "whole"}
    print(json.dumps({"card": gpu_name_and_power(), "ms": times, "saved_ms": saved, "registers": registers}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
