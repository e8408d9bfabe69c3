"""The controls of the SuperPoint + LightGlue cells' comparison: programs
whose answers must come out not correct on every seed.

  * `e4m3`, the precision below the configuration's bfloat16: the plain
    reference with both inputs of every convolution, linear layer and
    matrix product rounded through float8 e4m3 (plaindav2's
    `E4M3Matmuls`) computes the kept frames' and pairs' stages in the
    port's place (its keypoints, descriptors, log-assignments and matches,
    laid out in the port's slots); the pose part of the answer stays the
    port's.
  * Planted faults, each in the port, by replacing one of its functions
    for a request: `wqkv_split` (Wqkv's output unflattened as (3, heads,
    64) instead of (heads, 64, 3)), `rotate_halves` (rotate_half over the
    two halves of the channels instead of adjacent pairs),
    `no_matchability` (the matchability logits taken as 0 in the
    assignment), `sampling_no_shift` (descriptor sampling without the
    s/2 - 0.5 shift) and `pose_tf32` (the pose stage, estimate_relative_pose,
    with every float32 matrix product's inputs rounded to TF32, the
    precision below its float32: benchmark/reference/control.py). The
    port's CUDA graphs are dropped before and after each, so no graph of a
    sound run replays inside a control and no faulty one outlives it.

    python3 benchmark/reference/plainsplg/control.py --workload splg-clip257 --seeds 1,2,3

prints one JSON line a seed: the numbers the check reads for a sound run
and for each control. A cell's limits lie above the largest sound reading
and below the smallest control reading (benchmark/limits/<cell>.json gives
both).
"""

from __future__ import annotations

import contextlib
import sys
from pathlib import Path

import torch

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[3]))

from benchmark.reference.control import TF32Inputs  # noqa: E402
from benchmark.reference.plaindav2.control import E4M3Matmuls  # noqa: E402
from benchmark.reference.plainsplg import superpoint_lightglue as plain  # noqa: E402


def _wqkv_split(qkv, heads):
    qkv = qkv.unflatten(-1, (3, heads, -1)).permute(0, 1, 3, 4, 2)  # [B, N, heads, d, 3]
    qkv = qkv.transpose(1, 2)
    return qkv[..., 0], qkv[..., 1], qkv[..., 2]


def _rotate_halves(x):
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat((-x2, x1), dim=-1)


def _sampling_no_shift(xy, coarse, s=8):
    import torch.nn.functional as F

    b, c, h, w = coarse.shape
    scale = torch.tensor([w * s - s / 2 - 0.5, h * s - s / 2 - 0.5], dtype=xy.dtype, device=xy.device)
    grid = xy / scale * 2 - 1
    out = F.grid_sample(coarse, grid.view(b, 1, -1, 2), mode="bilinear", align_corners=True)
    return F.normalize(out.reshape(b, c, -1), p=2, dim=1).transpose(1, 2)


def _no_matchability(original):
    def assign(sim, z0, z1, mask0, mask1):
        return original(sim, torch.zeros_like(z0), torch.zeros_like(z1), mask0, mask1)

    return assign


def _pose_tf32(original):
    def estimate(*args, **kwargs):
        with TF32Inputs():
            return original(*args, **kwargs)

    return estimate


@contextlib.contextmanager
def port_fault(name: str):
    """The port with one planted fault, its graph cache dropped around it."""
    from slamtpu_torch.models import lightglue, superpoint
    from slamtpu_torch.pipeline import vo
    from slamtpu_torch.utils import graphs

    module, attr, make = {
        "wqkv_split": (lightglue, "split_qkv", lambda f: _wqkv_split),
        "rotate_halves": (lightglue, "rotate_half", lambda f: _rotate_halves),
        "no_matchability": (lightglue, "sigmoid_log_double_softmax", _no_matchability),
        "sampling_no_shift": (superpoint, "sample_descriptors", lambda f: _sampling_no_shift),
        "pose_tf32": (vo, "estimate_relative_pose", _pose_tf32),
    }[name]
    original = getattr(module, attr)
    _drop_graphs(graphs)
    setattr(module, attr, make(original))
    try:
        yield
    finally:
        setattr(module, attr, original)
        _drop_graphs(graphs)


def _drop_graphs(graphs) -> None:
    """Drop the port's graphs and give their private pools back to the card."""
    import gc

    graphs.reset()
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def e4m3_answer(driver, answer: dict) -> dict:
    """`answer` with its kept frames and pairs computed by the reference at
    e4m3, in the port's slot layout (K slots, dead ones masked; each
    log-assignment over the live slots and the dustbins, as
    drivers/splg_clip.py::live_block keeps it)."""
    kept = answer["kept"]
    k = driver.sp_conf["max_num_keypoints"]
    h, w = driver.frames.shape[1:]
    order = sorted(kept["frames"])
    with torch.no_grad(), E4M3Matmuls():
        frames = torch.as_tensor(driver.frames[order]).to(driver.device)
        refs = plain.superpoint(driver.ref_weights["superpoint"], frames, driver.sp_conf)
    kept_frames = {}
    for f, r in zip(order, refs):
        n, dev = len(r["keypoints"]), r["keypoints"].device
        pad = lambda x: torch.cat([x, x.new_zeros((k - n, *x.shape[1:]))])  # noqa: E731
        kept_frames[f] = dict(logits=r["logits"], descriptor_map=r["coarse"], xy=pad(r["keypoints"]),
                         descriptors=pad(r["descriptors"]), scores=pad(r["scores"]),
                         mask=torch.arange(k, device=dev) < n)
    assign = {}
    for p in kept["pairs"]:
        f0, f1 = kept_frames[p], kept_frames[p + 1]
        m0, m1 = f0["mask"], f1["mask"]
        with torch.no_grad(), E4M3Matmuls():
            o = plain.lightglue(driver.ref_weights["lightglue"], f0["xy"][m0], f1["xy"][m1], f0["descriptors"][m0],
                                f1["descriptors"][m1], (w, h), driver.lg_conf)
        dev = m0.device
        idx0, idx1 = torch.nonzero(m0)[:, 0], torch.nonzero(m1)[:, 0]
        matches0 = torch.full((k,), -1, dtype=torch.int64, device=dev)
        matches0[idx0] = torch.where(o["matches0"] >= 0, idx1[o["matches0"].clamp(min=0)], -1)
        assign[p] = dict(log_assignment=o["log_assignment"], matches0=matches0)
    return {**answer, "kept": {**kept, "frames": kept_frames, "assign": assign}}


CONTROLS = ("e4m3", "wqkv_split", "rotate_halves", "no_matchability", "sampling_no_shift", "pose_tf32")


def readings(cell_name: str, seed: int, device, spec=None, config=None, traffic=None) -> dict:
    """On one seed: the check's numbers for a sound request of the port and
    for each control, each against the reference."""
    import time

    from benchmark import harness, settings

    spec = spec or settings.spec()
    cell = settings.cell(spec, cell_name)
    config = config or settings.config_file(spec, cell["config"])
    traffic = traffic or settings.traffic_file(cell["traffic"])
    scene = harness.make_scene(config, traffic, seed)
    driver_mod = settings.load_module("drivers", f"{config['pipeline']}_{traffic['mode']}")
    t = time.perf_counter()
    port = driver_mod.Driver(config, traffic, scene, seed, device)
    sound = port.request(0)["answer"]
    out = {"seed": seed, "sound": port.check(sound)}
    for name in CONTROLS:
        if name == "e4m3":
            answer = e4m3_answer(port, sound)
        else:
            with port_fault(name):
                answer = port.request(0)["answer"]
        out[name] = port.check(answer)
    out["seconds"] = time.perf_counter() - t
    return out


def main() -> int:
    import argparse
    import json

    from benchmark.reference.plaindepth.control import _render  # the scenes, rendered in parallel

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    seeds = [int(s) for s in args.seeds.split(",")]
    _render(args.workload, seeds)
    for seed in seeds:
        print(json.dumps(readings(args.workload, seed, "cuda")), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
