"""The controls of the depth cells' comparison: programs whose answers must
come out not correct on every seed.

  * `E4M3Convs`, the precision below the configuration's bfloat16: every
    convolution's weight and input rounded through float8 e4m3 (round to
    nearest, saturated at +-448), with the reference (float32) in the
    port's place.
  * Planted faults, each in the port: `NoAntialias` (the downscale without
    its antialiasing filter), `NoBNStatistics` (BatchNorm with mean 0 and
    variance 1 in place of its running statistics) and `ZeroSkip1`
    (decoder level 1's skip, encoder feature 0, replaced by zeros).

Each is a TorchFunctionMode that acts on whatever runs inside it, on the
CPU and the card alike.

    python3 benchmark/reference/plaindepth/control.py --workload depth-b64 --seeds 1,2,3

prints one JSON line a seed: the numbers the check reads for a sound run
and for each control. A cell's limits lie above the largest sound reading
and below the smallest control reading (benchmark/limits/<cell>.json gives
both).
"""

from __future__ import annotations

import inspect

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

E4M3_MAX = 448.0
SKIP1_CHANNELS = (32, 64)  # decoder width 1 and encoder width 0, concatenated at level 1


def round_e4m3(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 (saturating), in x's dtype."""
    return x.clamp(-E4M3_MAX, E4M3_MAX).to(torch.float8_e4m3fn).to(x.dtype)


class E4M3Convs(TorchFunctionMode):
    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is torch.conv2d:
            args = (round_e4m3(args[0]), round_e4m3(args[1]), *args[2:])
        return func(*args, **kwargs)


class NoAntialias(TorchFunctionMode):
    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is F.interpolate and kwargs.get("antialias"):
            kwargs = {**kwargs, "antialias": False}
        return func(*args, **kwargs)


_BN = inspect.signature(F.batch_norm)


class NoBNStatistics(TorchFunctionMode):
    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is F.batch_norm:
            bound = _BN.bind(*args, **kwargs)
            bound.arguments["running_mean"] = torch.zeros_like(bound.arguments["running_mean"])
            bound.arguments["running_var"] = torch.ones_like(bound.arguments["running_var"])
            args, kwargs = bound.args, bound.kwargs
        return func(*args, **kwargs)


class ZeroSkip1(TorchFunctionMode):
    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is torch.cat:
            tensors = list(args[0] if args else kwargs["tensors"])
            dim = kwargs.get("dim", args[1] if len(args) > 1 else 0)
            if dim == 1 and len(tensors) == 2 and tuple(t.shape[1] for t in tensors) == SKIP1_CHANNELS:
                return func([tensors[0], torch.zeros_like(tensors[1])], dim=1)
        return func(*args, **kwargs)


# name -> (mode, the program it runs in: "port" or "reference")
CONTROLS = {
    "e4m3": (E4M3Convs, "reference"),
    "no_antialias": (NoAntialias, "port"),
    "no_bn_statistics": (NoBNStatistics, "port"),
    "zero_skip1": (ZeroSkip1, "port"),
}


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
    out = {"seed": seed, "sound": port.check(port.request(0)["answer"])}
    ref = None
    for name, (mode, program) in CONTROLS.items():
        if program == "reference" and ref is None:
            ref = driver_mod.Driver(config, traffic, scene, seed, device, program=driver_mod.reference_program)
        with mode():
            answer = (port if program == "port" else ref).request(0)["answer"]
        out[name] = port.check(answer)
    out["seconds"] = time.perf_counter() - t
    return out


def main() -> int:
    import argparse
    import json
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[3]))
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


def _render_one(cell_name: str, seed: int) -> None:
    from benchmark import harness, settings

    spec = settings.spec()
    cell = settings.cell(spec, cell_name)
    harness.make_scene(settings.config_file(spec, cell["config"]), settings.traffic_file(cell["traffic"]), seed)


def _render(cell_name: str, seeds: list) -> None:
    """Every seed's scene into the scene cache, in parallel host processes."""
    import multiprocessing
    import os

    with multiprocessing.get_context("spawn").Pool(min(len(seeds), os.cpu_count() or 1, 8)) as pool:
        pool.starmap(_render_one, [(cell_name, seed) for seed in seeds])


if __name__ == "__main__":
    raise SystemExit(main())
