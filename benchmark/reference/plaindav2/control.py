"""The controls of the Depth Anything V2 cells' comparison: programs whose
answers must come out not correct on every seed.

  * `E4M3Matmuls`, the precision below the configuration's bfloat16: both
    inputs of every linear layer, convolution, transposed convolution and
    attention product rounded through float8 e4m3 (round to nearest,
    saturated at +-448), with the reference (float32) in the port's place.
  * Planted faults, each in the port: `NoLayerScale` (x * gamma taken as
    x, the LayerScale left out of every block), `PosBySize` (the position
    table interpolated to the grid's size instead of by DINOv2's offset
    scale factors) and `FusionAlignCornersFalse` (the fusion blocks'
    bilinear resizes with align_corners=False).

Each is a TorchFunctionMode that acts on whatever runs inside it, on the
CPU and the card alike; `CONTROLS` builds each from the configuration's
model widths.

    python3 benchmark/reference/plaindav2/control.py --workload dav2l-b64 --seeds 1,2,3

prints one JSON line a seed: the numbers the check reads for a sound run
and for each control. A cell's limits lie above the largest sound reading
and below the smallest control reading (benchmark/limits/<cell>.json gives
both).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

E4M3_MAX = 448.0


def round_e4m3(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 (saturating), in x's dtype."""
    return x.clamp(-E4M3_MAX, E4M3_MAX).to(torch.float8_e4m3fn).to(x.dtype)


_PRODUCTS = {F.linear, torch.conv2d, torch.conv_transpose2d, torch.matmul}


class E4M3Matmuls(TorchFunctionMode):
    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _PRODUCTS:
            args = (round_e4m3(args[0]), round_e4m3(args[1]), *args[2:])
        return func(*args, **kwargs)


class NoLayerScale(TorchFunctionMode):
    """x * gamma -> x, where gamma is a 1-D parameter (the port's
    LayerScale; its only product with a parameter outside a linear layer,
    a convolution or a norm)."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in (torch.Tensor.mul, torch.mul) and len(args) == 2 \
                and isinstance(args[1], torch.nn.Parameter) and args[1].dim() == 1:
            return args[0]
        return func(*args, **kwargs)


class PosBySize(TorchFunctionMode):
    """The bicubic interpolation by scale factors (the position table's,
    the port's only one) made to the output's size, so the sampling scale
    is size / table instead of (size + 0.1) / table."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is F.interpolate and kwargs.get("mode") == "bicubic" and kwargs.get("scale_factor") is not None:
            x = args[0]
            size = tuple(math.floor(n * s) for n, s in zip(x.shape[-2:], kwargs["scale_factor"]))
            kwargs = {**kwargs, "scale_factor": None, "size": size}
        return func(*args, **kwargs)


class FusionAlignCornersFalse(TorchFunctionMode):
    """align_corners=False in the bilinear resizes of `features` channels
    (the fusion blocks'; the output's resize has features / 2)."""

    def __init__(self, features: int):
        super().__init__()
        self.features = features

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is F.interpolate and kwargs.get("mode") == "bilinear" and args[0].shape[1] == self.features:
            kwargs = {**kwargs, "align_corners": False}
        return func(*args, **kwargs)


# name -> (the mode from the configuration's model widths, the program it runs in: "port" or "reference")
CONTROLS = {
    "e4m3": (lambda model: E4M3Matmuls(), "reference"),
    "no_layerscale": (lambda model: NoLayerScale(), "port"),
    "pos_by_size": (lambda model: PosBySize(), "port"),
    "fusion_align_corners_false": (lambda model: FusionAlignCornersFalse(model["features"]), "port"),
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
    for name, (make, program) in CONTROLS.items():
        if program == "reference":
            ref = driver_mod.Driver(config, traffic, scene, seed, device, program=driver_mod.reference_program)
            with make(config["model"]):
                answer = ref.request(0)["answer"]
            del ref
        else:
            with make(config["model"]):
                answer = port.request(0)["answer"]
        out[name] = port.check(answer)
    out["seconds"] = time.perf_counter() - t
    return out


def main() -> int:
    import argparse
    import json
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[3]))
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
