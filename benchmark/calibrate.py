"""Readings for a cell's limits: on each seed, the numbers the check reads
for a sound run of the port and for the control (the plain reference in the
port's place, its matrix products in TF32), each against the reference.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 [--control 0|1]

One JSON line a seed. A cell's limits lie above the largest sound reading
and below the smallest control reading (PERF.md gives both). On a card the
control is also read with cuBLAS's own TF32 switch.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from benchmark import harness, programs, settings  # noqa: E402
from benchmark.reference.control import TF32Inputs  # noqa: E402


class _HardwareTF32:
    def __enter__(self):
        torch.backends.cuda.matmul.allow_tf32 = True

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32 = False


def readings(cell_name: str, seed: int, control: bool, device, spec=None, config=None, traffic=None) -> dict:
    spec = spec or settings.spec()
    cell = settings.cell(spec, cell_name)
    config = config or settings.config_file(spec, cell["config"])
    traffic = traffic or settings.traffic_file(cell["traffic"])
    scene = harness.make_scene(config, traffic, seed)
    driver_mod = settings.load_module("drivers", f"{config['pipeline']}_{traffic['mode']}")
    ref = programs.reference()
    out = {"seed": seed}
    t = time.perf_counter()
    port = driver_mod.Driver(config, traffic, scene, seed, device)
    out["sound"] = port.check(port.request(0)["answer"], ref)
    if control:
        for name, ctx in (("control_tf32", TF32Inputs), ("control_cublas_tf32", _HardwareTF32)):
            if name == "control_cublas_tf32" and torch.device(device).type != "cuda":
                continue
            drv = driver_mod.Driver(config, traffic, scene, seed, device, program=ref)
            with ctx():
                answer = drv.request(0)["answer"]
            out[name] = drv.check(answer, ref)
    out["seconds"] = time.perf_counter() - t
    return out


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control", type=int, default=1)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(readings(args.workload, seed, bool(args.control), "cuda")), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
