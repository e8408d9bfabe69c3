"""Host time, host syncs and LM iterations by program span, per cell, on
the card.

    python3 tools/trace_stages.py [--cells vo-clip257,vo-batch4,flagship-clip257] [--seed N] [--requests 2]

For each cell of BENCHMARK.json: its scene, configuration and driver as
the benchmark builds them, one warm request, then `--requests` requests
with the port's tracer on (`slamtpu_torch.utils.metrics.tracing`).
Prints one JSON line a cell: per frame, each span name's host ms and the
`syncs` counted directly under it (the innermost open span when the
synchronizing call was made), and the LM iterations per solve.
"""

from __future__ import annotations

import argparse
import collections
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--cells", default="vo-clip257,vo-batch4,flagship-clip257")
    p.add_argument("--seed", type=int, default=2**31 + 11)
    p.add_argument("--requests", type=int, default=2)
    args = p.parse_args(argv)

    import torch

    from benchmark import harness, settings
    from slamtpu_torch.utils import metrics

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    spec = settings.spec()
    for name in args.cells.split(","):
        cell = settings.cell(spec, name)
        config, traffic = settings.config_file(spec, cell["config"]), settings.traffic_file(cell["traffic"])
        scene = harness.make_scene(config, traffic, args.seed)
        driver = settings.load_module("drivers", f"{config['pipeline']}_{traffic['mode']}").Driver(
            config, traffic, scene, args.seed, torch.device("cuda"))
        driver.warmup()
        torch.cuda.synchronize()
        metrics.records()
        with metrics.tracing():
            frames = sum(driver.request(i)["frames"] for i in range(args.requests))
        rec = metrics.records()
        name_of = {s.id: s.name for s in rec.spans}
        host_ms = collections.Counter()
        for s in rec.spans:
            host_ms[s.name] += (s.end_ns - s.start_ns) / 1e6
        syncs, other = collections.Counter(), collections.Counter()
        for (counter, span_id), n in rec.counts.items():
            if counter == "syncs":
                syncs[name_of.get(span_id, "outside")] += n
            else:
                other[counter] += n
        out = {"cell": name, "card": harness.power_limit(), "frames": frames,
               "host_ms_per_frame": {k: round(v / frames, 4) for k, v in host_ms.most_common()},
               "syncs_per_frame": {k: round(v / frames, 4) for k, v in syncs.most_common()},
               "syncs_per_request": {k: v / args.requests for k, v in syncs.most_common()},
               "lm_iterations_per_solve": other["ba.lm_iterations"] / other["ba.solves"] if other["ba.solves"] else None,
               "solves_per_request": other["ba.solves"] / args.requests}
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
