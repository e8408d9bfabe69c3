"""One run of one cell: set-up, the measured window, the check against the
plain reference, and the result line.

The window is a closed loop with one client: a request is sent when the
one before it has returned its results to the host, from the window's
start until `seconds` have passed; the request running then is finished,
not cut, and the window ends with it.
"""

from __future__ import annotations

import dataclasses
import gc
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

from benchmark import settings
from benchmark.inputs import scene as scene_mod

FORBIDDEN = ("jax", "jaxlib", "flax", "slamtpu")  # top-level module names, compared whole
THREADS = 4  # host threads of PyTorch's CPU ops: the same on every run (1 read no steadier)


@dataclasses.dataclass
class Context:
    """What a metric reader reads. Times are perf_counter ns."""

    cell: dict
    config: dict
    traffic: dict
    scene: object
    device: object
    setup_s: float
    t_start: int
    t_end: int
    requests: list  # dicts: submit, complete (ns), frames, detected, failed
    trace: object = None  # trace.DeviceTrace of the window (traced runs)
    spans: object = None  # spans.Recorder (traced runs)

    @property
    def window_s(self) -> float:
        return (self.t_end - self.t_start) / 1e9

    @property
    def done(self) -> list:
        return [r for r in self.requests if not r["failed"]]

    @property
    def frames(self) -> int:
        return sum(r["frames"] for r in self.done)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def selected_metrics(spec: dict, cell: dict, trace: bool) -> list:
    """The cell's end-to-end metrics (trace off) or per-layer metrics (on)."""
    e2e = [m for m in spec["end_to_end"] if cell["name"] in m.get("workloads", [cell["name"]])]
    if not trace:
        return e2e
    reported = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"]
            if (cell["name"] in m["workloads"] if "workloads" in m else m["moves"] in reported)]


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "unknown"
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"


SCENE_CACHE = settings.HERE / ".scene_cache"  # git-ignored; fixed, inside the checkout


def make_scene(config: dict, traffic: dict, seed: int):
    """The cell's scene from the seed, rendered once per parameters and seed
    and then read from SCENE_CACHE (written under a temporary name in the
    same directory and moved into place, so a reader never sees a part)."""
    sc = traffic["scene"]
    params = dict(n_frames=sc["frames"], height=config["image"]["height"], width=config["image"]["width"],
                  camera=config["camera"], n_points=sc["landmarks"], step=sc["step"], seed=int(seed),
                  noise=sc["noise"], textured=sc["textured"])
    key = hashlib.sha256(json.dumps(params, sort_keys=True).encode()).hexdigest()[:24]
    path = SCENE_CACHE / f"{key}.npz"
    if path.exists():
        with np.load(path) as f:
            return scene_mod.Scene(f["frames"], f["rotations"], f["translations"])
    scene = scene_mod.render(**params)
    SCENE_CACHE.mkdir(parents=True, exist_ok=True)
    with tempfile.NamedTemporaryFile(dir=SCENE_CACHE, suffix=".tmp", delete=False) as f:
        np.savez(f, frames=scene.frames, rotations=scene.rotations, translations=scene.translations)
    os.replace(f.name, path)
    return scene


def run(cell_name: str, seed: int, seconds: float, trace: bool, t0: float, device=None, spec=None,
        config=None, traffic=None, limits=None):
    """One run; returns the result dict (the line's keys) and the compared
    numbers [(name, value, limit)]. device=None runs on the card; the other
    arguments replace the files BENCHMARK.json names (tests use them)."""
    import torch

    from benchmark import programs, spans, trace as trace_mod

    spec = spec or settings.spec()
    cell = settings.cell(spec, cell_name)
    config = config or settings.config_file(spec, cell["config"])
    traffic = traffic or settings.traffic_file(cell["traffic"])
    limits = limits or settings.limits_file(cell_name)
    on_card = device is None
    device = torch.device("cuda") if on_card else torch.device(device)
    torch.set_num_threads(THREADS)

    t = time.perf_counter()
    scene = make_scene(config, traffic, seed)
    log(f"set-up: scene {scene.frames.shape} made in {time.perf_counter() - t:.2f} s")
    driver_mod = settings.load_module("drivers", f"{config['pipeline']}_{traffic['mode']}")
    t = time.perf_counter()
    driver = driver_mod.Driver(config, traffic, scene, seed, device)
    driver.warmup()
    if on_card:
        torch.cuda.synchronize()
    log(f"set-up: program loaded and warmed up in {time.perf_counter() - t:.2f} s")

    metric_specs = selected_metrics(spec, cell, trace)
    readers = {m["name"]: settings.load_module("metrics", m["name"]) for m in metric_specs}
    recorder = profiler = None
    if trace:
        recorder = spans.Recorder()
        for reader in readers.values():
            for name, (target, keep) in getattr(reader, "SPANS", {}).items():
                recorder.install(name, target, keep)
        profiler = trace_mod.Profiler().__enter__() if on_card else None

    setup_s = time.perf_counter() - t0
    requests = []
    t_start = time.perf_counter_ns()
    deadline = t_start + int(seconds * 1e9)
    first_error = None
    i = 0
    while time.perf_counter_ns() < deadline:
        submit = time.perf_counter_ns()
        try:
            r = driver.request(i)
            r["failed"] = False
        except Exception:  # a request that raises counts as failed; the loop goes on
            first_error = first_error or traceback.format_exc()
            r = dict(frames=0, detected=[], answer=None, failed=True)
        r.update(submit=submit, complete=time.perf_counter_ns())
        requests.append(r)
        i += 1
    t_end = requests[-1]["complete"]
    if first_error:
        log(f"a request failed:\n{first_error}")

    device_trace = None
    if profiler is not None:
        profiler.__exit__(None, None, None)
        t = time.perf_counter()
        device_trace = profiler.collect()
        log(f"trace: {len(device_trace.names)} device operations read in {time.perf_counter() - t:.2f} s")
    if recorder is not None:
        recorder.remove()
    memory_peak = int(torch.cuda.max_memory_allocated()) if on_card else 0
    ctx = Context(cell, config, traffic, scene, device, setup_s, t_start, t_end, requests, device_trace, recorder)

    metrics = {}
    for m in metric_specs:
        value = readers[m["name"]].read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    # The check, after the window with the program's state released.
    answers = [r.pop("answer") for r in requests if not r["failed"]]
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    compared = []
    if answers:
        sample = answers[int(np.random.default_rng([seed, 0x5EED]).integers(len(answers)))]
        numbers = driver.check(sample, programs.reference())
        compared = [(name, float(numbers[name]), float(limit)) for name, limit in limits["limits"].items()]
    log(f"check: reference over the sampled request in {time.perf_counter() - t:.2f} s")
    failed = sum(r["failed"] for r in requests)
    correct = bool(answers) and failed == 0 and all(v <= lim for _, v, lim in compared)

    dev = {"platform": "gpu" if on_card else device.type,
           "kind": torch.cuda.get_device_name(0) if on_card else device.type,
           "count": int(cell["chips"]) if on_card else 1, "memory_peak_bytes": memory_peak}
    result = {"correct": correct, "attempted": len(requests), "failed": failed, "metrics": metrics, "device": dev}
    if trace:
        dev["window_s"] = ctx.window_s
        dev["busy_s"] = device_trace.busy_ns() / 1e9 if device_trace is not None else 0.0
        if device_trace is not None:
            result["breakdown"] = {"device_ops": device_trace.top_ops(10),
                                   "idle_gaps": idle_by_host_activity(device_trace, recorder, t_start, t_end)}
    return result, compared


def idle_by_host_activity(device_trace, recorder, t_start: int, t_end: int) -> list:
    """The device's idle time in the window by what the host was doing: each
    gap goes to the innermost span around its midpoint (calls of one span
    do not overlap one another)."""
    gaps = np.array(device_trace.gaps(t_start, t_end), np.int64).reshape(-1, 2)
    mids = (gaps[:, 0] + gaps[:, 1]) // 2
    label = np.full(len(gaps), -1)
    best = np.full(len(gaps), np.iinfo(np.int64).max)
    names = list(recorder.spans)
    for k, name in enumerate(names):
        calls = sorted((t0, t1) for t0, t1, _ in recorder.spans[name])
        if not calls:
            continue
        starts, ends = np.array(calls, np.int64).T
        idx = np.searchsorted(starts, mids, side="right") - 1
        ok = idx >= 0
        inside = ok & (mids < ends[np.maximum(idx, 0)])
        length = np.where(inside, ends[np.maximum(idx, 0)] - starts[np.maximum(idx, 0)], best)
        take = length < best
        label[take], best[take] = k, length[take]
    total: dict[str, float] = {}
    for k, seconds in zip(label.tolist(), ((gaps[:, 1] - gaps[:, 0]) / 1e9).tolist()):
        key = names[k] if k >= 0 else "outside the traced layers"
        total[key] = total.get(key, 0.0) + seconds
    return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:10]]


def main(cell_name: str, seed: int, seconds: float, trace: bool, t0: float) -> int:
    import torch

    spec = settings.spec()
    cell = settings.cell(spec, cell_name)
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        log(f"{cell_name} needs {cell['chips']} CUDA device(s); this host has "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}: no result")
        return 2
    result, compared = run(cell_name, seed, seconds, trace, t0, spec=spec)
    found = forbidden_modules()
    if found:
        log(f"modules of JAX or the JAX package were loaded: {found}: no result")
        return 3
    log(f"card: {power_limit()}")
    result["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in compared}
    for name, v, lim in compared:
        log(f"check {name}: {v!r} (limit {lim!r})")
    print(json.dumps(result))
    return 0
