"""BENCHMARK.json against the contract's limits on names, units and files,
and every file it names found by name."""

import json
import re

import pytest

from benchmark import settings

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")


@pytest.fixture(scope="module")
def spec():
    return settings.spec()


def test_top_level_keys(spec):
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert (settings.ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= spec["run_seconds"] <= 51 and isinstance(spec["run_seconds"], int)
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p.split("/") for p in spec["paths"])
    assert len(spec["command"]) <= 32 and spec["command"][1].startswith(spec["paths"][0] + "/")


def test_names_and_units(spec):
    entries = spec["configs"] + spec["workloads"] + spec["end_to_end"] + spec["per_layer"]
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
    for w in spec["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)
    for c in spec["configs"]:
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for text in [e.get("why") for e in entries] + [m.get("layer") for m in spec["per_layer"]] + \
            [c["source"] for c in spec["configs"]] + spec["command"]:
        if text is not None:
            assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in spec[group]]
        assert len(names) == len(set(names))


def test_metrics_fit_the_contract(spec):
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace") for m in e2e.values())
    cells = {w["name"] for w in spec["workloads"]}
    for m in spec["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert set(m.get("workloads", cells)) <= cells
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for cell in cells:
        reported = [m for m in e2e.values() if cell in m.get("workloads", [cell])]
        assert any(m["name"] == "setup_s" for m in reported) and len(reported) >= 2
        assert any(cell in m.get("workloads", [cell]) for m in spec["per_layer"])


def test_every_file_is_found_by_name(spec):
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert hasattr(settings.load_module("metrics", m["name"]), "read"), m["name"]
    for w in spec["workloads"]:
        traffic = settings.traffic_file(w["traffic"])
        config = settings.config_file(spec, w["config"])
        assert hasattr(settings.load_module("drivers", f"{config['pipeline']}_{traffic['mode']}"), "Driver")
        assert settings.limits_file(w["name"])["limits"]
    files = [c["file"] for c in spec["configs"]]
    assert len(files) == len(set(files))
    for c in spec["configs"]:
        assert c["file"].startswith(spec["paths"][0] + "/")
        assert json.loads((settings.ROOT / c["file"]).read_text())["reduced"] == c["reduced"]


def test_config_files_build_the_port_configs(spec):
    from slamtpu_torch.pipeline.point_cloud import PointCloudConfig
    from slamtpu_torch.pipeline.vo import VoConfig

    assert settings.build(VoConfig, settings.config_file(spec, "kitti-vo")["vo"]) == VoConfig()
    assert settings.build(PointCloudConfig, settings.config_file(spec, "kitti-flagship")["point_cloud"]) \
        == PointCloudConfig()
