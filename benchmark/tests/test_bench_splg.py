"""The SuperPoint + LightGlue cell at small sizes on the CPU: the harness's
whole run (window, answers, check) on the small cut of the cell
(benchmark/tests/small.py: 120x200 frames, 2048 slots, mostly dead) reads
correct on a sound run, with the learned frontend's counters in a traced
run; each control of benchmark/reference/plainsplg/control.py fails at
least one limit; the check reads 0 when the reference is the port's own
float32 path; the readers report nothing against a port
without the counters; and the parent's program fails the cell at once."""

import copy
import time
import types

import pytest
import torch

from benchmark import harness, settings
from benchmark.reference.plainsplg import control
from benchmark.reference.plainsplg import superpoint_lightglue as plain
from benchmark.tests import small

CELL = "splg-clip257"
SEED = 2**31 + 61


def _run(trace=False):
    spec, config, traffic, limits = small.files(CELL)
    return harness.run(CELL, SEED, 0.5, trace, time.perf_counter(), device="cpu", spec=spec, config=config,
                       traffic=traffic, limits=limits)


def test_a_sound_run_is_correct_and_traced_reads_the_learned_counters():
    result, compared = _run()
    assert result["correct"] and result["failed"] == 0, compared
    assert set(result["metrics"]) == {"frames_per_s", "setup_s"}
    assert [name for name, _, _ in compared] == list(settings.limits_file(CELL)["limits"])
    traced, _ = _run(trace=True)
    assert traced["correct"]
    metrics = traced["metrics"]
    # no device trace, graphs or sync counting on the CPU
    assert set(metrics) == {"splg_mfu", "detect_host_ms_per_frame", "pose_host_ms_per_frame",
                            "hypotheses_host_ms_per_frame", "host_wait_ms_per_frame"}
    assert 0 < metrics["splg_mfu"]["value"] < 100


def _tiny():
    """The small cut at 9 frames in chunks of 4 and 256 slots a frame."""
    spec, config, traffic, limits = small.files(CELL)
    config = copy.deepcopy(config)
    config["model"]["superpoint"]["max_num_keypoints"] = 256
    traffic.update(clip_frames=9, chunk_size=4)
    traffic["scene"] = dict(traffic["scene"], frames=9)
    return spec, config, traffic, limits


@pytest.fixture(scope="module")
def readings():
    spec, config, traffic, limits = _tiny()
    return control.readings(CELL, SEED, "cpu", spec=spec, config=config, traffic=traffic), limits["limits"]


@pytest.mark.parametrize("name", control.CONTROLS)
def test_each_control_fails_a_limit(readings, name):
    out, limits = readings
    assert all(out["sound"][k] <= lim for k, lim in limits.items()), out["sound"]
    assert any(out[name][k] > lim for k, lim in limits.items()), out[name]


def test_the_check_reads_zero_against_the_ports_own_float32_path(monkeypatch):
    """The reference's functions replaced by the port's float32 ones: every
    compared number reads 0 (the cosine gap 1e-6 at most, float32's
    rounding of a unit vector's product with itself), so the check's slot
    and index bookkeeping adds nothing of its own."""
    from slamtpu_torch.models import superpoint as sp

    spec, config, traffic, limits = _tiny()
    scene = harness.make_scene(config, traffic, SEED)
    driver = settings.load_module("drivers", "splg_clip").Driver(config, traffic, scene, SEED, torch.device("cpu"))
    assert driver.frontend.compute_dtype == torch.float32
    answer = driver.request(0)["answer"]
    fe = driver.frontend

    def port_superpoint(sd, frames, conf=plain.SP):
        feats, logits, descriptor_map = fe.detect(frames)
        coarse = sp.normalize_descriptors(descriptor_map)
        return [dict(logits=logits[i], coarse=coarse[i], keypoints=feats.xy[i][feats.mask[i]],
                     scores=feats.scores[i][feats.mask[i]], descriptors=feats.descriptors[i][feats.mask[i]])
                for i in range(len(frames))]

    def port_lightglue(sd, kpts0, kpts1, desc0, desc1, size, conf=plain.LG):
        """The port's LightGlue on one pair's live keypoints, which are the
        first slots of each frame, padded with dead slots as the run had them."""
        n0, n1 = len(kpts0), len(kpts1)
        k = driver.sp_conf["max_num_keypoints"]
        pad = lambda x: torch.cat([x, x.new_zeros((k - len(x), *x.shape[1:]))])[None]  # noqa: E731
        live = lambda n: (torch.arange(k) < n)[None]  # noqa: E731
        scores, m0, ms = fe.match(pad(kpts0), pad(desc0), live(n0), pad(kpts1), pad(desc1), live(n1), size)
        rows, cols = torch.cat([torch.arange(n0), torch.tensor([k])]), torch.cat([torch.arange(n1), torch.tensor([k])])
        return dict(log_assignment=scores[0][rows][:, cols], matches0=m0[0][:n0], mscores0=ms[0][:n0])

    monkeypatch.setattr(plain, "superpoint", port_superpoint)
    monkeypatch.setattr(plain, "lightglue", port_lightglue)
    monkeypatch.setattr(plain, "sample_descriptors", lambda kp, coarse: sp.sample_descriptors(kp[None], coarse)[0])
    numbers = driver.check(answer)
    # 1 - cosine of a unit vector with itself is a rounding of float32's, not 0
    assert numbers["sp_desc_cos_gap_max"] <= 1e-6
    assert {k: numbers[k] for k in limits["limits"] if numbers[k] and k != "sp_desc_cos_gap_max"} == {}
    assert len(answer["kept"]["pairs"]) == traffic["keep_pairs"] == 2


def test_readers_report_nothing_against_a_port_without_the_counters():
    from benchmark import program_spans

    window = program_spans.Window([], {}, 0, 1)
    ctx = types.SimpleNamespace(trace=None, config=small.files(CELL)[1], window_s=1.0, frames=0,
                                program_window=window)
    for name in ("splg_mfu", "lg_attention_roofline"):
        assert settings.load_module("metrics", name).read(ctx) is None


def test_a_port_without_the_learned_frontend_fails_the_cell_at_once(monkeypatch):
    """The parent's VoConfig has no `features`: building the cell's
    configuration raises before any frame is run."""
    import dataclasses

    from slamtpu_torch.pipeline import vo

    fields = {f.name: f.default for f in dataclasses.fields(vo.VoConfig) if f.name != "features"}
    parent = dataclasses.make_dataclass("VoConfig", [(n, object, dataclasses.field(default=d)) for n, d in
                                                     fields.items()], frozen=True)
    from benchmark import programs

    port = programs.port()
    monkeypatch.setattr(programs, "port", lambda: types.SimpleNamespace(**{**vars(port), "VoConfig": parent}))
    spec, config, traffic, limits = _tiny()
    t = time.perf_counter()
    with pytest.raises(ValueError, match="unknown config keys"):
        harness.run(CELL, SEED, 0.5, False, time.perf_counter(), device="cpu", spec=spec, config=config,
                    traffic=traffic, limits=limits)
    assert time.perf_counter() - t < 30
