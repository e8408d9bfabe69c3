"""The port's Depth Anything V2 (depth/depth_anything.py, models/vit.py,
models/dpt.py) against the plain reference
(benchmark/reference/plaindav2/depth_anything.py, the one the dav2l-b64
cell's check runs: functional PyTorch in float32 with TF32 off, written
from upstream's description), on weights drawn in upstream's layout
(`draw_state_dict`) and loaded into the port with strict=True, at a small
model on the CPU: width 64, 4 heads, 4 blocks, layers [0, 1, 2, 3],
features 16, out_channels [8, 16, 32, 32], a 56x84 input (a 4x6 patch
grid).

  * float32: max |d| <= 1e-5 (measured 2.9e-6 on outputs of 1.5-5). Both
    compute the same float32 operations in the same order of layers; they
    differ in how attention sums (the port's fused scaled_dot_product
    kernel against the reference's explicit softmax) and how the
    convolution library sums on other layouts, a few ulps a layer.
  * bfloat16, the cell's precision, within the cell's limits
    (benchmark/limits/dav2l-b64.json; measured here 0.020-0.024 of the
    frame's spread at most), and each control of that check
    (benchmark/reference/plaindav2/control.py) over at least one of them.
  * upstream's lower-bound resize, the position table at a 4x6 grid, the
    state dict's layout at the published widths, the operation count of
    benchmark/inputs/dav2_counts.py against torch's FlopCounterMode, the
    spans and counters, the CLI's --model, and MonoDepth2's predict_raw
    bit for bit as it was before the two predictors shared a host side.

One `cuda` test (no JAX here: `python -m pytest --noconftest -m cuda
tests/test_torch_depth_anything.py` runs it on the GPU) compares the two
at 518x1708, batch 64, on the card: bf16 within the cell's limits
(measured 0.049 / 0.040 / 0.035 on an H100), f32 within 1e-4 of the
frame's spread (measured 7.7e-6).
"""

import ast
import json
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.utils.flop_counter import FlopCounterMode, sdpa_flop_count

import slamtpu_torch
from benchmark import settings
from benchmark.inputs import dav2_counts
from benchmark.reference.plaindav2 import control
from benchmark.reference.plaindav2 import depth_anything as plain
from benchmark.reference.plaindepth import monodepth2 as plain_md2
from slamtpu_torch.depth import depth_anything, predictor
from slamtpu_torch.depth.depth_anything import DepthAnythingV2, DepthAnythingV2Config, DepthAnythingV2Net, target_size
from slamtpu_torch.depth.monodepth2 import MonoDepth2
from slamtpu_torch.io.synthetic import render_sequence
from slamtpu_torch.utils import metrics

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
LIMITS = json.loads((ROOT / "benchmark" / "limits" / "dav2l-b64.json").read_text())["limits"]
DRIVER = settings.load_module("drivers", "dav2_batch")
MODEL = settings.load_json(ROOT / "benchmark" / "configs" / "depth-anything-v2-vitl.json")["model"]
ARCH = dict(embed_dim=64, depth=4, num_heads=4, mlp_ratio=4, patch_size=14, img_size=112, layers=(0, 1, 2, 3),
            features=16, out_channels=(8, 16, 32, 32))
SMALL = DepthAnythingV2Config(**ARCH)
INPUT = 56  # 56x84 frames stay 56x84: a 4x6 grid
F32_ATOL = 1e-5
POOL = 8


@pytest.fixture(scope="module")
def weights():
    return plain.draw_state_dict(2**31 + 123, ARCH)


@pytest.fixture(scope="module")
def frames():
    return render_sequence(n_frames=3, height=56, width=84, n_points=300, step=0.8, seed=4).frames


@pytest.fixture(scope="module")
def reference(weights, frames):
    return plain.PlainDepthAnythingV2(weights, ARCH, INPUT).predict_raw(frames).numpy()


def _port(weights, dtype=None, device="cpu", config=SMALL, input_size=INPUT):
    return DepthAnythingV2(state_dict=weights, input_size=input_size, compute_dtype=dtype, device=device,
                           config=config)


def _numbers(port, ref) -> dict:
    """The cell's numbers of [N, H, W] maps, every frame kept and pooled."""
    port, ref = torch.as_tensor(port).float().cpu(), torch.as_tensor(ref).float().cpu()
    pooled = [F.avg_pool2d(x[:, None], POOL)[:, 0].numpy() for x in (port, ref)]
    return DRIVER.numbers(port.numpy(), ref.numpy(), *pooled, DRIVER._spread(ref.numpy()))


def test_the_reference_imports_nothing_of_the_port_and_keeps_tf32_off():
    for path in Path(plain.__file__).parent.glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            assert {n.split(".")[0] for n in names} <= {"__future__", "math", "numpy", "torch", "benchmark",
                                                        "time", "argparse", "json", "sys", "pathlib",
                                                        "multiprocessing", "os"}, (path, names)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        plain.PlainDepthAnythingV2(plain.draw_state_dict(1, ARCH), ARCH, INPUT).predict_raw(np.zeros((1, 56, 56)))
        assert not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.parametrize("hw, size", [((376, 1241), (518, 1708)), ((1241, 376), (1708, 518)),
                                      ((500, 500), (518, 518)), ((1080, 1920), (518, 924)),
                                      ((56, 84), (518, 784))])
def test_the_lower_bound_resize(hw, size):
    # KITTI, portrait, square, a frame larger than the bound on both sides, the small test frames.
    assert target_size(*hw) == plain.target_size(*hw) == size
    gh, gw = dav2_counts.grid(*hw, MODEL)
    assert (gh * 14, gw * 14) == size
    assert target_size(56, 84, INPUT) == (56, 84)
    assert DepthAnythingV2(config=SMALL, device="cpu").size_of(*hw) == size


def test_position_table_at_a_4x6_grid(weights):
    vit = _port(weights).net.pretrained
    with torch.no_grad():
        ours = vit.interpolate_pos_encoding(4, 6)
    theirs = plain.pos_embed(weights["pretrained.pos_embed"], 4, 6)
    assert ours.shape == (1, 25, 64)
    torch.testing.assert_close(ours, theirs, rtol=0, atol=1e-6)
    # The offset scale factors ((4 + 0.1) / 8, (6 + 0.1) / 8) sample elsewhere than the sizes would.
    with control.PosBySize(), torch.no_grad():
        by_size = vit.interpolate_pos_encoding(4, 6)
    assert (by_size - ours).abs().max() > 0.05


def test_published_layout_loads_strictly(weights):
    md = _port(weights)
    assert set(md.net.state_dict()) == set(weights)
    gammas = md.net.pretrained.blocks[2].ls1.gamma
    assert gammas.min() >= 0.2 and gammas.max() <= 0.5  # LayerScale moves the stream
    with torch.device("meta"):
        full = DepthAnythingV2Net()
    shapes = {k: tuple(v.shape) for k, v in full.state_dict().items()}
    assert shapes == plain.state_dict_shapes()
    assert sum(int(np.prod(s)) for s in shapes.values()) == 335_315_649
    again = plain.draw_state_dict(2**31 + 123, ARCH)
    assert all(torch.equal(weights[k], again[k]) for k in weights)


@pytest.mark.parametrize("size", ["model_size", "resized"])
def test_f32_port_matches_the_reference(weights, frames, reference, size):
    if size == "resized":
        frames = render_sequence(n_frames=2, height=90, width=150, n_points=300, step=0.8, seed=6).frames
        reference = plain.PlainDepthAnythingV2(weights, ARCH, INPUT).predict_raw(frames).numpy()
    out = _port(weights).predict_raw(frames)
    assert out.dtype == torch.float32 and tuple(out.shape) == (len(frames), *target_size(*frames.shape[1:], INPUT))
    np.testing.assert_allclose(out.numpy(), reference, rtol=0, atol=F32_ATOL)
    assert reference.std() > 0.1 and (reference > 0).mean() > 0.9  # a map that varies, mostly above the ReLU


def test_bf16_port_is_within_the_cell_limits(weights, frames, reference):
    out = _port(weights, torch.bfloat16).predict_raw(frames)
    assert out.dtype == torch.float32
    numbers = _numbers(out, reference)
    assert numbers["inv_gap_rel_max"] > 1e-4  # bf16 did run
    assert all(numbers[k] <= LIMITS[k] for k in LIMITS), numbers


@pytest.mark.parametrize("name", sorted(control.CONTROLS))
def test_each_control_exceeds_a_limit(weights, frames, reference, name):
    make, program = control.CONTROLS[name]
    model = _port(weights, torch.bfloat16) if program == "port" else plain.PlainDepthAnythingV2(weights, ARCH,
                                                                                                 INPUT)
    with make(ARCH):
        out = model.predict_raw(frames)
    numbers = _numbers(out, reference)
    assert any(numbers[k] > LIMITS[k] for k in LIMITS), numbers


def _sdpa_cpu(query, key, value, *args, out_shape=None, **kwargs):
    return sdpa_flop_count(query, key, value)


@pytest.mark.parametrize("hw", [(56, 84), (70, 98)])
def test_the_operation_count_is_the_flop_counters(hw):
    net = DepthAnythingV2Net(SMALL)
    model = {**MODEL, **ARCH, "input_size": INPUT}
    mapping = {torch.ops.aten._scaled_dot_product_flash_attention_for_cpu: _sdpa_cpu}
    with FlopCounterMode(display=False, custom_mapping=mapping) as counter, torch.no_grad():
        net(torch.zeros(1, 3, *hw))
    gh, gw = hw[0] // 14, hw[1] // 14
    counts = counter.get_flop_counts()["Global"]
    assert dav2_counts.flop_per_frame(model, gh, gw) == counter.get_total_flops()
    assert dav2_counts.attention_flop_per_frame(model, 1 + gh * gw) == sum(
        v for k, v in counts.items() if "attention" in str(k))
    # At the published widths and KITTI's size: 5.694 TFLOP a frame, 2.004 of it attention's.
    assert round(dav2_counts.flop_per_frame(MODEL, 37, 122) / 1e12, 3) == 5.694
    assert round(dav2_counts.attention_flop_per_frame(MODEL, 4515) / 1e12, 3) == 2.004


def test_spans_and_counters(weights, frames):
    model = _port(weights)
    metrics.records()
    with metrics.tracing():
        model.predict_raw(frames)
        model.predict(frames[0])
    rec = metrics.records()
    roots = sorted((s for s in rec.spans if s.parent is None), key=lambda s: s.start_ns)
    assert [s.name for s in roots] == ["depth.predict"] * 2
    inner = ["depth.upload", "depth.preprocess", "depth.encoder", "depth.decoder"]
    for root, n, tail in zip(roots, (3, 1), ([], ["depth.normalize"])):
        children = sorted((s for s in rec.spans if s.parent == root.id), key=lambda s: s.start_ns)
        assert [s.name for s in children] == inner + tail
        assert rec.counts[("depth.frames", root.id)] == n
        encoder = next(s for s in children if s.name == "depth.encoder")
        assert rec.counts[("depth.tokens", encoder.id)] == n * (1 + 4 * 6)
    assert {key[0] for key in rec.counts} == {"depth.frames", "depth.tokens"}


def _monodepth2_before(md, image):
    """MonoDepth2.predict_raw as it read before the depth predictors shared
    depth/predictor.py."""
    image = torch.as_tensor(image).to(md.device)
    single = image.ndim == 2 or (image.ndim == 3 and image.shape[-1] == 3)
    with torch.inference_mode():
        if image.ndim == 2 or (image.ndim == 3 and image.shape[-1] != 3):
            image = image[..., None].expand(*image.shape, 3)
        if image.ndim == 3:
            image = image[None]
        x = image.float().permute(0, 3, 1, 2)
        if x.shape[-2:] != (md.height, md.width):
            x = F.interpolate(x, size=(md.height, md.width), mode="bilinear", align_corners=False, antialias=True)
        x = x / 255.0
        if md.compute_dtype is not None:
            x = x.to(md.compute_dtype)
        disp = md.decoder(md.encoder(x), scales=(0,))[0][:, 0].float()
    return disp[0] if single else disp


@pytest.mark.parametrize("dtype", [None, torch.bfloat16], ids=["f32", "bf16"])
def test_monodepth2_is_bit_identical_through_the_shared_host_side(dtype):
    enc, dec = plain_md2.draw_state_dicts(11)
    md = MonoDepth2(encoder=enc, decoder=dec, width=128, height=64, compute_dtype=dtype, device="cpu")
    clip = np.random.default_rng(3).integers(0, 256, (3, 90, 150), dtype=np.uint8)
    for image in (clip, clip[0], np.repeat(clip[..., None], 3, axis=-1)):
        assert torch.equal(md.predict_raw(image), _monodepth2_before(md, image))
    assert isinstance(md, predictor.DepthPredictor) and isinstance(_port(None), predictor.DepthPredictor)


def test_flat_api_and_the_cli(monkeypatch, tmp_path, capsys, weights):
    from slamtpu_torch.cli.depth_estimation import main

    assert slamtpu_torch.DepthAnythingV2 is DepthAnythingV2
    monkeypatch.setattr(depth_anything, "VITL", SMALL)  # the CLI builds the published widths
    path = tmp_path / "dav2.pth"
    torch.save(weights, path)
    main(["synthetic:3x56x84", "--model", "depth_anything_v2_vitl", "--checkpoint", str(path), "--input-size",
          str(INPUT), "--batch", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "Frames processed: 3" in out and np.isfinite(float(out.split("Average inference:")[1].split()[0]))
    with pytest.raises(SystemExit):
        main(["synthetic:2x56x84", "--model", "depth_anything_v2_vitl", "--random-init", "--device", "cpu",
              "--fuse-vo", str(tmp_path / "c.ply")])
    assert "--fuse-vo takes MonoDepth2's depth" in capsys.readouterr().err


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU with -m cuda)")
    return "cuda"


@pytest.mark.cuda
def test_on_the_card_at_518x1708_batch_64(cuda):
    weights = plain.draw_state_dict(2**31 + 7)
    clip = render_sequence(n_frames=64, height=376, width=1241, n_points=4000, step=0.8, seed=5).frames
    out = _port(weights, torch.bfloat16, cuda, config=None, input_size=518).predict_raw(clip)
    assert tuple(out.shape) == (64, 518, 1708) and out.dtype == torch.float32
    reference = plain.PlainDepthAnythingV2(weights, device=cuda).predict_raw(clip)
    numbers = _numbers(out, reference)
    assert all(numbers[k] <= LIMITS[k] for k in LIMITS), numbers
    f32 = _port(weights, None, cuda, config=None, input_size=518).predict_raw(clip[:4])
    gap = (f32 - reference[:4]).abs().amax(dim=(1, 2)) / torch.as_tensor(DRIVER._spread(
        reference[:4].cpu().numpy()), device=cuda)
    print(f"bf16 against the reference: {numbers}; float32: largest gap over spread {gap.max().item():.3g}")
    assert gap.max() <= 1e-4, gap  # float32 on both sides, other summation orders (measured 7.7e-6)
