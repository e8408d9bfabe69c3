"""The port's MonoDepth2 against the plain reference
(benchmark/reference/plaindepth/monodepth2.py, the one the depth cells'
check runs: functional PyTorch in float32 with TF32 off, written from
upstream's description), on weights drawn with non-identity BatchNorm
(`draw_state_dicts`), loaded into the port through MonoDepth2(encoder=...,
decoder=...) with strict=True, at a 64x128 model on the CPU.

  * float32: max |d| <= 1e-5. Both compute the same float32 operations in
    the same order of layers; they differ only in how the convolution
    library sums (the port's input is a channels-last view, the
    reference's an NCHW copy, so other algorithms run), a few ulps a layer
    over about thirty layers (measured 2.7e-7 to 4.5e-7 here, 5.7e-7 and
    6.9e-7 with cuDNN on an H100 at 640x192), and a disparity lies in
    (0, 1).
  * bfloat16, the depth-b64 cell's precision, within the cell's limits
    (benchmark/limits/depth-b64.json: the largest gap, and the rms gap of
    a frame over the reference's standard deviation).
  * The controls of that check (benchmark/reference/plaindepth/control.py)
    exceed at least one of the limits: e4m3 convolutions in the reference,
    and in the port the downscale without antialiasing, BatchNorm without
    its running statistics, decoder level 1's skip zeroed.

One `cuda` test (no JAX here: `python -m pytest --noconftest -m cuda
tests/test_torch_depth_plain.py` runs it on the GPU) compares the two at
640x192, batch 64, on the card.
"""

import ast
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.reference.plaindepth import control
from benchmark.reference.plaindepth import monodepth2 as plain
from slamtpu_torch.depth.monodepth2 import MonoDepth2
from slamtpu_torch.io.synthetic import render_sequence

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
LIMITS = json.loads((ROOT / "benchmark" / "limits" / "depth-b64.json").read_text())["limits"]
H, W = 64, 128
F32_ATOL = 1e-5


def _numbers(port, ref) -> dict:
    """The cell's per-frame numbers of [N, H, W] disparities."""
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    rms = np.sqrt(((port - ref) ** 2).mean(axis=(1, 2)))
    return dict(disp_gap_max=float(np.abs(port - ref).max()),
                disp_rel_rms_max=float((rms / ref.reshape(len(ref), -1).std(axis=1)).max()))


@pytest.fixture(scope="module")
def weights():
    return plain.draw_state_dicts(2**31 + 123)


@pytest.fixture(scope="module")
def frames():
    return render_sequence(n_frames=3, height=90, width=150, n_points=300, step=0.8, seed=4).frames


@pytest.fixture(scope="module")
def reference(weights, frames):
    return plain.PlainMonoDepth2(*weights, width=W, height=H).predict_raw(frames).numpy()


def _port(weights, dtype=None, device="cpu", width=W, height=H):
    return MonoDepth2(encoder=weights[0], decoder=weights[1], width=width, height=height, compute_dtype=dtype,
                      device=device)


def test_both_copies_are_one_reference_that_imports_nothing_of_the_port():
    # One file serves the tests and the benchmark's check alike.
    assert Path(plain.__file__).resolve() == ROOT / "benchmark" / "reference" / "plaindepth" / "monodepth2.py"
    for node in ast.walk(ast.parse(Path(plain.__file__).read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        assert {n.split(".")[0] for n in names} <= {"__future__", "numpy", "torch"}, names
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        plain.PlainMonoDepth2(*plain.draw_state_dicts(1), width=64, height=64).predict_raw(np.zeros((1, 64, 64)))
        assert not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False


def test_drawn_weights_load_strictly_and_batchnorm_is_not_the_identity(weights):
    md = _port(weights)
    bn = md.encoder.layer3[0].bn2
    assert bn.running_mean.abs().min() > 0 and (bn.running_var != 1).all()
    assert (bn.weight != 1).all() and (bn.bias != 0).all()
    assert (md.decoder.decoder[10].conv.bias != 0).all()
    again = plain.draw_state_dicts(2**31 + 123)
    assert all(torch.equal(weights[0][k], again[0][k]) for k in weights[0])


@pytest.mark.parametrize("size", ["downscaled", "model_size"])
def test_f32_port_matches_the_reference(weights, frames, reference, size):
    if size == "model_size":
        frames = frames[:, :H, :W]
        reference = plain.PlainMonoDepth2(*weights, width=W, height=H).predict_raw(frames).numpy()
    disp = _port(weights).predict_raw(frames)
    assert disp.dtype == torch.float32 and tuple(disp.shape) == (3, H, W)
    np.testing.assert_allclose(disp.numpy(), reference, rtol=0, atol=F32_ATOL)
    assert reference.std() > 1e-2  # the field is not flat, so the comparison says something


def test_bf16_port_is_within_the_cell_limits(weights, frames, reference):
    numbers = _numbers(_port(weights, torch.bfloat16).predict_raw(frames), reference)
    assert numbers["disp_gap_max"] > F32_ATOL  # bf16 did run
    assert all(numbers[k] <= LIMITS[k] for k in numbers), numbers


@pytest.mark.parametrize("name", sorted(control.CONTROLS))
def test_each_control_exceeds_a_limit(weights, frames, reference, name):
    mode, program = control.CONTROLS[name]
    model = _port(weights, torch.bfloat16) if program == "port" else plain.PlainMonoDepth2(*weights, width=W,
                                                                                            height=H)
    with mode():
        disp = model.predict_raw(frames)
    numbers = _numbers(disp, reference)
    assert any(numbers[k] > LIMITS[k] for k in numbers), numbers


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU with -m cuda)")
    return "cuda"


@pytest.mark.cuda
def test_on_the_card_at_640x192_batch_64(weights, cuda):
    clip = render_sequence(n_frames=64, height=376, width=1241, n_points=4000, step=0.8, seed=5).frames
    ref = plain.PlainMonoDepth2(*weights, device=cuda)
    reference = torch.cat([ref.predict_raw(clip[i : i + 16]) for i in range(0, 64, 16)]).cpu().numpy()
    d32 = _port(weights, device=cuda, width=640, height=192).predict_raw(clip).cpu().numpy()
    np.testing.assert_allclose(d32, reference, rtol=0, atol=F32_ATOL)
    numbers = _numbers(_port(weights, torch.bfloat16, cuda, 640, 192).predict_raw(clip).cpu(), reference)
    assert all(numbers[k] <= LIMITS[k] for k in numbers), numbers
