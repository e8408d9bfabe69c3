"""MonoDepth2 in the port against the JAX package's Flax model.

The JAX model is initialised by Flax at 64x96, its BatchNorm statistics
randomized as in tests/test_depth.py (mean N(0, 0.5), var U(0.5, 1.5)) and
its decoder biases drawn N(0, 0.1) so every key mapping carries a non-zero
value; the weights cross by `convert.monodepth2_from_flax`. Bars, on this
CPU: encoder features atol 2e-4 and disparity atol 5e-4, the bars of
tests/test_depth.py and tests/test_depth_golden.py (measured: features
2.2e-5, disparity 5.4e-7). One input is larger than the model (94x310 ->
64x96), so the antialiased downscale is held to `jax.image.resize` (measured
4.2e-7; without antialiasing it is off by 0.15). The golden fixture
tests/fixtures/depth_golden.npz is loaded in the upstream checkpoint layout
through the port's depth/convert.py with strict=True and held at its own
bars. bf16 against f32 at tests/test_depth.py's bars (max |d| < 0.05,
correlation > 0.97); `predict_colored` byte-equal to the JAX package's.
"""

import os
import sys
import zlib

import jax
import numpy as np
import pytest
import torch

from slamtpu.depth.monodepth2 import MonoDepth2 as JMonoDepth2
from slamtpu_torch.convert import monodepth2_from_flax
from slamtpu_torch.depth import convert as tconvert
from slamtpu_torch.depth.monodepth2 import MonoDepth2
from slamtpu_torch.depth.predictor import _magma_lut
from slamtpu_torch.models.depth_decoder import DepthDecoder
from slamtpu_torch.models.resnet import ResNet18Encoder

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
from make_depth_fixtures import deterministic_state_dict  # noqa: E402

torch.set_num_threads(1)

H, W = 64, 96
FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "depth_golden.npz")


def _randomize(tree, rng):
    """Flax variables as nested dicts of numpy arrays, with BN statistics
    and conv biases drawn from `rng`."""
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict) or hasattr(value, "items"):
            out[key] = _randomize(value, rng)
            continue
        value = np.asarray(value)
        if key == "mean":
            value = rng.normal(0.0, 0.5, value.shape).astype(np.float32)
        elif key == "var":
            value = rng.uniform(0.5, 1.5, value.shape).astype(np.float32)
        elif key == "bias" and value.ndim == 1 and not value.any():
            value = rng.normal(0.0, 0.1, value.shape).astype(np.float32)
        out[key] = value
    return out


@pytest.fixture(scope="module")
def models():
    rng = np.random.default_rng(11)
    init = JMonoDepth2(width=W, height=H, seed=0)
    enc_vars = {"params": jax.tree_util.tree_map(np.asarray, init.encoder_vars["params"]),
                "batch_stats": _randomize(init.encoder_vars["batch_stats"], rng)}
    dec_vars = _randomize(init.decoder_vars, rng)
    jmd = JMonoDepth2(encoder_vars=enc_vars, decoder_vars=dec_vars, width=W, height=H)
    enc_sd, dec_sd = monodepth2_from_flax(enc_vars, dec_vars)
    tmd = MonoDepth2(encoder=enc_sd, decoder=dec_sd, width=W, height=H, device="cpu")
    return jmd, tmd


def test_package_import_turns_tf32_off():
    import slamtpu_torch  # noqa: F401

    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32


def test_encoder_features_match_jax(models, rng):
    jmd, tmd = models
    x = rng.uniform(0, 1, size=(2, H, W, 3)).astype(np.float32)
    feats_j = jmd.encoder.apply(jmd.encoder_vars, x)
    with torch.no_grad():
        feats_t = tmd.encoder(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert len(feats_t) == 5
    for fj, ft in zip(feats_j, feats_t):
        np.testing.assert_allclose(ft.permute(0, 2, 3, 1).numpy(), np.asarray(fj), atol=2e-4)


@pytest.mark.parametrize("shape", [(2, H, W, 3), (2, 94, 310, 3)], ids=["model_size", "downscaled"])
def test_predict_raw_matches_jax(models, rng, shape):
    jmd, tmd = models
    x = rng.uniform(0, 255, size=shape).astype(np.float32)
    disp_j = np.asarray(jmd.predict_raw(x))
    disp_t = tmd.predict_raw(x)
    assert disp_t.dtype == torch.float32 and tuple(disp_t.shape) == (2, H, W)
    np.testing.assert_allclose(disp_t.numpy(), disp_j, atol=5e-4)
    assert disp_j.std() > 1e-2  # the field is not flat, so the comparison says something


@pytest.mark.parametrize("kind", ["gray", "rgb", "gray_clip", "rgb_batch"])
def test_input_shapes_match_jax(models, rng, kind):
    jmd, tmd = models
    shape, out = {"gray": ((H, W), (H, W)), "rgb": ((H, W, 3), (H, W)), "gray_clip": ((2, H, W), (2, H, W)),
                  "rgb_batch": ((2, H, W, 3), (2, H, W))}[kind]
    img = rng.uniform(0, 255, size=shape).astype(np.uint8)
    disp = tmd.predict_raw(img)
    assert tuple(disp.shape) == out
    np.testing.assert_allclose(disp.numpy(), np.asarray(jmd.predict_raw(img)), atol=5e-4)


def test_predict_normalization(models, rng):
    _, tmd = models
    img = rng.uniform(0, 255, size=(H, W)).astype(np.uint8)
    disp = tmd.predict(img).numpy()
    assert disp.shape == (H, W)
    assert abs(disp.min()) < 1e-6 and abs(disp.max() - 1.0) < 1e-6


def test_bf16_close_to_f32(models, rng):
    _, tmd = models
    md16 = MonoDepth2(encoder=tmd.encoder.state_dict(), decoder=tmd.decoder.state_dict(), width=W, height=H,
                      compute_dtype=torch.bfloat16, device="cpu")
    assert md16.encoder.bn1.running_var.dtype == torch.bfloat16  # BN statistics are cast too
    x = rng.uniform(0, 255, size=(2, H, W, 3)).astype(np.float32)
    d32 = tmd.predict_raw(x).numpy()
    d16 = md16.predict_raw(x)
    assert d16.dtype == torch.float32
    d16 = d16.numpy()
    assert np.abs(d16 - d32).max() < 0.05
    corr = np.corrcoef(d32.ravel(), d16.ravel())[0, 1]
    assert corr > 0.97, corr


@pytest.mark.parametrize("batched", [False, True])
def test_predict_colored_byte_equal_to_jax(batched):
    rng_ = np.random.default_rng(7)
    disp = rng_.uniform(0.01, 0.9, size=(3, 24, 32) if batched else (24, 32)).astype(np.float32)
    disp[..., 0, :5] = 5.0  # outliers, so p95 != max
    disp[..., 1, :4] = disp[..., 1, :1]  # ties

    class JStub:
        predict_raw = lambda self, image: disp  # noqa: E731
        predict_colored = JMonoDepth2.predict_colored

    class TStub:
        _raw = lambda self, image: torch.from_numpy(disp)  # noqa: E731
        predict_colored = MonoDepth2.predict_colored

    got = TStub().predict_colored(None)
    assert got.dtype == np.uint8 and got.shape == disp.shape + (3,)
    np.testing.assert_array_equal(got, JStub().predict_colored(None))
    assert _magma_lut().shape == (728, 3)


def test_predict_colored_of_the_model(models, rng):
    _, tmd = models
    img = rng.uniform(0, 255, size=(H, W, 3)).astype(np.uint8)
    colored = tmd.predict_colored(img)
    assert colored.shape == (H, W, 3) and colored.dtype == np.uint8
    assert len(np.unique(colored.reshape(-1, 3), axis=0)) > 10


def test_random_init_follows_flax_defaults():
    """Same seed, same weights; lecun-normal conv kernels (std sqrt(1/fan_in),
    truncated at 2 of the underlying normal's std), zero biases, BN identity,
    as Flax draws them (values differ, their statistics agree)."""
    a = MonoDepth2(width=W, height=H, seed=3, device="cpu")
    b = MonoDepth2(width=W, height=H, seed=3, device="cpu")
    c = MonoDepth2(width=W, height=H, seed=4, device="cpu")
    for x, y in zip(a.encoder.state_dict().values(), b.encoder.state_dict().values()):
        assert torch.equal(x, y)
    assert not torch.equal(a.encoder.conv1.weight, c.encoder.conv1.weight)
    jvars = JMonoDepth2(width=W, height=H, seed=0).encoder_vars
    for name, jkernel in (("layer4.1.conv2", jvars["params"]["layer4_1"]["conv2"]["kernel"]),
                          ("conv1", jvars["params"]["conv1"]["kernel"])):
        w = a.encoder.get_submodule(name).weight.detach()
        std = (1.0 / w[0].numel()) ** 0.5
        assert abs(float(w.std()) / std - 1.0) < 0.03
        assert abs(float(np.asarray(jkernel).std()) / std - 1.0) < 0.03
        assert float(w.abs().max()) <= 2.0 * std / 0.87962566103423978 + 1e-6
    assert torch.equal(a.encoder.bn1.weight, torch.ones(64)) and not a.encoder.bn1.bias.any()
    assert not a.decoder.decoder[0].conv.conv.bias.any()


@pytest.fixture(scope="module")
def golden():
    return np.load(FIXTURE, allow_pickle=True)


@pytest.fixture(scope="module")
def golden_model(golden, tmp_path_factory):
    """The fixture's weights written as upstream's encoder.pth / depth.pth
    (the `encoder.` prefix, height / width / use_stereo, torchvision's `fc`
    head) and loaded by path through depth/convert.py with strict=True."""
    seed = int(golden["seed"])
    h, w = int(golden["height"]), int(golden["width"])
    shapes = {part: {k: tuple(int(d) for d in s.split(",") if d)
                     for k, s in zip(golden[f"{part}_keys"], golden[f"{part}_shapes"])} for part in ("enc", "dec")}
    enc = {f"encoder.{k}": v for k, v in deterministic_state_dict(seed, shapes["enc"]).items()}
    enc.update(deterministic_state_dict(seed, {"encoder.fc.weight": (1000, 512), "encoder.fc.bias": (1000,)}))
    enc = {k: torch.from_numpy(np.asarray(v)) for k, v in enc.items()}
    enc.update(height=h, width=w, use_stereo=False)
    dec = {k: torch.from_numpy(v) for k, v in deterministic_state_dict(seed, shapes["dec"]).items()}
    d = tmp_path_factory.mktemp("weights")
    torch.save(enc, d / "encoder.pth")
    torch.save(dec, d / "depth.pth")
    return MonoDepth2(encoder_path=str(d / "encoder.pth"), depth_path=str(d / "depth.pth"), width=w, height=h,
                      device="cpu")


def _golden_input(golden):
    seed = int(golden["seed"])
    h, w = int(golden["height"]), int(golden["width"])
    rng = np.random.default_rng([seed, zlib.crc32(b"__input__")])
    return rng.uniform(0, 1, size=(1, h, w, 3)).astype(np.float32)


def test_golden_encoder_levels(golden, golden_model):
    x = torch.from_numpy(_golden_input(golden)).permute(0, 3, 1, 2)
    with torch.no_grad():
        feats = [f.permute(0, 2, 3, 1).numpy() for f in golden_model.encoder(x)]
    assert len(feats) == 5
    for i, f in enumerate(feats):
        np.testing.assert_allclose(f[0, :6, :6, :8], golden[f"feat{i}_slice"], atol=2e-4)
        np.testing.assert_allclose(f.mean(), golden[f"feat{i}_mean"], atol=2e-4)


def test_golden_disparity(golden, golden_model):
    x = _golden_input(golden)
    disp = golden_model.predict_raw(x[0] * 255.0).numpy()
    assert disp.shape == golden["disp0"].shape
    np.testing.assert_allclose(disp, golden["disp0"], atol=5e-4)


def test_converters_fail_loudly_on_a_wrong_key():
    enc = {f"encoder.{k}": v for k, v in ResNet18Encoder().state_dict().items()}
    enc["encoder.layer5.0.conv1.weight"] = torch.zeros(1)
    with pytest.raises(RuntimeError, match="layer5"):
        ResNet18Encoder().load_state_dict(tconvert.convert_encoder(enc), strict=True)
    dec = DepthDecoder().state_dict()
    dec.pop("decoder.13.conv.bias")
    with pytest.raises(RuntimeError, match="decoder.13.conv.bias"):
        DepthDecoder().load_state_dict(tconvert.convert_decoder(dec), strict=True)


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        MonoDepth2(width=W, height=H)
