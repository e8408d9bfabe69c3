"""The Depth Anything V2 cell at a small size on the CPU: the harness's
whole run (window, answers, check) reads correct on a sound run, with the
program's depth spans and counters in a traced run and no module of JAX
or the JAX package loaded, and not correct under each control of the
check (the reference at e4m3 in the port's place; the port with each
planted fault); the network's operation count at the published widths
against torch's FlopCounterMode on the meta device; the kernel classes on
names recorded on an H100; a request's answer under its size cap; the
readers against a port without the new counters."""

import copy
import json
import subprocess
import sys
import time
import types

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import harness, settings
from benchmark.inputs import dav2_counts
from benchmark.reference.plaindav2 import control
from benchmark.reference.plaindav2.depth_anything import PlainDepthAnythingV2

CELL = "dav2l-b64"
ANSWER_CAP = 16 * 2**20  # bytes a request keeps at the cell's size
SMALL = dict(embed_dim=64, depth=4, num_heads=4, mlp_ratio=4, patch_size=14, img_size=112, layers=[0, 1, 2, 3],
             features=16, out_channels=[8, 16, 32, 32], input_size=56)


def small():
    """(spec, config, traffic, limits) of the cell with a small model (input
    size 56: 56x98 from 120x200 frames, a 4x7 grid) on 16 frames, in calls
    of 4, 8 thumbnails; the limits are the cell's."""
    spec = settings.spec()
    cell = settings.cell(spec, CELL)
    config = copy.deepcopy(settings.config_file(spec, cell["config"]))
    traffic = copy.deepcopy(settings.traffic_file(cell["traffic"]))
    config["image"] = {"height": 120, "width": 200}
    config["camera"] = {"fx": 180.0, "fy": 180.0, "cx": 100.0, "cy": 60.0}
    config["model"].update(SMALL)
    traffic["scene"].update(frames=16, landmarks=300)
    traffic.update(batch=4, check_block=4, thumbnail_frames=8)
    return spec, config, traffic, settings.limits_file(CELL)


def _run(trace=False):
    spec, config, traffic, limits = small()
    return harness.run(CELL, 2**31 + 61, 0.5, trace, time.perf_counter(), device="cpu", spec=spec, config=config,
                       traffic=traffic, limits=limits)


def test_a_sound_run_is_correct_and_traced_reads_the_depth_counters():
    result, compared = _run()
    assert result["correct"] and result["failed"] == 0, compared
    assert set(result["metrics"]) == {"frames_per_s", "setup_s"}
    traced, _ = _run(trace=True)
    assert traced["correct"]
    metrics = traced["metrics"]
    assert set(metrics) == {"dav2_mfu", "depth_upload_host_ms_per_frame"}  # no device trace on the CPU
    assert 0 < metrics["dav2_mfu"]["value"] < 100 and metrics["depth_upload_host_ms_per_frame"]["value"] > 0


class _E4M3Reference:
    """The reference, its products at e4m3, behind the port's constructor."""

    def __init__(self, state_dict, input_size, compute_dtype, device, config):
        arch = {k: getattr(config, k) for k in ("embed_dim", "depth", "num_heads", "mlp_ratio", "patch_size",
                                                "img_size", "layers", "features", "out_channels")}
        self.ref = PlainDepthAnythingV2(state_dict, arch, input_size, device)

    def predict_raw(self, frames):
        with control.E4M3Matmuls():
            return self.ref.predict_raw(frames)


@pytest.mark.parametrize("name", sorted(control.CONTROLS))
def test_each_control_is_not_correct(monkeypatch, name):
    from slamtpu_torch.depth import depth_anything

    make, program = control.CONTROLS[name]
    if program == "reference":
        monkeypatch.setattr(depth_anything, "DepthAnythingV2", _E4M3Reference)
    else:
        original = depth_anything.DepthAnythingV2.predict_raw

        def faulty(self, image):
            with make(SMALL):
                return original(self, image)

        monkeypatch.setattr(depth_anything.DepthAnythingV2, "predict_raw", faulty)
    result, compared = _run()
    assert not result["correct"], compared


def test_the_operation_count_at_the_published_widths_is_the_flop_counters():
    from slamtpu_torch.depth.depth_anything import DepthAnythingV2Net

    model = settings.config_file(settings.spec(), "depth-anything-v2-vitl")["model"]
    with torch.device("meta"):
        net = DepthAnythingV2Net()
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        net(torch.zeros(1, 3, 518, 1708, device="meta"))  # SDPA on the meta device counts as two bmm
    counts = {str(k): v for k, v in counter.get_flop_counts()["Global"].items()}
    assert dav2_counts.grid(376, 1241, model) == (37, 122) and model["tokens"] == 1 + 37 * 122
    assert dav2_counts.flop_per_frame(model, 37, 122) == counter.get_total_flops() == 5_693_766_582_784
    assert dav2_counts.attention_flop_per_frame(model, 4515) == counts["aten.bmm"]


# Names from a profiler trace of one 64-frame call of the cell's network on
# an H100 (PyTorch 2.11, CUDA 12.8: cuDNN's SDPA, cuBLAS's nvjet GEMMs,
# cuDNN's convolutions and transposed convolutions, then the memory-bound
# kernels; the thumbnail pooling as the MonoDepth2 cell recorded it), cut at
# 200 characters, with the class each belongs to.
RECORDED = [
    ('cudnn_generated_fort_native_sdpa_sm90_flash_fprop_wgmma_f16_knob_7_64x128x64_4x1x1_cga1x1x1_kernel0_0',
     'attention'),
    ('nvjet_tst_256x128_64x4_1x2_h_bz_coopA_bias_TNT', 'matmul'),
    ('nvjet_tst_512x8_64x3_2x1_v_ssched_bz_TNT', 'matmul'),
    ('sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_tilesize128x128x64_warpgroupsize1x1x1_g1_ex'
     'ecute_segment_k_off_kernel__5x_cudnn', 'matmul'),
    ('void cutlass__5x_cudnn::Kernel<cutlass_tensorop_bf16_s16816fprop_optimized_bf16_128x128_32x4_nhwc_align8>(cu'
     'tlass_tensorop_bf16_s16816fprop_optimized_bf16_128x128_32x4_nhwc_align8::Params)', 'matmul'),
    ('void cutlass__5x_cudnn::Kernel<cutlass_tensorop_bf16_s16816dgrad_optimized_bf16_256x64_32x4_nhwc_align8>(cut'
     'lass_tensorop_bf16_s16816dgrad_optimized_bf16_256x64_32x4_nhwc_align8::Params)', 'matmul'),
    ('sm90_xmma_dgrad_implicit_gemm_indexed_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_tilesize256x128x64_warpgroupsize2x1'
     'x1_g1_strided_execute_kernel__5x_cudnn', 'matmul'),
    ('void at::native::(anonymous namespace)::upsample_bilinear2d_nhwc_out_frame<c10::BFloat16, float>(float, floa'
     't, bool, int, int, int, int, int, c10::BFloat16 const*, c10::BFloat16*, int)', 'resize'),
    ('void at::native::(anonymous namespace)::upsample_bicubic2d_out_frame<float, float>(int, float, float, bool, '
     'torch::headeronly::detail::GenericPackedTensorAccessor<torch::headeronly::detail::TensorAcce', 'resize'),
    ('void at::native::elementwise_kernel<128, 4, at::native::gpu_kernel_impl_nocast<at::native::CUDAFunctor_add<c'
     '10::BFloat16> >(at::TensorIteratorBase&, at::native::CUDAFunctor_add<c10::BFloat16> const&):', 'other'),
    ('void at::native::vectorized_elementwise_kernel<8, at::native::CUDAFunctor_add<c10::BFloat16>, std::array<cha'
     'r*, 3ul> >(int, at::native::CUDAFunctor_add<c10::BFloat16>, std::array<char*, 3ul>)', 'other'),
    ('void at::native::vectorized_elementwise_kernel<8, at::native::GeluCUDAKernelImpl(at::TensorIteratorBase&, at'
     '::native::GeluType)::{lambda()#2}::operator()() const::{lambda()#4}::operator()() const::{la', 'gelu'),
    ('void at::native::(anonymous namespace)::vectorized_layer_norm_kernel<c10::BFloat16, float, false>(int, float'
     ', c10::BFloat16 const*, c10::BFloat16 const*, c10::BFloat16 const*, float*, float*, c10::BFl', 'layer_norm'),
    ('void at::native::elementwise_kernel<128, 4, at::native::gpu_kernel_impl_nocast<at::native::BinaryFunctor<c10'
     '::BFloat16, c10::BFloat16, c10::BFloat16, at::native::binary_internal::MulFunctor<float> > >', 'other'),
    ('void at::native::vectorized_elementwise_kernel<8, at::native::(anonymous namespace)::launch_clamp_scalar(at:'
     ':TensorIteratorBase&, c10::Scalar, c10::Scalar, at::native::detail::ClampLimits)::{lambda()#', 'other'),
    ('void nhwcAddPaddingKernel<__nv_bfloat16, __nv_bfloat16, float, true, (cudnnKernelDataType_t)0>(int, int, int'
     ', int, int, int, int, int, __nv_bfloat16 const*, __nv_bfloat16*, int, int, int, int, float, ', 'layout'),
    ('void at::native::(anonymous namespace)::CatArrayBatchedCopy<at::native::(anonymous namespace)::OpaqueType<2u'
     '>, unsigned int, 3, 64, 64>(at::native::(anonymous namespace)::OpaqueType<2u>*, at::native::', 'cat'),
    ('void at::native::unrolled_elementwise_kernel<at::native::direct_copy_kernel_cuda(at::TensorIteratorBase&)::{'
     'lambda()#3}::operator()() const::{lambda()#7}::operator()() const::{lambda(float)#1}, std::a', 'other'),
    ('void at::native::vectorized_elementwise_kernel<8, at::native::bfloat16_copy_kernel_cuda(at::TensorIteratorBa'
     'se&)::{lambda(float)#1}, std::array<char*, 2ul> >(int, at::native::bfloat16_copy_kernel_cuda', 'other'),
    ('void at::native::(anonymous namespace)::avg_pool2d_out_cuda_frame<float, float>(int, float const*, long, lon'
     'g, long, long, int, int, int, int, int, int, int, float*, int, bool, bool)', 'thumbnail'),
]


@pytest.mark.parametrize("name, kind", RECORDED, ids=[n.split("(")[0][-48:] for n, _ in RECORDED])
def test_the_classifier_sorts_recorded_h100_kernel_names(name, kind):
    assert dav2_counts.kind_of(name) == kind
    assert dav2_counts.is_attention(name) is (kind == "attention")
    assert dav2_counts.is_nonmatmul(name) is (kind not in ("matmul", "attention", "thumbnail"))


def _answer_bytes(config, traffic) -> int:
    """What a request keeps: the kept and thumbnail frames' indices (int64),
    the kept frames' maps and the thumbnails (float32)."""
    h, w = (n * config["model"]["patch_size"] for n in dav2_counts.grid(config["image"]["height"],
                                                                        config["image"]["width"], config["model"]))
    pool, keep, thumbs = traffic["thumbnail_pool"], traffic["keep_frames"], traffic["thumbnail_frames"]
    return keep * (8 + 4 * h * w) + thumbs * (8 + 4 * (h // pool) * (w // pool))


def test_an_answer_stays_under_its_cap():
    spec = settings.spec()
    cell = settings.cell(spec, CELL)
    assert _answer_bytes(settings.config_file(spec, cell["config"]), settings.traffic_file(cell["traffic"])) \
        <= ANSWER_CAP
    _, config, traffic, _ = small()
    traffic["batch"] = 5  # calls of 5, 5, 5 and a short last one of 1
    scene = harness.make_scene(config, traffic, 5)
    driver = settings.load_module("drivers", "dav2_batch").Driver(config, traffic, scene, 5, torch.device("cpu"))
    answer = driver.request(0)["answer"]
    assert sum(a.nbytes for a in answer.values()) == _answer_bytes(config, traffic)
    # A frame both kept and pooled sits beside its own thumbnail, whichever call carried it.
    both = sorted(set(answer["keep"].tolist()) & set(answer["thumb"].tolist()))
    for f in both:
        k, t = answer["keep"].tolist().index(f), answer["thumb"].tolist().index(f)
        pooled = torch.nn.functional.avg_pool2d(torch.from_numpy(answer["kept"][k])[None, None], 8)[0, 0]
        torch.testing.assert_close(pooled.numpy(), answer["thumbs"][t], rtol=0, atol=1e-5)


def test_readers_report_nothing_against_a_port_without_the_counters(monkeypatch):
    from benchmark import program_spans

    window = program_spans.Window([], {}, 0, 1)
    ctx = types.SimpleNamespace(trace=None, config=small()[1], window_s=1.0, frames=0, program_window=window)
    for name in ("dav2_mfu", "dav2_attention_roofline", "dav2_nonmatmul_ms_per_frame"):
        assert settings.load_module("metrics", name).read(ctx) is None


DRY_RUN = """
import json, sys, time
sys.path.insert(0, {root!r})
from benchmark import harness
from benchmark.tests import test_bench_dav2 as t
spec, config, traffic, limits = t.small()
harness.run(t.CELL, 7, 0.5, True, time.perf_counter(), device="cpu", spec=spec, config=config, traffic=traffic,
            limits=limits)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_a_dry_run_loads_no_jax_module():
    out = subprocess.run([sys.executable, "-c", DRY_RUN.format(root=str(settings.ROOT))], capture_output=True,
                         text=True, timeout=600, cwd=str(settings.ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    top = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "slamtpu_torch" in top and "torch" in top
    assert not top & {"jax", "jaxlib", "flax", "slamtpu"}, top & {"jax", "jaxlib", "flax", "slamtpu"}
