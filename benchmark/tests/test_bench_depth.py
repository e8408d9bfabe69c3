"""The depth cell at a small size on the CPU: the harness's whole run
(window, answers, check) reads correct on a sound run, with the program's
depth spans in a traced run and no module of JAX or the JAX package
loaded, and not correct under each control of the check (the reference at
e4m3 in the port's place; the port with each planted fault); the network's
operation count against a meta-device pass of the port's modules; the
kernel classes on names recorded on an H100; a request's answer under its
size cap."""

import copy
import json
import subprocess
import sys
import time

import pytest
import torch

from benchmark import harness, settings
from benchmark.inputs import depth_counts
from benchmark.reference.plaindepth import control
from benchmark.reference.plaindepth.monodepth2 import PlainMonoDepth2

CELL = "depth-b64"
ANSWER_CAP = 4 * 2**20  # bytes a request keeps at the cell's size


def small():
    """(spec, config, traffic, limits) of the cell at 64x128 on 16 frames of
    120x200, in calls of 4; the limits are the cell's."""
    spec = settings.spec()
    cell = settings.cell(spec, CELL)
    config = copy.deepcopy(settings.config_file(spec, cell["config"]))
    traffic = copy.deepcopy(settings.traffic_file(cell["traffic"]))
    config["image"] = {"height": 120, "width": 200}
    config["camera"] = {"fx": 180.0, "fy": 180.0, "cx": 100.0, "cy": 60.0}
    config["model"].update(width=128, height=64)
    traffic["scene"].update(frames=16, landmarks=300)
    traffic.update(batch=4, check_block=4)
    return spec, config, traffic, settings.limits_file(CELL)


def _run(trace=False):
    spec, config, traffic, limits = small()
    return harness.run(CELL, 2**31 + 61, 0.5, trace, time.perf_counter(), device="cpu", spec=spec, config=config,
                       traffic=traffic, limits=limits)


def test_a_sound_run_is_correct_and_traced_reads_the_depth_spans():
    result, compared = _run()
    assert result["correct"] and result["failed"] == 0, compared
    assert set(result["metrics"]) == {"frames_per_s", "setup_s"}
    traced, _ = _run(trace=True)
    assert traced["correct"]
    metrics = traced["metrics"]
    assert set(metrics) == {"depth_mfu", "depth_upload_host_ms_per_frame"}  # no device trace on the CPU
    assert 0 < metrics["depth_mfu"]["value"] < 100 and metrics["depth_upload_host_ms_per_frame"]["value"] > 0


class _E4M3Reference:
    """The reference, its convolutions at e4m3, behind the port's constructor."""

    def __init__(self, encoder, decoder, width, height, compute_dtype, device):
        self.ref = PlainMonoDepth2(encoder, decoder, width, height, device)

    def predict_raw(self, frames):
        with control.E4M3Convs():
            return self.ref.predict_raw(frames)


@pytest.mark.parametrize("name", sorted(control.CONTROLS))
def test_each_control_is_not_correct(monkeypatch, name):
    from slamtpu_torch.depth import monodepth2

    mode, program = control.CONTROLS[name]
    if program == "reference":
        monkeypatch.setattr(monodepth2, "MonoDepth2", _E4M3Reference)
    else:
        original = monodepth2.MonoDepth2.predict_raw

        def faulty(self, image):
            with mode():
                return original(self, image)

        monkeypatch.setattr(monodepth2.MonoDepth2, "predict_raw", faulty)
    result, compared = _run()
    assert not result["correct"], compared


@pytest.mark.parametrize("size", [(192, 640), (64, 128), (320, 1024)])
def test_the_operation_count_matches_a_meta_pass_of_the_port(size):
    from slamtpu_torch.models.depth_decoder import DepthDecoder
    from slamtpu_torch.models.resnet import ResNet18Encoder

    macs = []
    enc, dec = ResNet18Encoder().to("meta"), DepthDecoder().to("meta")
    for m in [*enc.modules(), *dec.modules()]:
        if isinstance(m, torch.nn.Conv2d):
            m.register_forward_hook(lambda m, i, o: macs.append(o.numel() * m.weight[0].numel()))
    with torch.no_grad():
        dec(enc(torch.zeros((1, 3, *size), device="meta")), scales=(0,))
    assert depth_counts.flop_per_frame(*size) == 2.0 * sum(macs)
    assert len(depth_counts.conv_layers(*size)) == len(macs) == 31
    if size == (192, 640):
        assert round(depth_counts.flop_per_frame(*size) / 1e9, 2) == 16.00


# Names from a profiler trace of the cell on an H100 (PyTorch 2.11, CUDA 12.8,
# cuDNN's engines: the bf16 forward, then the driver's thumbnail pooling),
# cut after their template arguments' start, with the class each belongs to.
RECORDED = [
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_tilesize256x64x32_warpgroupsize1x1x1_g1_"
     "execute_segment_k_off_kernel__5x_cudnn", "conv"),
    ("sm80_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_tilesize256x32x32_stage4_warpsize4x1x1_g1_"
     "tensor16x8x16_execute_kernel__5x_cudnn", "conv"),
    ("void cutlass__5x_cudnn::Kernel<cutlass_tensorop_bf16_s16816fprop_optimized_bf16_256x64_32x4_nhwc_align8>("
     "cutlass_tensorop_bf16_s16816fprop_optimized_bf16_256x64_32x4_nhwc_align8::Params)", "conv"),
    ("void cudnn::engines_precompiled::nchwToNhwcKernel<__nv_bfloat16, __nv_bfloat16, float, false, true, "
     "(cudnnKernelDataType_t)0>(cudnn::engines_precompiled::nchw2nhwc_params_t<float>, __nv_bfloat16 const*, "
     "__nv_bfloat16*)", "layout"),
    ("void cudnn::engines_precompiled::nhwcToNchwKernel<__nv_bfloat16, __nv_bfloat16, float, true, false, "
     "(cudnnKernelDataType_t)0>(cudnn::engines_precompiled::nhwc2nchw_params_t<float>, __nv_bfloat16 const*, "
     "__nv_bfloat16*)", "layout"),
    ("void nhwcAddPaddingKernel<__nv_bfloat16, __nv_bfloat16, float, true, (cudnnKernelDataType_t)0>(int, int, "
     "int, int, int, int, int, int, __nv_bfloat16 const*, __nv_bfloat16*, int, int, int, int, float, float, "
     "cudnn::reduced_divisor,", "layout"),
    ("void tensorTransformGeneric<__nv_bfloat16, __nv_bfloat16, float, true, false, false, "
     "(cudnnKernelDataType_t)0>(cudnnTensorTransformStruct, tensorTransformParams, int, unsigned long, "
     "__nv_bfloat16 const*, __nv_bfloat16*, float, flo", "layout"),
    ("void at::native::(anonymous namespace)::reflection_pad2d_out_kernel<c10::BFloat16>(c10::BFloat16 const*, "
     "c10::BFloat16*, long, long, int, int, int, int, int, int, int)", "pad"),
    ("void at::native::(anonymous namespace)::CatArrayBatchedCopy<at::native::(anonymous namespace)::OpaqueType<2u>,"
     " unsigned int, 4, 64, 64>(at::native::(anonymous namespace)::OpaqueType<2u>*, at::native::(anonymous "
     "namespace)::CatArrI", "cat"),
    ("void at::native::batch_norm_transform_input_channels_last_kernel<c10::BFloat16, float, c10::BFloat16, 4>("
     "c10::BFloat16 const*, c10::BFloat16 const*, float const*, float const*, c10::BFloat16 const*, "
     "c10::BFloat16 const*, c10::BFlo", "batch_norm"),
    ("void at::native::(anonymous namespace)::upsample_nearest2d_out_frame<c10::BFloat16, "
     "&at::native::nearest_neighbor_compute_source_index>(c10::BFloat16 const*, c10::BFloat16*, unsigned long, "
     "unsigned long, unsigned long, unsigned lo", "resize"),
    ("void at::native::(anonymous namespace)::upsample_gen2d_aa_out_frame<float, float, "
     "at::native::upsample_antialias::BilinearFilterFunctor>(float, float, torch::headeronly::detail::"
     "GenericPackedTensorAccessor<torch::headeronly::detai", "resize"),
    ("void at::native::(anonymous namespace)::max_pool_forward_nhwc<c10::BFloat16, int>(c10::BFloat16 const*, int, "
     "int, int, int, int, int, int, int, int, int, int, int, int, int, int, int, int, int, int, int, "
     "c10::BFloat16*, long*)", "max_pool"),
    ("void at::native::vectorized_elementwise_kernel<8, at::native::(anonymous namespace)::elu_kernel("
     "at::TensorIteratorBase&, c10::Scalar const&, c10::Scalar const&, c10::Scalar const&)::{lambda()#1}::"
     "operator()() const::{lambda()#4}::", "elementwise"),
    ("void at::native::elementwise_kernel<128, 4, at::native::gpu_kernel_impl_nocast<at::native::CUDAFunctor_add<"
     "c10::BFloat16> >(at::TensorIteratorBase&, at::native::CUDAFunctor_add<c10::BFloat16> const&)::{lambda(int)"
     "#1}>(int, at::nat", "elementwise"),
    ("void at::native::vectorized_elementwise_kernel<8, at::native::sigmoid_kernel_cuda(at::TensorIteratorBase&)::"
     "{lambda()#2}::operator()() const::{lambda()#4}::operator()() const::{lambda(c10::BFloat16)#1}, "
     "std::array<char*, 2ul> >(in", "elementwise"),
    ("void at::native::(anonymous namespace)::avg_pool2d_out_cuda_frame<float, float>(int, float const*, long, "
     "long, long, long, int, int, int, int, int, int, int, float*, int, bool, bool)", "thumbnail"),
]


@pytest.mark.parametrize("name, kind", RECORDED, ids=[n.split("(")[0][-48:] for n, _ in RECORDED])
def test_the_classifier_sorts_recorded_h100_kernel_names(name, kind):
    assert depth_counts.kind_of(name) == kind
    assert depth_counts.is_conv(name) is (kind == "conv")
    assert depth_counts.is_nonconv(name) is (kind not in ("conv", "thumbnail"))  # the thumbnail is the driver's


def _answer_bytes(config, traffic) -> int:
    """What a request keeps: the kept frames' indices (int64) and disparities,
    and every frame's thumbnail (float32)."""
    h, w, pool = config["model"]["height"], config["model"]["width"], traffic["thumbnail_pool"]
    return traffic["keep_frames"] * (8 + 4 * h * w) + traffic["scene"]["frames"] * 4 * (h // pool) * (w // pool)


@pytest.mark.parametrize("batch", [4, 5])  # 5: calls of 5, 5, 5 and a short last one of 1
def test_an_answer_stays_under_its_cap(batch):
    spec = settings.spec()
    cell = settings.cell(spec, CELL)
    assert _answer_bytes(settings.config_file(spec, cell["config"]), settings.traffic_file(cell["traffic"])) \
        <= ANSWER_CAP
    _, config, traffic, _ = small()
    traffic["batch"] = batch
    scene = harness.make_scene(config, traffic, 5)
    driver = settings.load_module("drivers", "depth_batch").Driver(config, traffic, scene, 5, torch.device("cpu"))
    answer = driver.request(0)["answer"]
    assert sum(a.nbytes for a in answer.values()) == _answer_bytes(config, traffic)
    # Each kept frame sits beside its own thumbnail, whichever call carried it.
    pooled = torch.nn.functional.avg_pool2d(torch.from_numpy(answer["kept"])[:, None], traffic["thumbnail_pool"])
    torch.testing.assert_close(pooled[:, 0].numpy(), answer["thumbs"][answer["keep"]], rtol=0, atol=1e-6)


DRY_RUN = """
import json, sys, time
sys.path.insert(0, {root!r})
from benchmark import harness
from benchmark.tests import test_bench_depth as t
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
