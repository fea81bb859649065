"""The counts behind the rooflines, against decode steps worked by hand."""
import math

import pytest

from bench.count.transformer import Shape, tick_work, total
from bench.harness import spec


def _cfg(name):
    return spec.load_json(spec.BENCH_DIR / "configs" / f"{name}.json")


def test_yi6b_decode_step_streams_11_6_gb():
    s = Shape.of(_cfg("yi-6b"))
    attn = 4096 * 4096 + 2 * 4096 * 512 + 4096 * 4096      # q, k, v, o
    ffn = 3 * 4096 * 11008
    head = 4096 * 64000
    norms = (2 * 32 + 1) * 4096 * 4
    want = 2 * (32 * (attn + ffn) + head) + norms
    assert want == 11_598_315_520
    assert s.step_weight_bytes() == want
    assert s.kv_bytes_per_token == 32 * 4 * 128 * 2 * 2 == 65536


def test_qwen3_decode_step_outside_experts_and_routed():
    s = Shape.of(_cfg("qwen3-30b-a3b"))
    attn = 2 * 48 * (2048 * 4096 + 2 * 2048 * 512 + 4096 * 2048)
    head = 2 * 2048 * 151936
    routers = 4 * 48 * 2048 * 128
    norms = (2 * 48 + 1) * 2048 * 4
    outside = attn + head + routers + norms
    assert outside == 2_485_395_456
    assert s.step_weight_bytes(0) == outside
    expert = 2 * 3 * 2048 * 768
    # 64 tokens reach E (1 - (1 - k/E)^64) ~ 125.9 of 128 experts
    routed = 128 * (1 - (1 - 8 / 128) ** 64)
    assert routed == pytest.approx(125.94, abs=0.01)
    assert s.distinct_experts(64) == pytest.approx(routed)
    assert s.step_weight_bytes(routed) == pytest.approx(
        outside + 48 * routed * expert)
    assert s.kv_bytes_per_token == 48 * 4 * 128 * 2 * 2 == 98304


@pytest.mark.parametrize("name", ["yi-6b", "qwen3-30b-a3b"])
def test_config_reckoning_matches_counts(name):
    cfg = _cfg(name)
    s = Shape.of(cfg)
    assert cfg["weights_bytes"] == s.weights_bytes()
    assert cfg["kv_bytes_per_token"] == s.kv_bytes_per_token
    mats, f32, norms = spec.reference(cfg).layout(cfg)
    made = (2 * sum(math.prod(sh) for _, sh, _ in mats)
            + 4 * sum(math.prod(sh) for _, sh, _ in f32 + norms))
    assert made == s.weights_bytes()


def test_tick_work_decode_and_chunk():
    s = Shape.of(_cfg("yi-6b"))
    w = tick_work(s, [(256, 256 * 600)], None)
    assert w.bytes == pytest.approx(s.step_weight_bytes()
                                    + 256 * 600 * 65536)
    assert w.flash_bytes == pytest.approx(
        256 * 600 * 65536 + 2 * 256 * 2 * 32 * 128 * 32)
    flops = 256 * (s.linear_flops_per_token() + 2 * 4096 * 64000) \
        + 4 * 32 * 128 * 256 * 600 * 32
    assert w.flops == pytest.approx(flops)
    # a chunk alone reads the weights once; beside a decode step it shares
    # that step's read
    c = tick_work(s, [], (512, 1024))
    both = tick_work(s, [(256, 256 * 600)], (512, 1024))
    assert c.bytes == pytest.approx(s.step_weight_bytes()
                                    + (1024 + 512) * 65536)
    assert both.bytes == pytest.approx(w.bytes + (1024 + 512) * 65536)
    pairs = 512 * 1024 + 512 * 513 / 2
    assert c.flops == pytest.approx(512 * s.linear_flops_per_token()
                                    + 2 * 4096 * 64000
                                    + 4 * 32 * 128 * pairs * 32)


def test_least_time_is_per_tick_bound():
    s = Shape.of(_cfg("yi-6b"))
    ticks = [([(256, 256 * 600)], None)] * 3
    t = total(ticks, s, 989e12, 3.35e12)
    one = (s.step_weight_bytes() + 256 * 600 * 65536) / 3.35e12
    assert t["least_s"] == pytest.approx(3 * one)
    assert t["decode_steps"] == 3


def test_kernel_names_and_classes():
    from bench.harness import trace
    name = ("void (anonymous namespace)::decode_partial_mma_kernel<128, 16,"
            " true>((anonymous namespace)::Args)")
    assert trace.short(name) == "decode_partial_mma_kernel"
    assert trace.FLASH_DECODE.search(name)
    assert trace.short("void at::native::reduce_kernel<512, 1>(int)") == \
        "at::native::reduce_kernel"
    for gemm in ("nvjet_tst_128x64_64x8_1x2_h_bz_NNT",
                 "sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize64x128x8",
                 "void cublasLt::splitKreduce_kernel<32, 16>(int)"):
        assert trace.GEMM.search(gemm) and not trace.FLASH_DECODE.search(gemm)


def test_slice_busy_is_the_union():
    from bench.harness import trace
    ops = [trace.DeviceOp("a", 0, 10), trace.DeviceOp("b", 5, 20),
           trace.DeviceOp("c", 30, 40)]
    sl = trace.Slice(window_s=1e-7, start_ns=0, end_ns=100, ops=ops)
    assert sl.busy_intervals() == [(0, 20), (30, 40)]
    assert sl.busy_s == pytest.approx(30e-9)
