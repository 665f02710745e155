"""The operation and byte counts and the readers built on the trace."""
import benchkit  # noqa: F401
import pytest

from benchlib import counts, registry
from benchlib.harness import Reading
from benchlib.profile import Profile

H100 = "NVIDIA H100 80GB HBM3"


def test_bitonic_bytes_read_once_written_once():
    R, N = 16384, 1024
    assert counts.bitonic_bytes("sort_rows", [[R, N]], ["float"]) == 2 * R * N * 4
    assert counts.bitonic_bytes("sort_rows_kv", [[R, N], [R, N], []],
                                ["int", "int", "Scalar"]) == 2 * R * N * 8
    # two (R, N) runs in, one (R, 2N) out
    assert counts.bitonic_bytes("merge_rows", [[R, N], [R, N]], ["float", "float"]) == \
        2 * (2 * R * N * 4)
    assert counts.bitonic_bytes("merge_rows_kv", [[R, N]] * 4 + [[]],
                                ["int", "int", "int", "int", "Scalar"]) == 2 * (4 * R * N * 4)
    with pytest.raises(ValueError):
        counts.bitonic_bytes("gather", [[R]], ["float"])


@pytest.mark.parametrize("B,S,total", [(1, 8192, 4.717e13), (2, 4096, 4.332e13)])
def test_deepseek_moe_16b_flops_equal_the_hand_count(B, S, total):
    cfg = registry.config("deepseek-moe-16b")
    attn_proj = 4 * 2 * 2048 * 2048  # q, k, v, o
    dense = 3 * 2 * 2048 * 10944
    moe = 2 * 2048 * 64 + 8 * 3 * 2 * 2048 * 1408  # router; 6 routed + 2 shared
    per_token = 28 * attn_proj + dense + 27 * moe
    assert per_token == 4_818_206_720  # 4.81 GFLOP a token, the router's 7.1 MFLOP in it
    attention = B * 28 * 2 * 16 * (128 + 128) * (S * (S + 1) // 2)  # the causal pairs
    head = B * 2 * 2048 * 102400  # the last position of each prompt only
    want = B * S * per_token + attention + head
    assert counts.lm_prefill_flops(cfg, S, B) == want
    assert want == pytest.approx(total, rel=1e-3)


def test_causal_attention_counts_the_kept_pairs():
    assert counts.causal_attention_flops(1, 4, 4, 1, 2, 2) == 2 * 4 * (4 + 3 + 2 + 1)
    assert counts.causal_attention_flops(2, 3, 5, 2, 8, 4) == 2 * 2 * 2 * 12 * 6


def _profile(device, ops, host=(), window=(0.0, 1e6), launches=()):
    """Kernels (name, start, end[, correlation]), operators (name, start,
    dims, types[, end]) on thread 1, runtime calls (name, start, end) and
    launches (start, correlation) on thread 1, in microseconds."""
    ev = [{"ph": "X", "cat": "user_annotation", "name": "bench_window",
           "ts": window[0], "dur": window[1] - window[0]}]
    ev += [{"ph": "X", "cat": "kernel", "name": k[0], "ts": k[1], "dur": k[2] - k[1],
            "args": {"device": 0, **({"correlation": k[3]} if len(k) > 3 else {})}}
           for k in device]
    ev += [{"ph": "X", "cat": "cpu_op", "name": o[0], "ts": o[1], "tid": 1,
            "dur": (o[4] - o[1]) if len(o) > 4 else 1,
            "args": {"Input Dims": o[2], "Input type": o[3]}} for o in ops]
    ev += [{"ph": "X", "cat": "cuda_runtime", "name": n, "ts": a, "dur": b - a}
           for n, a, b in host]
    ev += [{"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": a, "dur": 1,
            "tid": 1, "args": {"correlation": c}} for a, c in launches]
    return Profile(ev, 0)


def test_profile_busy_is_the_union_and_gaps_are_named_by_the_host():
    p = _profile([("k1", 100, 300), ("k2", 200, 400), ("copy", 600, 700)], [],
                 host=[("cudaStreamSynchronize", 350, 650)], window=(0, 1000))
    assert p.busy_s == pytest.approx(400e-6) and p.window_s == pytest.approx(1e-3)
    gaps = dict(p.idle_gaps())
    assert gaps["cudaStreamSynchronize"] == pytest.approx(200e-6)
    assert p.top_device_ops()[0] == ["k1", pytest.approx(200e-6)]


def test_kernel_roofline_sort_reader():
    R, N = 131072, 1024
    moved = 2 * R * N * 4
    t_us = moved / 3.35e12 * 1e6 * 2  # twice the bound: 50%
    p = _profile([("void sort_rows_kernel<10, false, false, float, int>", 10, 10 + t_us, 7),
                  ("elementwise", 0, 10, 8)],
                 [("repro_torch::sort_rows", 5, [[R, N]], ["float"], 9)],
                 launches=[(6, 7), (8, 8)])
    r = Reading(shapes=p, device_kind=H100)
    assert registry.reader("kernel_roofline.sort")(r) == pytest.approx(50.0, rel=1e-6)
    assert registry.reader("kernel_roofline.sort")(Reading(shapes=p, device_kind="cpu")) is None
    assert registry.reader("kernel_roofline.sort")(Reading(profile=p, device_kind=H100)) is None


@pytest.mark.parametrize("case", ["card_clock_past_the_window", "op_without_kernel",
                                  "kernel_without_launch", "launch_outside_the_op"])
def test_kernel_roofline_sort_counts_only_paired_calls_and_kernels(case):
    # an op's bytes count only with its own kernel's time, and the kernel's
    # time wherever the card's clock puts it against the host's
    R, N = 131072, 1024
    t_us = 2 * R * N * 4 / 3.35e12 * 1e6 * 2  # one call at 50% of its bound
    kernels = [("void merge_rows_kernel<11, true, float, int>", 100, 100 + t_us, 1)]
    ops = [("repro_torch::merge_rows", 10, [[R, N // 2], [R, N // 2]], ["float", "float"], 20)]
    launches = [(15, 1)]
    window = (0, 1e6)
    if case == "card_clock_past_the_window":
        window = (0, 50)
    elif case == "op_without_kernel":  # a CPU operand: the twin runs, no kernel
        ops.append(("repro_torch::merge_rows", 30, [[R, N]] * 2, ["float", "float"], 40))
    elif case == "kernel_without_launch":
        kernels.append(("void merge_rows_kernel<11, true, float, int>", 500, 500 + t_us, 2))
    else:
        kernels.append(("void merge_rows_kernel<11, true, float, int>", 500, 500 + t_us, 3))
        launches.append((45, 3))
    r = Reading(shapes=_profile(kernels, ops, window=window, launches=launches),
                device_kind=H100)
    assert registry.reader("kernel_roofline.sort")(r) == pytest.approx(50.0, rel=1e-6)


def test_profile_window_from_the_syncs_around_a_card_only_trace():
    # no annotation: the stretch runs from the first sync's end to the last's
    ev = [{"ph": "X", "cat": "cuda_runtime", "name": "cudaDeviceSynchronize", "ts": t,
           "dur": 10} for t in (100, 500, 990)]
    ev += [{"ph": "X", "cat": "kernel", "name": "k", "ts": 200, "dur": 300,
            "args": {"device": 0}}]
    p = Profile(ev, 0)
    assert p.window == pytest.approx((110e-6, 1000e-6))
    assert p.busy_s == pytest.approx(300e-6) and p.ops == []
    with pytest.raises(RuntimeError):
        Profile(ev[:1], 0)


def test_collective_kernels_are_not_busy():
    # NCCL's kernel spins while its rank waits: idle, unless work overlaps it
    p = _profile([("ncclDevKernel_AllGather_RING_LL(...)", 0, 600), ("k", 500, 700)], [],
                 host=[("cudaStreamSynchronize", 0, 1000)], window=(0, 1000))
    assert p.busy_s == pytest.approx(200e-6)
    assert dict(p.idle_gaps())["cudaStreamSynchronize"] == pytest.approx(800e-6)
    assert p.top_device_ops()[0][0].startswith("ncclDevKernel")


def test_prefill_mfu_reader():
    calls = [{"latency_s": 0.3, "items": 8192, "ok": True}] * 10
    r = Reading(calls=calls, device_kind=H100,
                extra={"flops_per_request": 4.7e13, "mfu_window_s": 3.0, "mfu_requests": 10})
    assert registry.reader("prefill_mfu")(r) == pytest.approx(100 * 4.7e14 / (3.0 * 989e12))
