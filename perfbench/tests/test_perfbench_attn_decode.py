"""``attn_decode_roofline`` on synthetic traces: the live K and V the
profiled decode steps read (counted by their token readbacks) over the
union of the dense decode attention kernel's intervals, and nothing read
where that kernel never ran."""

import json

import pytest

from perfbench import arith, run

YI = arith.Dims(layers=48, d=4096, heads=32, kv_heads=4, head_dim=128,
                ff=11008, vocab=64000)
MIXTRAL = arith.Dims(layers=7, d=6144, heads=48, kv_heads=8, head_dim=128,
                     ff=16384, vocab=32768, experts=8, top_k=2)
SPLIT = ("void (anonymous namespace)::decode_attention_kernel_split"
         "<__nv_bfloat16, 8, 128>((anonymous namespace)"
         "::Params)")
COMBINE = ("void (anonymous namespace)::decode_attention_kernel_combine"
           "<__nv_bfloat16>((anonymous namespace)::Params)")
PAGED = ("void (anonymous namespace)::paged_attention_kernel_split"
         "<__nv_bfloat16, __nv_bfloat16, false, 128>((anonymous namespace)"
         "::Params)")
NVJET = "nvjet_tst_192x192_64x3_2x1_v_bz_coopB_NNN"
READBACK = "Memcpy DtoH (Device -> Pageable)"


def _ev(name, start, end, cat="kernel"):
    return {"name": name, "cat": cat, "start": start, "end": end, "bytes": 0}


def _record(device, marks, dims=YI, batch=64, plen=512):
    return {"trace": {"device": device, "host": [], "marks": marks},
            "dims": dims, "profiled": {"batch": batch, "plen": plen}}


def _read(rec):
    return run.reader("attn_decode_roofline")(rec)


def test_kv_bytes_per_token_by_hand():
    # K and V x 48 layers x 4 kv heads x 128 x 2 bytes
    assert YI.kv_bytes_per_token == 2 * 48 * 4 * 128 * 2 == 98304
    assert MIXTRAL.kv_bytes_per_token == 2 * 7 * 8 * 128 * 2 == 28672


@pytest.mark.parametrize("dims", [YI, MIXTRAL], ids=["yi", "mixtral"])
def test_bound_is_the_live_kv_of_the_counted_steps(dims):
    """Three steps 0.1 s apart, each a split kernel per layer-pair and a
    token readback; other kernels and copies are not attention."""
    device = []
    for s in range(3):
        t = 0.1 * s
        device += [_ev(SPLIT, t, t + 0.001),
                   _ev(SPLIT, t + 0.0005, t + 0.002),   # overlaps once
                   _ev(NVJET, t + 0.002, t + 0.05),
                   _ev(READBACK, t + 0.05, t + 0.0501, cat="gpu_memcpy")]
    device.append(_ev("Memcpy DtoD (Device -> Device)", 0.0, 0.01,
                      cat="gpu_memcpy"))
    got = _read(_record(device, {"decode": (0.0, 0.3)}, dims))
    live = 64 * ((512 + 1) + (512 + 2) + (512 + 3)) * dims.kv_bytes_per_token
    assert got == pytest.approx(100.0 * live / 3.35e12 / (3 * 0.002))


def test_combine_counts_and_the_window_clips():
    """The combine kernel is K8's too; a kernel straddling the window's end
    counts only inside it, and a readback after it is no step."""
    device = [_ev(SPLIT, 0.0, 0.001), _ev(COMBINE, 0.001, 0.0015),
              _ev(READBACK, 0.01, 0.0101, cat="gpu_memcpy"),
              _ev(SPLIT, 0.0195, 0.0205),
              _ev(READBACK, 0.03, 0.0301, cat="gpu_memcpy")]
    got = _read(_record(device, {"decode": (0.0, 0.02)}, batch=4, plen=100))
    live = 4 * (100 + 1) * YI.kv_bytes_per_token
    assert got == pytest.approx(100.0 * live / 3.35e12 / 0.002)


def test_a_profile_of_the_yi_step_reads_below_100():
    """Six steps of yi-9b at 64 x 512 whose K8 kernels take the time the
    bytes need at 3.35 TB/s read 100%; at 2.5 TB/s, 74.6%."""
    device = []
    for s in range(6):
        t = 0.05 * s
        need = 64 * (512 + s + 1) * YI.kv_bytes_per_token / 2.5e12
        device += [_ev(SPLIT, t, t + need),
                   _ev(READBACK, t + 0.04, t + 0.0401, cat="gpu_memcpy")]
    got = _read(_record(device, {"decode": (0.0, 0.3)}))
    assert got == pytest.approx(100.0 * 2.5 / 3.35)


def test_reads_nothing_without_the_kernel():
    """The plain path's einsums, or K3's paged kernel, are not K8: nothing
    is read and nothing raises; nor without a trace, a decode mark or a
    readback."""
    device = [_ev(NVJET, 0.0, 0.1), _ev(PAGED, 0.1, 0.11),
              _ev(READBACK, 0.11, 0.111, cat="gpu_memcpy")]
    assert _read(_record(device, {"decode": (0.0, 1.0)})) is None
    assert _read({"dims": YI}) is None
    k8 = [_ev(SPLIT, 0.0, 0.1)]
    assert _read(_record(k8, {"prefill": (0.0, 1.0)})) is None
    assert _read(_record(k8, {"decode": (0.0, 1.0)})) is None


def test_benchmark_lists_the_metric_in_the_three_cells():
    bench = json.loads((run.ROOT / "BENCHMARK.json").read_text())
    m = {e["name"]: e for e in bench["per_layer"]}["attn_decode_roofline"]
    assert m["moves"] == "tpot_ms_p50" and m["source"] == "device_trace"
    assert m["workloads"] == ["yi9b-flexgen-offload", "yi9b-flexgen-hbm",
                              "mixtral8x22b-flexgen-hbm"]
    for cell in m["workloads"]:
        assert "attn_decode_roofline" in run.load_cell(cell).per_layer
