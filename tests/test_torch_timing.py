"""The bookkeeping of ``chip_smoke.py``'s device timer, on made-up records:
folding profiler events into per-kernel time per launch, the profiler
disagreement flag, the host-late count and the repeats' spread. The timer
itself needs the card; this arithmetic is what every kernel ranking in
PERF.md rests on, so it is pinned here on the CPU."""

import importlib.util
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


def _load_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


cs = _load_smoke()

B9 = ("void nezha::(anonymous namespace)::paged_prefill_kernel<"
      "__nv_bfloat16, __nv_bfloat16, false, 8>(__nv_bfloat16 const*, "
      "__nv_bfloat16 const*, int, float)")
WRITE = ("void nezha::(anonymous namespace)::quant_prefill_write_kernel<"
         "__nv_bfloat16>(__nv_bfloat16 const*, signed char*, int)")
FLUSH = "Memcpy DtoD (Device -> Device)"


@pytest.mark.parametrize("raw,name", [
    (B9, "paged_prefill_kernel"),
    (WRITE, "quant_prefill_write_kernel"),
    ("fmha_cutlassF_bf16_aligned_64x64_rf_sm80(PyTorchMemEffAttention::"
     "AttentionKernel<cutlass::bfloat16_t, cutlass::arch::Sm80, true, 64, "
     "64, 64, true, true>::Params)", "fmha_cutlassF_bf16_aligned_64x64_rf_sm80"),
    ("void pytorch_flash::flash_fwd_kernel<Flash_fwd_kernel_traits<64, 128, "
     "128, 4, false, false, cutlass::bfloat16_t>, false, true>(Flash_fwd_"
     "params)", "flash_fwd_kernel"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::"
     "FillFunctor<float>, std::array<char*, 1ul> >(int, at::native::"
     "FillFunctor<float>, std::array<char*, 1ul>)",
     "vectorized_elementwise_kernel"),
    (FLUSH, "Memcpy DtoD"),
    ("plain_name", "plain_name"),
])
def test_kernel_name(raw, name):
    assert cs.kernel_name(raw) == name


def test_fold_profiler_events_per_call_and_per_launch():
    """Five profiled calls of a two-kernel row (B10: attention then
    write), each after an L2 flush: launches per call and the mean device
    time of a launch, the flush's own events left out."""
    events = []
    for i in range(5):
        events += [(FLUSH, 20.0), (B9, 40.0 + i), (WRITE, 8.0)]
    kernels = cs.fold_profiler_events(events, 5,
                                      exclude={cs.kernel_name(FLUSH)})
    assert kernels == {
        "paged_prefill_kernel": {"launches_per_call": 1.0,
                                 "us_per_launch": 42.0},
        "quant_prefill_write_kernel": {"launches_per_call": 1.0,
                                       "us_per_launch": 8.0}}
    assert cs.profiler_us(kernels) == pytest.approx(50.0)


def test_fold_profiler_events_lost_and_repeated_launches():
    """A launch the profiler missed shows as fewer launches per call; a
    kernel launched twice a call (a backward's two grids of one name)
    counts both, and profiler_us weighs each kernel by its launches."""
    events = [(B9, 10.0)] * 4 + [(WRITE, 3.0)] * 10
    kernels = cs.fold_profiler_events(events, 5)
    assert kernels["paged_prefill_kernel"] == {"launches_per_call": 0.8,
                                               "us_per_launch": 10.0}
    assert kernels["quant_prefill_write_kernel"] == {
        "launches_per_call": 2.0, "us_per_launch": 3.0}
    assert cs.profiler_us(kernels) == pytest.approx(0.8 * 10 + 2 * 3)


def test_fold_profiler_events_empty():
    assert cs.fold_profiler_events([], 5) == {}
    assert cs.profiler_us({}) == 0.0


@pytest.mark.parametrize("event_ms,prof_us,flag", [
    (0.100, 100.0, False),       # equal
    (0.114, 100.0, False),       # 14% over: within 15%
    (0.116, 100.0, True),        # 16% over and 16 us
    (0.084, 100.0, True),        # 16% under
    (0.012, 8.0, False),         # 50% over, but only 4 us
    (0.0141, 8.0, True),         # 76% over and 6.1 us
    (0.030, 0.0, True),          # no profiled kernel at all
])
def test_profiler_disagrees(event_ms, prof_us, flag):
    """Flagged when the event time and the profiler time differ by more
    than 15% of the profiler time and by more than 5 us."""
    assert cs.profiler_disagrees(event_ms, prof_us) is flag


@pytest.mark.parametrize("started,late", [
    ([False] * 150, 0),
    ([False] * 149 + [True], 1),
    ([True, False, True], 2),
    ([], 0),
])
def test_host_late_count(started, late):
    """A call is host-late when its start event had completed by the
    time the host had enqueued the call and its end event."""
    assert cs.host_late_count(started) == late


@pytest.mark.parametrize("values,want", [
    ([0.21, 0.2, 0.22], [0.2, 0.21, 0.22]),
    ([4.0, 1.0, 3.0, 2.0], [1.0, 2.5, 4.0]),
    ([0.5], [0.5, 0.5, 0.5]),
])
def test_spread(values, want):
    assert cs.spread(values) == want


@pytest.mark.parametrize("times,mean,dropped", [
    ([0.05, 0.051, 0.049], 0.05, 0),
    ([0.045] * 49 + [2.4], 0.045, 1),     # a stall of the device
    ([0.04, 0.16, 0.161], (0.04 + 0.16 + 0.161) / 3, 0),   # 4x, kept
])
def test_repeat_mean_leaves_out_stalls(times, mean, dropped):
    """A call over four times its repeat's median is left out of the
    repeat's mean and counted."""
    got, n = cs.repeat_mean(times)
    assert got == pytest.approx(mean) and n == dropped


def test_timing_fields_kernel_and_library_rows():
    """One row's fields: the mean of the repeats' means, their spread,
    the host-late count, the spin, the profiled kernels and the flag;
    a yardstick's under ``library_``."""
    kernels = {"paged_prefill_kernel": {"launches_per_call": 1.0,
                                        "us_per_launch": 50.0}}
    row = cs.timing_fields([0.05, 0.051, 0.052], [False] * 3, 2.0, kernels)
    assert row["ms"] == pytest.approx(0.051)
    assert row["ms_spread"] == [0.05, 0.051, 0.052]
    assert row["host_late"] == 0 and row["delay_ms"] == 2.0
    assert row["outliers"] == 0 and row["host_late_retried"] == []
    assert row["profiler_us"] == pytest.approx(50.0)
    assert row["event_over_profiler"] == pytest.approx(1.02)
    assert row["profiler_disagrees"] is False
    lib = cs.timing_fields([0.07] * 3, [False, True, False], 4.0, {},
                           prefix="library_", retried=[2])
    assert set(lib) == {f"library_{k}" for k in cs.TIMING_KEYS}
    assert lib["library_host_late"] == 1
    assert lib["library_host_late_retried"] == [2]
    assert lib["library_event_over_profiler"] is None
    assert lib["library_profiler_disagrees"] is True


def test_reported_keeps_every_timing_field():
    """The kernels line carries the kernel's and the yardstick's timing
    fields, the backend, the plain time and the bound of its case, and
    none of the case's own keys."""
    kernels = {"k": {"launches_per_call": 1.0, "us_per_launch": 10.0}}
    case = {"S": 256, "start": 768, "max_abs_err": 0.001,
            **cs.timing_fields([0.01] * 3, [False] * 3, 2.0, kernels),
            **cs.timing_fields([0.02] * 3, [False] * 3, 2.0, kernels,
                               prefix="library_"),
            "library_backend": "EFFICIENT_ATTENTION", "plain_ms": 20.0,
            "bound_ms": 0.001, "bound_by": "bytes"}
    out = cs.reported(case)
    assert "S" not in out and "max_abs_err" not in out
    for key in ("ms_spread", "host_late", "profiler_us", "profiler_kernels",
                "library_backend", "library_ms", "plain_ms", "bound_ms"):
        assert key in out
    assert out["library_backend"] == "EFFICIENT_ATTENTION"


@pytest.mark.parametrize("counts,whole", [
    ({"a": 5, "b": 5}, True),        # one launch of each a call
    ({"a": 10}, True),               # two launches a call
    ({"a": 5, "b": 3}, False),       # b's events lost in two calls
    ({}, False),                     # nothing caught
])
def test_whole_launches(counts, whole):
    """A profile is kept when every kernel was caught a whole number of
    times a call; a fraction means the profiler lost events."""
    events = [(name, 1.0) for name, n in counts.items() for _ in range(n)]
    assert cs.whole_launches(cs.fold_profiler_events(events, 5)) is whole


@pytest.mark.parametrize("prefix", ["", "library_"])
@pytest.mark.parametrize("means,empty", [
    ([0.05, 0.051, 0.052], 0.0041),
    ([0.0059] * 3, 0.0042),
    ([0.0030, 0.0031, 0.0032], 0.0040),     # under the zero point
])
def test_timing_fields_carry_the_zero_point(prefix, means, empty):
    """A row carries the rig's zero point (the empty launch's ms) and its
    own ms less it, beside its ms, which stays the events' reading."""
    row = cs.timing_fields(means, [False] * 3, 2.0, {}, prefix=prefix,
                           empty_ms=empty)
    ms = sum(means) / len(means)
    assert row[f"{prefix}ms"] == pytest.approx(ms)
    assert row[f"{prefix}empty_ms"] == empty
    assert row[f"{prefix}ms_less_empty"] == pytest.approx(ms - empty)
    assert set(row) == {f"{prefix}{k}" for k in cs.TIMING_KEYS}


def test_timing_fields_without_a_zero_point():
    """The zero point's own row, and any row timed without one, carries
    None in both fields rather than a made-up 0."""
    row = cs.timing_fields([0.004] * 3, [False] * 3, 2.0, {})
    assert row["empty_ms"] is None and row["ms_less_empty"] is None
    assert row["ms"] == pytest.approx(0.004)


def test_reported_carries_the_zero_point():
    """The kernels line keeps the kernel's and its yardstick's zero point
    and ms less it."""
    case = {**cs.timing_fields([0.0384] * 3, [False] * 3, 2.0, {},
                               empty_ms=0.004),
            **cs.timing_fields([0.0677] * 3, [False] * 3, 2.0, {},
                               prefix="library_", empty_ms=0.004),
            "library_backend": "EFFICIENT_ATTENTION", "plain_ms": 43.0,
            "bound_ms": 0.00198, "bound_by": "bytes"}
    out = cs.reported(case)
    assert out["empty_ms"] == out["library_empty_ms"] == 0.004
    assert out["ms_less_empty"] == pytest.approx(0.0344)
    assert out["library_ms_less_empty"] == pytest.approx(0.0637)
