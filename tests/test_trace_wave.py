"""tools/trace_wave.py's reduction from a profiler trace to device time per
wave and per scope, on a small synthetic trace."""
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))
import trace_wave as tw  # noqa: E402

HLO = """
  %input_reduce_select_fusion.1 = f32[8]{0} fusion(f32[8,4]{1,0} %x), kind=kInput, calls=%c, metadata={op_name="jit(step)/while/body/traverse_brute/reduce_min" source_file="a.py"}
  ROOT %loop_add_fusion = f32[8]{0} fusion(%y), kind=kLoop, calls=%d, metadata={op_name="jit(step)/while/body/add"}
"""


def _events():
    meta = [dict(ph="M", name="process_name", pid=1,
                 args=dict(name="/device:GPU:0")),
            dict(ph="M", name="process_name", pid=2,
                 args=dict(name="/host:CPU"))]

    def ev(name, ts, dur, pid=1, module="step"):
        return dict(ph="X", pid=pid, name=name, ts=ts, dur=dur,
                    args=dict(hlo_module=module))
    return meta + [
        ev("input_reduce_select_fusion_1", 0.0, 300.0),
        ev("loop_add_fusion", 250.0, 150.0),          # overlaps: union 400
        ev("void traverse_kernel<false>(float4 const*)", 500.0, 100.0),
        ev("loop_add_fusion", 700.0, 100.0),
        ev("other_module_kernel", 0.0, 5000.0, module="other"),
        ev("host_thing", 0.0, 5000.0, pid=2),
    ]


def test_kernel_scopes_maps_fusion_names():
    scopes = tw.kernel_scopes(HLO)
    assert scopes["input_reduce_select_fusion_1"].endswith(
        "traverse_brute/reduce_min")
    assert scopes["loop_add_fusion"] == "jit(step)/while/body/add"


def test_reduce_trace_busy_and_traversal_share():
    r = tw.reduce_trace(_events(), "step", tw.kernel_scopes(HLO), waves=2)
    assert r["window_ms"] == pytest.approx(0.8)
    assert r["busy_ms"] == pytest.approx(0.6)
    assert r["busy_share"] == pytest.approx(0.75)
    assert r["device_ms_per_wave"] == pytest.approx(0.3)
    # the brute-force fusion (by HLO scope) + the CUDA kernel (by symbol)
    assert r["traversal_ms_per_wave"] == pytest.approx(0.2)
    assert r["top_kernels_ms"][0][0] == "input_reduce_select_fusion_1"


def test_reduce_trace_without_module_events_raises():
    with pytest.raises(RuntimeError):
        tw.reduce_trace(_events(), "missing", {}, waves=1)
