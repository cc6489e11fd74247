"""The profiled window's reduction, on events made by hand."""

import pytest
import torch

from benchmark_torch.harness import trace

CUDA = torch.autograd.DeviceType.CUDA
CPU = torch.autograd.DeviceType.CPU


class Event:
    def __init__(self, name, kind, start, end, device=CPU, thread=1):
        self._name, self._kind = name, kind
        self._start, self._end = start, end
        self._device, self._thread = device, thread

    def name(self):
        return self._name

    def activity_type(self):
        return self._kind

    def start_ns(self):
        return self._start

    def end_ns(self):
        return self._end

    def device_type(self):
        return self._device

    def start_thread_id(self):
        return self._thread


def test_busy_idle_and_gaps():
    events = [
        Event(trace.WINDOW, 'user_annotation', 0, 1000),
        Event('EINet.run', 'user_annotation', 10, 990),
        Event('EINet.run', 'gpu_user_annotation', 10, 990, CUDA),
        Event('aten::copy_', 'cpu_op', 20, 60),
        Event('cudaMemcpyAsync', 'cuda_runtime', 30, 50),
        Event('Memcpy HtoD', 'gpu_memcpy', 100, 200, CUDA),
        Event('k21', 'kernel', 150, 700, CUDA),
        Event('Memset', 'gpu_memset', 800, 850, CUDA),
        Event('Activity Buffer Request', 'cuda_profiler_range', 0, 1000),
        Event('aten::other_thread', 'cpu_op', 0, 1000, thread=2),
    ]
    t = trace.summarize(events)
    assert t.window_s == pytest.approx(1000e-9)
    assert t.busy_s == pytest.approx((600 + 50) * 1e-9)
    assert t.device_op_s == pytest.approx((100 + 550 + 50) * 1e-9)
    assert t.n_device_ops == 3
    assert t.n_by_kind == {'gpu_memcpy': 1, 'kernel': 1, 'gpu_memset': 1}
    assert t.device_ops[0] == ['k21', pytest.approx(550e-9)]
    gaps = dict(t.idle_gaps)
    # 0-100: its middle (50) in the copy's runtime call; 700-800 and
    # 850-1000 inside the trial's span alone
    assert gaps == {'aten::copy_ > cudaMemcpyAsync': pytest.approx(100e-9),
                    'EINet.run': pytest.approx(250e-9)}
