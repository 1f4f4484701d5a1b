"""The port's trace parser (training/profiling.py: ``report_device_ops``)
on chrome traces ``torch.profiler`` writes on the CPU: the host's operator
timeline is summed by name and divided by the steps; a CPU trace has no
device (CUDA kernel) events; a directory without a trace reports none."""

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from allophant_tpu_torch.training.profiling import device_op_times, report_device_ops


def test_report_reads_a_trace_written_on_the_cpu(tmp_path, capsys):
    with profile(activities=[ProfilerActivity.CPU]) as profiler:
        for _ in range(2):
            (torch.ones(32, 32) @ torch.ones(32, 32)).sum()
    (tmp_path / "nested").mkdir()
    profiler.export_chrome_trace(str(tmp_path / "nested" / "trace.json"))
    per_step = report_device_ops(str(tmp_path), steps=2, top=3, category="cpu_op")
    totals, counts = device_op_times(str(tmp_path / "nested" / "trace.json"), "cpu_op")
    assert counts["aten::mm"] == 2 and per_step["aten::mm"] == totals["aten::mm"] / 1e3 / 2
    assert np.isclose(sum(per_step.values()), sum(totals.values()) / 2e3)
    printed = capsys.readouterr().out.splitlines()
    assert printed[0].startswith("cpu_op total:") and len(printed) == 4
    assert report_device_ops(str(tmp_path), steps=2) == {}
    assert capsys.readouterr().out.strip() == "no kernel events found in trace"


def test_no_trace(tmp_path, capsys):
    assert report_device_ops(str(tmp_path), steps=1) == {}
    assert capsys.readouterr().out.strip() == "no trace written"
