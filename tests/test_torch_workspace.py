"""The buffers the port's kernel wrappers keep between calls
(``prego_tpu_torch/ops/_cuda.py::Workspace``), on the CPU: the logic that
decides when a call reuses them and when it replaces them."""

import torch

from prego_tpu_torch.ops._cuda import Workspace


def test_workspace_grows_only_when_a_call_needs_more():
    """The buffers K5 and K3 keep between calls: one set per (device,
    stream), reused while a call fits, replaced by larger (zeroed) ones only
    when it does not; another stream gets its own."""
    cpu = torch.device("cpu")
    ws = Workspace(torch.int32, zero=True)
    a, b = ws.get(cpu, 1, 64, 4)
    assert (a.numel(), b.numel(), a.dtype) == (64, 4, torch.int32) and not torch.any(a)
    a[0] = 7  # a kernel would leave it zero; kept as it is while calls fit
    assert all(x is y for x, y in zip(ws.get(cpu, 1, 32, 4), (a, b)))
    assert ws.get(cpu, 1, 64, 2)[0][0] == 7
    c, d = ws.get(cpu, 1, 16, 8)  # the tickets outgrow their buffer: both replaced
    assert (c.numel(), d.numel()) == (64, 8) and not torch.any(c)
    e, _ = ws.get(cpu, 2, 16, 8)
    assert e is not c and e.numel() == 16
