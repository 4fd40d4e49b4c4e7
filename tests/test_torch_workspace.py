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


def test_workspace_keeps_a_dtype_and_a_zeroing_per_buffer():
    """f32 partial sums beside int32 counters that must start at zero (K8's
    projection): each buffer has its own dtype, only the counters are
    zeroed, a call that outgrows either replaces the set (the counters zero
    again), and each stream has its own set."""
    cpu = torch.device("cpu")
    ws = Workspace((torch.float32, torch.int32), zero=(False, True))
    part, tickets = ws.get(cpu, 7, 96, 3)
    assert (part.dtype, tickets.dtype, part.numel(), tickets.numel()) == (
        torch.float32, torch.int32, 96, 3)
    assert not torch.any(tickets)
    tickets[1] = 5  # a kernel leaves them zero; kept as they are while calls fit
    again = ws.get(cpu, 7, 64, 2)
    assert again[0] is part and again[1] is tickets and tickets[1] == 5
    part2, tickets2 = ws.get(cpu, 7, 128, 2)  # the partial sums outgrow theirs
    assert part2.numel() == 128 and tickets2.numel() == 3 and not torch.any(tickets2)
    other, other_tickets = ws.get(cpu, 8, 16, 1)
    assert other is not part2 and (other.numel(), other_tickets.numel()) == (16, 1)


def test_k8_and_k9_workspaces_hold_the_buffers_their_kernels_take():
    """K8 and K8u share pass 1's partial sums and (m, l), the head partials
    (f32) and the column tiles' counters (int32, zero); K9 keeps its split
    partial sums (f32) and the normed rows (bf16), and no counter."""
    from prego_tpu_torch.ops import decode_attention_wo as dwo
    from prego_tpu_torch.ops import fused_dense as fd

    cpu = torch.device("cpu")
    bufs = dwo.WORKSPACE.get(cpu, 0, 40, 8, 24, 4)
    assert [b.dtype for b in bufs] == [torch.float32] * 3 + [torch.int32]
    assert [b.numel() for b in bufs] == [40, 8, 24, 4] and not torch.any(bufs[3])
    part, xn = fd.WORKSPACE.get(cpu, 0, 48, 16)
    assert (part.dtype, xn.dtype, part.numel(), xn.numel()) == (
        torch.float32, torch.bfloat16, 48, 16)


def test_workspace_keeps_a_set_that_a_capture_used(monkeypatch):
    """A CUDA graph holds the addresses of the set it captured: when a later
    call outgrows that set it is kept (``retired``), not freed, and its
    successor is not marked until a capture uses it; a set no capture used
    is simply replaced."""
    from prego_tpu_torch.ops import _cuda

    cpu = torch.device("cpu")
    ws = Workspace((torch.float32, torch.int32), zero=(False, True))
    plain = ws.get(cpu, 1, 8, 2)
    ws.get(cpu, 1, 16, 2)  # outgrown, never captured: dropped
    assert ws.retired == []
    monkeypatch.setattr(_cuda, "_capturing", lambda device: True)
    captured = ws.get(cpu, 1, 4, 1)  # fits: the same set, now captured
    monkeypatch.setattr(_cuda, "_capturing", lambda device: False)
    assert captured[0] is not plain[0] and ws.get(cpu, 1, 16, 2)[0] is captured[0]
    grown = ws.get(cpu, 1, 32, 2)
    assert ws.retired == [captured] and grown[0].numel() == 32 and not torch.any(grown[1])
    ws.get(cpu, 1, 64, 2)  # the successor was never captured: not kept
    assert ws.retired == [captured]
    other = ws.get(cpu, 2, 8, 1)  # another stream's set is its own
    assert other[0] is not grown[0] and ws.retired == [captured]
