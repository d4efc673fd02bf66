"""``benchmark/spans.py`` on a synthetic trace: each device operation put
down to its span (through its launch; a backward operation through its
node's link to the forward operation; one with no link by the time of its
launch, on any thread; one launched outside every span, or whose launch
is missing, to none), each idle gap placed inside or outside the root
spans, and the sweeps against a direct search.  On a card: a traced tiny
training window puts at least 99% of its device time under the program's
spans."""

from __future__ import annotations

import random
from types import SimpleNamespace

import pytest
import torch

from benchmark import harness, spans, tracing
from benchmark.tests.tiny import tiny_backbone, tiny_spec  # noqa: F401  (fixture)

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
MAIN, AUTOGRAD = 1, 2


class Event:
    """The fields of a profiler event that the reader uses."""

    def __init__(self, name, start, end, thread=MAIN, device=CPU, corr=0, seq=-1, fwd=0,
                 annotation=False):
        self._v = dict(name=name, start_ns=start, duration_ns=end - start, start_thread_id=thread,
                       device_type=device, correlation_id=corr, sequence_nr=seq,
                       fwd_thread_id=fwd, is_user_annotation=annotation)

    def __getattr__(self, key):
        v = self.__dict__["_v"][key]
        return lambda: v


def launch(corr, at, run, thread=MAIN):
    """A runtime call at ``at`` and the kernel it launched, run over ``run``."""
    return [Event("cudaLaunchKernel", at, at + 1, thread, corr=corr),
            Event(f"kernel_{corr}", *run, device=CUDA, corr=corr)]


def trace():
    """fetch > to_device, then step > {augment > augment.wait, backbone,
    head, losses, backward, adamw} on the main thread; the backward's
    nodes on the autograd thread; a kernel launched after the step and
    one whose launch is missing; the device copy of a user annotation."""
    ev = [Event("fetch", 0, 10), Event("to_device", 2, 6), *launch(100, 3, (10, 15)),
          Event("step", 20, 200), Event("augment", 21, 25), Event("augment.wait", 22, 24),
          Event("backbone", 25, 60), Event("aten::convolution", 30, 40, seq=7),
          *launch(101, 32, (40, 60)),
          Event("head", 60, 80), Event("aten::matmul", 61, 71, seq=8),
          Event("aten::mm", 62, 70, seq=8), *launch(102, 65, (70, 75)),
          Event("losses", 80, 100), Event("aten::mean", 82, 90, seq=9),
          *launch(103, 85, (90, 95)),
          Event("backward", 100, 160),
          Event("autograd::engine::evaluate_function: MmBackward0", 105, 120, AUTOGRAD,
                seq=8, fwd=MAIN),
          Event("MmBackward0", 106, 119, AUTOGRAD, seq=8, fwd=MAIN),
          Event("aten::mm", 107, 115, AUTOGRAD), *launch(104, 110, (120, 130), AUTOGRAD),
          Event("autograd::engine::evaluate_function: ConvolutionBackward0", 121, 140,
                AUTOGRAD, seq=7, fwd=MAIN),
          *launch(105, 125, (130, 150), AUTOGRAD),
          Event("autograd::engine::evaluate_function: torch::autograd::AccumulateGrad",
                141, 150, AUTOGRAD),
          *launch(106, 145, (150, 152), AUTOGRAD),
          Event("adamw", 160, 190), *launch(107, 170, (175, 185)),
          *launch(108, 210, (215, 220)),
          Event("kernel_999", 230, 232, device=CUDA, corr=999),
          Event("backward", 0, 232, device=CUDA, annotation=True)]
    random.Random(0).shuffle(ev)
    return SimpleNamespace(profiler=SimpleNamespace(kineto_results=SimpleNamespace(
        events=lambda: ev)))


def test_each_operation_goes_to_the_span_that_caused_it(capsys):
    found = spans.Spans(trace(), steps=1)
    assert dict(found.device_ns) == {
        ("fetch", "to_device"): 5, ("step", "backbone"): 20 + 20, ("step", "head"): 5 + 10,
        ("step", "losses"): 5, ("step", "backward"): 2, ("step", "adamw"): 10, (): 5 + 2}
    ns = 1e-6           # one ns in ms
    assert found.busy_ms(("fetch", "to_device", "augment")) == pytest.approx(5 * ns)
    assert found.busy_ms(("backbone",), under="step") == pytest.approx(40 * ns)
    assert found.busy_ms(("backbone",), under="serve") == 0.0
    assert found.busy_ms(("head",)) == pytest.approx(15 * ns)
    assert found.busy_ms(("clip", "adamw")) == pytest.approx(10 * ns)
    assert found.busy_ms(("step",)) == pytest.approx(72 * ns)
    assert found.host_ms("augment.wait") == pytest.approx(2 * ns)
    found.report()
    assert "% under no span" in capsys.readouterr().err


def test_each_idle_gap_is_placed_inside_or_outside_the_roots():
    found = spans.Spans(trace(), steps=1)
    # gaps: [0,10) [15,40) [60,70) [75,90) [95,120) [152,175) [185,215) [220,230)
    assert found.window_ns == 232 and found.idle_ns == 148
    assert found.idle_in_ns["step"] == 20 + 10 + 15 + 25 + 23 + 15
    assert found.idle_share_in("step") == pytest.approx(100 * 108 / 148)
    assert found.idle_share_in("serve") == 0.0
    assert dict(found.idle_by_span) == {"to_device": 10, "backbone": 25, "head": 10,
                                        "losses": 15, "backward": 25, "adamw": 23,
                                        "outside every span": 30 + 10}


def test_a_trace_without_spans_reads_nothing(capsys):
    plain = [e for e in trace().profiler.kineto_results.events()
             if e.name() not in spans.SPANS]
    prof = SimpleNamespace(profiler=SimpleNamespace(kineto_results=SimpleNamespace(
        events=lambda: plain)))
    ctx = SimpleNamespace(prof=prof, window={"steps": 3})
    assert spans.of(ctx) is None and ctx.program_spans is None
    ctx = SimpleNamespace(prof=trace(), window={"steps": 0})
    assert spans.of(ctx) is None
    assert capsys.readouterr().err == ""
    ctx = SimpleNamespace(prof=trace(), window={"steps": 2})
    assert spans.of(ctx) is spans.of(ctx)
    assert spans.of(ctx).busy_ms(("step",)) == pytest.approx(36e-6)


def _nested(rng, lo, hi, depth):
    out = []
    t = lo
    while depth and t < hi - 2 and rng.random() < 0.8:
        s = rng.randint(t, hi - 2)
        e = rng.randint(s + 1, hi)
        out.append((s, e))
        out += _nested(rng, s, e, depth - 1)
        t = e
    return out


def test_the_sweeps_agree_with_a_direct_search():
    rng = random.Random(1)
    for _ in range(50):
        ivs = sorted(_nested(rng, 0, 1000, 4), key=lambda x: (x[0], -x[1]))
        times = [rng.randint(-5, 1005) for _ in range(200)]

        def direct(t, upto=len(ivs)):
            inside = [k for k in range(upto) if ivs[k][0] <= t < ivs[k][1]]
            return inside[-1] if inside else -1
        assert spans._innermost(ivs, times) == [direct(t) for t in times]
        assert spans._nest(ivs) == [
            max([k for k in range(i) if ivs[k][0] <= ivs[i][0] and ivs[i][1] <= ivs[k][1]],
                default=-1) for i in range(len(ivs))]


@pytest.mark.cuda
def test_a_traced_tiny_step_puts_its_device_time_under_the_spans(tiny_backbone):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    spec = tiny_spec("hcompnet_cub190.train_joint")
    cell = harness.driver(spec).Cell(spec, 2 ** 31 + 7, "cuda")
    cell.setup()
    torch.cuda.synchronize()
    prof = tracing.start()
    w = cell.window(1.0)
    prof.stop()
    found = spans.of(SimpleNamespace(prof=prof, window=w))
    total = sum(found.device_ns.values())
    assert found.device_ns.get((), 0) <= 0.01 * total, dict(found.device_ns)
    assert found.busy_ms(("backbone",), under="step") > 0 and found.busy_ms(("head",)) > 0
    assert found.host_ms("augment.wait") > 0
