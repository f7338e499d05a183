"""The closed loop on the CPU: calls, depth, reservoir and each call's
times, as the metric readers get them."""

import random
from types import SimpleNamespace

import torch

from benchmark import harness

CPU = torch.device("cpu")


class Counting:
    pool = 3

    def __init__(self):
        self.slots = []

    def call(self, slot):
        self.slots.append(slot)
        return torch.full((2,), float(len(self.slots) - 1))


def test_closed_loop_record():
    loop = harness.load_loop("closed")
    entry = Counting()
    rec = loop.run(entry, {}, 0.0, CPU, random.Random(1), 2, max_calls=7)
    assert rec.calls == 7 and entry.slots == [0, 1, 2, 0, 1, 2, 0]
    assert len(rec.issued_s) == len(rec.enqueue_ns) == len(rec.done_s) == 7
    assert rec.issued_s == sorted(rec.issued_s) and rec.issued_s[0] >= 0
    assert all(d >= i for i, d in zip(rec.issued_s, rec.done_s))
    assert rec.seconds >= rec.done_s[-1] - 1e-6
    assert len(rec.kept) == 2
    for i, slot, out in rec.kept:
        assert slot == i % 3 and out[0].item() == i


def test_closed_loop_stops_on_time():
    loop = harness.load_loop("closed")
    rec = loop.run(Counting(), {}, 0.05, CPU, random.Random(2), 0)
    assert rec.calls >= 2 and rec.kept == []
    assert rec.seconds >= 0.05


def test_readers_get_the_entry_and_the_window():
    line = SimpleNamespace(
        entry=SimpleNamespace(meshes_per_call=10),
        window=SimpleNamespace(calls=4, seconds=2.0))
    assert harness.load_reader("meshes_per_s")(line) == 20.0


def test_closed_loop_keeps_the_mix_depth_in_flight(monkeypatch):
    loop = harness.load_loop("closed")
    waits = []

    class Counted(loop._HostEvent):
        def synchronize(self):
            waits.append(self)

    monkeypatch.setattr(loop, "_HostEvent", Counted)
    for depth, expected in ((None, 5), (3, 4), (16, 0)):
        waits.clear()
        traffic = {} if depth is None else {"depth": depth}
        rec = loop.run(Counting(), traffic, 0.0, CPU, random.Random(3), 0,
                       max_calls=7)
        assert rec.calls == 7 and len(waits) == expected
