"""tools/timing.py's guard on ``device_ms``, on the CPU with the CUDA
calls it makes replaced by fakes: it returns the events' time per call
when every call was queued before the spin ended, retries once with a
longer spin, and raises ``LaunchQueueOverflow`` when the spin ended
first both times (the host blocked on a full launch queue, so the events
would time its gaps)."""

import pytest
import torch

from kaldi_tpu_torch.tools import timing


class FakeCuda:
    """torch.cuda's _sleep, synchronize and Event: ``spun`` events (those
    recorded without timing, after each spin) report the spin over or
    not from ``ended``, one value a spin; timed events read 12 ms."""

    def __init__(self, ended):
        self.ended = list(ended)
        self.sleeps = []

    def install(self, monkeypatch):
        fake = self

        class Event:
            def __init__(self, enable_timing=False):
                self.timing = enable_timing

            def record(self):
                pass

            def query(self):
                return fake.ended.pop(0)

            def elapsed_time(self, other):
                return 12.0

        monkeypatch.setattr(torch.cuda, "Event", Event)
        monkeypatch.setattr(torch.cuda, "_sleep",
                            lambda cycles: fake.sleeps.append(cycles))
        monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)


def test_device_ms_times_calls_queued_behind_the_spin(monkeypatch):
    fake = FakeCuda([False])
    fake.install(monkeypatch)
    calls = []
    assert timing.device_ms(lambda: calls.append(1), 4) == 3.0
    assert len(calls) == 2 + 4 and len(fake.sleeps) == 1


def test_device_ms_retries_with_a_longer_spin(monkeypatch):
    fake = FakeCuda([True, False])
    fake.install(monkeypatch)
    assert timing.device_ms(lambda: None, 6) == 2.0
    assert len(fake.sleeps) == 2 and fake.sleeps[1] > fake.sleeps[0]


def test_device_ms_raises_past_the_launch_queue(monkeypatch):
    fake = FakeCuda([True, True])
    fake.install(monkeypatch)
    with pytest.raises(timing.LaunchQueueOverflow, match="graph_ms"):
        timing.device_ms(lambda: None, 10)
