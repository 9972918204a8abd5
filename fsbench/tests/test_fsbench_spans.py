"""spans.py: the per-span reduction on a profile built by hand, and on a
profiled interval at the tiny size (the CPU, and one card test)."""
from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from fsbench import spans as SP
from fsbench import trace as TR
from fsbench.tests.conftest import tiny

MS = 1_000_000          # ns
CELL = "dn_splatter_flat.seed30k"
SEED = 2 ** 31 + 77


class Event:
    def __init__(self, name, start, end, *, cuda=False, corr=0, thread=1,
                 annotation=False):
        self._v = (name, start * MS, (end - start) * MS, corr, thread,
                   annotation)
        self._cuda = cuda

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def correlation_id(self):
        return self._v[3]

    def start_thread_id(self):
        return self._v[4]

    def is_user_annotation(self):
        return self._v[5]

    def device_type(self):
        return DeviceType.CUDA if self._cuda else DeviceType.CPU


def fake_profile(annotations: bool):
    """One step on the main thread (1): fs.bin launches a kernel, autograd's
    thread (2) launches one inside fs.backward, fs.update one; a log
    boundary copies to the host and syncs; a kernel without a launch and a
    sync after every span. With `annotations`, the user-scope records' host
    events and their annotations on the card's timeline."""
    ev = [Event("fs.step", 0, 100), Event("fs.forward", 5, 40),
          Event("fs.bin", 10, 20), Event("fs.backward", 45, 80),
          Event("fs.update", 82, 95), Event("fs.log_boundary", 120, 130),
          Event("cudaLaunchKernel", 12, 13, corr=1),
          Event("cudaLaunchKernel", 50, 51, corr=2, thread=2),
          Event("cudaLaunchKernel", 85, 86, corr=3),
          Event("cudaMemcpyAsync", 125, 125.5, corr=4),
          Event("cudaStreamSynchronize", 126, 127),
          Event("cudaDeviceSynchronize", 150, 151),
          Event("aten::mul", 11, 14),
          Event("k1", 30, 50, cuda=True, corr=1),
          Event("k2", 60, 70, cuda=True, corr=2),
          Event("k3", 90, 110, cuda=True, corr=3),
          Event("Memcpy DtoH", 125, 127, cuda=True, corr=4),
          Event("k4", 140, 141, cuda=True, corr=99)]
    if annotations:
        ev += [Event("user.region", 44, 81, annotation=True),
               Event("user.region", 55, 75, cuda=True, annotation=True),
               Event("user.region", 0, 141, cuda=True, annotation=True)]
    return SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: ev)))


def test_reduce_attributes_exactly():
    red = SP.reduce(SP.records(fake_profile(False)))
    assert red["steps"] == 1
    assert red["busy_s"] * 1e3 == pytest.approx(53.0)
    assert red["idle_s"] * 1e3 == pytest.approx(58.0)
    want = {  # count, device ms, launches, idle ms, syncs
        "fs.step": (1, 0, 0, 2, 0), "fs.forward": (1, 0, 0, 0, 0),
        "fs.bin": (1, 20, 1, 0, 0), "fs.backward": (1, 10, 1, 20, 0),
        "fs.update": (1, 20, 1, 8, 0), "fs.log_boundary": (1, 2, 1, 8, 1),
        SP.OUTSIDE: (0, 1, 0, 20, 1)}
    got = {k: (r["count"], r["device_ms"], r["launches"], r["idle_ms"],
               r["syncs"]) for k, r in red["spans"].items()}
    assert got == pytest.approx(want)
    assert red["in_spans_share"] == pytest.approx(100 * 52 / 53)
    assert red["outside_share"] == pytest.approx(100 * 1 / 53)
    s = SP.summary(red, [{"pairs_dropped": 6, "pairs_truncated": 9}], 3)
    assert s == pytest.approx(dict(
        bin_device_ms=20.0, update_device_ms=20.0,
        backward_idle_share=100 * 20 / 58, host_syncs_per_step=1.0,
        pairs_dropped_per_step=2.0, pairs_truncated_per_step=3.0))


def test_annotations_are_no_device_work():
    """The same profile with user-scope records: the reduction leaves their
    annotations out and reads what it read without them, and without them
    it reads trace.py's busy time and launches."""
    plain, noted = (SP.reduce(SP.records(fake_profile(a)))
                    for a in (False, True))
    assert noted["busy_s"] == plain["busy_s"]
    assert noted["spans"]["fs.backward"] == plain["spans"]["fs.backward"]
    ev = TR.events(fake_profile(False))
    assert plain["busy_s"] == pytest.approx(TR.busy_seconds(ev))
    assert sum(r["launches"] for r in plain["spans"].values()) == \
        ev["launches"]


def test_a_profile_without_spans_is_all_outside():
    prof = fake_profile(False)
    ev = [e for e in prof.profiler.kineto_results.events()
          if not e.name().startswith("fs.")]
    red = SP.reduce(SP.records(SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: ev)))))
    assert red["steps"] == 0 and set(red["spans"]) == {SP.OUTSIDE}
    assert red["outside_share"] == 100.0
    assert SP.summary(red, [{"loss": 1.0}], 100)["pairs_dropped_per_step"] \
        is None


def test_timeline_nesting():
    edges, labels = SP.timeline([("a", 0, 10), ("b", 2, 4), ("c", 4, 6),
                                 ("d", 12, 14)])
    at = [SP.label_at(edges, labels, t) for t in (-1, 1, 3, 4, 7, 11, 13, 20)]
    assert at == [SP.OUTSIDE, "a", "b", "c", "a", SP.OUTSIDE, "d",
                  SP.OUTSIDE]
    assert SP.split(edges, labels, 1, 13) == [
        ("a", 1), ("b", 2), ("c", 2), ("a", 4), (SP.OUTSIDE, 2), ("d", 1)]


def test_profiled_interval_on_the_cpu():
    out = SP.profile_spans(CELL, SEED, device="cpu", shrink=tiny(CELL))
    every = tiny(CELL)["config"]["adc"]["refine_every"]
    assert out["steps"] == (8, 8 + every)
    rows = out["spans"]["spans"]
    for name in ("step", "forward", "project", "bin", "composite", "losses",
                 "backward", "update"):
        assert rows["fs." + name]["count"] == every, name
    assert rows["fs.refine_boundary"]["count"] == 1
    assert out["trace_busy_ms"] == 0.0 and out["bin_device_ms"] == 0.0
    assert out["pairs_dropped_per_step"] >= 0
    assert out["pairs_truncated_per_step"] >= 0


@pytest.mark.gpu
def test_profiled_interval_on_the_card(card):
    """On the card the spans add no device event: the reduction's busy time
    is trace.py's, its launches are, and at most 1% of the busy time
    falls outside every span."""
    out = SP.profile_spans(CELL, SEED, device=card, shrink=tiny(CELL))
    red = out["spans"]
    steps = red["steps"]
    assert steps == tiny(CELL)["config"]["adc"]["refine_every"]
    assert 1e3 * red["busy_s"] / steps == pytest.approx(out["trace_busy_ms"])
    assert sum(r["launches"] for r in red["spans"].values()) == \
        pytest.approx(out["trace_launches"])
    assert red["outside_share"] <= 1.0
