"""The program's spans and counters as the benchmark reads them: the
attribution of device operations to the span that launched them, held to
hand counts on a synthetic trace (an operation launched from a second
thread, one with no launch record, the spans' mirrors on the device's
timeline); the two counter readers by hand; and on the CPU at the tiny
cell, a traced run that reads them and a traced step whose decode
positions the engine counts as the benchmark's own hook does."""
import math
import time
from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

import program_spans
import tiny
from benchlib import harness, program_trace, spec, trace
from benchlib.program_trace import ProgramTrace

SPANS = ("trainer.step", "trainer.collect", "trainer.settle",
         "trainer.update", "update.forward", "update.backward",
         "update.optimizer", "trainer.publish", "engine.prepare_params",
         "engine.prefill", "engine.decode", "decode.keys", "decode.scan",
         "decode.readback", "engine.replay")


class _Ev:
    def __init__(self, name, s, e, *, cuda=False, corr=0, user=False,
                 thread=1):
        self._n, self._s, self._e = name, s, e
        self._cuda, self._corr, self._user = cuda, corr, user
        self._thread = thread

    def name(self):
        return self._n

    def start_ns(self):
        return round(self._s * 1e9)

    def duration_ns(self):
        return round((self._e - self._s) * 1e9)

    def device_type(self):
        return DeviceType.CUDA if self._cuda else DeviceType.CPU

    def correlation_id(self):
        return self._corr

    def is_user_annotation(self):
        return self._user

    def start_thread_id(self):
        return self._thread


def _prof():
    """A traced step: two decode chunks and an update, eight device
    operations (seven launched, one backward launch on the autograd
    thread, one with no launch record), the spans' mirrors on the device,
    and a host op whose id collides with a launch's correlation id."""
    P, H = program_trace.PREFIX, harness.SPAN
    host = [(H + "step", 0.0, 10.0), (P + "trainer.step", 0.0, 10.0),
            (P + "engine.decode", 1.0, 3.0), (P + "decode.keys", 1.0, 1.2),
            (P + "decode.scan", 1.2, 2.0), (P + "decode.readback", 2.0, 3.0),
            (P + "engine.replay", 3.0, 3.5),
            (P + "engine.decode", 4.0, 5.0), (P + "decode.keys", 4.0, 4.1),
            (P + "decode.scan", 4.1, 4.5), (P + "decode.readback", 4.5, 5.0),
            (P + "engine.replay", 5.0, 5.2),
            (P + "trainer.update", 6.0, 9.5),
            (P + "update.forward", 6.0, 7.0),
            (P + "update.backward", 7.0, 8.5),
            (P + "update.optimizer", 8.5, 9.5)]
    evs = [_Ev(n, s, e, user=True) for n, s, e in host]
    launches = [(1, 1.1, "cudaMemcpyAsync", (1.15, 1.16)),
                (2, 1.3, "cudaLaunchKernel", (1.4, 1.9)),
                (3, 1.5, "cuLaunchKernel", (1.9, 2.1)),
                (4, 4.2, "cudaLaunchKernelExC", (4.3, 4.6)),
                (5, 6.5, "cudaLaunchKernel", (6.6, 7.4)),
                (6, 7.5, "cudaLaunchKernel", (7.6, 8.6)),
                (7, 9.0, "cudaLaunchKernel", (9.0, 9.3))]
    for corr, t, api, (s, e) in launches:
        evs.append(_Ev(api, t, t + 0.001, corr=corr,
                       thread=2 if corr == 6 else 1))
        evs.append(_Ev(f"void kernel_{corr}<float>(float*)", s, e,
                       cuda=True, corr=corr))
    evs += [_Ev("void orphan_kernel(int)", 9.6, 9.7, cuda=True, corr=8),
            _Ev("aten::mm", 0.5, 0.6, corr=5),
            _Ev(P + "engine.decode", 1.15, 2.1, cuda=True, user=True),
            _Ev(H + "step", 1.15, 9.7, cuda=True, user=True)]
    return SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: evs)))


BUSY = 0.01 + 0.7 + 0.3 + 0.8 + 1.0 + 0.3 + 0.1


def test_mirrors_are_no_device_operations():
    prof = _prof()
    s = trace.from_profiler(prof, harness.SPAN, "step")
    assert len(s.ops) == 8 and math.isclose(s.busy_s, BUSY)
    assert not any(k.startswith("repro") for k in s.by_kernel)
    pt = program_trace.from_profiler(prof, s.lo, s.hi,
                                     other_prefixes=(harness.SPAN,))
    assert len(pt.ops) == 8 and math.isclose(pt.busy_s, BUSY)
    assert pt.linked == 7                 # the orphan has no launch record


def test_program_readings_by_hand():
    pt = program_trace.from_profiler(_prof(), 0.0, 10.0)
    r = program_trace.readings(pt, 4)
    assert set(r) == set(program_trace.READINGS)
    assert math.isclose(r["decode_host_ms_per_step"], 1000 * 1.2 / 8)
    assert math.isclose(r["decode_device_ms_per_step"],
                        1000 * (0.01 + 0.7 + 0.3) / 8)
    assert r["decode_launches_per_step"] == 3 / 8
    assert math.isclose(r["replay_ms_per_chunk"], 1000 * 0.7 / 2)
    assert math.isclose(r["update_fwd_s"], 0.8)
    # launched from the autograd engine's thread inside update.backward
    assert math.isclose(r["update_bwd_s"], 1.0)
    assert math.isclose(r["update_opt_s"], 0.3)
    assert math.isclose(pt.attributed_share(), (BUSY - 0.1) / BUSY)


def test_span_table_by_hand():
    t = program_trace.from_profiler(_prof(), 0.0, 10.0).table()
    assert set(t) == {"trainer.step", "engine.decode", "decode.keys",
                      "decode.scan", "decode.readback", "engine.replay",
                      "trainer.update", "update.forward", "update.backward",
                      "update.optimizer", "unattributed"}
    want_dev = {"decode.keys": 0.01, "decode.scan": 1.0,
                "update.forward": 0.8, "update.backward": 1.0,
                "update.optimizer": 0.3, "engine.decode": 0.0}
    for name, v in want_dev.items():
        assert math.isclose(t[name]["device_s"], v, abs_tol=1e-9), name
    want_idle = {"trainer.step": 1.15 + 2.0 + 0.3, "decode.scan": 0.24,
                 "engine.replay": 2.2, "update.backward": 0.2,
                 "update.optimizer": 0.4 + 0.3}
    for name, v in want_idle.items():
        assert math.isclose(t[name]["idle_s"], v, abs_tol=1e-9), name
    assert t["decode.scan"]["count"] == 2
    assert math.isclose(t["decode.scan"]["host_s"], 1.2)
    assert math.isclose(t["unattributed"]["device_s"], 0.1)
    assert t["unattributed"]["idle_s"] == 0.0
    idle = sum(r["idle_s"] for r in t.values())
    assert math.isclose(idle, 10.0 - BUSY)


def test_no_device_work_reads_nothing_of_the_device():
    pt = ProgramTrace([], {}, [("decode.scan", 0.0, 1.0),
                               ("engine.decode", 0.0, 1.0),
                               ("engine.replay", 1.0, 1.5),
                               ("update.forward", 2.0, 3.0)], 0.0, 3.0)
    assert program_trace.readings(pt, 8) == {
        "decode_host_ms_per_step": 125.0, "replay_ms_per_chunk": 500.0}
    assert pt.attributed_share() == 1.0


def _read(name, stats):
    return spec.metric_reader(name)(SimpleNamespace(stats=stats))


def test_counter_readers_by_hand():
    stats = {"prefill_tokens": 3000, "reprefill_tokens": 1200,
             "prefill_positions": 4000}
    assert _read("reprefill_token_share", stats) == 40.0
    assert _read("prefill_pad_share", stats) == 25.0
    # an engine without the counters (an older program): silent
    assert _read("reprefill_token_share", {"prefill_tokens": 3000}) is None
    assert _read("prefill_pad_share", {"prefill_tokens": 3000}) is None
    assert _read("reprefill_token_share", {"reprefill_tokens": 0,
                                           "prefill_tokens": 0}) is None


def test_traced_rehearsal_reads_the_counters(tmp_path):
    root = tiny.make(tmp_path)
    cell = spec.load_cell("tiny.cell", root)
    res = harness.run(cell, 4_100_000_019, 0.5, True,
                      t_start=time.perf_counter(), device="cpu",
                      log=lambda *a, **k: None)
    assert res["correct"], res["checks"]
    m = res["metrics"]
    for name in ("reprefill_token_share", "prefill_pad_share"):
        assert 0.0 <= m[name]["value"] < 100.0, name
    assert m["prefill_pad_share"]["value"] > 0.0


@pytest.fixture(scope="module")
def traced_step(tmp_path_factory):
    root = tiny.make(tmp_path_factory.mktemp("spans"))
    cell = spec.load_cell("tiny.cell", root)
    return program_spans.trace_step(cell, 4_100_000_023, device="cpu",
                                    log=lambda *a, **k: None)


def test_traced_step_on_the_cpu(traced_step):
    r = traced_step
    assert set(SPANS) <= set(r["spans"]), set(SPANS) - set(r["spans"])
    assert set(r["readings"]) == {"decode_host_ms_per_step",
                                  "replay_ms_per_chunk"}
    assert all(v > 0 for v in r["readings"].values())
    assert r["device_ops"] == 0 and r["span_mirrors_on_device"] == 0
    assert r["spans"]["engine.decode"]["count"] == \
        r["counters"]["decode_chunks"] > 0
    c = r["counters"]
    assert c["prefill_positions"] >= c["prefill_tokens"] > 0
    assert program_spans.fmt_table(r["spans"])[0].startswith("span")


def test_engine_counts_the_positions_the_harness_hook_counts(traced_step):
    c = traced_step["counters"]
    assert c["decode_kv_positions"] == traced_step["harness_positions"] > 0
