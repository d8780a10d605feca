"""The port's spans and rollout counters, on the CPU at the tiny config.

* one ``CoPRISTrainer.step`` under ``torch.profiler`` records every span
  of the trainer, the update and the rollout engine, nested where the
  work nests, and one ``engine.decode`` a decode chunk;
* with no profiler, ``span()`` is one shared no-op, and a profiled step
  trains on the same batch, to the same loss, as an unprofiled one;
* the engine's counters held to counts made outside it:
  ``reprefill_tokens`` to the lengths of the buffered partials that a
  step resumed, ``prefill_positions`` to the padded shapes of the
  prefills, ``decode_kv_positions`` to the cached positions that the
  chunks' active rows read.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.common import tracing  # noqa: E402
from repro_torch.common.config import RolloutConfig, TrainConfig  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.copris import CoPRISTrainer  # noqa: E402
from repro_torch.data.tasks import EOS, AdditionTask  # noqa: E402
from repro_torch.models import model as M  # noqa: E402

torch.set_num_threads(1)
CFG = get_config("tiny")
RO = dict(batch_size=2, group_size=2, max_prompt_len=16, max_response_len=12,
          concurrency=8, mode="copris", decode_chunk=4)
TC = dict(lr=2e-4, warmup_steps=2, microbatches=2, entropy_coef=0.01)
SPANS = ("trainer.step", "trainer.collect", "trainer.settle",
         "trainer.update", "update.forward", "update.backward",
         "update.optimizer", "trainer.publish", "engine.prepare_params",
         "engine.prefill", "engine.decode", "decode.keys", "decode.scan",
         "decode.readback", "engine.replay")


def _trainer(seed=0):
    params = M.init_params(CFG, seed=seed, device="cpu")
    return CoPRISTrainer(CFG, RolloutConfig(**RO),
                         TrainConfig(**TC, seed=seed),
                         AdditionTask(max_value=9, seed=seed), eos_id=EOS,
                         params=params, device="cpu")


def _profiled_step(trainer):
    """(the step's output, its program spans [(name, start, end)])."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = trainer.step()
    n = len(tracing.PREFIX)
    spans = [(e.name()[n:], e.start_ns(), e.start_ns() + e.duration_ns())
             for e in prof.profiler.kineto_results.events()
             if e.name().startswith(tracing.PREFIX)]
    return out, spans


@pytest.fixture(scope="module")
def profiled():
    """Trainer A: an unprofiled step, then a profiled one (partials carried
    over into it); its spans and the decode chunks the step ran."""
    tr = _trainer()
    try:
        tr.step()
        chunks0 = tr.engine.stats_snapshot()["decode_chunks"]
        out, spans = _profiled_step(tr)
        chunks = tr.engine.stats_snapshot()["decode_chunks"] - chunks0
        yield dict(out=out, spans=spans, chunks=chunks,
                   batch={k: v.copy() for k, v in tr.last_batch.items()})
    finally:
        tr.close()


def _inside(inner, outer, spans):
    """Every ``inner`` span lies within some ``outer`` span."""
    outs = [(s, e) for n, s, e in spans if n == outer]
    return all(any(s0 <= s and e <= e0 for s0, e0 in outs)
               for n, s, e in spans if n == inner)


def test_profiled_step_records_every_span(profiled):
    spans = profiled["spans"]
    names = {n for n, _, _ in spans}
    assert set(SPANS) <= names, set(SPANS) - names
    assert sum(n == "trainer.step" for n, _, _ in spans) == 1
    for inner in ("update.forward", "update.backward", "update.optimizer"):
        assert _inside(inner, "trainer.update", spans), inner
    for inner in ("decode.keys", "decode.scan", "decode.readback"):
        assert _inside(inner, "engine.decode", spans), inner
    for inner in ("trainer.collect", "trainer.settle", "trainer.update",
                  "trainer.publish"):
        assert _inside(inner, "trainer.step", spans), inner
    # one forward a microbatch, one decode span a chunk
    assert sum(n == "update.forward" for n, _, _ in spans) == \
        TC["microbatches"]
    assert profiled["chunks"] > 0
    assert sum(n == "engine.decode" for n, _, _ in spans) == \
        profiled["chunks"]


def test_span_is_one_shared_noop_without_a_profiler():
    assert not torch.autograd._profiler_enabled()
    a, b = tracing.span("engine.decode"), tracing.span("update.forward")
    assert a is b
    with a:
        pass
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        on = tracing.span("engine.decode")
    assert on is not a
    assert tracing.span("engine.decode") is a


def test_profiled_step_trains_as_an_unprofiled_one(profiled):
    tr = _trainer()
    try:
        tr.step()
        out = tr.step()
        batch = tr.last_batch
    finally:
        tr.close()
    for k in ("tokens", "loss_mask", "behaviour_logp", "rewards",
              "stage_ids"):
        np.testing.assert_array_equal(batch[k], profiled["batch"][k], k)
    assert out["pg_loss"] == profiled["out"]["pg_loss"]


def _partials(engine):
    """The buffered partial trajectories a next stage may resume, with
    their lengths now."""
    return [(t, t.total_len) for g in engine.buffer.groups()
            for t in g.trajectories if not t.done and t.response_len > 0]


def test_engine_counters_against_independent_counts():
    tr = _trainer(seed=1)
    eng = tr.engine
    shapes, positions = [], []
    prefill_batch, decode_chunk = eng._prefill_batch, eng._decode_chunk

    def count_prefill(params, tokens, *a):
        shapes.append(tokens.shape)
        return prefill_batch(params, tokens, *a)

    def count_decode(params, live, resp_len, key):
        before = eng.cache_len.astype(np.int64)
        toks, logps, active = decode_chunk(params, live, resp_len, key)
        for d in range(active.shape[0]):
            positions.append(int(((before + d + 1) * active[d]).sum()))
        return toks, logps, active

    eng._prefill_batch, eng._decode_chunk = count_prefill, count_decode
    resumed_steps = 0
    try:
        for _ in range(3):
            partials = _partials(eng)
            s0 = eng.stats_snapshot()
            shapes.clear()
            positions.clear()
            tr.step()
            s1 = eng.stats_snapshot()
            got = {k: s1[k] - s0.get(k, 0) for k in (
                "reprefill_tokens", "prefill_positions", "prefill_tokens",
                "decode_kv_positions")}
            # a partial the stage resumed grew; it was prefilled once, at
            # its whole length before the stage
            want = sum(L for t, L in partials if t.total_len > L)
            resumed_steps += want > 0
            assert got["reprefill_tokens"] == want
            assert got["prefill_positions"] == sum(r * s for r, s in shapes)
            assert got["prefill_positions"] >= got["prefill_tokens"] > 0
            assert got["decode_kv_positions"] == sum(positions) > 0
    finally:
        tr.close()
    assert resumed_steps >= 2           # two steps carried partials over
