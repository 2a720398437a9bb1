"""The serving executor's decode tick as a CUDA graph
(``serve/engine.py::Executor.decode``) and the in-place contract it rests
on: no leaf of the executor's cache or parameters is rebound or
reallocated after construction, whatever the engine does between ticks
(admissions, an eviction with requeue, copy-on-write forks, tier
demotions and promotions, parking).  On the CPU every tick runs eagerly;
on a card (``-m card``) the replayed graph's greedy tokens equal the
eager step's at every tick.  Tiny configurations; no JAX."""
import numpy as np
import pytest
import torch

from repro_torch.configs import tiny_config
from repro_torch.models import build_model
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.tree import leaves_with_paths

N_SLOTS, MAX_SEQ, PAGE = 3, 48, 8
#: engine options by case; a tiered pool holds two of the three slots'
#: sequences in HBM (pages_per_slot 6), so live slots rotate through it
CASES = {
    "dense": ("qwen3-4b", {}),
    "paged": ("qwen3-4b", dict(paged_kv=True, page_tokens=PAGE)),
    "prefix_share": ("qwen3-4b", dict(paged_kv=True, page_tokens=PAGE,
                                      prefix_share=True)),
    "tiered": ("qwen3-4b", dict(paged_kv=True, page_tokens=PAGE,
                                prefix_share=True, kv_pages=(12, 24))),
    "hybrid": ("jamba-v0.1-52b", dict(paged_kv=True, page_tokens=PAGE,
                                      prefix_share=True)),
}
#: the tick before which the first live slot is evicted and requeued
EVICT_AT = 4


def _requests(vocab: int) -> list:
    """Six requests over three slots: two prompts extend a 12-token base
    (its first page is shared read-only), one is the base itself (its
    partial second page is shared copy-on-write and forked at its first
    decode write), three are unrelated."""
    rng = np.random.RandomState(0)
    base = rng.randint(0, vocab, size=12)
    prompts = [np.concatenate([base, rng.randint(0, vocab, size=5)]),
               base.copy(), rng.randint(0, vocab, size=9),
               np.concatenate([base, rng.randint(0, vocab, size=3)]),
               rng.randint(0, vocab, size=20), rng.randint(0, vocab, size=7)]
    return [Request(rid, p, n) for rid, (p, n) in
            enumerate(zip(prompts, (18, 16, 14, 15, 12, 17)))]


def _engine(case: str, device, dtype: str = "float32") -> ServeEngine:
    arch, kw = CASES[case]
    model = build_model(tiny_config(arch, dtype=dtype))
    params = model.init(0, device=device)
    return ServeEngine(model, params, n_slots=N_SLOTS, max_seq=MAX_SEQ, **kw)


def _record(ex) -> tuple[list, list]:
    """Every leaf of the executor's cache and parameters: path, object,
    address, shape, strides, dtype; and the leaves themselves, which the
    caller holds so that no later tensor can take an address or an id of
    theirs."""
    leaves = [(name, path, t) for name, tree in (("cache", ex.cache),
                                                 ("params", ex.params))
              for path, t in leaves_with_paths(tree)]
    return [(name, path, id(t), t.data_ptr(), tuple(t.shape), t.stride(),
             t.dtype) for name, path, t in leaves], leaves


def _drive(eng: ServeEngine, on_tick=None) -> int:
    """Submit the requests, evict the first live slot with requeue before
    tick ``EVICT_AT`` and run to the end; returns the decode ticks run.
    ``on_tick(eng, next_tokens)`` sees each decode's output."""
    ex = eng.executor
    decode, ticks = ex.decode, []

    def counted(last_tokens):
        nxt = decode(last_tokens)
        ticks.append(1)
        if on_tick is not None:
            on_tick(eng, nxt)
        return nxt

    ex.decode = counted
    for req in _requests(eng.model.cfg.vocab):
        eng.submit(req)
    while eng.scheduler.pending_count or eng.slot_req:
        if eng._tick == EVICT_AT:
            assert eng.evict_slots([min(eng.slot_req)]) == 1
        eng.step()
        assert eng._tick < 400
    return len(ticks)


@pytest.mark.parametrize("case", list(CASES))
def test_cache_and_params_stay_in_place(case):
    """The executor's leaves keep their addresses, shapes, strides and
    dtypes through every operation between ticks; each operation the case
    has did happen; every tick ran eagerly, none was captured."""
    eng = _engine(case, "cpu")
    before, _held = _record(eng.executor)
    ticks = _drive(eng)
    assert _record(eng.executor)[0] == before
    st = eng.stats()
    assert st["completed"] == 6 and st["evictions"] == 1
    if eng.paged_kv:
        assert st["pages_free"] == eng.pool.n_pages
    if eng.prefix_share:
        assert st["pages_shared"] > 0 and st["cow_copies"] > 0
    if eng.tiered:
        assert st["demotions"] > 0 and st["promotions"] > 0
        assert st["tier_stale_drops"] == 0
    assert (st["decode_eager"], st["decode_graph_captures"],
            st["decode_graph_replays"]) == (ticks, 0, 0)
    assert ticks >= 32


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the decode graph is captured only "
                    "there")
    return torch.device("cuda")


@pytest.mark.card
@pytest.mark.parametrize("case", ["paged", "hybrid"])
def test_graph_tokens_equal_eager_tokens_on_the_card(card, case):
    """One engine replays the captured tick, one runs every tick eagerly,
    in lockstep from the same weights and requests (an eviction and
    admissions between ticks): every live row's greedy token is equal at
    every tick; the graph engine captured once and replayed every tick but
    its first."""
    graph = _engine(case, card, "bfloat16")
    eager = _engine(case, card, "bfloat16")
    eager.executor.decode = eager.executor._decode_eager
    seen = {"graph": [], "eager": []}

    def recorder(name):
        return lambda eng, nxt: seen[name].append(
            {s: int(nxt[s]) for s in eng.slot_req})

    ticks = _drive(graph, recorder("graph"))
    assert _drive(eager, recorder("eager")) == ticks >= 32
    assert seen["graph"] == seen["eager"]
    assert ({c.rid: c.tokens for c in graph.done}
            == {c.rid: c.tokens for c in eager.done})
    st = graph.stats()
    assert (st["decode_eager"], st["decode_graph_captures"],
            st["decode_graph_replays"]) == (1, 1, ticks - 1)
    assert eager.stats()["decode_graph_captures"] == 0
