"""The serving engine owns the weights it is handed
(``serve/engine.py::own_weights``): every leaf a model reads only cast
whole to its bf16 compute dtype is converted once, inside its own bytes;
the engine's logits and tokens are bit for bit those of the per-call
casts; nothing else of the tree moves; and a decode tick casts no weight.
Tiny configurations of each family at bf16 compute, float32 parameters,
on the CPU."""
import copy
import math

import numpy as np
import pytest
import torch

from repro_torch.configs import tiny_config
from repro_torch.models import build_model
from repro_torch.serve import engine as engine_mod
from repro_torch.serve.engine import Executor, Request, ServeEngine
from repro_torch.tree import leaves_with_paths

CPU = "cpu"
BF16 = torch.bfloat16
#: one architecture a family, each computing in bf16
FAMILIES = {"dense-gqa": "qwen3-4b", "dense-gelu-bias": "starcoder2-3b",
            "moe": "llama4-maverick-400b-a17b",
            "mamba2-hybrid": "jamba-v0.1-52b", "mla": "deepseek-v2-236b"}
PROMPTS = (9, 13)
TICKS = 3


def _model(arch, dtype="bfloat16"):
    return build_model(tiny_config(arch, dtype=dtype))


def _recorded(model) -> list:
    """Every logits tensor the model's serving calls return, in order."""
    seen = []
    for name in ("prefill", "decode_step"):
        def rec(*args, _fn=getattr(model, name), **kw):
            logits, cache = _fn(*args, **kw)
            seen.append(logits.clone())
            return logits, cache
        setattr(model, name, rec)
    return seen


def _prompts(vocab):
    rng = np.random.RandomState(5)
    return [rng.randint(0, vocab, size=n) for n in PROMPTS]


def _served_by_engine(arch, params):
    model = _model(arch)
    logits = _recorded(model)
    eng = ServeEngine(model, params, n_slots=len(PROMPTS), max_seq=32)
    for rid, prompt in enumerate(_prompts(model.cfg.vocab)):
        eng.submit(Request(rid, prompt, TICKS + 5))
    for _ in range(TICKS):             # the first tick holds both prefills
        eng.step()
    tokens = [eng.slot_generated[s] for s in range(len(PROMPTS))]
    return logits, tokens, eng.stats()


def _served_with_casts(arch, params, monkeypatch):
    """The same calls through an :class:`Executor` that keeps the tree as
    it is handed: every call casts its weights, as before ownership."""
    model = _model(arch)
    logits = _recorded(model)
    with monkeypatch.context() as mp:
        mp.setattr(engine_mod, "own_weights", lambda model, params: {})
        ex = Executor(model, params, n_slots=len(PROMPTS), max_seq=32)
    tokens = []
    for slot, prompt in enumerate(_prompts(model.cfg.vocab)):
        tok = torch.as_tensor(prompt, dtype=torch.int64)[None]
        tokens.append([ex.prefill(tok, slot, [], np.zeros(0, bool))])
    for _ in range(TICKS):
        last = np.array([[t[-1]] for t in tokens], np.int32)
        for t, nxt in zip(tokens, ex.decode(last)):
            t.append(int(nxt))
    return logits, tokens


@pytest.mark.parametrize("family", list(FAMILIES))
def test_owned_weights_serve_bit_for_bit(family, monkeypatch):
    """A prefill of two prompts and three decode ticks on the converted
    tree give the logits and tokens of an unconverted deep copy driven
    with the per-call casts, bit for bit."""
    arch = FAMILIES[family]
    params = _model(arch).init(0, device=CPU)
    plain = copy.deepcopy(params)
    got, got_tokens, st = _served_by_engine(arch, params)
    want, want_tokens = _served_with_casts(arch, plain, monkeypatch)
    assert st["weights_converted"] > 0
    assert {t.dtype for _, t in leaves_with_paths(plain)} == {torch.float32}
    assert got_tokens == want_tokens
    assert len(got) == len(want) == len(PROMPTS) + TICKS
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == torch.float32
        assert torch.equal(a, b)


def test_float32_compute_converts_nothing():
    model = _model("qwen3-4b", dtype="float32")
    params = model.init(0, device=CPU)
    before = copy.deepcopy(params)
    eng = ServeEngine(model, params, n_slots=2, max_seq=32)
    st = eng.stats()
    assert st["weights_converted"] == st["weights_converted_bytes"] == 0
    assert st["weights_kept"] == len(leaves_with_paths(params))
    for (path, t), (_, u) in zip(leaves_with_paths(params),
                                 leaves_with_paths(before)):
        assert t.dtype == torch.float32 and torch.equal(t, u), path


def _one_buffer(layout, seed=0):
    """The benchmark's layout of weights: every leaf a view of one float32
    buffer, in path order, at offsets no wider than 4-byte aligned."""
    pairs = leaves_with_paths(layout)
    gen = torch.Generator().manual_seed(seed)
    flat = torch.randn(1 + sum(math.prod(t.shape) for _, t in pairs),
                       generator=gen)
    out, off = {}, 1                  # one float ahead: no leaf 8-aligned
    for path, t in pairs:
        n = math.prod(t.shape)
        out[path] = flat[off:off + n].view(tuple(t.shape))
        off += n

    def rebuild(tree, prefix=()):
        if isinstance(tree, dict):
            return {k: rebuild(v, prefix + (k,)) for k, v in tree.items()}
        if isinstance(tree, list):
            return [rebuild(v, prefix + (i,)) for i, v in enumerate(tree)]
        return out[prefix]
    return rebuild(layout)


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def test_conversion_in_each_leafs_own_bytes(monkeypatch):
    """On one shared float32 buffer (the benchmark's layout), in chunks of
    128 elements: each converted leaf holds its values in bf16 at a
    256-byte boundary inside its own bytes, in the same storage; two
    leaves over the same bytes are converted once; a leaf another leaf
    partly covers, and every leaf read in float32, keeps its bits."""
    monkeypatch.setattr(engine_mod, "CONVERT_CHUNK", 128)
    model = _model("jamba-v0.1-52b")
    params = _one_buffer(model.init(0, device="meta"))
    named = set(model.compute_dtype_leaves())
    attn = next(p[:-1] for p in named if p[-1] == "wk")
    wk = _at(params, attn + ("wk",))
    # wv: a second tensor over wk's bytes; the probe: half of wq's bytes
    _at(params, attn[:-1])["attn"]["wv"] = wk.view(wk.shape)
    wq = _at(params, attn + ("wq",))
    params["probe"] = wq.view(-1)[: wq.numel() // 2]
    before = {p: (t.data_ptr(), t.numel() * 4, t.clone())
              for p, t in leaves_with_paths(params)}
    storage = wk.untyped_storage().data_ptr()

    eng = ServeEngine(model, params, n_slots=2, max_seq=32)
    st = eng.stats()
    after = dict(leaves_with_paths(params))
    converted = {p for p in named if p in after
                 and p != attn + ("wq",)}
    for path, t in after.items():
        start, nbytes, old = before[path]
        assert t.untyped_storage().data_ptr() == storage, path
        if path not in converted:
            assert t.dtype == torch.float32 and t.data_ptr() == start, path
            assert torch.equal(t, old), path
            continue
        assert t.dtype == BF16 and t.is_contiguous(), path
        assert t.to(model.cfg.activation_dtype) is t, path
        assert torch.equal(t, old.to(BF16)), path
        assert start <= t.data_ptr() <= start + nbytes - 2 * t.numel(), path
        if 2 * t.numel() >= 256:
            assert t.data_ptr() % 256 == 0, path
    wv = _at(params, attn + ("wv",))
    assert wv is not wk and wv.data_ptr() == wk.data_ptr()
    unique = {before[p][:2] for p in converted}
    assert st["weights_converted"] == len(converted)
    assert st["weights_converted_bytes"] == sum(n for _, n in unique)
    assert st["weights_kept"] == len(after) - len(converted)
    assert len(unique) == len(converted) - 1


def _decode_casts(arch, monkeypatch, *, own: bool) -> set:
    """Input shapes of every ``aten::_to_copy`` in one profiled decode
    tick that match a leaf the model reads cast to its compute dtype (a
    scanned leaf is cast a layer's slice at a time)."""
    model = _model(arch)
    params = model.init(0, device=CPU)
    named = set(model.compute_dtype_leaves())
    shapes = set()
    for path, t in leaves_with_paths(params):
        if path in named:
            shapes |= {tuple(t.shape), tuple(t.shape[1:])}
    with monkeypatch.context() as mp:
        if not own:
            mp.setattr(engine_mod, "own_weights", lambda model, params: {})
        eng = ServeEngine(model, params, n_slots=2, max_seq=32)
    for rid, prompt in enumerate(_prompts(model.cfg.vocab)):
        eng.submit(Request(rid, prompt, 8))
    eng.step()                        # both prefills and a first tick
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU],
            record_shapes=True) as prof:
        eng.step()
    return {tuple(e.input_shapes[0]) for e in prof.events()
            if e.name == "aten::_to_copy" and e.input_shapes
            and tuple(e.input_shapes[0]) in shapes}


def test_decode_tick_casts_no_weight(monkeypatch):
    """A decode tick of the hybrid stack (Mamba2, GQA, dense and MoE
    layers) records no ``aten::_to_copy`` of a converted leaf's shape; with
    the tree left as handed, the same tick records them."""
    arch = FAMILIES["mamba2-hybrid"]
    assert _decode_casts(arch, monkeypatch, own=False)
    assert _decode_casts(arch, monkeypatch, own=True) == set()
