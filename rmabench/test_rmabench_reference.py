"""Each plain reference against ``repro_torch`` at a tiny size on the CPU,
with the program computing in float32, so the two must agree to float32
rounding: the dense loss and gradients, and the hybrid forward's logits
(Mamba2 through the scan, GQA, the dropless top-2 MoE, the SwiGLU FFN)."""
import pytest
import torch

from rmabench import harness, tiny, weights
from rmabench.reference import dense, hybrid

pytest.importorskip("repro_torch")


def _program(model):
    from repro_torch.models import build_model

    return build_model(harness.model_config(model))


def _dense_model():
    m = dict(harness.load_json("configs", "starcoder2-3b-x15-dp4.json")
             ["model"])
    m.update(tiny.DENSE, dtype="float32")
    return m


def _hybrid_model():
    m = harness.load_json("configs", "jamba-v0.1-52b-x8.json")["model"]
    m.update(tiny.HYBRID, dtype="float32")
    m["ssm"].update(tiny.HYBRID_SSM)
    m["moe"].update(tiny.HYBRID_MOE)
    return m


@pytest.mark.parametrize("seed", [3, 2**31 + 1])
def test_dense_loss_and_gradients(seed):
    m = _dense_model()
    prog = _program(m)
    params = weights.make_params(prog.init(0, device="meta"), seed, "cpu")
    g = torch.Generator().manual_seed(seed % 1000)
    toks = torch.randint(0, m["vocab"], (2, 21), generator=g)
    pairs = list(weights.walk(params))
    ps = [t.detach().requires_grad_(True) for _, t in pairs]
    tree = weights.rebuild(params, {p: x for (p, _), x in zip(pairs, ps)})
    loss, _ = prog.loss(tree, {"tokens": toks[:, :-1],
                               "labels": toks[:, 1:]})
    want = torch.autograd.grad(loss, ps)
    rs = [t.detach().requires_grad_(True) for _, t in pairs]
    rtree = weights.rebuild(params, {p: x for (p, _), x in zip(pairs, rs)})
    ref = sum(dense.loss(rtree, toks[r, :-1], toks[r, 1:], m)
              for r in range(2)) / 2
    got = torch.autograd.grad(ref, rs)
    assert float(ref.detach()) == pytest.approx(float(loss.detach()), rel=1e-5)
    for w, r in zip(want, got):
        torch.testing.assert_close(r, w, rtol=1e-4,
                                   atol=1e-5 * float(w.abs().max()) + 1e-9)


@pytest.mark.parametrize("seed", [4, 10**11 + 3])
def test_hybrid_logits(seed):
    m = _hybrid_model()
    prog = _program(m)
    params = weights.make_params(prog.init(0, device="meta"), seed, "cpu")
    g = torch.Generator().manual_seed(seed % 1000)
    toks = torch.randint(0, m["vocab"], (1, 37), generator=g)
    with torch.no_grad():
        want, _ = prog.forward(params, {"tokens": toks})
        got = hybrid.logits(params, toks[0], m)
    torch.testing.assert_close(got, want[0, :, :m["vocab"]], rtol=1e-4,
                               atol=1e-4)
    rows = hybrid.logits(params, toks[0], m, rows=slice(30, 37))
    torch.testing.assert_close(rows, got[30:37], rtol=1e-5, atol=1e-5)


def test_references_import_no_program():
    import ast
    import pathlib

    for path in pathlib.Path(hybrid.__file__).parent.glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module] if isinstance(node, ast.ImportFrom)
                     else [])
            for n in names:
                top = (n or "").split(".")[0]
                assert top in ("torch", "math", "contextlib", "rmabench",
                               "__future__"), (path.name, n)
                if top == "rmabench":
                    assert n.startswith("rmabench.reference"), (path.name, n)
