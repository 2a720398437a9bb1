"""The repository's pytest settings for ``tests/``: the one marker of tests
that need a CUDA card.  Such a test decides in a fixture whether there is
a card and skips without one; run them on the card with

    python3 -m pytest -q -m card tests/test_torch_serve_graph.py
"""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips without one)")
