"""The paged KV layout of disaggregated serving: ``paginate_cache`` turns the
dense GQA caches of a stack cache into physical page pools with a per-row
page table, and ``park_slot`` points a released row at the parking page.

Ported from the JAX package's ``serve/disagg.py`` (its ``_is_gqa_cache``,
``paginate_cache`` and ``park_slot``).  The control window, fetch_op
tickets, doorbells and the round-trip demo are not ported yet (ROADMAP
item 9).
"""
from __future__ import annotations

import torch


def _is_gqa_cache(d) -> bool:
    return isinstance(d, dict) and set(d) == {"k", "v", "pos"}


def paginate_cache(cache, page_tokens: int):
    """Convert every dense GQA KV leaf ``{k, v, pos}`` of a stack cache into
    the pooled page layout ``{k_pages, v_pages, page_table, page_ro,
    page_hot, pos}``.

    Dense ``k``/``v`` leaves of shape ``(…, B, S, KV, hd)`` become physical
    pools of ``B·S/pt`` allocatable pages **plus one parking page**; every
    page-table entry starts at the parking page, and the engine's pool
    (which hands out ids ``0 … B·S/pt − 1``) wires rows to real pages at
    slot admission.  Idle and released decode rows still scatter their
    discarded per-step KV through the table; parking those writes on a page
    no allocation can own keeps them off a live slot's pages.  Leaves that
    are not self-attention KV (the step counter) pass through unchanged.

    ``page_ro`` is the per-page write protection of copy-on-write prefix
    sharing (the decode scatter drops writes at a protected page like
    overflow writes); ``page_hot`` the per-page residency bit of the tiered
    pool (the gather reads the parking page instead of a non-hot page, and
    the scatter drops writes at one).  The parking page is never protected
    and always hot."""
    if _is_gqa_cache(cache):
        k = cache["k"]
        *lead, b, s, kv, hd = k.shape
        if s % page_tokens:
            raise ValueError(f"max_seq={s} not divisible by "
                             f"page_tokens={page_tokens}")
        pages_per_row = s // page_tokens
        n_alloc = b * pages_per_row        # the pool's page ids
        dev = k.device

        def repage(x):
            pool = x.reshape(*lead, n_alloc, page_tokens, kv, hd)
            park = x.new_zeros((*lead, 1, page_tokens, kv, hd))
            return torch.cat([pool, park], dim=len(lead))

        return {
            "k_pages": repage(k),
            "v_pages": repage(cache["v"]),
            "page_table": torch.full((*lead, b, pages_per_row), n_alloc,
                                     dtype=torch.int32, device=dev),
            "page_ro": torch.zeros((*lead, n_alloc + 1), dtype=torch.bool,
                                   device=dev),
            "page_hot": torch.ones((*lead, n_alloc + 1), dtype=torch.bool,
                                   device=dev),
            "pos": cache["pos"],
        }
    if isinstance(cache, dict):
        return {key: paginate_cache(val, page_tokens)
                for key, val in cache.items()}
    if isinstance(cache, list):
        return [paginate_cache(val, page_tokens) for val in cache]
    return cache


def park_slot(cache, slot: int):
    """Point a released slot's page-table rows at the parking page and
    rewind its position counter, in place (returns ``cache``): the slot's
    idle decode writes then land on the parking page, never on its old
    pages, which the pool may hand to a later admission."""
    if isinstance(cache, dict):
        if "k_pages" in cache:
            park = cache["k_pages"].shape[-4] - 1   # the extra page
            cache["page_table"][..., slot, :] = park
            cache["pos"][..., slot] = 0
            return cache
        for val in cache.values():
            park_slot(val, slot)
    elif isinstance(cache, list):
        for val in cache:
            park_slot(val, slot)
    return cache


__all__ = ["paginate_cache", "park_slot"]
