#!/usr/bin/env python3
"""K3's pinned-host path against the host link, on one CUDA card.

    python3 benchmarks_torch/host_link.py

The tiered KV pool's demotes and promotes are K3 launches on a window in
pinned host memory (``kernels/rma_put.py::put_rows``, the ``-host``
variants).  This measures what bounds them, at one ``qwen3-4b`` page
(16 tokens x 8 KV heads x 128 x K,V x 36 layers, bf16: 2,359,296 bytes):

1. A read's round trip over the link: one thread, a dependent chain of
   16-byte loads that bypass the caches, in pinned host memory at its
   device-mapped address (beside the same chain in device memory), so
   Little's law gives the bytes the link needs in flight: its rate times
   that wait.
2. ``copy_`` to and from pinned memory, the yardstick (a copy engine; the
   port never calls it on this path).
3. K3's copy loop (``csrc/probes.cu::rt_copy_loop`` at unroll 1, the loop
   of ``csrc/rma_put.cu``) at 16, 33, 66, 132, 264 and 528 blocks, read
   and put: bytes in flight (blocks x 256 threads x 16 bytes) and GB/s.
4. Placement: the chain and the read on a second pinned buffer allocated
   after the first, and the first again.

Run as a script, it also does steps 5-7 (``chip_smoke.py`` ``[kernels]``
calls :func:`measure` for steps 1-4 and prints the same lines):

5. The loop with each thread ``unroll`` (1, 2, 4, 8) loads in flight
   before its first store, over 8-528 blocks: design (a) of a host path
   sized for the link.
6. In turns: K3 itself (``put_rows``, its 144 blocks at a page), the loop
   at 144 blocks and unroll 1, and at 32 blocks and unroll 8 (1 MiB in
   flight).
7. What else the SMs could do (``benchmarks_torch/csrc/
   host_link_probes.cu``, built here): the loop with each load flavour
   (cache operator, L2 prefetch size, a bulk prefetch into L2 a chunk
   ahead); the bulk-copy design (cp.async.bulk into shared memory and
   back out) — whether it reads device-mapped host memory at all, and at
   what rate; and pinned memory of other kinds (write-combined, huge pages
   registered).

Every time of K3 or the loop is a CUDA graph of captured calls replayed
(card time); the chain and the bulk probe by CUDA events.  Every launch is
first held bit for bit against what was put.  Needs one CUDA card; exits
non-zero without one.
"""
import argparse
import ctypes
import hashlib
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
#: the page payload of qwen3-4b (16-token pages), bf16 elements
PAGE_E = 16 * 8 * 128 * 2 * 36
#: K3's loop's grid sweep (blocks of 256 threads, 16-byte loads)
GRID = (16, 33, 66, 132, 264, 528)
#: the unrolled loop's sweep
UNROLLS = (1, 2, 4, 8)
UNROLL_GRID = (8, 16, 33, 66, 132, 264, 528)
#: rounds of (K3, the loop at 144 x 1, at 32 x 8, at 32 x 8, at 144 x 1, K3)
TURNS = 5
#: the bulk probe's sweep: (stage bytes, stages, blocks)
BULK = tuple((sb, st, b) for sb in (8192, 32768) for st in (2, 4)
             for b in (16, 66, 132))
#: rt_hint_read's load flavours (csrc/host_link_probes.cu)
HINTS = ("none", "L2::64B", "L2::128B", "L2::256B", "nc.L2::256B",
         "cg.L2::256B", "bulk prefetch")
#: rt_host_alloc's kinds (csrc/host_link_probes.cu)
ALLOC_KINDS = ("cudaHostAlloc", "write-combined", "huge pages, registered")
_P, _I64, _I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
#: host_link_probes.cu's entry points
PROBE_SIGNATURES = {"rt_bulk_read": (_P, _P, _I64, _I, _I, _I, _P, _P),
                    "rt_hint_read": (_P, _P, _I64, _I, _I, _I, _P),
                    "rt_host_alloc": (_I64, _I, _P),
                    "rt_host_free": (_P, _I)}
_probe_lib = []


def probe(symbol: str):
    """An entry point of ``csrc/host_link_probes.cu``, built on first use
    with the port's flags and header into the port's build directory."""
    from repro_torch import _build

    if not _probe_lib:
        src = os.path.join(HERE, "csrc", "host_link_probes.cu")
        h = hashlib.sha256()
        for part in (open(src, "rb").read(), _build.HEADER.read_bytes(),
                     " ".join(_build.NVCC_FLAGS).encode()):
            h.update(part)
        out = _build.build_dir() / f"libhost_link_probes-{h.hexdigest()[:16]}.so"
        if not out.exists():
            out.parent.mkdir(parents=True, exist_ok=True)
            tmp = f"{out}.tmp{os.getpid()}"
            subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-I",
                            str(_build.CSRC), "-o", tmp, src], check=True,
                           capture_output=True)
            os.replace(tmp, out)
        _probe_lib.append(ctypes.CDLL(str(out)))
    fn = getattr(_probe_lib[0], symbol)
    fn.argtypes = PROBE_SIGNATURES[symbol]
    fn.restype = ctypes.c_int
    return fn


def graph_ms(torch, fn, reps: int = 20, replays: int = 5) -> float:
    """Card time of one ``fn()``: ``reps`` calls captured in one CUDA graph
    and the graph replayed, so no host work falls between the launches."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(replays):
        graph.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / (reps * replays)


def event_ms(torch, fn, reps: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def chase_ns(torch, ptr: int, span: int, *, steps: int = 2048,
             stride: int = 4096 + 16) -> float:
    """ns of one 16-byte read in a dependent chain at device address
    ``ptr`` (a ``span``-byte buffer, 16-byte aligned)."""
    from repro_torch import _build
    from repro_torch.kernels import common

    fn = _build.lib("probes", "rt_chase")
    out = torch.zeros(1, dtype=torch.int32, device="cuda")
    stream = common.stream_ptr(torch.device("cuda"))

    def run(k):
        common.check_launch("chase", fn(ptr, span, stride, k,
                                        out.data_ptr(), stream))

    def timed(k):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        run(k)
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b)
    run(64)
    torch.cuda.synchronize()
    # the launch's own cost cancels between a long and a short chain
    return (timed(steps) - timed(16)) / (steps - 16) * 1e6


def measure(torch, *, full: bool = False, log=print) -> dict:
    """Run steps 1-4 (and 5-7 with ``full``) on the current card and return
    what they found."""
    from repro_torch import _build
    from repro_torch.kernels import common
    from repro_torch.kernels import rma_put as k3

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    nbytes = PAGE_E * 2
    loop_fn = _build.lib("probes", "rt_copy_loop")
    pool = torch.zeros((1, 4 * PAGE_E), dtype=torch.bfloat16, pin_memory=True)
    page = torch.randn((1, PAGE_E), generator=gen, device=dev).to(
        torch.bfloat16)
    back = torch.empty_like(page)
    out: dict = {"bytes": nbytes}

    def region_of(buf):
        return buf[:, PAGE_E:2 * PAGE_E]

    def loop(src: int, dst: int, blocks: int, unroll: int):
        # the current stream, read at each call: a graph captures on its own
        common.check_launch("copy_loop", loop_fn(
            src, dst, nbytes, blocks, unroll, common.stream_ptr(dev)))

    def read(blocks, unroll, buf=pool):
        loop(k3.map_host(buf) + PAGE_E * 2, back.data_ptr(), blocks, unroll)

    def put(blocks, unroll, buf=pool):
        loop(page.data_ptr(), k3.map_host(buf) + PAGE_E * 2, blocks, unroll)

    def checked(blocks, unroll, buf=pool):
        """Both directions at ``blocks`` x ``unroll`` round-trip the page
        bit for bit."""
        region_of(buf).zero_()
        put(blocks, unroll, buf)
        back.zero_()
        read(blocks, unroll, buf)
        torch.cuda.synchronize()
        if not (torch.equal(back, page)
                and torch.equal(region_of(buf), page.cpu())):
            raise AssertionError(f"the loop at {blocks} x {unroll} did not "
                                 "round-trip the page")

    def swept(blocks, unroll, buf=pool):
        checked(blocks, unroll, buf)
        return dict(inflight=blocks * k3.PUT_THREADS * 16 * unroll,
                    read=graph_ms(torch, lambda: read(blocks, unroll, buf)),
                    put=graph_ms(torch, lambda: put(blocks, unroll, buf)))

    # 1. a read's round trip
    span = 4 * nbytes
    dev_buf = torch.zeros(span // 4, dtype=torch.int32, device=dev)
    out["latency_ns"] = dict(
        host=chase_ns(torch, k3.map_host(pool), span),
        device=chase_ns(torch, dev_buf.data_ptr(), span))
    del dev_buf
    # 2. the yardstick
    region = region_of(pool)
    out["copy_ms"] = dict(
        put=graph_ms(torch, lambda: region.copy_(page, non_blocking=True)),
        read=graph_ms(torch, lambda: back.copy_(region, non_blocking=True)))
    # 3. K3's loop over the grid
    out["grid"] = {b: swept(b, 1) for b in GRID}
    best = min(out["grid"], key=lambda b: out["grid"][b]["read"])
    out["best"] = dict(blocks=best, unroll=1, **out["grid"][best])
    # 4. placement: a second pinned buffer allocated after the first
    k3_blocks = k3.launch_blocks(nbytes)
    pool2 = torch.zeros((1, 4 * PAGE_E), dtype=torch.bfloat16,
                        pin_memory=True)
    checked(k3_blocks, 1, pool2)
    out["second"] = dict(
        latency_ns=chase_ns(torch, k3.map_host(pool2), span),
        read=graph_ms(torch, lambda: read(k3_blocks, 1, pool2)),
        copy_read=graph_ms(torch, lambda: back.copy_(region_of(pool2),
                                                     non_blocking=True)))
    out["first_again"] = dict(
        read=graph_ms(torch, lambda: read(k3_blocks, 1)))
    out["k3_blocks"] = k3_blocks
    del pool2
    if full:
        # 5. design (a): loads in flight a thread
        out["unrolled"] = {(u, b): swept(b, u) for u in UNROLLS
                           for b in UNROLL_GRID}
        best = min(out["unrolled"], key=lambda k: out["unrolled"][k]["read"])
        out["best_unrolled"] = dict(unroll=best[0], blocks=best[1],
                                    **out["unrolled"][best])
        # 6. K3 itself against the loop, in turns
        out["turns"] = turns(torch, k3, page, back, pool, read, put)
        # 7. the other ways
        out["hints"] = hint_sweep(torch, region, page)
        out["bulk"] = bulk_probe(torch, page, region)
        out["alloc"] = alloc_sweep(torch, page, read_loop=loop)
    report(out, log)
    return out


def turns(torch, k3, page, back, pool, read, put) -> dict:
    """K3's guarded launch (``put_rows``: its own grid) against the loop at
    K3's grid and at 32 blocks x unroll 8, in turns: {who: {direction:
    [ms, ...]}}."""
    dev = page.device
    regs = torch.zeros((1, 4, 3), dtype=torch.int32, device=dev)
    regs[0, :, 0] = torch.tensor([1, 2, 4, 0], dtype=torch.int32)
    hnd = torch.tensor([[2, PAGE_E, PAGE_E, 1]], dtype=torch.int32,
                       device=dev)
    err = torch.zeros(1, dtype=torch.int32, device=dev)
    tgt = torch.zeros(1, dtype=torch.int32, device=dev)
    k3_blocks = k3.launch_blocks(PAGE_E * 2)
    calls = {
        "k3": (lambda: k3.put_rows(pool, back, tgt, handles=hnd, regs=regs,
                                   err=err, read=True),
               lambda: k3.put_rows(page, pool, tgt, handles=hnd, regs=regs,
                                   err=err)),
        f"loop {k3_blocks} x 1": (lambda: read(k3_blocks, 1),
                                  lambda: put(k3_blocks, 1)),
        "loop 32 x 8": (lambda: read(32, 8), lambda: put(32, 8)),
    }
    for who, (rd, pt) in calls.items():
        pool[:, PAGE_E:2 * PAGE_E].zero_()
        pt()
        back.zero_()
        rd()
        torch.cuda.synchronize()
        if not (torch.equal(back, page) and err.item() == 0):
            raise AssertionError(f"{who} did not round-trip the page")
    found = {who: {"read": [], "put": []} for who in calls}
    order = list(calls) + list(calls)[::-1]
    for _ in range(TURNS):
        for who in order:
            rd, pt = calls[who]
            found[who]["read"].append(graph_ms(torch, rd))
            found[who]["put"].append(graph_ms(torch, pt))
    return found


def bulk_probe(torch, page, region) -> dict:
    """cp.async.bulk from the pinned pool's device-mapped address into
    device memory; returns {(stage bytes, stages, blocks): ms} and whether
    every copy arrived intact."""
    from repro_torch.kernels import common
    from repro_torch.kernels import rma_put as k3

    fn = probe("rt_bulk_read")
    fail = torch.zeros(1, dtype=torch.int32, device="cuda")
    land = torch.empty_like(page)
    stream = common.stream_ptr(torch.device("cuda"))
    region.copy_(page)
    torch.cuda.synchronize()
    src = k3.map_host(region)
    found = {}
    for sb, st, blocks in BULK:
        def run(sb=sb, st=st, blocks=blocks):
            common.check_launch("bulk_read", fn(
                src, land.data_ptr(), page.numel() * 2, sb, st, blocks,
                fail.data_ptr(), stream))
        land.zero_()
        run()
        torch.cuda.synchronize()
        if fail.item():
            return {"works": False, "failed_at": (sb, st, blocks)}
        if not torch.equal(land, page):
            return {"works": False, "wrong_at": (sb, st, blocks)}
        found[(sb, st, blocks)] = event_ms(torch, run)
    return {"works": True, "ms": found}


def hint_sweep(torch, region, page) -> dict:
    """The loop with each load flavour of ``HINTS``, at unroll 4 and 8
    over 33, 66 and 132 blocks: {(hint, unroll, blocks): ms}, each read
    checked against what the region holds."""
    from repro_torch.kernels import common
    from repro_torch.kernels import rma_put as k3

    fn = probe("rt_hint_read")
    land = torch.empty_like(page)
    region.copy_(page)
    torch.cuda.synchronize()
    src = k3.map_host(region)
    found = {}
    for h in range(len(HINTS)):
        for unroll in (4, 8):
            for blocks in (33, 66, 132):
                def run(h=h, unroll=unroll, blocks=blocks):
                    common.check_launch("hint_read", fn(
                        src, land.data_ptr(), page.numel() * 2, blocks,
                        unroll, h, common.stream_ptr(torch.device("cuda"))))
                land.zero_()
                run()
                torch.cuda.synchronize()
                if not torch.equal(land, page):
                    raise AssertionError(f"hint read {HINTS[h]} wrong")
                found[(HINTS[h], unroll, blocks)] = graph_ms(torch, run)
    return found


def host_tensor(torch, nbytes: int, kind: int):
    """A bf16 CPU tensor over ``nbytes`` of pinned host memory of ``kind``,
    and the function that frees it."""
    ptr = ctypes.c_void_p()
    rc = probe("rt_host_alloc")(nbytes, kind, ctypes.byref(ptr))
    if rc != 0 or not ptr.value:
        raise RuntimeError(f"rt_host_alloc kind {kind}: code {rc}")
    buf = (ctypes.c_byte * nbytes).from_address(ptr.value)
    t = torch.frombuffer(buf, dtype=torch.bfloat16)
    return t, lambda: probe("rt_host_free")(ptr.value, kind)


def alloc_sweep(torch, page, *, read_loop) -> dict:
    """The chain and the reads (K3 at its own grid, the loop at 32 x 8 and
    at 132 x 1, copy_) on pinned memory of each ``ALLOC_KINDS``."""
    from repro_torch.kernels import common
    from repro_torch.kernels import rma_put as k3

    dev = torch.device("cuda")
    regs = torch.zeros((1, 4, 3), dtype=torch.int32, device=dev)
    regs[0, :, 0] = 1
    hnd = torch.tensor([[1, 0, PAGE_E, 0]], dtype=torch.int32, device=dev)
    tgt = torch.zeros(1, dtype=torch.int32, device=dev)
    back = torch.empty_like(page)
    found = {}
    for kind, name in enumerate(ALLOC_KINDS):
        flat, free = host_tensor(torch, 4 * PAGE_E * 2, kind)
        buf = flat.view(1, -1)
        if not buf.is_pinned():
            raise AssertionError(f"{name}: not seen as pinned")
        k3.put_rows(page, buf, tgt, handles=hnd, regs=regs)

        def read(buf=buf):
            k3.put_rows(buf, back, tgt, handles=hnd, regs=regs, read=True)
        src = k3.map_host(buf)
        back.zero_()
        read()
        torch.cuda.synchronize()
        ok = torch.equal(back, page)
        back.zero_()
        read_loop(src, back.data_ptr(), 32, 8)
        torch.cuda.synchronize()
        if not (ok and torch.equal(back, page)):
            raise AssertionError(f"{name}: a page did not round-trip")
        found[name] = dict(
            latency_ns=chase_ns(torch, src, 4 * PAGE_E * 2),
            k3=graph_ms(torch, read),
            unrolled=graph_ms(torch, lambda: read_loop(
                src, back.data_ptr(), 32, 8)),
            loop=graph_ms(torch, lambda: read_loop(
                src, back.data_ptr(), 132, 1)),
            copy=graph_ms(torch, lambda: back.copy_(buf[:, :PAGE_E],
                                                    non_blocking=True)))
        torch.cuda.synchronize()
        common.MAPPED_HOST.pop(flat.untyped_storage().data_ptr(), None)
        del buf, flat, read
        free()
    return found


def report(out: dict, log=print) -> None:
    nb = out["bytes"]

    def gbs(ms):
        return nb / ms / 1e6

    def rows(found, key=str):
        return "; ".join(
            f"{key(k)}: {r['inflight']}, {r['read']:.4f} / "
            f"{gbs(r['read']):.2f}, {r['put']:.4f} / {gbs(r['put']):.2f}"
            for k, r in found.items())

    lat = out["latency_ns"]
    log(f"[host-link] one 16-byte read's round trip (dependent chain, "
        f"uncached): pinned host {lat['host']:.0f} ns, device memory "
        f"{lat['device']:.0f} ns; Little's law at 63.0 GB/s: "
        f"{63.0 * lat['host']:.0f} bytes in flight")
    c = out["copy_ms"]
    log(f"[host-link] copy_ of one page ({nb} bytes): to pinned "
        f"{c['put']:.4f} ms ({gbs(c['put']):.2f} GB/s), from pinned "
        f"{c['read']:.4f} ms ({gbs(c['read']):.2f} GB/s)")
    log("[host-link] K3's loop at the host address (blocks: bytes in "
        "flight, read ms / GB/s, put ms / GB/s): " + rows(out["grid"]))
    b = out["best"]
    log(f"[host-link] the grid's fastest read: {b['blocks']} blocks "
        f"({b['inflight']} bytes in flight), {b['read']:.4f} ms "
        f"({gbs(b['read']):.2f} GB/s); K3 launches {out['k3_blocks']} "
        f"blocks at a page")
    s, f = out["second"], out["first_again"]
    log(f"[host-link] a second pinned buffer: chain {s['latency_ns']:.0f} "
        f"ns, read {s['read']:.4f} ms at {out['k3_blocks']} blocks, copy_ "
        f"from it {s['copy_read']:.4f}; the first again: read "
        f"{f['read']:.4f}")
    if "unrolled" in out:
        for unroll in UNROLLS:
            log(f"[host-link] the loop, unroll {unroll} (blocks: bytes in "
                f"flight, read ms / GB/s, put ms / GB/s): " + rows(
                    {b: r for (u, b), r in out["unrolled"].items()
                     if u == unroll}))
        b = out["best_unrolled"]
        log(f"[host-link] the unrolled sweep's fastest read: {b['blocks']} "
            f"blocks x unroll {b['unroll']} ({b['inflight']} bytes in "
            f"flight), {b['read']:.4f} ms ({gbs(b['read']):.2f} GB/s)")
    if "turns" in out:
        for d in ("read", "put"):
            log(f"[host-link] {d} in turns (ms; medians): " + "; ".join(
                f"{who} {', '.join(f'{x:.4f}' for x in t[d])} "
                f"({statistics.median(t[d]):.4f})"
                for who, t in out["turns"].items()))
    if "alloc" in out:
        log("[host-link] by allocation (chain ns; read ms / GB/s: K3, the "
            "loop 32 x 8, 132 x 1, copy_): " + "; ".join(
                f"{k}: {v['latency_ns']:.0f}; {v['k3']:.4f} / "
                f"{gbs(v['k3']):.2f}, {v['unrolled']:.4f} / "
                f"{gbs(v['unrolled']):.2f}, {v['loop']:.4f} / "
                f"{gbs(v['loop']):.2f}, {v['copy']:.4f} / {gbs(v['copy']):.2f}"
                for k, v in out["alloc"].items()))
    if "hints" in out:
        log("[host-link] the read loop by load flavour (flavour x unroll x "
            "blocks: ms / GB/s): " + "; ".join(
                f"{k[0]} x{k[1]} x{k[2]}: {v:.4f} / {gbs(v):.2f}"
                for k, v in out["hints"].items()))
    if "bulk" in out:
        b = out["bulk"]
        if not b["works"]:
            log(f"[host-link] bulk copies from device-mapped host memory: "
                f"do not work ({b})")
        else:
            log("[host-link] bulk copies from device-mapped host memory "
                "arrive intact; read (stage bytes x stages x blocks: ms / "
                "GB/s): " + "; ".join(
                    f"{k[0]}x{k[1]}x{k[2]}: {v:.4f} / {gbs(v):.2f}"
                    for k, v in b["ms"].items()))


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(
        argv)
    sys.path.insert(0, os.path.join(HERE, "..", "src"))
    import torch

    if not torch.cuda.is_available():
        print("host_link: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"[env] torch {torch.__version__} cuda {torch.version.cuda} card "
          f"{smi}", flush=True)
    _build.build(["rma_put", "probes"])
    probe("rt_hint_read")
    measure(torch, full=True, log=lambda s: print(s, flush=True))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
