#!/usr/bin/env python3
"""Where the SSD scan's two kernels spend their time: ``csrc/ssd_scan.cu``
(K8) and ``csrc/ssd_pass.cu`` (the pass) rebuilt with one part switched
off, each variant timed by CUDA-graph replay at the ``mamba2-370m`` prefill
shape (1, 2048, 32 x 64), N 128, chunk 64, bf16 (the pass on K8's
outputs).

    python3 benchmarks_torch/ssd_ablate.py

A variant's output is wrong by design; only its time means anything.  The
variants patch the source text, so each names the lines it changes and the
script fails when they are gone.  Needs one CUDA card and ``nvcc``.
"""
import ctypes
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))

def _off(line: str) -> tuple[str, str]:
    """The line run only when L < 0, that is never."""
    return line, line.replace("rt_mma_bf16", "if (L < 0) rt_mma_bf16", 1)


K8_VARIANTS = {
    "base": [],
    "no C B^T products": [
        _off("        rt_mma_bf16(cb[2 * jj], af, bf[0], bf[1]);"),
        _off("        rt_mma_bf16(cb[2 * jj + 1], af, bf[2], bf[3]);")],
    "no y section": [("    if (16 * warp < QP) {\n      float acc[8][4];",
                      "    if (16 * warp < QP && L < 0) {\n      float acc[8][4];")],
    "no state section": [("    if (16 * warp < PP) {", "    if (16 * warp < PP && L < 0) {")],
    "no state products": [
        _off("          rt_mma_bf16(acc[2 * nn], ah[kk], bf[0], bf[1]);"),
        _off("          rt_mma_bf16(acc[2 * nn], al[kk], bf[0], bf[1]);"),
        _off("          rt_mma_bf16(acc[2 * nn + 1], ah[kk], bf[2], bf[3]);"),
        _off("          rt_mma_bf16(acc[2 * nn + 1], al[kk], bf[2], bf[3]);")],
    "no state stores": [("          for (int r = lane >> 4; r < rows && q < nw; r += 2)",
                         "          for (int r = lane >> 4; r < rows && q < nw && L < 0; r += 2)")],
    # the grid: heads a CTA (the host aims at one wave of three CTAs an SM)
    "one head a CTA": [("group_size(B, nc, H, 396)", "group_size(B, nc, H, 1 << 30)")],
    "two heads a CTA": [("group_size(B, nc, H, 396)", "group_size(B, nc, H, 528)")],
}

READOUT = ("    if (16 * mt < nv) {\n", "    if (16 * mt < nv && L < 0) {\n")
PASS_VARIANTS = {
    "base": [],
    # the read-out: C and carry fragments, products, y written
    "no read-out": [READOUT],
    "no y epilogue": [("        if (t >= nv) continue;\n        const float e = half",
                       "        if (t >= nv || L > 0) continue;\n        const float e = half")],
    "no products": [
        _off("          rt_mma_bf16(part[2 * (kk & 3)], ah, bh[2 * i], bh[2 * i + 1]);"),
        _off("          rt_mma_bf16(part[2 * (kk & 3) + 1], ah, bl[2 * i], bl[2 * i + 1]);")],
    # the loads of every chunk after the first stages
    "no loads": [("    if (c + STAGES - 1 < nc)\n      load_stage",
                  "    if (c + STAGES - 1 < nc && L < 0)\n      load_stage")],
    "no C rows": [("    if (qc < NP)\n", "    if (false && qc < NP)\n")],
    "no wait": [("    rt_cp_async_wait<STAGES - 2>();\n    __syncthreads();", "    __syncthreads();")],
    "no barrier": [("    rt_cp_async_wait<STAGES - 2>();\n    __syncthreads();",
                    "    rt_cp_async_wait<STAGES - 2>();")],
    "no hi/lo publish": [("    publish((c + 1) & 1);", "    if (L < 0) publish((c + 1) & 1);")],
}


def graph_ms(torch, fn, reps: int = 20, replays: int = 5) -> float:
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


def main() -> int:
    sys.path.insert(0, os.path.join(HERE, "..", "src"))
    import torch

    if not torch.cuda.is_available():
        print("ssd_ablate: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch import _build
    from repro_torch.kernels.common import DTYPE_CODES
    from repro_torch.kernels.ssd_scan import ssd_intra_chunk

    out = _build.build_dir() / "ssd_ablate"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for kernel, src, variants in (("K8", "ssd_scan.cu", K8_VARIANTS),
                                  ("pass", "ssd_pass.cu", PASS_VARIANTS)):
        source = (_build.CSRC / src).read_text()
        for name, subs in variants.items():
            text = source
            for old, new in subs:
                if old not in text:
                    raise AssertionError(f"{kernel} {name}: the source no "
                                         f"longer has {old!r}")
                text = text.replace(old, new)
            i = len(procs)
            path = out / f"v{i}.cu"
            path.write_text(text)
            cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
                   "-o", str(out / f"libv{i}.so"), str(path)]
            procs[(kernel, name)] = (i, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
    for (kernel, name), (_, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{kernel} {name}: nvcc failed\n{log}")

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    L, H, P, N, Q = 2048, 32, 64, 128, 64
    x = (rand(1, L, H * P) * 0.5).bfloat16()
    a = -torch.nn.functional.softplus(rand(1, L, H))
    bm, cm = ((rand(1, L, N) * 0.5).bfloat16() for _ in range(2))
    yi, st, cum = ssd_intra_chunk(x, a, bm, cm, chunk=Q, nheads=H, headdim=P)
    k8_out = [torch.empty_like(t) for t in (yi, st, cum)]   # K8's variants'
    y = torch.empty((1, L, H, P), dtype=torch.bfloat16, device="cuda")
    fin = torch.empty((1, H, P, N), dtype=torch.bfloat16, device="cuda")
    bf16 = DTYPE_CODES[torch.bfloat16]
    print(f"[ablate] {smi}; at (1, {L}, {H}x{P}) N {N} chunk {Q} bf16, card "
          "ms by graph replay:", flush=True)
    for (kernel, name), (i, _) in procs.items():
        lib = ctypes.CDLL(str(out / f"libv{i}.so"))
        entry = "rt_ssd_intra_chunk" if kernel == "K8" else "rt_ssd_pass"
        fn = getattr(lib, entry)
        fn.argtypes = _build.SIGNATURES["ssd_scan" if kernel == "K8"
                                        else "ssd_pass"][entry]
        fn.restype = ctypes.c_int
        if kernel == "K8":
            args = (x.data_ptr(), a.data_ptr(), bm.data_ptr(), cm.data_ptr(),
                    *(t.data_ptr() for t in k8_out), 1, L, Q, H, P, N, N, N,
                    bf16)
        else:
            args = (yi.data_ptr(), st.data_ptr(), cum.data_ptr(),
                    cm.data_ptr(), None, 0, y.data_ptr(), fin.data_ptr(), 1,
                    L, Q, H, P, N, N, bf16)

        def run(fn=fn, args=args, what=f"{kernel} {name}"):
            rc = fn(*args, torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"{what}: launch failed with {rc}")
        print(f"[ablate] {kernel} {name}: {graph_ms(torch, run):.4f} ms",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
