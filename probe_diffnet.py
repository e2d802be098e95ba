"""Where the bf16 DiffNet kernels (K1 and K5, ``bf16_form`` in
``speech_editing_tpu_torch/csrc/diffnet_block{,_bwd}.cu``) spend their time
on the card: per-CTA phase times, and variants with one part taken out.

A copy of the two sources gets a probe at each phase boundary (thread 0 of
each CTA writes ``%globaltimer`` into a device array that an extra C
function reads back) and, for a variant, ``#ifdef`` switches that drop a
part of the kernels:

    base      the kernels as they are
    no_tma    no weight tiles loaded (the producer posts 0 bytes a stage)
    no_mma    no wgmma issued
    skeleton  neither: the ring's barriers, the A loads and the epilogues
    no_ring   neither, and no ring barriers waited on or released

Each variant is built with ``nvcc`` (``build.NVCC_FLAGS``) into a
temporary directory, swapped in through ``build._loaded`` in a process of
its own, and run at the bf16 run step's B=16 x T=446 and the bf16
flagship step's B=78 x T=512 (rows padded to their own lengths) with the
wrapper's tile plan, or with ``--share N`` CTAs a cluster sharing the
weights. For each kernel it prints the mean over CTAs of every
phase (K1: staging, then each chunk's stages and epilogue; K5's gate and
scatter passes: staging, stages, epilogue, end) and the kernel's span.

    python3 probe_diffnet.py [--share N] [variant ...]   (all five by default)

It needs the card and the CUDA toolkit; the outputs are not checked (the
kernels' checks are ``chip_smoke.py``'s).
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys
import tempfile

import numpy as np
import torch

from speech_editing_tpu_torch.ops.cuda import build
from speech_editing_tpu_torch.ops.cuda import diffnet_block as k1

VARIANTS = {"base": [], "no_tma": ["-DNO_TMA"], "no_mma": ["-DNO_MMA"],
            "skeleton": ["-DNO_TMA", "-DNO_MMA"],
            "no_ring": ["-DNO_TMA", "-DNO_MMA", "-DNO_RING"]}
SHAPES = ((16, 446), (78, 512))
PROBE = r'''
__device__ unsigned long long g_probe[8192][16];
#define PROBE(k) do { if (threadIdx.x == 0 && blockIdx.x < 8192) { unsigned long long t_; \
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_)); g_probe[blockIdx.x][k] = t_; } } while (0)
extern "C" int read_probe(unsigned long long* host, int n) {
  return (int)cudaMemcpyFromSymbol(host, g_probe, (size_t)n * 16 * 8);
}
'''
# (file, text a line starts with, its occurrence, probe, before or after that line)
PROBES = [
    ("diffnet_block.cu", "cluster_sync();    // the barriers", 0, "PROBE(0);", "after"),
    ("diffnet_block.cu", "consumer_sync();", 1, "PROBE(1);", "after"),
    ("diffnet_block.cu", "wgmma::fence_operands(hi);", 0, "PROBE(2 + 2 * chunk);", "after"),
    ("diffnet_block.cu", "const bool p2 = chunk >= nch;", 0,
     "if (chunk > 0) PROBE(1 + 2 * chunk);", "after"),
    ("diffnet_block.cu", "cluster_sync();    // no CTA leaves", 0, "PROBE(9);", "before"),
    ("diffnet_block_bwd.cu", "if (tid == 0) ring.init(stages, share, 0);", 0, "PROBE(0);", "before"),
    ("diffnet_block_bwd.cu", "consumer_sync();", 1, "PROBE(1);", "after"),
    ("diffnet_block_bwd.cu", "wgmma::fence_operands(hi);", 0, "PROBE(2);", "after"),
    ("diffnet_block_bwd.cu", "cluster_sync();", 2, "PROBE(3);", "before"),
    ("diffnet_block_bwd.cu", "if (tid == 0) ring.init(stages, share, 0);", 1, "PROBE(8);", "before"),
    ("diffnet_block_bwd.cu", "stage(0);", 0, "PROBE(9);", "after"),
    ("diffnet_block_bwd.cu", "wgmma::fence_operands(hi);", 1, "PROBE(10);", "after"),
    ("diffnet_block_bwd.cu", "cluster_sync();", 5, "PROBE(11);", "before"),
]
# the variants' switches: (file, text, replacement)
SWITCHES = [
    ("diffnet_bf16.cuh",
     "    wgmma::mma_rs<TB>(lo, a[s], dl, !(first && s == 0));\n"
     "    wgmma::mma_rs<TB>(hi, a[s], dh, !(first && s == 0));",
     "#ifndef NO_MMA\n    wgmma::mma_rs<TB>(lo, a[s], dl, !(first && s == 0));\n"
     "    wgmma::mma_rs<TB>(hi, a[s], dh, !(first && s == 0));\n#endif"),
    ("diffnet_bf16.cuh", "    mbar_expect_tx(&ring.full[s], stage_bytes);\n",
     "#ifdef NO_TMA\n    mbar_expect_tx(&ring.full[s], 0);\n    continue;\n#endif\n"
     "    mbar_expect_tx(&ring.full[s], stage_bytes);\n"),
    ("diffnet_bf16.cuh", "    __syncwarp();\n    if (share == 1 && lane == 0)",
     "#ifdef NO_RING\n    return;\n#endif\n    __syncwarp();\n    if (share == 1 && lane == 0)"),
    ("diffnet_bf16.cuh", "  const int rank = share > 1 ? (int)cluster_rank() : 0;",
     "#ifdef NO_RING\n  return;\n#endif\n  const int rank = share > 1 ? (int)cluster_rank() : 0;"),
    ("diffnet_block.cu", "    tf32x3::mbar_wait(&ring.full[s], (i / stages) & 1);",
     "#ifndef NO_RING\n    tf32x3::mbar_wait(&ring.full[s], (i / stages) & 1);\n#endif"),
    ("diffnet_block_bwd.cu", "    tf32x3::mbar_wait(&ring.full[s], (i / stages) & 1);",
     "#ifndef NO_RING\n    tf32x3::mbar_wait(&ring.full[s], (i / stages) & 1);\n#endif"),
]


def instrumented(dst: str) -> None:
    """The sources, probed and switchable, in dst."""
    shutil.copytree(build.CSRC, dst)
    texts = {}
    for name in ("diffnet_bf16.cuh", "diffnet_block.cu", "diffnet_block_bwd.cu"):
        with open(os.path.join(dst, name)) as f:
            texts[name] = f.read()
    for name, old, new in SWITCHES:
        if old not in texts[name]:
            raise RuntimeError(f"{name}: no {old!r} to switch")
        texts[name] = texts[name].replace(old, new)
    for name in ("diffnet_block.cu", "diffnet_block_bwd.cu"):
        lines = texts[name].split("\n")
        inserts = []
        for file, key, nth, probe, where in PROBES:
            if file != name:
                continue
            hits = [i for i, line in enumerate(lines) if line.strip().startswith(key)]
            inserts.append((hits[nth] + (where == "after"), "  " + probe))
        for i, probe in sorted(inserts, reverse=True):
            lines.insert(i, probe)
        texts[name] = "\n".join(lines).replace("namespace bf16_form {\n",
                                               PROBE + "namespace bf16_form {\n", 1)
    for name, text in texts.items():
        with open(os.path.join(dst, name), "w") as f:
            f.write(text)


def inputs(gen, b: int, t: int, c: int = 256, h: int = 192):
    r = lambda *s, scale=1.0: torch.randn(*s, device="cuda", generator=gen) * scale
    lengths = torch.randint(t // 5, t + 1, (b,), device="cuda", generator=gen)
    lengths[0] = t
    mask = (torch.arange(t, device="cuda")[None] < lengths[:, None]).float()
    args = (r(b, t, c), r(b, t, h, scale=0.5), r(b, c, scale=0.3), mask,
            r(3 * c, 2 * c, scale=0.05), r(2 * c, scale=0.1), r(h, 2 * c, scale=0.05),
            r(2 * c, scale=0.1), r(c, 2 * c, scale=0.05), r(2 * c, scale=0.1))
    return [a.to(torch.bfloat16) for a in args]


def phases(name: str, ctas: int, marks: list) -> str:
    buf = np.zeros((ctas, 16), dtype=np.uint64)
    build._loaded[name].read_probe(buf.ctypes.data, ctas)
    buf = buf.astype(np.float64) / 1e3          # ns -> us
    spans = ", ".join(f"{label} {np.mean(buf[:, b] - buf[:, a]):.2f}"
                      for label, a, b in marks)
    first, last = marks[0][1], marks[-1][2]
    return (f"span {buf[:, last].max() - buf[:, first].min():.2f} us, a CTA "
            f"{np.mean(buf[:, last] - buf[:, first]):.2f} us: {spans}")


def run_variant(variant: str, lib_dir: str, share: int) -> None:
    if share:
        k1._share = lambda tiles: share
    for name in ("diffnet_block", "diffnet_block_bwd"):
        build._loaded[name] = ctypes.CDLL(os.path.join(lib_dir, f"lib{name}.so"))
        build._loaded[name].read_probe.argtypes = [ctypes.c_void_p, ctypes.c_int]
    gen = torch.Generator(device="cuda").manual_seed(0)
    k1_marks = [("staging", 0, 1)] + [
        (f"{part} {n} {what}", 2 + 2 * i - (what == "stages"), 2 + 2 * i + (what == "epilogue"))
        for i, (part, n) in enumerate((("first product chunk", 0), ("first product chunk", 1),
                                       ("second product chunk", 0),
                                       ("second product chunk", 1)))
        for what in ("stages", "epilogue")]
    k5_marks = {"gate": [("staging", 0, 1), ("stages", 1, 2), ("epilogue", 2, 3)],
                "scatter": [("staging", 8, 9), ("stages", 9, 10), ("epilogue", 10, 11)]}
    for b, t in SHAPES:
        x, cond, step, mask, *w = inputs(gen, b, t)
        dxo, dsk = (torch.randn(b, t, 256, device="cuda", generator=gen).to(torch.bfloat16)
                    for _ in range(2))
        tiles = b * -(-t // 64)
        split, share = k1._tile_plan_bf16(b, t)
        for _ in range(3):
            h = k1.diffnet_block(x, cond, step, mask, *w, dilation=1, return_h=True)[2]
        torch.cuda.synchronize()
        ctas = -(-tiles // share) * share
        print(f"[probe] {variant} B={b} T={t} (cluster {share}) K1: "
              f"{phases('diffnet_block', ctas, k1_marks)}", flush=True)
        for _ in range(3):
            k1.diffnet_block_bwd(h, dxo, dsk, mask, w[0], w[4], 1)
        torch.cuda.synchronize()
        for part, marks in k5_marks.items():
            print(f"[probe] {variant} B={b} T={t} K5 {part}: "
                  f"{phases('diffnet_block_bwd', ctas, marks)}", flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("probe_diffnet.py needs a CUDA device")
    args = sys.argv[1:]
    share = 0
    if args[:1] == ["--share"]:
        share, args = int(args[1]), args[2:]
    if args[:1] and args[0].startswith("--run="):
        run_variant(args[0][len("--run="):], args[1], share)
        return
    names = args or list(VARIANTS)
    unknown = [n for n in names if n not in VARIANTS]
    if unknown:
        sys.exit(f"unknown variants {unknown}; choose from {list(VARIANTS)}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    with tempfile.TemporaryDirectory(prefix="probe_diffnet_") as tmp:
        src = os.path.join(tmp, "csrc")
        instrumented(src)
        procs = {}
        for variant in names:
            out = os.path.join(tmp, variant)
            os.makedirs(out)
            for name in ("diffnet_block", "diffnet_block_bwd"):
                cmd = [build._nvcc(), *build.NVCC_FLAGS, *VARIANTS[variant], "-o",
                       os.path.join(out, f"lib{name}.so"), os.path.join(src, f"{name}.cu")]
                procs[variant, name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                        stderr=subprocess.STDOUT, text=True)
        for (variant, name), proc in procs.items():
            text, _ = proc.communicate()
            if proc.returncode != 0:
                sys.exit(f"{variant} {name}: nvcc exited {proc.returncode}\n{text[-3000:]}")
        for variant in names:
            subprocess.run([sys.executable, os.path.abspath(__file__), "--share", str(share),
                            f"--run={variant}", os.path.join(tmp, variant)], check=True)


if __name__ == "__main__":
    main()
