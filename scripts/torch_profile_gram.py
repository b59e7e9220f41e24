#!/usr/bin/env python3
"""Where the time of the bf16 Gram's TMA + wgmma kernel goes, on one card.

    python3 scripts/torch_profile_gram.py [--json OUT]

At the CIFAR-10 shape (8, 1024, 3072), bf16 x, it builds copies of
``csrc/gram.cu`` with parts of ``gram_bf16_tma_kernel`` taken out and
times each against the unchanged kernel and ``torch.bmm(..., out_dtype=
float32)`` (the call that writes the same fp32 output):

- ``kernel``: the kernel as it is;
- ``no_stores``: the epilogue stores nothing (the products and the loads);
- ``no_mirror``: the epilogue stores each entry but not its mirror;
- ``no_products``: the wgmma instructions are gone (the loads and the
  stores of zeros);
- ``streaming_stores`` / ``no_allocate_stores``: the same stores with the
  streaming hint (``st.global.cs``) or ``L1::no_allocate``, where the
  kernel makes plain write-back stores.

Each is timed with CUDA events over 30 back-to-back launches, in three
rounds that alternate the builds, and one JSON line per build gives the
rounds' ms per launch. The copies are built by
``scripts/torch_kernel_copies.py``. It prints the card's name and power
limit first, imports nothing of JAX or of the JAX package, needs a card, and
exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import re
import sys

import torch_kernel_copies as kc

SHAPE = (8, 1024, 3072)
ROUNDS, REPS = 3, 30
SOURCE = "gram.cu"

STORE_START = "      if (r >= d || c >= d) continue;"
MIRROR = ("        g[(size_t)c * d + r] = v0;\n"
          "        if (c1) g[(size_t)(c + 1) * d + r] = v1;\n")
KERNEL_HEAD = "__global__ void __launch_bounds__(T_THREADS, 1)"
NO_ALLOCATE = """__device__ __forceinline__ void st_na(float* p, float v) {
  asm volatile("st.global.L1::no_allocate.f32 [%0], %1;" :: "l"(p), "f"(v) : "memory");
}
__device__ __forceinline__ void st_na(float2* p, float2 v) {
  asm volatile("st.global.L1::no_allocate.v2.f32 [%0], {%1, %2};"
               :: "l"(p), "f"(v.x), "f"(v.y) : "memory");
}

"""
PRODUCT = ("        wgmma_m64n256k16(acc, sw128_desc(a + kk * 2048), "
           "sw128_desc(b + kk * 2048));")


def no_stores(src: str) -> str:
    if src.count(STORE_START) != 1:
        raise RuntimeError(f"{SOURCE} has no single text {STORE_START!r}")
    start = src.index(STORE_START)
    end = src.index("    }\n  }\n}\n", start)
    # keep the accumulators alive without storing them
    return kc.edit(src, src[start:end],
                   "      if (v0 == 1234.5f && v1 == 1234.5f) g[r] = v0;\n", SOURCE)


def hinted_stores(src: str, fn: str) -> str:
    """Every epilogue store ``g[i] = v`` / ``*reinterpret_cast<float2*>(p)
    = v`` as ``fn(g + i, v)`` / ``fn(reinterpret_cast<float2*>(p), v)``."""
    before = src
    src = re.sub(r"\*reinterpret_cast<float2\*>\((g \+ [^;]*?)\) = (make_float2\([^;]*\));",
                 rf"{fn}(reinterpret_cast<float2*>(\1), \2);", src)
    out = re.sub(r"\bg\[(\(size_t\)[^\]]*)\] = (v[01]);", rf"{fn}(g + \1, \2);", src)
    if out.count(f"{fn}(") - before.count(f"{fn}(") != 8:
        raise RuntimeError(f"{SOURCE}'s epilogue stores are not the 8 the hints rewrite")
    return out


VARIANTS = {
    "kernel": lambda s: s,
    "no_stores": no_stores,
    "no_mirror": lambda s: kc.edit(s, MIRROR, "", SOURCE),
    "no_products": lambda s: kc.edit(
        s, PRODUCT, '        asm volatile("" : "+f"(acc[kk]) : '
                    '"l"(sw128_desc(a)), "l"(sw128_desc(b)));', SOURCE),
    "streaming_stores": lambda s: hinted_stores(s, "__stcs"),
    "no_allocate_stores": lambda s: hinted_stores(
        kc.edit(s, KERNEL_HEAD, NO_ALLOCATE + KERNEL_HEAD, SOURCE), "st_na"),
}


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", help="also write the results to this file")
    args = ap.parse_args(argv)
    if not kc.require_card("torch_profile_gram"):
        return 2
    from distributed_eigenspaces_tpu_torch.ops import gram as gram_mod

    card = kc.card()
    libs = kc.build("gram", VARIANTS, {"det_gram": [
        kc.PTR, kc.PTR, kc.INT, kc.INT, kc.INT, kc.INT, kc.FLOAT, kc.INT, kc.PTR]})
    m, n, d = SHAPE
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(SHAPE, generator=gen, device="cuda").to(torch.bfloat16)
    out = torch.empty((m, d, d), device="cuda")
    if not gram_mod.takes_tma(d, x.dtype, x.data_ptr() % 16 == 0):
        raise RuntimeError("the profile shape does not take the TMA kernel")

    def launch(name):
        kc.checked(libs[name].det_gram(x.data_ptr(), out.data_ptr(), m, n, d, 1, float(n), 1,
                                       torch.cuda.current_stream().cuda_stream), name)

    launch("kernel")
    want = gram_mod.gram_plain(x)
    rel = float((out - want).norm() / want.norm())
    if rel > 1e-4:
        raise RuntimeError(f"the unchanged copy is off by {rel}")
    del want
    fns = {name: (lambda name=name: launch(name)) for name in libs}
    fns["bmm_fp32_out"] = lambda: torch.bmm(x.mT, x, out_dtype=torch.float32)
    results = []
    for name, times in kc.rounds(fns, ROUNDS, REPS).items():
        row = {"build": name, "shape": list(SHAPE), "ms_per_launch": times,
               "rounds": ROUNDS, "reps": REPS, "card": card}
        results.append(row)
        print(json.dumps(row), flush=True)
    if args.json:
        with open(args.json, "w", encoding="utf-8") as f:
            json.dump({"card": card, "unchanged_rel_err": rel, "results": results}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
