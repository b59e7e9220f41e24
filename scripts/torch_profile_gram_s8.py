#!/usr/bin/env python3
"""Where the time of the s8 Gram's two launches goes, on one card.

    python3 scripts/torch_profile_gram_s8.py [--json OUT]

At the CIFAR-10 block (8, 1024, 3072), synthetic1024's (8, 2048, 1024) and
mnist784's (8, 1024, 784), int8 x, it builds copies of
``csrc/gram_s8.cu`` with parts of ``gram_s8_tma_kernel`` taken out and
times each against the unchanged kernel:

- ``kernel``: the pair as it is (``det_gram_s8``), and its transpose alone
  (``det_gram_s8_transpose``, reported as ``transpose``);
- ``no_stores``: the epilogue stages its chunks in shared memory but
  issues no TMA store (the transpose, the loads, the products, the
  staging);
- ``no_epilogue``: the products and the loads alone (nothing converted,
  staged or stored);
- ``no_stores_no_sync``: ``no_stores`` without the warpgroup barriers,
  the proxy fence and the wait for a buffer (the epilogue's arithmetic
  and shared-memory writes alone);
- ``no_mirror``: the epilogue stores each entry but not its mirror;
- ``no_products``: the wgmma instructions are gone (the transpose, the
  loads and the stores of zeros);
- ``register_epilogue``: every shape takes the epilogue that stores from
  registers (the kernel's path for d % 4 != 0), the design before the TMA
  stores;
- ``stages4_bufs1``: four ring stages and one staging buffer per
  warpgroup, where the kernel has three and two;
- ``fdiv``: every entry divided with ``__fdiv_rn``, where the kernel
  multiplies by the exact reciprocal of a power-of-two divisor;
- ``no_l2_hints``: loads and stores under the normal L2 policy, where the
  kernel keeps x^T (evict_last) and streams G (evict_first).

Each is timed with CUDA events over 30 back-to-back launches, in three
rounds that alternate the builds, and one JSON line per build and shape
gives the rounds' ms per launch. The copies are built by
``scripts/torch_kernel_copies.py``. It prints the card's name and power
limit first, imports nothing of JAX or of the JAX package, needs a card, and
exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch_kernel_copies as kc

SHAPES = ((8, 1024, 3072), (8, 2048, 1024), (8, 1024, 784))
ROUNDS, REPS = 3, 30
SOURCE = "gram_s8.cu"

STORE = "              tma_store(&out_map, buf + h * S_EPI_BOX_BYTES, c0, rh, w, stream);\n"
MIRROR = ("              if (mirror) tma_store(&out_map, buf + (2 + h) * S_EPI_BOX_BYTES, "
          "rh, c0, w, stream);\n")
POW2 = "  return divisor > 0.f && std::frexp(divisor, &e) == 0.5f ? 1.f / divisor : 0.f;"
KEEP = "createpolicy.fractional.L2::evict_last.b64"
STREAM = "createpolicy.fractional.L2::evict_first.b64"
NORMAL = "createpolicy.fractional.L2::evict_normal.b64"
EPILOGUE = "      if (r0 < d) {"
SYNC_IN = ("          if (leader) bulk_wait_read<S_EPI_BUFS - 1>();  "
           "// the buffer's last stores read it\n          wg_sync(wg);\n")
SYNC_OUT = "          fence_async_smem();\n          wg_sync(wg);\n"


def no_stores(src: str) -> str:
    return kc.edit(kc.edit(src, STORE, "", SOURCE), MIRROR, "", SOURCE)
PRODUCT = ("        wgmma_m64n256k32_s8(acc, kmajor_sw128_desc(a + kk * 32),\n"
           "                            kmajor_sw128_desc(b + kk * 32));")
TMA_RULE = "bool tma_store_rows(int d) { return d % 4 == 0; }"
STAGES = "constexpr int S_STAGES = 3;"
BUFS = "constexpr int S_EPI_BUFS = 2;"

VARIANTS = {
    "kernel": lambda s: s,
    "no_stores": no_stores,
    "no_epilogue": lambda s: kc.edit(s, EPILOGUE, "      if (r0 < 0) {", SOURCE),
    "no_stores_no_sync": lambda s: kc.edit(kc.edit(no_stores(s), SYNC_IN, "", SOURCE),
                                           SYNC_OUT, "", SOURCE),
    "no_mirror": lambda s: kc.edit(s, MIRROR, "", SOURCE),
    "no_products": lambda s: kc.edit(
        s, PRODUCT, '        asm volatile("" : "+r"(acc[kk]) : '
                    '"l"(kmajor_sw128_desc(a)), "l"(kmajor_sw128_desc(b)));', SOURCE),
    "register_epilogue": lambda s: kc.edit(
        s, TMA_RULE, "bool tma_store_rows(int d) { return false; }", SOURCE),
    "stages4_bufs1": lambda s: kc.edit(kc.edit(s, STAGES, "constexpr int S_STAGES = 4;", SOURCE),
                                       BUFS, "constexpr int S_EPI_BUFS = 1;", SOURCE),
    "fdiv": lambda s: kc.edit(s, POW2, "  return (void)e, 0.f;", SOURCE),
    "no_l2_hints": lambda s: kc.edit(kc.edit(s, KEEP, NORMAL, SOURCE), STREAM, NORMAL, SOURCE),
}
#: the copies that compute the whole Gram, each held bit for bit to the plain
#: version before it is timed
EXACT = ("kernel", "register_epilogue", "stages4_bufs1", "fdiv", "no_l2_hints")


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", help="also write the results to this file")
    args = ap.parse_args(argv)
    if not kc.require_card("torch_profile_gram_s8"):
        return 2
    from distributed_eigenspaces_tpu_torch.ops import gram as gram_mod

    card = kc.card()
    libs = kc.build("gram_s8", VARIANTS, {
        "det_gram_s8": [kc.PTR, kc.PTR, kc.PTR, kc.INT, kc.INT, kc.INT, kc.FLOAT, kc.INT,
                        kc.PTR],
        "det_gram_s8_transpose": [kc.PTR, kc.PTR, kc.INT, kc.INT, kc.INT, kc.INT, kc.PTR]})
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = []
    for shape in SHAPES:
        m, n, d = shape
        x = torch.randint(-127, 128, shape, generator=gen, device="cuda", dtype=torch.int8)
        xt = torch.empty((m, d, gram_mod.s8_pad(n)), dtype=torch.int8, device="cuda")
        out = torch.empty((m, d, d), device="cuda")

        def launch(name):
            kc.checked(libs[name].det_gram_s8(
                x.data_ptr(), xt.data_ptr(), out.data_ptr(), m, n, d, float(n), 1,
                torch.cuda.current_stream().cuda_stream), name)

        def transpose():
            kc.checked(libs["kernel"].det_gram_s8_transpose(
                x.data_ptr(), xt.data_ptr(), m, n, d, 1,
                torch.cuda.current_stream().cuda_stream), "transpose")

        want = gram_mod.gram_s8_plain(x)
        for name in EXACT:
            out.fill_(float("nan"))
            launch(name)
            if not torch.equal(out, want):
                raise RuntimeError(f"the {name} copy differs from the plain version at {shape}")
        del want
        fns = {name: (lambda name=name: launch(name)) for name in libs}
        fns["transpose"] = transpose
        for name, times in kc.rounds(fns, ROUNDS, REPS).items():
            row = {"build": name, "shape": list(shape), "ms_per_launch": times,
                   "rounds": ROUNDS, "reps": REPS, "card": card}
            results.append(row)
            print(json.dumps(row), flush=True)
        del x, xt, out
    if args.json:
        with open(args.json, "w", encoding="utf-8") as f:
            json.dump({"card": card, "results": results}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
