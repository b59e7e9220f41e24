"""The port's analyzer (``distributed_eigenspaces_tpu_torch/analysis``) held
against the JAX analyzer in one process, on the CPU.

Both analyzers audit the same four programs (``serve_project_solo`` and the
three kernel programs) and must find each honours its contract; the five
mutations the port carries must be caught by both with the same rule; the
copied concurrency fixtures must give the same findings. The port audits
the launch geometry its ``*_launch`` functions declare (the kernels run only
on the card); a geometry test holds those functions to the constants of the
CUDA sources, read as text. Tolerance: the mutant's plain version against
the Pallas body's ``dot_general`` at rel 1e-6 (fp32 sums of 1024 products
in another order).
"""

import ast
import dataclasses
import json
import math
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_eigenspaces_tpu.analysis import ast_lints as jax_lints
from distributed_eigenspaces_tpu.analysis import contracts as jax_contracts
from distributed_eigenspaces_tpu.analysis import mutations as jax_mutations
from distributed_eigenspaces_tpu.analysis import programs as jax_programs
from distributed_eigenspaces_tpu_torch.analysis import (
    ast_lints,
    contracts,
    mutations,
    programs,
    report,
)
from distributed_eigenspaces_tpu_torch.ops import geometry
from distributed_eigenspaces_tpu_torch.ops import gram as tgram
from distributed_eigenspaces_tpu_torch.ops import matvec_gram as mg
from distributed_eigenspaces_tpu_torch.ops import mutant_full_block as mfb
from distributed_eigenspaces_tpu_torch.ops import serve_project as sp

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "distributed_eigenspaces_tpu_torch" / "csrc"
KERNEL_PROGRAMS = ["pallas_serve_project_bf16", "pallas_serve_project_i8",
                   "pallas_matvec_gram"]
FIXTURES = {
    "blocking_under_lock": "_FIXTURE_BLOCKING",
    "lock_order": "_FIXTURE_LOCK_ORDER",
    "unguarded_shared_write": "_FIXTURE_UNGUARDED",
}


# -- the lock-discipline lint ------------------------------------------------


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_concurrency_fixture_same_findings_in_both(name):
    attr = FIXTURES[name]
    src = getattr(mutations, attr)
    assert src == getattr(jax_mutations, attr)  # copied verbatim
    port = {(v.rule, v.location) for v in ast_lints.lint_concurrency_source(src, "f.py")}
    ref = {(v.rule, v.location) for v in jax_lints.lint_concurrency_source(src, "f.py")}
    assert port == ref and port
    assert mutations.MUTATIONS[name][0] in {rule for rule, _ in port}


def test_port_threaded_runtime_lock_discipline_clean():
    viols = ast_lints.lint_concurrency()
    assert not viols, [v.format() for v in viols]
    assert all(p.startswith("distributed_eigenspaces_tpu_torch/")
               for p in ast_lints.CONCURRENCY_TARGETS)
    for rel in ast_lints.CONCURRENCY_TARGETS:
        assert (ROOT / rel).is_file(), rel


# -- the program matrix in both analyzers -----------------------------------


@pytest.mark.parametrize("name", sorted(programs.PROGRAMS))
def test_program_ok_in_both_analyzers(devices, name):
    assert name in jax_programs.PROGRAMS
    ref_built = jax_programs.build_program(name)
    ref_viols, ref = jax_contracts.check_program(ref_built)
    assert not ref_viols, [v.format() for v in ref_viols]
    built = programs.build_program(name, device="cpu")
    viols, detail = contracts.check_program(built)
    assert not viols, [v.format() for v in viols]
    assert detail["ok"] and ref["ok"]
    assert built.contract == ref_built.contract == detail["contract"]
    p = built.params
    assert (p.d, p.k, p.rows) == (ref_built.params.d, ref_built.params.k,
                                  ref_built.params.rows)
    assert detail["memory"]["policy"] == ref["memory"]["policy"] == "factor_only"
    assert built.source and (ROOT / "distributed_eigenspaces_tpu_torch" / built.source).is_file()
    if name in KERNEL_PROGRAMS:
        for pal in (detail["pallas"], ref["pallas"]):
            assert pal["n_pallas_calls"] >= 1
            assert pal["max_block_elems_seen"] < p.rows * p.d
            assert pal["max_block_elems_seen"] <= pal["block_bound_elems"] == 131072


def test_kernel_programs_plain_outputs_match_jax(devices):
    """On the CPU a kernel program runs its plain version: the same
    numbers the JAX kernel gives in interpret mode on the same inputs."""
    from distributed_eigenspaces_tpu.ops import pallas_gram as pg

    blocks = dict(block_rows=jax_programs._PALLAS_BR, block_d=jax_programs._PALLAS_BD)
    for name in KERNEL_PROGRAMS:
        built = programs.build_program(name, device="cpu")
        args = [jnp.asarray(a.numpy()) for a in built.args]
        if name.endswith("bf16"):
            ref = pg.serve_project_pallas(*args, **blocks, interpret=True)
            got, tol = built.output, 1e-5
        elif name.endswith("i8"):
            ref = pg.serve_project_i8_pallas(*args, **blocks, interpret=True)
            got, tol = built.output, 1e-5
        else:
            ref = pg.matvec_gram_pallas(*args, block_d=blocks["block_d"], interpret=True)[0]
            got, tol = built.output[0], 1e-5
        ref = np.asarray(ref)
        assert got.shape == ref.shape
        assert np.linalg.norm(got.numpy() - ref) / np.linalg.norm(ref) <= tol, name


def test_serve_program_output_is_the_engine_projection():
    built = programs.build_program("serve_project_solo", device="cpu")
    x, v = built.args
    assert torch.equal(built.output, x @ v)
    (launch,) = built.launches
    # the fp32 route: the split kernel with an fp32 basis, one column pair
    assert launch.kernel == "serve_split_kernel<float, 2, 1>"
    assert launch.grid_rule == "occupancy" and launch.order


# -- the mutations -----------------------------------------------------------


@pytest.mark.parametrize("name", list(mutations.MUTATIONS))
def test_mutation_caught_with_the_jax_rule_in_both(devices, name):
    rule, runner = mutations.MUTATIONS[name]
    ref_rule, ref_runner = jax_mutations.MUTATIONS[name]
    assert rule == ref_rule
    for viols in (runner(torch.device("cpu")), ref_runner()):
        hits = [v for v in viols if v.rule == rule]
        assert hits, [v.format() for v in viols]
        assert hits[0].program in hits[0].format() and rule in hits[0].format()
        assert hits[0].location


def test_run_mutation_checks_aggregate():
    ok, records = mutations.run_mutation_checks(device="cpu")
    assert ok, records
    assert [r["mutation"] for r in records] == list(mutations.MUTATIONS)
    # the JAX package's record keys (analysis/mutations.py run_mutation_checks)
    assert all(set(r) == {"mutation", "expected_rule", "caught", "n_violations",
                          "messages"} for r in records)


def test_dense_temp_flagged_by_both_memory_passes(devices):
    """The same (16, 64) x^T x: the JAX jaxpr/HLO walk and the port's
    dispatch-mode trace both find the (64, 64) buffer."""
    ref = [v for v in jax_mutations.MUTATIONS["dense_temp"][1]() if v.rule == "dense-buffer"]
    port = [v for v in mutations.MUTATIONS["dense_temp"][1](torch.device("cpu"))
            if v.rule == "dense-buffer"]
    assert ref and port
    assert any("[64, 64]" in v.message for v in ref)
    assert any("[64, 64]" in v.message for v in port)
    assert all("aten.mm" in v.location for v in port)


def test_dense_premise_violation_raises_loudly():
    contract = contracts.CONTRACTS["serve_transform"]
    with pytest.raises(ValueError, match="rows"):
        contracts.check_memory(contract, contracts.ProgramParams(d=64, k=2, rows=64),
                               program="bad_config")


def test_gate_bites_in_both_directions():
    """The mutant's launch is flagged; the same launch spread over 2 CTAs
    of 128 rows each (131072 elements, the budget exactly) is not."""
    contract = contracts.CONTRACTS["serve_pallas"]
    params = contracts.ProgramParams(d=1024, k=8, rows=256)
    launch = mfb.mutant_full_block_launch(256, 1024, 8)
    viols, metrics = contracts.check_pallas(contract, params, [launch], program="m")
    assert [v.rule for v in viols] == ["pallas-block"]
    assert "'x'" in viols[0].message and "262144" in viols[0].message
    assert "mutant_full_block_kernel" in viols[0].location
    assert metrics["max_block_elems_seen"] == 262144
    split = dataclasses.replace(
        launch, grid=(2, 1, 1),
        operands=(("x", (128, 1024)),) + launch.operands[1:3] + (("o", (128, 8)),),
    )
    viols, metrics = contracts.check_pallas(contract, params, [split], program="m")
    assert viols == [] and metrics["max_block_elems_seen"] == 131072


def test_presence_rule_refuses_a_program_without_launches():
    contract = contracts.CONTRACTS["serve_pallas"]
    params = contracts.ProgramParams(d=1024, k=8, rows=256)
    viols, metrics = contracts.check_pallas(contract, params, [], program="p")
    assert [v.rule for v in viols] == ["pallas-presence"]
    assert metrics["n_pallas_calls"] == 0
    _, metrics = contracts.check_pallas(
        contracts.CONTRACTS["serve_transform"], params, [], program="p")
    assert metrics["policy"] == "unchecked"


def test_mutant_plain_matches_the_pallas_body():
    """``mutant_full_block_plain`` against the body of the JAX mutant's
    kernel (``jax.lax.dot_general`` with fp32 results) on the same
    numpy-seeded (256, 1024) . (1024, 8) operands."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((256, 1024)).astype(np.float32)
    v = np.linalg.qr(rng.standard_normal((1024, 8)))[0].astype(np.float32)
    ref = np.asarray(jax.lax.dot_general(
        jnp.asarray(x), jnp.asarray(v), (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
    ))
    got = mfb.mutant_full_block_plain(torch.from_numpy(x), torch.from_numpy(v)).numpy()
    assert got.dtype == np.float32 and got.shape == (256, 8)
    assert np.linalg.norm(got - ref) / np.linalg.norm(ref) <= 1e-6


def test_mutant_wrapper_refuses_cpu_tensors():
    x, v = torch.zeros((4, 16)), torch.zeros((16, 2))
    before = mfb.launches
    with pytest.raises(ValueError, match="CUDA"):
        mfb.mutant_full_block_cuda(x, v)
    assert mfb.launches == before


# -- launch geometry against the CUDA sources --------------------------------


def _constexprs(path: Path) -> dict:
    """``constexpr int NAME = EXPR;`` at namespace scope, evaluated in
    order (C integer division)."""
    names: dict = {}
    for name, expr in re.findall(r"^constexpr int (\w+) = ([^;]+);", path.read_text(), re.M):
        tree = ast.parse(expr.replace("/", "//"), mode="eval")
        names[name] = eval(compile(tree, str(path), "eval"), {"__builtins__": {}}, dict(names))
    return names


def test_serve_project_launch_uses_the_source_constants():
    src = CSRC / "serve_project.cu"
    c = _constexprs(src)
    for name in ("WARPS", "THREADS", "MAX_PAIRS", "S_ROWS", "S_GB", "S_BASIS_WORDS",
                 "S_F32_BASIS_WORDS", "S_MIN_CTAS", "S_SPREAD_ITEMS"):
        assert c[name] == getattr(sp, name), name
    text = src.read_text()
    assert "serve_split_kernel<XT, B, NP><<<dim3(gx, tiles), THREADS, smem, s>>>" in text
    assert "__launch_bounds__(THREADS, S_MIN_CTAS)" in text
    assert "return 4 * ((size_t)words * ds + 2 * WARPS * S_ROWS * 2 * np);" in text
    assert "return b == kF32 ? 2 * np + 1 : (np | 1);" in text
    assert "return b == kF32 ? S_F32_BASIS_WORDS : S_BASIS_WORDS;" in text
    # the old fp32 kernel is gone: every route launches the split kernel
    assert not re.search(r"\bserve_project_kernel\b", text) and "launch_f32" not in text
    for rows, d, k in ((256, 1024, 8), (1000, 3000, 10), (5, 1100, 19), (1, 1, 1),
                       (512, 30000, 10), (1056, 3072, 10), (65536, 2000, 33)):
        np_ = min(c["MAX_PAIRS"], (k + 1) // 2)
        # one column pair per tile below S_SPREAD_ITEMS 4-row items, so that
        # small launches spread over more SMs
        if math.ceil(rows / c["S_ROWS"]) < c["S_SPREAD_ITEMS"]:
            np_ = 1
        for basis, code in (("bf16", 0), ("i8", 1), ("f32", 2)):
            words = 2 * np_ + 1 if basis == "f32" else np_ | 1
            budget = c["S_F32_BASIS_WORDS" if basis == "f32" else "S_BASIS_WORDS"]
            for x_dtype, xt, vec in ((torch.float32, "float", 4),
                                     (torch.bfloat16, "unsigned short", 8)):
                if basis == "f32" and x_dtype != torch.float32:
                    continue  # the fp32 route takes fp32 x only
                launch = sp.serve_project_launch(rows, d, k, x_dtype, basis)
                plan = sp.split_plan(rows, d, k, x_dtype, basis)
                assert plan["tiles"] == math.ceil(k / (2 * np_))
                group = 32 * vec
                ds = min(math.ceil(d / group) * group, budget // words // group * group)
                assert (plan["ds"], plan["words"]) == (ds, words)
                assert launch.kernel == f"serve_split_kernel<{xt}, {code}, {np_}>"
                assert launch.grid is None and launch.grid_rule == "occupancy"
                assert launch.threads == c["THREADS"] == c["WARPS"] * 32
                assert launch.static_smem == 0
                assert launch.dynamic_smem == 4 * (words * ds + 2 * c["WARPS"]
                                                   * c["S_ROWS"] * 2 * np_)
                ops = dict(launch.operands)
                assert ops["x (item)"] == (min(c["S_ROWS"], rows), d)
                assert ops["v staged"] == (min(ds, d), min(2 * np_, k))
                assert ("scale" in ops) == (basis == "i8")
                assert launch.resolved((7, 1, 1)).grid == (7, 1, 1)
    # the bulk CIFAR-10 project stages its whole (3072, 10) basis: 61,440
    # bytes; a full 512-row bucket runs 5 tiles of 2 columns
    cifar = sp.serve_project_launch(65536, 3072, 10)
    assert cifar.dynamic_smem == 4 * (5 * 3072 + 2 * 8 * 4 * 10) == 64000
    burst = sp.serve_project_launch(512, 3072, 10)
    assert burst.kernel == "serve_split_kernel<float, 0, 1>"
    assert burst.dynamic_smem == 4 * (3072 + 2 * 8 * 4 * 2)
    # the fp32 route stages its whole unrounded (3072, 10) basis in 11 words
    # a row, 135 KB, within its own budget; a full bucket 3 words a row
    f32 = sp.serve_project_launch(65536, 3072, 10, basis="f32")
    assert f32.kernel == "serve_split_kernel<float, 2, 5>"
    assert f32.dynamic_smem == 4 * (11 * 3072 + 2 * 8 * 4 * 10) == 137728
    assert sp.serve_project_launch(512, 3072, 10, basis="f32").dynamic_smem == 4 * (
        3 * 3072 + 2 * 8 * 4 * 2)
    assert sp.serve_project_launch(8, 64, 2, torch.bfloat16).kernel == (
        "serve_split_kernel<unsigned short, 0, 1>")


def _split_kernel_body() -> str:
    """The source of ``serve_split_kernel`` and of the two device functions
    that walk its load batches."""
    text = (CSRC / "serve_project.cu").read_text()
    parts = []
    for head in ("__device__ __forceinline__ void load_batch(",
                 "__device__ __forceinline__ void fma_batch(",
                 "    serve_split_kernel(const XT* __restrict__ x"):
        i = text.index(head)
        parts.append(text[i:text.index("\n}\n", i)])
    return "\n".join(parts)


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,k", [(3072, 10), (1, 1), (129, 19), (1100, 33), (12288, 10),
                                 (30000, 10)])
def test_serve_split_order_is_the_same_at_every_row_count(d, k, x_dtype):
    """The d split and the combine order ``serve_project_launch`` declares
    for the bf16 and int8 kernels are a function of (d, k) alone: the same
    for 1, 7, 32, 512 and 65536 rows, so a row padded into a bucket is
    summed as it is alone. The declared order replays the kernel's own d
    loop, read here from the source, through the staged chunks of each row
    count's plan (at d = 12288 and 30000 the chunk changes with the row
    count); the lane tree's offsets and the warp combine are read from the
    source too. Every d group is walked by exactly one warp, in ascending
    order."""
    body = _split_kernel_body()
    for line in ("for (int c0 = 0; c0 < d; c0 += ds) {",
                 "const int g0 = c0 / G;",
                 "const int g1 = min(groups, (c0 + ds) / G);",
                 "for (int g = g0 + (warp - g0 % WARPS + WARPS) % WARPS; g < g1;",
                 "g += WARPS * S_GB) {",
                 "for (int b = 0; b < S_GB; ++b) {",
                 "const int gb = g + b * WARPS;",
                 "for (int w = 1; w < WARPS; ++w) s += pb[w * N];"):
        assert line in body, line
    assert body.count("for (int b = 0; b < S_GB; ++b) {") == 2  # load, then FMA
    halving = re.findall(r"halve<NP, [^>]*, (\d+)>\(acc, lane\);", body)
    butterfly = re.findall(r"__shfl_xor_sync\(0xffffffffu, s, (\d+)\)", body)
    lane_tree = tuple(int(n) for n in halving + butterfly)
    chunks = {sp.split_plan(rows, d, k, x_dtype)["ds"] for rows in (1, 7, 32, 512, 65536)}
    bases = ("bf16", "i8", "f32") if x_dtype == torch.float32 else ("bf16", "i8")
    chunks |= {sp.split_plan(rows, d, k, x_dtype, "f32")["ds"]
               for rows in (1, 7, 32, 512, 65536) if x_dtype == torch.float32}
    orders = {sp.serve_project_launch(rows, d, k, x_dtype, basis).order
              for rows in (1, 7, 32, 512, 65536) for basis in bases}
    assert len(orders) == 1, (chunks, orders)
    order = dict(orders.pop())
    groups = math.ceil(d / order["group"])
    walked = [g for w in order["warp_groups"] for g in w]
    assert sorted(walked) == list(range(groups))
    assert all(list(w) == sorted(w) and all(g % sp.WARPS == i for g in w)
               for i, w in enumerate(order["warp_groups"]))
    assert order["lane_tree"] == lane_tree == (16, 8, 4, 2, 1)
    assert order["warp_combine"] == tuple(range(sp.WARPS))
    if d >= 12288:  # the chunk does vary with the row count here
        assert len(chunks) > 1 and min(chunks) < d
    # what does vary with the row count, the staged chunk and the column
    # tiles, keeps whole groups and covers every column
    for rows in (1, 7, 32, 512, 65536):
        for basis in bases:
            plan = sp.split_plan(rows, d, k, x_dtype, basis)
            assert plan["ds"] % order["group"] == 0
            assert plan["tiles"] * 2 * plan["np"] >= k > (plan["tiles"] - 1) * 2 * plan["np"]


@pytest.mark.parametrize("d,f,k,resident", [
    (1024, 32, 8, True), (12288, 200, 58, True), (3000, 80, 13, True), (97, 5, 70, True),
    (1, 1, 1, True), (100000, 8, 8, True), (12288, 400, 58, False), (4000, 37, 200, False),
    (1, 1, 220, False), (12288, 800, 58, False), (12288, 800, 108, False)])
def test_matvec_gram_launch_uses_the_source_constants(d, f, k, resident):
    """``matvec_gram_launch`` / ``matvec_gram_plan`` against
    ``csrc/matvec_gram.cu`` read as text: the constants, the plan rule
    (resident where the whole slab fits beside y, else streamed), phase A's
    rectangle and the shared memory of each plan, computed here from the
    source's constants."""
    src = CSRC / "matvec_gram.cu"
    c = _constexprs(src)
    for name in ("THREADS", "WARPS", "SLABS", "PAIR", "RC", "AQ", "AC", "PASS_QP", "PASS_CG",
                 "TR_RESIDENT", "TR_STREAMED", "ST_STREAMED", "FC", "KC", "SUM_MIN",
                 "SMEM_MAX"):
        assert c[name] == getattr(mg, name), name
    text = src.read_text()
    for line in ("p.rows = (d + SLABS - 1) / SLABS;",
                 "p.pc = min((p.kp / 4 + AC - 1) / AC, PASS_CG);",
                 "p.pq = min(THREADS / 2 / p.pc, PASS_QP);",
                 "const int fw = 4 * AQ * p.pq, kw = 4 * AC * p.pc;",
                 "const size_t resident = 4 * resident_floats(p.fp, p.kp, p.nchunk, fw, kw);",
                 "p.resident = resident <= (size_t)SMEM_MAX;",
                 "p.smem = p.resident ? resident : 4 * streamed_floats(p.kp, fw, kw);",
                 "return nchunk * RC * fp +\n         mx(mx(nchunk * RC * kp + fw * kw, SUM_MIN),"
                 "\n            fp * kp + (size_t)WARPS * TR_RESIDENT * wstride((int)kp) + "
                 "kp * kp);",
                 "constexpr size_t PROWS = WARPS * TR_STREAMED;\n  return mx(mx(ST_STREAMED * "
                 "RC * (fw + kw) + fw * kw, SUM_MIN),\n            ST_STREAMED * (PROWS * FC + "
                 "FC * KC) + PROWS * wstride((int)kp));",
                 "int wstride(int kp) { return kp + ((16 - kp) % 32 + 32) % 32; }",
                 "return PAIR * min(pairs, p.npart);", "pallas_gram.py"):
        assert line in text, line

    fp, kp = math.ceil(f / 4) * 4, math.ceil(k / 4) * 4
    ws = kp + (16 - kp) % 32  # w rows 16 floats modulo 32 apart
    pc = min(math.ceil(kp // 4 / c["AC"]), c["PASS_CG"])
    pq = min(c["THREADS"] // 2 // pc, c["PASS_QP"])
    fw, kw = 4 * c["AQ"] * pq, 4 * c["AC"] * pc
    rows = math.ceil(d / c["SLABS"])
    nchunk = math.ceil(rows / c["RC"])
    smem_resident = 4 * (nchunk * c["RC"] * fp + max(
        nchunk * c["RC"] * kp + fw * kw, c["SUM_MIN"],
        fp * kp + c["WARPS"] * c["TR_RESIDENT"] * ws + kp * kp))
    pr = c["WARPS"] * c["TR_STREAMED"]
    smem_streamed = 4 * max(c["ST_STREAMED"] * c["RC"] * (fw + kw) + fw * kw, c["SUM_MIN"],
                            c["ST_STREAMED"] * (pr * c["FC"] + c["FC"] * c["KC"]) + pr * ws)

    plan = mg.matvec_gram_plan(d, f, k)
    assert (plan["rows"], plan["nslab"], plan["nchunk"]) == (rows, math.ceil(d / rows), nchunk)
    assert (plan["pq"], plan["pc"]) == (pq, pc)
    assert pq * pc <= c["THREADS"] // 2  # one block per lane pair
    assert plan["resident"] is resident
    assert (smem_resident <= c["SMEM_MAX"]) is resident
    want = smem_resident if resident else smem_streamed
    assert plan["fits"] and plan["smem"] == want <= c["SMEM_MAX"]
    launch = mg.matvec_gram_launch(d, f, k)
    tr = c["TR_RESIDENT"] if resident else c["TR_STREAMED"]
    assert launch.kernel == f"matvec_gram_kernel<{tr}>"
    assert f"matvec_gram_kernel<{'TR_RESIDENT' if resident else 'TR_STREAMED'}>" in text
    assert launch.dynamic_smem == want and launch.static_smem == 0
    assert launch.threads == c["THREADS"]
    assert launch.grid is None and launch.grid_rule == "occupancy"
    assert launch.resolved((132, 1, 1)).grid == (132, 1, 1)
    assert "attrs[1].val.clusterDim.x = PAIR;" in text  # launched in pairs
    ops = dict(launch.operands)
    assert ops["C (slab)"] == (min(rows, d), f)
    assert ops["C staged"] == ((nchunk * c["RC"], fp) if resident
                               else (c["ST_STREAMED"] * c["RC"], fw))
    # every operand a CTA owns stays within the analyzer's tile budget
    assert max(launch.operand_elems().values()) <= 131072


def test_matvec_gram_slice_shape_takes_one_slab_per_sm():
    """The slice shape: 131 slabs of 94 rows, each staged whole (three
    chunks), so C is read from device memory once, in one pass of phase A;
    eight workers' factors (f = 400) and sixteen (f = 800) stream."""
    plan = mg.matvec_gram_plan(12288, 200, 58)
    assert (plan["rows"], plan["nslab"], plan["nchunk"], plan["resident"]) == (94, 131, 3, True)
    assert 4 * mg.AQ * plan["pq"] >= 200 and 4 * mg.AC * plan["pc"] >= 58
    assert mg.matvec_gram_plan(12288, 400, 58)["stages"] == mg.ST_STREAMED
    assert not mg.matvec_gram_plan(12288, 800, 58)["resident"]


@pytest.mark.parametrize("f", [1, 800, 6720, 10**6])
@pytest.mark.parametrize("d", [1, 12288])
def test_matvec_gram_takes_any_f_up_to_max_k(d, f):
    """The streamed plan's shared memory does not depend on f (nor d), so
    every f fits at every k' up to ``MAX_K``, which is at least the 840 the
    fused sweep has always taken, and the wrapper's one limit."""
    assert mg.MAX_K >= 840
    for k in (1, 58, 108, 220, 840, mg.MAX_K):
        plan = mg.matvec_gram_plan(d, f, k)
        assert plan["fits"], k
        if not plan["resident"]:  # the same shared memory for every d and f
            assert plan["smem"] == mg.matvec_gram_plan(12288, 10**6, k)["smem"], k
    streamed = mg.matvec_gram_plan(12288, 10**6, mg.MAX_K + 1)
    assert not streamed["resident"] and not streamed["fits"]


@pytest.mark.parametrize("m,n,d,dtype,aligned", [
    (8, 1024, 3072, torch.bfloat16, True), (4, 128, 256, torch.float32, True),
    (3, 1000, 3000, torch.bfloat16, True), (2, 37, 129, torch.bfloat16, True),
    (2, 96, 64, torch.bfloat16, False), (1, 1, 1, torch.float32, True),
    (5, 64, 136, torch.bfloat16, True), (8, 1024, 3072, torch.float32, True),
    (3, 1000, 3001, torch.float32, True), (3, 1000, 3000, torch.float32, False),
    (8, 256, 512, torch.float32, True), (8, 100, 510, torch.float32, True),
    (2, 1, 300, torch.float32, True), (5, 37, 130, torch.float32, True),
    (65535, 2, 8, torch.float32, True)])
def test_gram_launch_uses_the_source_constants(m, n, d, dtype, aligned):
    """``gram_launch`` against ``csrc/gram.cu`` read as text: the tile and
    stage constants, the shape rules that pick the kernel (and, for fp32,
    its tile edge and copy width), and the launch each kernel makes (the TMA
    kernel's persistent grid is sized on the card; the others take one CTA
    per upper-triangle tile)."""
    src = CSRC / "gram.cu"
    c = _constexprs(src)
    for name in ("TILE", "THREADS", "SMEM_BYTES", "T_BK", "T_STAGES", "T_THREADS",
                 "T_SMEM_BYTES", "F_THREADS", "F_BK", "F_STAGES", "F_FILL"):
        assert c[name] == getattr(tgram, name), name
    text = src.read_text()
    assert "return dtype == 1 && aligned && d % 8 == 0;" in text
    assert "gram_bf16_tma_kernel<<<gx, T_THREADS, T_SMEM_BYTES, s>>>" in text
    assert "gram_f32_kernel<T, VEC><<<grid, F_THREADS, smem, s>>>" in text
    assert "constexpr int smem = F_STAGES * 2 * F_BK * T * 4;  // the ring" in text
    assert "gram_bf16_kernel<<<grid, THREADS, SMEM_BYTES, s>>>" in text
    assert text.count("const dim3 grid(tiles * (tiles + 1) / 2, 1, m);") == 2
    assert "for (int t = 128; t > 32; t /= 2) {" in text  # f32_tile: 128, 64, else 32
    assert "if ((long long)m * (tiles * (tiles + 1) / 2) >= F_FILL) return t;" in text
    assert "bool f32_vec(int d, int aligned) { return aligned && d % 4 == 0; }" in text
    for t in tgram.F_TILES[:-1]:
        assert f"case {t}: return launch_f32_vec<{t}>" in text
    assert f"default: return launch_f32_vec<{tgram.F_TILES[-1]}>" in text
    assert "__launch_bounds__(T_THREADS, 1)" in text and "pallas_gram.py" in text
    launch = tgram.gram_launch(m, n, d, dtype, aligned)
    tma = dtype == torch.bfloat16 and aligned and d % 8 == 0
    assert tgram.takes_tma(d, dtype, aligned) == tma
    if tma:
        assert launch.kernel == "gram_bf16_tma_kernel"
        assert launch.grid is None and launch.grid_rule == "occupancy"
        assert (launch.threads, launch.dynamic_smem) == (c["T_THREADS"], c["T_SMEM_BYTES"])
        ops = dict(launch.operands)
        assert ops["x staged"] == (c["T_STAGES"] * c["T_BK"], 3 * c["TILE"])
        assert ops["G block (item)"] == (min(128, d), min(256, d))
        assert launch.resolved((132, 1, 1)).grid == (132, 1, 1)
    elif dtype == torch.float32:
        edge = next((t for t in (128, 64) if m * _tri(math.ceil(d / t)) >= c["F_FILL"]), 32)
        vec = 4 if aligned and d % 4 == 0 else 1
        assert tgram.f32_tile(m, d) == edge and tgram.f32_vec(d, aligned) == vec
        assert launch.kernel == f"gram_f32_kernel<{edge}, {vec}>"
        assert launch.grid == (_tri(math.ceil(d / edge)), 1, m)
        assert launch.threads == c["F_THREADS"]
        assert launch.dynamic_smem == c["F_STAGES"] * 2 * c["F_BK"] * edge * 4
        ops = dict(launch.operands)
        assert ops["G tile (item)"] == (min(edge, d), min(edge, d))
        assert ops["x staged"] == (c["F_STAGES"] * c["F_BK"], 2 * edge)
        # every operand a CTA owns stays within the analyzer's tile budget
        assert max(launch.operand_elems().values()) <= 131072
    else:
        tiles = math.ceil(d / c["TILE"])
        assert launch.kernel == "gram_bf16_kernel"
        assert launch.grid == (tiles * (tiles + 1) // 2, 1, m)
        assert (launch.threads, launch.dynamic_smem) == (c["THREADS"], c["SMEM_BYTES"])
        assert dict(launch.operands)["G tile (item)"] == (min(128, d), min(128, d))
    assert launch.static_smem == 0 and launch.source == "csrc/gram.cu"
    assert launch.kernel.split("<")[0] in geometry.RECORDED_KERNELS


@pytest.mark.parametrize("m,n,d,aligned", [
    (8, 1024, 3072, True), (8, 2048, 1024, True), (3, 1000, 1000, True),
    (1, 37, 9, True), (2, 130, 48, False), (65535, 2, 16, True), (8, 1000, 3072, False),
    (8, 64, 16, True)])
def test_gram_s8_launch_uses_the_source_constants(m, n, d, aligned):
    """``gram_s8_launch`` against ``csrc/gram_s8.cu`` read as text: the two
    launches in order (the transpose, then the TMA kernel), their tile,
    stage, staging and thread constants, the load-width and store rules,
    the transpose's grid over (n_pad, d, m) and the TMA kernel's
    persistent, occupancy-sized grid; the source has no ``mma.sync``
    product."""
    src = CSRC / "gram_s8.cu"
    c = _constexprs(src)
    for name in ("X_TILE", "X_THREADS", "X_SMEM_BYTES", "S_PAD", "S_TILE", "S_BK", "S_STAGES",
                 "S_THREADS", "S_EPI_BOX", "S_EPI_BUFS", "S_SMEM_BYTES"):
        assert c[name] == getattr(tgram, name), name
    text = src.read_text()
    assert "bool transpose_vec(int d, int aligned) { return aligned && d % 16 == 0; }" in text
    assert "bool tma_store_rows(int d) { return d % 4 == 0; }" in text
    assert "const int n_pad = (n + S_PAD - 1) / S_PAD * S_PAD;" in text
    assert ("const dim3 grid((n_pad + X_TILE - 1) / X_TILE, (d + X_TILE - 1) / X_TILE, m);"
            in text)
    assert "gram_s8_transpose_kernel<VEC><<<grid, X_THREADS, 0, s>>>" in text
    assert "gram_s8_tma_kernel<true><<<gx, S_THREADS, S_SMEM_BYTES, s>>>" in text
    assert "gram_s8_tma_kernel<false><<<gx, S_THREADS, S_SMEM_BYTES, s>>>" in text
    assert "__shared__ __align__(16) uint32_t tile[X_TILE * X_TILE / 4];" in text
    assert "__launch_bounds__(S_THREADS, 1)" in text
    # the two launches of det_gram_s8, in order
    body = text[text.index('extern "C" int det_gram_s8('):]
    assert body.index("det_gram_s8_transpose(x, xt, m, n, d, aligned, stream)") < body.index(
        "launch_tma(")
    assert "ops/linalg.py::gram" in text
    assert "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8" in text
    assert "mma.sync" not in text and "gram_s8_kernel" not in text
    transpose, tma = tgram.gram_s8_launch(m, n, d, aligned)
    n_pad = -(-n // 16) * 16
    assert n_pad % c["S_PAD"] == 0 and tgram.s8_pad(n) == n_pad
    vec = 16 if aligned and d % 16 == 0 else 1
    assert tgram.transpose_vec(d, aligned) == vec
    assert transpose.kernel == f"gram_s8_transpose_kernel<{vec}>"
    assert transpose.grid == (math.ceil(n_pad / c["X_TILE"]), math.ceil(d / c["X_TILE"]), m)
    assert (transpose.threads, transpose.dynamic_smem, transpose.static_smem) == (
        c["X_THREADS"], 0, c["X_SMEM_BYTES"])
    assert transpose.grid_rule == "fixed"
    assert dict(transpose.operands)["x^T tile (item)"] == (min(128, d), min(128, n_pad))
    assert tma.kernel == f"gram_s8_tma_kernel<{'true' if d % 4 == 0 else 'false'}>"
    assert tma.grid is None and tma.grid_rule == "occupancy"
    assert (tma.threads, tma.dynamic_smem, tma.static_smem) == (
        c["S_THREADS"], c["S_SMEM_BYTES"], 0)
    assert c["S_SMEM_BYTES"] <= 232448  # the shared memory a block may use
    ops = dict(tma.operands)
    assert ops["x^T staged"] == (c["S_STAGES"] * 3 * c["S_TILE"], c["S_BK"])
    assert ops["x^T rows j (item)"] == (min(256, d), n_pad)
    assert ops["G block (item)"] == (min(128, d), min(256, d))
    assert tma.resolved((132, 1, 1)).grid == (132, 1, 1)
    for launch in (transpose, tma):
        assert launch.source == "csrc/gram_s8.cu"
        assert launch.kernel.split("<")[0] in geometry.RECORDED_KERNELS


def _tri(tiles: int) -> int:
    return tiles * (tiles + 1) // 2


@pytest.mark.parametrize("m,d,edge", [
    (4, 256, 32), (8, 3072, 128), (3, 3000, 128), (8, 512, 64), (1, 1, 32), (2, 300, 32),
    (1, 2048, 128), (1, 1024, 64)])
def test_gram_f32_tile_fills_the_card(m, d, edge):
    """The fp32 tile rule: the largest edge whose CTAs fill the 132 SMs, else
    the smallest. At the entry shape 128 x 128 tiles gave 12 CTAs; 32 x 32
    tiles give 144."""
    launch = tgram.gram_launch(m, 64, d, torch.float32)
    assert tgram.f32_tile(m, d) == edge
    ctas = launch.grid[0] * launch.grid[2]
    larger = [t for t in tgram.F_TILES if t > edge]
    assert all(m * _tri(math.ceil(d / t)) < tgram.F_FILL for t in larger)
    if edge > tgram.F_TILES[-1]:
        assert ctas >= tgram.F_FILL
    if (m, d) == (4, 256):
        assert ctas == 144 >= 132 and launch.kernel == "gram_f32_kernel<32, 4>"


def test_mutant_launch_uses_the_source_constants():
    src = CSRC / "mutant_full_block.cu"
    c = _constexprs(src)
    assert (c["THREADS"], c["KC"], c["SMEM_MAX"]) == (mfb.THREADS, mfb.KC, mfb.SMEM_MAX)
    text = src.read_text()
    assert "<<<dim3(1, 1, 1), THREADS, smem," in text
    assert "analysis/mutations.py:352" in text
    for rows, d, k, kp in ((256, 1024, 8, 8), (100, 1000, 5, 8), (3, 7, 17, 24)):
        launch = mfb.mutant_full_block_launch(rows, d, k)
        assert launch.grid == (1, 1, 1) and launch.threads == c["THREADS"]
        assert launch.dynamic_smem == 4 * d * kp and launch.static_smem == 0
        assert dict(launch.operands)["x"] == (rows, d)


# -- the recorder and the profile comparison ---------------------------------


def _fake_launch(kernel, grid, smem=0):
    return geometry.KernelLaunch(kernel=kernel, source="csrc/x.cu", grid=grid,
                                 threads=256, dynamic_smem=smem, static_smem=0,
                                 operands=(("x", (1, 1)),))


def test_recording_nests_and_sees_every_launch():
    a, b = _fake_launch("k", (1, 1, 1)), _fake_launch("k", (2, 1, 1))
    geometry.note(a)  # no recorder: dropped
    with geometry.recording() as outer:
        geometry.note(a)
        with geometry.recording() as inner:
            geometry.note(b)
    assert outer == [a, b] and inner == [b]


def test_profiled_symbol_and_geometry_comparison():
    name = ("void (anonymous namespace)::serve_split_kernel<float, 2, 1>"
            "(float const*, void const*, float const*, float*, int, int, int, int, int)")
    bases = {"serve_split_kernel", "matvec_gram_kernel"}
    assert geometry._symbol(name, bases) == "serve_split_kernel<float, 2, 1>"
    assert geometry._symbol("(anonymous namespace)::matvec_gram_kernel(float const*)",
                            bases) == "matvec_gram_kernel"
    assert geometry._symbol("void at::native::vectorized_elementwise_kernel<4>(int)",
                            bases) is None
    launch = sp.serve_project_launch(256, 1024, 8, basis="f32").resolved((8, 4, 1))
    ev = {"symbol": launch.kernel, "grid": (8, 4, 1), "block": (256, 1, 1),
          "smem": launch.dynamic_smem, "name": name}
    assert geometry.geometry_mismatches([ev], [launch]) == []
    assert geometry.geometry_mismatches([ev, ev], [launch])  # one event too many
    assert geometry.geometry_mismatches([dict(ev, smem=0)], [launch])
    assert geometry.geometry_mismatches([], [launch])
    unresolved = mg.matvec_gram_launch(1024, 32, 8)
    assert "unresolved" in geometry.geometry_mismatches([], [unresolved])[0]
    split = sp.serve_project_launch(256, 1024, 8)
    assert "unresolved" in geometry.geometry_mismatches([], [split])[0]
    split = split.resolved((64, 1, 1))
    ev = {"symbol": split.kernel, "grid": (64, 1, 1), "block": (256, 1, 1),
          "smem": split.dynamic_smem, "name": name}
    assert geometry.geometry_mismatches([ev], [split]) == []
    assert geometry.geometry_mismatches([dict(ev, grid=(8, 1, 1))], [split])


# -- the report and the script -------------------------------------------------


def test_run_analysis_report_shape():
    rep = report.run_analysis(device="cpu")
    assert {"schema", "programs", "lints", "ok", "n_violations"} <= set(rep)
    assert rep["ok"] and rep["n_violations"] == 0 and rep["device"] == "cpu"
    # the whole matrix: the single-device programs and the mesh ones
    assert list(rep["programs"]) == list(programs.MATRIX)
    assert set(programs.PROGRAMS) | set(programs.MESH_PROGRAMS) == set(programs.MATRIX)
    assert set(rep["lints"]) == {"concurrency"}
    for entry in rep["programs"].values():
        assert {"contract", "ok", "memory", "pallas", "launches", "source",
                "violations", "collectives", "costs"} <= set(entry)
    only_lints = report.run_analysis([], device="cpu")
    assert only_lints["programs"] == {} and only_lints["ok"]


def test_default_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        report.run_analysis()
    with pytest.raises(RuntimeError, match="cuda"):
        report.run_mutation_report()
    with pytest.raises(RuntimeError, match="cuda"):
        programs.build_program("serve_project_solo")
    with pytest.raises(KeyError, match="nope"):
        programs.build_program("nope", device="cpu")


def test_torch_analyze_cli_cpu(tmp_path, capsys):
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "torch_analyze_cli", ROOT / "scripts" / "torch_analyze.py")
    cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cli)
    out_path = tmp_path / "report.json"
    rc = cli.main(["--all", "--mutation-check", "--device", "cpu", "--json", str(out_path)])
    assert rc == 0, capsys.readouterr().out
    out = json.loads(out_path.read_text())
    assert set(out) == {"schema", "device", "analysis", "mutation_check", "elapsed_s", "ok"}
    assert out["ok"] and out["schema"] == report.SCHEMA
    assert len(out["analysis"]["programs"]) == len(programs.MATRIX) == 27
    assert len(out["mutation_check"]["mutations"]) == len(mutations.MUTATIONS) == 14
    assert all(r["caught"] for r in out["mutation_check"]["mutations"])
    assert cli.main(["--list"]) == 0
    assert cli.main(["--lints-only", "--device", "cpu"]) == 0
    assert "serve_project_solo" in capsys.readouterr().out
