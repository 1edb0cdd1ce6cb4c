"""The hand-written CUDA flash-attention kernels against their plain PyTorch
versions on the card. These need an NVIDIA GPU (sm_90a) and nvcc, so they
skip elsewhere; run them on the card with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(--noconftest: the suite's conftest imports jax, which the card machine
lacks; this file imports no jax.)

Tolerances: fp32 inputs agree to fp32 round-off of a different summation
order (2e-4 on O(1) values at these sizes). bf16 inputs are held to
chip_smoke.py's phase-2 limit, per row: ||kernel - plain||_2 <= 1e-2 *
||plain||_2 for out/dq/dk/dv and 2e-3 on each fp32 lse entry (chip_smoke's
docstring says why). `test_planted_wrong_kernels_fail` shows that limit
fails a kernel with a planted fault, and `test_mutant_sites` (which needs no
card and runs in the CPU suite) that each planted fault still lands in the
kernels it names, the tensor-core forward, dq and dk/dv included.

The AdamW kernel (`csrc/adamw.cu`) is held to its plain version bit for
bit (chip_smoke phase 6a); a copy with nu's bias correction dropped must
fail that gate. The offloaded optimizer trains a debug-size model on the
card with its state pinned on the host, each streamed step equal bit for
bit to the plain update; and chip_smoke phase 6b, at its full size, fails
each of three faults planted in the offloaded optimizer.

The context-parallel schedules (chip_smoke phase 8a) run in its thread
world at S 2048 (the phase runs S 8192): ring (zigzag and contiguous),
Ulysses and mesh 2x2 within the per-row limit of the whole sequence and
of the kernels' plain versions, with their launches per rank, and the
planted fault (rank 1's zigzag chunks swapped) over the limit."""

import re

import pytest
import torch

import chip_smoke
from picotron_tpu_torch.kernels import build
from picotron_tpu_torch.ops import flash_attention as fa
from picotron_tpu_torch.ops.rope import rope_tables

cuda = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA; run `python -m pytest "
                    "--noconftest "
                    "-m cuda tests/test_torch_cuda.py` on the card")
    return torch.device("cuda")


CASES = [
    # (b, hq, hkv, sq, sk, d, causal, positions, rope)
    (2, 4, 4, 256, 256, 64, True, None, True),
    (1, 8, 2, 192, 192, 128, True, None, True),
    (1, 4, 2, 100, 100, 64, True, None, False),        # ragged edge
    (1, 4, 1, 128, 256, 64, True, "shifted", True),    # later q shard
    (1, 4, 2, 96, 160, 128, False, None, False),       # non-causal, sk > sq
    (1, 8, 2, 200, 200, 128, True, None, True),        # GQA 4:1, ragged, D 128
]


def _make(case, dtype, dev, seed=0):
    b, hq, hkv, sq, sk, d, causal, positions, rope = case
    g = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g, device=dev).to(dtype)  # noqa: E731
    q, k, v = r(b, hq, sq, d), r(b, hkv, sk, d), r(b, hkv, sk, d)
    qpos = torch.arange(sq, device=dev, dtype=torch.int32)
    kpos = torch.arange(sk, device=dev, dtype=torch.int32)
    if positions == "shifted":
        qpos = qpos + (sk - sq)
    tabs = None
    if rope:
        cos, sin = rope_tables(512, d, device=dev)
        tabs = fa._tables((cos, sin), qpos, kpos)
    static = causal and positions is None
    return q, k, v, qpos, kpos, tabs, causal, static


def _assert_close(got, want, dtype, what):
    if dtype == torch.float32:
        torch.testing.assert_close(got.float(), want.float(), rtol=0,
                                   atol=2e-4, msg=what)
        return
    lse = what == "lse"
    worst = float(chip_smoke.row_errors(got, want, lse=lse).max())
    limit = chip_smoke.LSE_ATOL if lse else chip_smoke.ROW_RTOL
    assert worst <= limit, f"{what}: worst row error {worst:.4g} > {limit}"


@cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", CASES, ids=range(len(CASES)))
def test_kernels_match_plain(case, dtype, dev):
    q, k, v, qpos, kpos, tabs, causal, static = _make(case, dtype, dev)
    fa.reset_launch_counts()
    out, lse = fa.fwd_kernel(q, k, v, qpos, kpos, tabs, causal, static)
    out_p, lse_p = fa.fwd_plain(q, k, v, qpos, kpos, tabs, causal)
    torch.cuda.synchronize()
    _assert_close(out, out_p, dtype, "out")
    _assert_close(lse, lse_p, dtype, "lse")

    g = torch.Generator(device=dev).manual_seed(1)
    do = torch.randn(out.shape, generator=g, device=dev).to(dtype)
    dlse = torch.randn(lse.shape, generator=g, device=dev)
    got = fa._bwd(q, k, v, out_p, lse_p, do, dlse, qpos, kpos, tabs, causal,
                  static)
    want = fa.bwd_plain(q, k, v, out_p, lse_p, do, dlse, qpos, kpos, tabs,
                        causal)
    torch.cuda.synchronize()
    for a, b_, name in zip(got, want, ("dq", "dk", "dv")):
        _assert_close(a, b_, dtype, name)
    assert fa.launches == {"flash_fwd": 1, "flash_bwd_dq": 1,
                           "flash_bwd_dkv": 1}
    # bf16 runs the tensor-core kernels, fp32 the CUDA-core ones; the bf16
    # kernels at D 64 run the wgmma ones: with RoPE the forward rotates q
    # and k (two pre-pass launches), and dq and dk/dv share two more
    variant = "tensor_core" if dtype == torch.bfloat16 else "cuda_core"
    wgmma = dtype == torch.bfloat16 and case[5] == 64
    for counts in (fa.fwd_launches, fa.dq_launches, fa.dkv_launches):
        assert counts == {"wgmma": 0, "tensor_core": 0, "cuda_core": 0,
                          "wgmma" if wgmma else variant: 1}
    assert fa.prepass_launches == {"rope_rows": 4 * (wgmma and case[8])}


@cuda
def test_public_wrapper_launches_kernels_and_autograd(dev):
    q = torch.randn(2, 128, 8, 64, device=dev, dtype=torch.bfloat16,
                    requires_grad=True)
    k = torch.randn(2, 128, 4, 64, device=dev, dtype=torch.bfloat16,
                    requires_grad=True)
    v = torch.randn_like(k, requires_grad=True)
    rope = rope_tables(128, 64, device=dev)
    fa.reset_launch_counts()
    out = fa.flash_attention(q, k, v, causal=True, rope=rope)
    out.float().square().sum().backward()
    torch.cuda.synchronize()
    assert fa.launches == {"flash_fwd": 1, "flash_bwd_dq": 1,
                           "flash_bwd_dkv": 1}
    for counts in (fa.fwd_launches, fa.dq_launches, fa.dkv_launches):
        assert counts == {"wgmma": 1, "tensor_core": 0, "cuda_core": 0}
    # one rotation of q and k for the forward, and one shared by dq and
    # dk/dv
    assert fa.prepass_launches == {"rope_rows": 4}
    assert q.grad.shape == q.shape and torch.isfinite(q.grad.float()).all()


@cuda
def test_wrapper_raises_instead_of_falling_back(dev):
    q = torch.randn(1, 64, 2, 48, device=dev)  # head_dim 48: no variant
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention(q, q, q)


# the wgmma dq's and dk/dv's edge cases: (b, hq, hkv, sq, sk, causal, q
# position shift, rope); explicit positions unless the shift is 0
WGMMA_EDGES = {
    "ragged S 130": (1, 4, 2, 130, 130, True, 0, True),
    "shifted, ragged 97 x 161, GQA 4": (1, 4, 1, 97, 161, True, 64, True),
    "GQA 4, static causal": (1, 8, 2, 256, 256, True, 0, True),
    "fully masked rows": (1, 4, 4, 128, 128, True, -40, False),
    "not causal, sk > sq": (2, 4, 2, 96, 160, False, 0, True),
}


@cuda
@pytest.mark.parametrize("edge", list(WGMMA_EDGES))
def test_wgmma_dkv_edge_cases(edge, dev):
    """The wgmma dk/dv (D 64, bf16) against `bwd_plain` at ragged S (not a
    multiple of 64, nor of 4), shifted positions, q rows that see no key
    (lse -inf), GQA with n_rep 4 and no causal mask, each with a nonzero
    LSE cotangent, within chip_smoke's per-row limit."""
    b, hq, hkv, sq, sk, causal, shift, rope = WGMMA_EDGES[edge]
    g = torch.Generator(device=dev).manual_seed(3)
    r = lambda *s: torch.randn(*s, generator=g, device=dev).to(  # noqa: E731
        torch.bfloat16)
    q, k, v = r(b, hq, sq, 64), r(b, hkv, sk, 64), r(b, hkv, sk, 64)
    qpos = torch.arange(shift, shift + sq, device=dev, dtype=torch.int32)
    kpos = torch.arange(sk, device=dev, dtype=torch.int32)
    tabs = (fa._tables(rope_tables(512, 64, device=dev), qpos, kpos)
            if rope else None)
    static = causal and shift == 0
    out, lse = fa.fwd_plain(q, k, v, qpos, kpos, tabs, causal)
    if shift < 0:
        assert torch.isneginf(lse).any()
    do = r(b, hq, sq, 64)
    dlse = torch.randn(b, hq, sq, generator=g, device=dev)
    fa.reset_launch_counts()
    dk, dv = fa.bwd_dkv_kernel(q, k, v, do, lse, fa._delta(do, out, dlse),
                               qpos, kpos, tabs, causal, static)
    _, dk_p, dv_p = fa.bwd_plain(q, k, v, out, lse, do, dlse, qpos, kpos,
                                 tabs, causal)
    torch.cuda.synchronize()
    _assert_close(dk, dk_p, torch.bfloat16, "dk")
    _assert_close(dv, dv_p, torch.bfloat16, "dv")
    assert fa.dkv_launches == {"wgmma": 1, "tensor_core": 0, "cuda_core": 0}
    assert fa.prepass_launches == {"rope_rows": 2 if rope else 0}


@cuda
@pytest.mark.parametrize("edge", list(WGMMA_EDGES))
def test_wgmma_dq_edge_cases(edge, dev):
    """The wgmma dq (D 64, bf16), run as the backward runs it (`_bwd`:
    q and k rotated once, for dq and dk/dv alike), against `bwd_plain` at
    the dk/dv's edge cases (ragged S, shifted positions, q rows that see
    no key, GQA with n_rep 4, no causal mask), each with a nonzero LSE
    cotangent, within chip_smoke's per-row limit."""
    b, hq, hkv, sq, sk, causal, shift, rope = WGMMA_EDGES[edge]
    g = torch.Generator(device=dev).manual_seed(5)
    r = lambda *s: torch.randn(*s, generator=g, device=dev).to(  # noqa: E731
        torch.bfloat16)
    q, k, v = r(b, hq, sq, 64), r(b, hkv, sk, 64), r(b, hkv, sk, 64)
    qpos = torch.arange(shift, shift + sq, device=dev, dtype=torch.int32)
    kpos = torch.arange(sk, device=dev, dtype=torch.int32)
    tabs = (fa._tables(rope_tables(512, 64, device=dev), qpos, kpos)
            if rope else None)
    static = causal and shift == 0
    out, lse = fa.fwd_plain(q, k, v, qpos, kpos, tabs, causal)
    if shift < 0:
        assert torch.isneginf(lse).any()
    do = r(b, hq, sq, 64)
    dlse = torch.randn(b, hq, sq, generator=g, device=dev)
    fa.reset_launch_counts()
    got = fa._bwd(q, k, v, out, lse, do, dlse, qpos, kpos, tabs, causal,
                  static)
    want = fa.bwd_plain(q, k, v, out, lse, do, dlse, qpos, kpos, tabs,
                        causal)
    torch.cuda.synchronize()
    for a, b_, name in zip(got, want, ("dq", "dk", "dv")):
        _assert_close(a, b_, torch.bfloat16, name)
    assert fa.dq_launches == {"wgmma": 1, "tensor_core": 0, "cuda_core": 0}
    assert fa.prepass_launches == {"rope_rows": 2 if rope else 0}


@cuda
@pytest.mark.parametrize("edge", list(WGMMA_EDGES))
def test_wgmma_fwd_edge_cases(edge, dev):
    """The wgmma forward (D 64, bf16) against `fwd_plain`, out and lse, at
    the backward kernels' edge cases (ragged S, shifted positions, q rows
    that see no key: a zero output and lse -inf, GQA with n_rep 4, no
    causal mask), within chip_smoke's per-row limits."""
    b, hq, hkv, sq, sk, causal, shift, rope = WGMMA_EDGES[edge]
    g = torch.Generator(device=dev).manual_seed(6)
    r = lambda *s: torch.randn(*s, generator=g, device=dev).to(  # noqa: E731
        torch.bfloat16)
    q, k, v = r(b, hq, sq, 64), r(b, hkv, sk, 64), r(b, hkv, sk, 64)
    qpos = torch.arange(shift, shift + sq, device=dev, dtype=torch.int32)
    kpos = torch.arange(sk, device=dev, dtype=torch.int32)
    tabs = (fa._tables(rope_tables(512, 64, device=dev), qpos, kpos)
            if rope else None)
    static = causal and shift == 0
    fa.reset_launch_counts()
    out, lse = fa.fwd_kernel(q, k, v, qpos, kpos, tabs, causal, static)
    out_p, lse_p = fa.fwd_plain(q, k, v, qpos, kpos, tabs, causal)
    torch.cuda.synchronize()
    # rows that see no key: lse -inf where the plain version's is, and a
    # zero output
    dark = torch.isneginf(lse_p)
    assert bool(dark.any()) == (shift < 0)
    assert torch.equal(torch.isneginf(lse), dark) and not out[dark].any()
    _assert_close(out, out_p, torch.bfloat16, "out")
    _assert_close(lse[~dark], lse_p[~dark], torch.bfloat16, "lse")
    assert fa.fwd_launches == {"wgmma": 1, "tensor_core": 0, "cuda_core": 0}
    assert fa.prepass_launches == {"rope_rows": 2 if rope else 0}


@cuda
def test_rope_rows_matches_rot_bit_for_bit(dev):
    """The rotation pre-pass equals its plain version `_rot` bit for bit
    (the same fp32 roundings), at a ragged length."""
    g = torch.Generator(device=dev).manual_seed(4)
    x = torch.randn(2, 3, 77, 64, generator=g, device=dev).to(torch.bfloat16)
    pos = torch.arange(5, 82, device=dev, dtype=torch.int32)
    c, s, _, _ = fa._tables(rope_tables(128, 64, device=dev), pos, pos)
    fa.reset_launch_counts()
    got = fa.rope_rows(x, c, s)
    torch.cuda.synchronize()
    assert torch.equal(got, fa._rot(x, c, s, 1.0))
    assert fa.prepass_launches == {"rope_rows": 1}


# Faults planted in a copy of the CUDA source: (pattern, replacement, count).
# Each edits every kernel that has the site, so each kernel's own output
# shows whether the limit catches it. The counts include the sites in the
# tensor-core forward, dq and dk/dv (`fwd_wgmma_kernel`,
# `bwd_dq_wgmma_kernel` and `bwd_dkv_wgmma_kernel` at D 64,
# `fwd_mma_kernel`, `bwd_dq_mma_kernel` and `bwd_dkv_mma_kernel` at D
# 128), the kernels bf16 inputs run.
MUTANTS = {
    # the causal mask lets each q row see one key past its own position
    # (fwd_wgmma_kernel and bwd_dq_wgmma_kernel (their q positions in
    # registers, qp), fwd_mma_kernel, fwd_kernel, bwd_dq_kernel,
    # bwd_dq_mma_kernel, bwd_dkv_kernel, bwd_dkv_mma_kernel and
    # bwd_dkv_wgmma_kernel, whose transposed masks index kp_s by kv row)
    "mask_off_by_one": (r">= kp_s\[(\w+)\]", r"+ 1 >= kp_s[\1]", 9),
    # the same, only in q rows at position 1024 and later
    "late_mask_off_by_one": (r"(qp(?:_s)?\[[^\]]+\]) >= kp_s\[(\w+)\]",
                             r"\1 + (\1 >= 1024) >= kp_s[\2]", 9),
    # the diagonal tile counted as full: its mask is never applied (one
    # `classify` shared by all kernels)
    "diagonal_tile_as_full": (r"t\.full = q0 >= k0 \+ nk - 1;",
                              "t.full = q0 >= k0;", 1),
    # the last visible tile of the inner loop is dropped (fwd, dq: the
    # diagonal kv tile, in fwd_wgmma_kernel, fwd_mma_kernel,
    # bwd_dq_mma_kernel and bwd_dq_wgmma_kernel through their
    # next-visible-tile search; dk/dv: the last q tile, in
    # bwd_dkv_mma_kernel and bwd_dkv_wgmma_kernel the last head's)
    "last_tile_skipped": (r"kt < kv_end; \+\+kt|qt < num_q; \+\+qt"
                          r"|it < it_end; \+\+it", None, 9),
    # fwd_mma_kernel packs P's A fragment for kv columns 8..15 of each
    # k-step from the S n-tile of columns 0..7
    "p_from_wrong_ntile": (r"s\[2 \* kk \+ 1\]", "s[2 * kk]", 4),
    # the bf16 dk/dv kernels' (GQA head x q tile) sequence drops its last
    # head (with one head per group, every head)
    "gqa_last_head_dropped": (r"it_end = n_rep \* nqt",
                              "it_end = (n_rep - 1) * nqt", 2),
    # bwd_dq_wgmma_kernel takes row g's delta for row g + 8 of each warp's
    # 16 (the lane's two rows of the wgmma accumulator)
    "dq_delta_wrong_row": (r"\(dp\[4 \* j \+ e\] - dl\[e >> 1\]\)",
                           "(dp[4 * j + e] - dl[0])", 1),
    # fwd_wgmma_kernel adds each tile's P V to an O that was not rescaled
    # by alpha = exp(m_old - m_new) (both of the lane's rows' columns)
    "fwd_o_not_rescaled": (r"o\[4 \* j \+ 2 \* i( \+ 1)?\] \*= alpha;", "",
                           2),
    # fwd_wgmma_kernel packs P's A fragments for rows g and g + 8 of each
    # warp's 16 from each other's accumulator entries
    "fwd_p_wrong_fragment": (
        r"pack_bf16\(s\[8 \* kk \+ 2 \* i\], s\[8 \* kk \+ 2 \* i \+ 1\]\)",
        "pack_bf16(s[8 * kk + (2 * i ^ 2)], s[8 * kk + (2 * i ^ 2) + 1])", 1),
}
# the faults that only one kernel has a site for
ONE_KERNEL = {"gqa_last_head_dropped": "bwd_dkv_wgmma_kernel",
              "dq_delta_wrong_row": "bwd_dq_wgmma_kernel",
              "fwd_o_not_rescaled": "fwd_wgmma_kernel",
              "fwd_p_wrong_fragment": "fwd_wgmma_kernel"}


def _mutate(name):
    """The kernel source with fault `name` planted, and its site count."""
    pattern, repl, _ = MUTANTS[name]
    src = (build.CSRC / "flash_attention.cu").read_text()
    if repl is None:  # drop the loop's last iteration
        repl = lambda m: m.group(0).replace(";", " - 1;", 1)  # noqa: E731
    return re.subn(pattern, repl, src)


def _plant(name, tmp_path):
    mutated, n = _mutate(name)
    assert n == MUTANTS[name][2], f"{name}: {n} sites, want {MUTANTS[name][2]}"
    (tmp_path / "flash_attention.cu").write_text(mutated)


def _kernel_body(src, name):
    """The text of `__global__ ... name(` up to the next __global__."""
    start = src.index(f" {name}(")
    end = src.find("__global__", start)
    return src[start:end if end >= 0 else len(src)]


def _lands_in(mutant, kernel):
    """Whether fault `mutant` edits `kernel` (the classify fault lands in
    every kernel that calls `classify`)."""
    src = (build.CSRC / "flash_attention.cu").read_text()
    body = _kernel_body(src, kernel)
    if mutant == "diagonal_tile_as_full":
        return "classify(" in body
    return body != _kernel_body(_mutate(mutant)[0], kernel)


@pytest.mark.parametrize("mutant", list(MUTANTS))
def test_mutant_sites(mutant):
    """Each planted fault finds its stated number of sites; every one but
    the one-kernel faults lands in the tensor-core forward, and every one
    with a site in a CUDA-core kernel has one in each of its tensor-core
    counterparts (the wgmma kernel at D 64 and the mma.sync one at D 128);
    no card needed."""
    mutated, n = _mutate(mutant)
    assert n == MUTANTS[mutant][2], f"{mutant}: {n} sites"
    if mutant in ONE_KERNEL:
        assert _lands_in(mutant, ONE_KERNEL[mutant])
        assert not _lands_in(mutant, "fwd_mma_kernel")
    else:
        assert _lands_in(mutant, "fwd_mma_kernel"), f"{mutant} misses fwd"
    for old, new in (("fwd_kernel", "fwd_wgmma_kernel"),
                     ("fwd_kernel", "fwd_mma_kernel"),
                     ("bwd_dq_kernel", "bwd_dq_mma_kernel"),
                     ("bwd_dq_kernel", "bwd_dq_wgmma_kernel"),
                     ("bwd_dkv_kernel", "bwd_dkv_wgmma_kernel"),
                     ("bwd_dkv_kernel", "bwd_dkv_mma_kernel")):
        if _lands_in(mutant, old):
            assert _lands_in(mutant, new), f"{mutant} misses {new}"


def test_tensor_core_forward_in_source():
    """The bf16 forward at D 128 is a kernel of its own whose products are
    bf16 mma.sync instructions fed by ldmatrix from a cp.async ring, and
    pt_flash_fwd sends bf16 D 128 to it alone; no card needed."""
    src = (build.CSRC / "flash_attention.cu").read_text()
    assert re.search(r"__global__ void __launch_bounds__\(MMA_NT[^)]*\) "
                     r"fwd_mma_kernel\(", src)
    assert re.search(r"mma\.sync\.aligned\.m16n8k16\.row\.col\.f32\.bf16"
                     r"\.bf16\.f32", src)
    for instr in ("ldmatrix.sync.aligned.m8n8.x4.shared.b16",
                  "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16",
                  "cp.async.cg.shared.global", "cp.async.wait_group"):
        assert instr in src, instr
    body = _kernel_body(src, "fwd_mma_kernel")
    for helper in ("mma_16816(", "ldsm_x4(", "ldsm_x4_trans(", "issue_kv(",
                   "cp_async_wait<"):
        assert helper in body, helper
    fwd = src[src.index("int pt_flash_fwd("):]
    fwd = fwd[:fwd.index("\n}\n")]
    assert re.findall(r"is_bf16 && D == (\d+)\) return \(int\)"
                      r"launch_fwd_mma<\1>", fwd) == ["128"]
    assert "launch_fwd_mma<64>" not in src
    assert "launch_fwd<__nv_bfloat16" not in src
    assert "PT_DISPATCH(launch_fwd," not in src


def test_wgmma_forward_in_source():
    """The bf16 forward at D 64 is a Hopper kernel of its own: its two
    products are wgmma.mma_async instructions (S = Q K^T with both
    operands in shared memory, O += P V with P from registers), fed by TMA
    copies (cp.async.bulk.tensor) that complete on an mbarrier ring, with
    no block-wide barrier in its loop, on q and k rotated beforehand (no
    tables); pt_flash_fwd sends bf16 D 64 to it and bf16 D 128 to the
    mma.sync kernel; no card needed."""
    src = (build.CSRC / "flash_attention.cu").read_text()
    assert re.search(r"__global__ void __launch_bounds__\(WG_NT[^)]*\) "
                     r"fwd_wgmma_kernel\(", src)
    body = _kernel_body(src, "fwd_wgmma_kernel")
    body = body[:body.index("\n}\n")]  # the kernel alone
    assert body.count("wgmma_ss(") == 1  # S = Q K^T
    assert body.count("wgmma_rs_t(") == 1  # O += P V
    for helper in ("tma_load_3d(", "tma_load_1d(", "mbar_init(",
                   "mbar_wait(", "mbar_arrive(", "mbar_expect_tx(",
                   "wg_fence(", "wg_commit(", "wg_wait<"):
        assert helper in body, helper
    for instr in ("cp.async.bulk.tensor.3d.shared::cluster.global",
                  "mbarrier.try_wait.parity", "wgmma.mma_async"):
        assert instr in src, instr
    loop = body[body.index("for (int n = 0; kt < kv_end; ++n)"):]
    assert "__syncthreads" not in loop
    # q and k come rotated: no per-tile rotation, no tables, no mma.sync
    assert "rope_tile" not in body and "mma_16816" not in body
    assert not re.search(r"\b(cq|sq|ck|sk)\b", body)
    fwd = src[src.index("int pt_flash_fwd("):]
    fwd = fwd[:fwd.index("\n}\n")]
    assert re.findall(r"is_bf16 && D == (\d+)\) return \(int\)"
                      r"(launch_fwd_\w+)", fwd) == [
        ("64", "launch_fwd_wgmma"), ("128", "launch_fwd_mma")]
    assert fa.WGMMA_HEAD_DIMS == (64,)


def test_tensor_core_dkv_in_source():
    """The bf16 dk/dv at D 64 is a Hopper kernel of its own: its four
    products are wgmma.mma_async instructions (S^T and dP^T with both
    operands in shared memory, dV and dK with P^T and dS^T from
    registers), fed by TMA copies (cp.async.bulk.tensor) that complete on
    an mbarrier ring, with no block-wide barrier in its loop;
    pt_flash_bwd_dkv sends bf16 D 64 to it and bf16 D 128 to the mma.sync
    kernel; no card needed."""
    src = (build.CSRC / "flash_attention.cu").read_text()
    assert re.search(r"__global__ void __launch_bounds__\(WG_NT[^)]*\) "
                     r"bwd_dkv_wgmma_kernel\(", src)
    assert re.search(r"wgmma\.mma_async\.sync\.aligned\.m64n64k16\.f32"
                     r"\.bf16\.bf16", src)
    for instr in ("cp.async.bulk.tensor.3d.shared::cluster.global",
                  "cp.async.bulk.tensor.1d.shared::cluster.global",
                  ".mbarrier::complete_tx", "mbarrier.arrive.expect_tx", "mbarrier.try_wait.parity",
                  "wgmma.fence.sync.aligned", "wgmma.commit_group",
                  "wgmma.wait_group"):
        assert instr in src, instr
    body = _kernel_body(src, "bwd_dkv_wgmma_kernel")
    body = body[:body.index("\n}\n")]  # the kernel alone
    assert body.count("wgmma_ss(") == 2  # S^T = K Q^T, dP^T = V dO^T
    assert body.count("wgmma_rs_t(") == 2  # dV += P^T dO, dK += dS^T Q
    for helper in ("tma_load_3d(", "mbar_wait(", "mbar_arrive(",
                   "mbar_expect_tx(", "wg_wait<"):
        assert helper in body, helper
    loop = body[body.index("for (int n = 0; it < it_end; ++n)"):]
    assert "__syncthreads" not in loop
    assert "rope_tile" not in body and "cq" not in body  # q comes rotated
    dkv = src[src.index("int pt_flash_bwd_dkv("):]
    dkv = dkv[:dkv.index("\n}\n")]
    assert re.findall(r"is_bf16 && D == (\d+)\) return \(int\)"
                      r"(launch_dkv_\w+)", dkv) == [
        ("64", "launch_dkv_wgmma"), ("128", "launch_dkv_mma")]
    assert "launch_dkv_mma<64>" not in src
    assert "bwd_dkv_kernel<__nv_bfloat16" not in src
    assert "launch_dkv<__nv_bfloat16" not in src
    assert fa.WGMMA_HEAD_DIMS == (64,)


def test_tensor_core_dq_in_source():
    """The bf16 dq at D 64 is a Hopper kernel of its own: its three
    products are wgmma.mma_async instructions (S and dP with both operands
    in shared memory, dQ += dS K with dS from registers), fed by TMA
    copies (cp.async.bulk.tensor) that complete on an mbarrier ring, with
    no block-wide barrier in its loop, on q and k rotated beforehand;
    pt_flash_bwd_dq sends bf16 D 64 to it and bf16 D 128 to the mma.sync
    kernel; no card needed."""
    src = (build.CSRC / "flash_attention.cu").read_text()
    assert re.search(r"__global__ void __launch_bounds__\(WG_NT[^)]*\) "
                     r"bwd_dq_wgmma_kernel\(", src)
    body = _kernel_body(src, "bwd_dq_wgmma_kernel")
    body = body[:body.index("\n}\n")]  # the kernel alone
    assert body.count("wgmma_ss(") == 2  # S = Q K^T, dP = dO V^T
    assert body.count("wgmma_rs_t(") == 1  # dQ += dS K
    for helper in ("tma_load_3d(", "tma_load_1d(", "mbar_init(",
                   "mbar_wait(", "mbar_arrive(", "mbar_expect_tx(",
                   "wg_fence(", "wg_commit(", "wg_wait<"):
        assert helper in body, helper
    loop = body[body.index("for (int n = 0; kt < kv_end; ++n)"):]
    assert "__syncthreads" not in loop
    # k comes rotated: no per-tile rotation, no k tables
    assert "rope_tile" not in body
    assert not re.search(r"\b(ck|sk)\b", body)
    dq = src[src.index("int pt_flash_bwd_dq("):]
    dq = dq[:dq.index("\n}\n")]
    assert re.findall(r"is_bf16 && D == (\d+)\) return \(int\)"
                      r"(launch_dq_\w+)", dq) == [
        ("64", "launch_dq_wgmma"), ("128", "launch_dq_mma")]
    assert "launch_dq_mma<64>" not in src
    assert "bwd_dq_kernel<__nv_bfloat16" not in src
    assert "launch_dq<__nv_bfloat16" not in src
    assert "PT_DISPATCH(launch_dq," not in src
    assert fa.WGMMA_HEAD_DIMS == (64,)


def test_variant_edits_and_ptxas_lines():
    """kernels/variants.py edits the source by exact substrings (refusing
    one that is absent) and keeps the ptxas lines of one kernel; no card
    needed."""
    from picotron_tpu_torch.kernels import variants

    src = (build.CSRC / "flash_attention.cu").read_text()
    name, edited = variants.edit(src, "ns3:int DQ_NS = 2;=>int DQ_NS = 3;")
    assert name == "ns3" and edited.count("int DQ_NS = 3;") == 1
    assert edited.replace("int DQ_NS = 3;", "int DQ_NS = 2;") == src
    for bad in ("ns3:no such text=>x", "ns3 no separator", ":a=>b"):
        with pytest.raises(ValueError):
            variants.edit(src, bad)
    log = ("ptxas info    : Compiling entry function '_Z17fwd_mma_kernelILi64E'"
           " for 'sm_90a'\nptxas info    : Used 152 registers\n"
           "ptxas info    : Compiling entry function "
           "'_Z17bwd_dq_mma_kernelILi64E' for 'sm_90a'\n"
           "    0 bytes stack frame, 0 bytes spill stores\n"
           "ptxas info    : Used 180 registers\n")
    got = variants.ptxas_lines(log, "bwd_dq_mma_kernel")
    assert len(got) == 3 and got[-1].endswith("Used 180 registers")


@cuda
@pytest.mark.parametrize("mutant", [*MUTANTS, "dlse_dropped"])
def test_planted_wrong_kernels_fail(mutant, dev, tmp_path, monkeypatch,
                                    capsys):
    """Each planted fault fails chip_smoke's phase-2 limit on some output,
    and the mask faults fail it on every output in the late half of the
    rows alone (where a limit scaled by the tensor's largest value, printed
    beside it, is loosest)."""
    if mutant == "dlse_dropped":  # the LSE cotangent left out of delta
        delta = fa._delta
        monkeypatch.setattr(fa, "_delta", lambda do4, o4, dlse: delta(
            do4, o4, None))
    else:
        _plant(mutant, tmp_path)
        monkeypatch.setattr(build, "CSRC", tmp_path)
        monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
        monkeypatch.setattr(build, "_LIBS", {})
    failed, late_failed = set(), set()
    for i, (label, shp) in enumerate(chip_smoke.SHAPES.items()):
        b, hq, hkv, sq, sk, d, shift = shp
        case = chip_smoke.make_case(fa, rope_tables, *shp, dev=dev, seed=i)
        for key, (name, rows, abs_err, scale) in chip_smoke.kernel_errors(
                fa, case).items():
            limit = (chip_smoke.LSE_ATOL if key == "lse"
                     else chip_smoke.ROW_RTOL)
            seq = sk if key in ("dk", "dv") else sq
            late = float(rows.view(-1, seq)[:, seq // 2:].max())
            worst = float(rows.max())
            old = abs_err / max(1.0, scale)  # the max-scaled limit, 2e-2
            with capsys.disabled():
                print(f"\n{mutant} | {label} | {key}: worst row {worst:.4g}, "
                      f"late half {late:.4g} (limit {limit:g}); max abs "
                      f"{abs_err:.4g} / max(1, max|plain|) = {old:.4g}",
                      end="")
            if worst > limit:
                failed.add(key)
            if late > limit:
                late_failed.add(key)
        del case
        torch.cuda.empty_cache()
    assert failed, f"{mutant}: every output within the limit"
    # a fault in a bf16 kernel fails that kernel's own outputs
    for kernel, outs in (("fwd_wgmma_kernel", {"out", "lse"}),
                         ("fwd_mma_kernel", {"out", "lse"}),
                         ("bwd_dq_wgmma_kernel", {"dq"}),
                         ("bwd_dq_mma_kernel", {"dq"}),
                         ("bwd_dkv_wgmma_kernel", {"dk", "dv"}),
                         ("bwd_dkv_mma_kernel", {"dk", "dv"})):
        if mutant in MUTANTS and _lands_in(mutant, kernel):
            assert failed & outs, f"{mutant}: {kernel}'s outputs passed"
    if mutant.endswith("mask_off_by_one"):
        assert late_failed >= {"out", "dq", "dk", "dv"}, late_failed


@cuda
def test_bf16_save_resume_on_the_card_is_bit_identical(dev, tmp_path):
    """A debug-size bf16 model (head_dim 64, so the tensor-core kernels
    run) preempted by SIGTERM after step 2 and auto-resumed to step 4 on
    the card: the losses and final params equal an uninterrupted run's."""
    import os
    import signal

    from picotron_tpu_torch import train
    from picotron_tpu_torch.config import config_from_dict

    def cfg(save_dir=None):
        raw = {"model": {"name": "debug-tiny", "hidden_size": 128,
                         "num_attention_heads": 2, "num_key_value_heads": 1,
                         "dtype": "bfloat16"},
               "training": {"seq_length": 128, "micro_batch_size": 2,
                            "gradient_accumulation_steps": 2,
                            "total_train_steps": 4, "learning_rate": 1e-3,
                            "adam_moments_dtype": "bfloat16", "remat": False,
                            "eval_frequency": 4, "eval_steps": 1}}
        if save_dir:
            raw["checkpoint"] = {"save_dir": str(save_dir),
                                 "auto_resume": True}
        return config_from_dict(raw)

    def preempt(step, metrics):
        first.append(metrics["loss"])
        if step == 2:
            os.kill(os.getpid(), signal.SIGTERM)

    first = []
    fa.reset_launch_counts()
    with pytest.raises(SystemExit) as e:
        train.run(cfg(tmp_path), "cuda", on_step=preempt)
    assert e.value.code == 75
    resumed = train.run(cfg(tmp_path), "cuda")
    assert resumed["start_step"] == 2
    # 4 layers x ga 2 x 4 steps, + the eval's 4 x 2 x 1 forward launches
    assert fa.launches == {"flash_fwd": 40, "flash_bwd_dq": 32,
                           "flash_bwd_dkv": 32}
    assert fa.fwd_launches == {"wgmma": 40, "tensor_core": 0, "cuda_core": 0}
    whole = train.run(cfg(), "cuda")
    assert first + resumed["losses"] == whole["losses"]
    assert resumed["val_losses"] == whole["val_losses"]
    for (n, p), q in zip(resumed["state"].model.named_parameters(),
                         whole["state"].model.parameters()):
        assert torch.equal(p, q), n


def _small_bf16_cfg(**training):
    from picotron_tpu_torch.config import config_from_dict

    return config_from_dict({
        "model": {"name": "debug-tiny", "hidden_size": 128,
                  "num_attention_heads": 2, "num_key_value_heads": 1,
                  "dtype": "bfloat16"},
        "training": {"seq_length": 128, "micro_batch_size": 2,
                     "gradient_accumulation_steps": 2, "remat": False,
                     "grad_engine": "ad", **training}})


@cuda
def test_gemm_accumulate_writes_in_place(dev):
    assert chip_smoke.gemm_accumulate_in_place(dev) <= 1e-5


@cuda
def test_fused_engine_matches_ad_on_the_card(dev):
    """chip_smoke phase 5(a) at debug size (head_dim 64: the tensor-core
    kernels): fused vs AD grads and GEMM-accumulate vs plain within
    GRAD_RTOL per tensor, the same loss; the fused step launches each
    kernel once per layer and microbatch."""
    out = chip_smoke.engine_parity(_small_bf16_cfg())
    assert out["worst_grad_rel_l2"] <= chip_smoke.GRAD_RTOL
    assert out["worst_gemm_vs_plain_rel_l2"] <= chip_smoke.GRAD_RTOL
    assert abs(out["loss_ad"] - out["loss_fused"]) <= chip_smoke.LOSS_ATOL
    from picotron_tpu_torch import train

    fa.reset_launch_counts()
    result = train.run(_small_bf16_cfg(remat=True, remat_policy="dots_attn",
                                       grad_engine="auto",
                                       total_train_steps=2), "cuda")
    assert len(result["losses"]) == 2
    # 4 layers x ga 2 x 2 steps
    assert fa.launches == {"flash_fwd": 16, "flash_bwd_dq": 16,
                           "flash_bwd_dkv": 16}
    assert fa.fwd_launches == {"wgmma": 16, "tensor_core": 0, "cuda_core": 0}


@cuda
def test_chunked_ce_on_the_card(dev):
    """chip_smoke phase 5(d) at a small size: within its limits, and the
    chunked CE's peak memory below the unchunked one's."""
    out = chip_smoke.chunked_ce_check(n=(2, 256), hidden=128, vocab=8192,
                                      chunk=1024)
    assert out["peak_gb"] < out["peak_gb_unchunked"]


# -- the AdamW kernel (csrc/adamw.cu) ----------------------------------------

# the bias correction of nu dropped: sqrt(v) in place of sqrt(v / c2)
ADAMW_MUTANT = (r"__fsqrt_rn\(__fdiv_rn\(v, h\.c2\)\)", "__fsqrt_rn(v)")


def test_adamw_mutant_site():
    """The planted AdamW fault finds exactly one site; no card needed."""
    src = (build.CSRC / "adamw.cu").read_text()
    assert len(re.findall(ADAMW_MUTANT[0], src)) == 1


@cuda
def test_adamw_kernel_matches_plain(dev):
    """chip_smoke phase 6(a)'s comparison: ragged sizes, both moment
    dtypes, clip under and over, grad_scale, ok True and False, with and
    without the compute copy, bit for bit."""
    from picotron_tpu_torch import optimizer as topt

    topt.reset_launch_counts()
    out = chip_smoke.adamw_vs_plain(dev)
    assert out["max_abs_err"] == 0.0 and out["max_ulp"] == 0
    assert topt.launches["adamw"] == out["cases"]


@cuda
def test_adamw_wrapper_raises_instead_of_falling_back(dev):
    from picotron_tpu_torch import optimizer as topt
    from picotron_tpu_torch.config import TrainingConfig

    t = TrainingConfig()
    h = topt.step_hyper(t, topt.make_lr(t), 0)
    def z(n=64, dt=torch.float32):
        return torch.zeros(n, dtype=dt, device=dev)

    with pytest.raises(ValueError, match="aligned"):
        topt.adamw_update(z(65)[1:], z(), z(), z(), h)
    with pytest.raises(ValueError, match="contiguous"):
        topt.adamw_update(z(128)[::2], z(), z(), z(), h)
    with pytest.raises(ValueError, match="fp32"):
        topt.adamw_update(z(dt=torch.bfloat16), z(), z(), z(), h)
    with pytest.raises(ValueError, match="mu and nu"):
        topt.adamw_update(z(), z(), z(dt=torch.float16), z(dt=torch.float16),
                          h)
    with pytest.raises(ValueError, match="grad_norm"):
        topt.adamw_update(z(), z(), z(), z(), h, grad_norm=torch.ones(1))
    with pytest.raises(ValueError, match="out"):
        topt.adamw_update(z(), z(), z(), z(), h, out=z())


@cuda
def test_planted_adamw_fault_fails(dev, tmp_path, monkeypatch):
    """A copy of adamw.cu with nu's bias correction dropped fails chip_smoke
    phase 6(a)'s bit-for-bit gate."""
    src = (build.CSRC / "adamw.cu").read_text()
    mutated, n = re.subn(ADAMW_MUTANT[0], ADAMW_MUTANT[1], src)
    assert n == 1
    (tmp_path / "adamw.cu").write_text(mutated)
    monkeypatch.setattr(build, "CSRC", tmp_path)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "_LIBS", {})
    with pytest.raises(AssertionError, match="adamw kernel vs plain"):
        chip_smoke.adamw_vs_plain(dev)


@cuda
def test_offload_trains_on_the_card(dev):
    """optimizer_offload at debug size on the card: the master and
    moments pinned on the host; every streamed step equal bit for bit to
    the plain update of the state before it (chip_smoke's
    `replay_offload_steps`: master, mu, nu and the bf16 compute copy);
    the masters moved; the AdamW kernel once per slice per step; and
    step 1's loss equal to the resident AdamW's bit for bit."""
    from picotron_tpu_torch import optimizer as topt
    from picotron_tpu_torch import train

    topt.reset_launch_counts()
    replays, state = [], {}
    real = train.build_state

    def build_state(cfg, d):
        out = real(cfg, d)
        state["opt"] = out[0].optimizer
        state["init"] = [m.clone() for m in state["opt"].master]
        chip_smoke.replay_offload_steps(state["opt"], replays)
        return out

    train.build_state = build_state
    try:
        off = train.run(_small_bf16_cfg(optimizer_offload=True,
                                        total_train_steps=3,
                                        learning_rate=1e-3), "cuda")
    finally:
        train.build_state = real
    opt = off["state"].optimizer
    assert isinstance(opt, topt.OffloadAdamW)
    assert opt.master[0].is_pinned() and opt.mu[0].is_pinned()
    assert opt.mu[0].device.type == "cpu"
    assert [r["step"] for r in replays] == [1, 2, 3]
    assert all(not r["mismatched"] for r in replays), replays
    assert all(not torch.equal(m, m0)
               for m, m0 in zip(opt.master, state["init"]))
    assert topt.launches["adamw"] == 3 * len(opt.slices)
    resident = train.run(_small_bf16_cfg(total_train_steps=1,
                                         learning_rate=1e-3), "cuda")
    assert resident["losses"][0] == off["losses"][0]


# the gates of chip_smoke phase 6b that each planted fault must fail (its
# failure messages), one entry per chip_smoke.OFFLOAD_FAULTS; the replay
# reads the grad buffer the fault zeroed, so it cannot see a lost grad,
# and the resident comparisons must
OFFLOAD_FAULT_GATES = {
    "moments_not_copied_back": ("replay:", "offload's roundings",
                                "resident update: step 3"),
    "embedding_slices_skipped": ("replay:", "offload's roundings",
                                 "resident update: step 1, embedding"),
    "embedding_grad_lost": ("offload's roundings",
                            "resident update: step 1, embedding"),
}


def chip_smoke_dir() -> str:
    import os

    return os.path.dirname(os.path.abspath(chip_smoke.__file__))


@pytest.fixture(scope="module")
def offload_refs():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return chip_smoke.offload_references(fa, chip_smoke_dir())


@cuda
@pytest.mark.parametrize("fault", chip_smoke.OFFLOAD_FAULTS)
def test_planted_offload_faults_fail(fault, offload_refs):
    """Phase 6b at its full size (the phase-3 config, 3 steps) with a
    fault planted in the offloaded optimizer fails the gates named
    above."""
    with pytest.raises(AssertionError) as err:
        chip_smoke.offload_vs_resident(fa, chip_smoke_dir(), offload_refs,
                                       fault)
    msg = str(err.value)
    for gate in OFFLOAD_FAULT_GATES[fault]:
        assert gate in msg, (gate, msg[:800])


@cuda
def test_cp_schedules_at_s2048_and_their_planted_fault(dev):
    """chip_smoke phase 8a at B 1, S 2048, Hq = Hkv = 32, D 128: the
    phase raises if a schedule leaves the per-row limits, launches other
    than its per-rank counts, or if the planted fault passes."""
    res = chip_smoke.cp_schedules_phase("test", shape=(1, 2048, 32, 32, 128))
    assert set(res["schedules"]) == set(chip_smoke.CP_SCHEDULES)
    for name, entry in res["schedules"].items():
        assert entry["launches_per_rank"] == [
            chip_smoke.CP_LAUNCHES[name](r) for r in range(chip_smoke.CP)]
        assert not chip_smoke.over_limits(entry["worst_row_vs_plain_blocks"])
    assert chip_smoke.over_limits(res["planted_fault"])


@cuda
def test_pipeline_walks_at_a_small_size_and_their_planted_fault(dev):
    """chip_smoke phase 9 at a small width (hidden 512, 8 heads of D 64,
    4 layers, seq 512, ga 4, bf16): the five walks of a 2-stage thread
    world against pp 1 on the card; the phase raises if a walk leaves
    the limits or a stage's launch counts, or if the planted fault
    passes."""
    raw = {"model": {"name": "Llama-2-7B", "hidden_size": 512,
                     "intermediate_size": 1376, "num_hidden_layers": 4,
                     "num_attention_heads": 8, "num_key_value_heads": 8,
                     "vocab_size": 1024, "max_position_embeddings": 512,
                     "dtype": "bfloat16"},
           "training": {"seq_length": 512, "micro_batch_size": 1,
                        "gradient_accumulation_steps": 4, "remat": True,
                        "adam_moments_dtype": "bfloat16"},
           "distributed": {"pp_size": 2}}
    res = chip_smoke.pp_phase("test", raw)
    assert set(res["walks"]) == set(chip_smoke.PP_WALKS) | {
        chip_smoke.PP_FAULT}
    for name in chip_smoke.PP_WALKS:
        entry = res["walks"][name]
        assert entry["loss_rel_err_max"] <= chip_smoke.PP_LOSS_RTOL
        assert [s["flash"]["flash_bwd_dq"] for s in entry["stages"]] == [
            len(s["layers"]) * 4 for s in entry["stages"]]
