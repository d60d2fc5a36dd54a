"""K3 (dense SPD solve) of ceres_tpu_torch: the plain version against the
JAX package's Pallas kernel (ceres_tpu/ops/pallas_kernels.py
chol_solve_small, interpret mode on the CPU) and an f64 solve; the
wrapper's choice of variant (U in shared memory up to m = 223, else in
a global scratch, none past 1,024); and, on a card only, every CUDA
kernel against its plain version, K3's two variants bit for bit.

Tolerance 1e-4 relative, as test_chol_solve_small_interpret uses: an f32
factorization of an SPD matrix with condition number ~10^2.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity_kit import (ctt, main_path_options, rel, small_bal,
                              torch_problem)

from ceres_tpu.ops.pallas_kernels import chol_solve_small
from ceres_tpu_torch.ops.cost import snavely_sq, snavely_sq_plain
from ceres_tpu_torch.ops.kernels import (CHOL_VARIANTS, SMEM_OPTIN,
                                         _chol_launch, chol_smem_bytes,
                                         chol_solve, chol_solve_plain,
                                         chol_variant)
from ceres_tpu_torch.ops.lin import elim, elim_plain, lin, lin_plain
from ceres_tpu_torch.program import CompiledProgram
from ceres_tpu_torch.solvers.schur import detect_schur_structure
from ceres_tpu_torch.solvers.schur_fused import FusedSchurStep


def _spd(m, seed=None):
    """A seeded SPD system (S, b) of size m, condition number ~10^2."""
    rng = np.random.default_rng(m if seed is None else seed)
    A = rng.standard_normal((m, m + 4)).astype(np.float32)
    S = A @ A.T + m * np.eye(m, dtype=np.float32)
    return S, rng.standard_normal(m).astype(np.float32)


@pytest.mark.parametrize("m", [3, 24, 144, 160, 239])
def test_k3_plain_matches_jax_and_f64(m):
    S, b = _spd(m)
    y = chol_solve_plain(torch.as_tensor(S), torch.as_tensor(b)).numpy()
    y_jax = np.asarray(chol_solve_small(jnp.asarray(S), jnp.asarray(b)))
    y_64 = np.linalg.solve(S.astype(np.float64), b.astype(np.float64))
    assert rel(y, y_64) < 1e-4
    assert rel(y, y_jax) < 1e-4


@pytest.mark.parametrize("m", [3, 36, 144])
def test_k3_plain_batch_matches_single_solves(m):
    """The plain K3 on a batch of systems [B, m, m] (batch mode's
    reduced solves) gives each system's single-solve bits; an indefinite
    element gives NaN there alone."""
    systems = [_spd(m, seed) for seed in range(4)]
    S = torch.as_tensor(np.stack([a for a, _ in systems]))
    b = torch.as_tensor(np.stack([v for _, v in systems]))
    S[2, 0, 0] = -1.0
    y = chol_solve(S, b)
    for i in range(4):
        want = chol_solve_plain(S[i], b[i])
        assert torch.equal(y[i], want) or (
            i == 2 and torch.isnan(y[i]).all() and torch.isnan(want).all())
    assert not torch.isnan(y[[0, 1, 3]]).any()


def test_k3_indefinite_gives_nan():
    S = torch.as_tensor(np.diag([1.0, -1.0, 2.0]).astype(np.float32))
    y = chol_solve(S, torch.ones(3))
    assert torch.isnan(y).all()


@pytest.mark.parametrize("m, variant", [
    (1, "shared"), (144, "shared"), (160, "shared"), (191, "shared"),
    (223, "shared"), (224, "global"), (238, "global"), (512, "global"),
    (1024, "global")])
def test_k3_variant_at_the_shared_memory_edge(m, variant):
    """S with b as its column m, padded to 32 T rows of 32 T + 4 floats
    (T = ceil((m + 1) / 32)), fits in the 227 KB a block may opt in to up
    to m = 223; past it the global-scratch kernel."""
    assert chol_variant(m) == variant
    assert (chol_smem_bytes(m) <= SMEM_OPTIN) == (variant == "shared")


@pytest.mark.parametrize("m", [0, 1025])
def test_k3_refuses_m_outside_its_range(m):
    with pytest.raises(ValueError, match="outside 1..1024"):
        chol_variant(m)


def test_k3_variants_refuse_cpu_tensors():
    """The variants launch or raise: a CPU tensor is not taken."""
    S, b = (torch.as_tensor(a) for a in _spd(3))
    for variant in ("shared", "global"):
        with pytest.raises(ValueError, match="expected a CUDA tensor"):
            _chol_launch(S, b, variant)


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 2, 3, 15, 16, 17, 24, 31, 32, 143, 144,
                               150, 159, 160, 191, 223, 224, 238, 512,
                               1024])
def test_cuda_k3_bit_equal_to_plain(m):
    """K3 on the card (the variant chol_variant picks) gives the plain
    version's bits on the card, and the global variant does at every m."""
    _cuda_or_skip()
    S, b = (torch.as_tensor(a).cuda() for a in _spd(m))
    want = chol_solve_plain(S, b)
    n0 = [CHOL_VARIANTS[v].launches for v in ("shared", "global")]
    total0 = chol_solve.launches
    got = chol_solve(S, b)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    shared = chol_variant(m) == "shared"
    assert [CHOL_VARIANTS[v].launches - n for v, n in
            zip(("shared", "global"), n0)] == [int(shared), int(not shared)]
    assert chol_solve.launches == total0 + 1
    if shared:
        assert torch.equal(_chol_launch(S, b, "global"), want)
    assert torch.equal(chol_solve(S, b), got)
    y64 = np.linalg.solve(S.double().cpu().numpy(),
                          b.double().cpu().numpy())
    assert rel(got.cpu().numpy(), y64) < 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("m", [3, 144, 223, 224, 512])
def test_cuda_k3_batch_one_launch_bit_equal_to_plain(m):
    """K3 on a batch of 16 systems in one launch (both variants) gives
    the plain version's bits on each."""
    _cuda_or_skip()
    systems = [_spd(m, seed) for seed in range(16)]
    S = torch.as_tensor(np.stack([a for a, _ in systems])).cuda()
    b = torch.as_tensor(np.stack([v for _, v in systems])).cuda()
    want = chol_solve_plain(S, b)
    total0 = chol_solve.launches
    got = chol_solve(S, b)
    torch.cuda.synchronize()
    assert chol_solve.launches == total0 + 1
    assert torch.equal(got, want)
    if chol_variant(m) == "shared":
        assert torch.equal(_chol_launch(S, b, "global"), want)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [3, 144, 160, 223, 512])
def test_cuda_k3_indefinite_gives_nan_on_both_variants(m):
    _cuda_or_skip()
    S, b = (torch.as_tensor(a).cuda() for a in _spd(m))
    S[m // 2, m // 2] = -1.0
    variants = ["global"]
    if chol_variant(m) == "shared":
        variants.append("shared")
    for variant in variants:
        y = _chol_launch(S, b, variant)
        torch.cuda.synchronize()
        assert torch.isnan(y).all(), variant


@pytest.mark.cuda
def test_cuda_kernels_match_plain_versions():
    """Each CUDA kernel against its plain version on the card, on the
    small problem (limits as chip_smoke.py: 1e-5 in f32, 1e-12 in f64).
    Run on a machine with a card: python -m pytest tests -m cuda."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    opts = main_path_options(ctt, device="cuda")
    program = CompiledProgram(torch_problem(small_bal()), device="cuda")
    step = FusedSchurStep(program, opts,
                          detect_schur_structure(program, opts))
    x = program.initial_state()
    ne, nf = step.ne, step.nf
    xe = x[step.e_slab:step.e_slab + 3 * ne].view(ne, 3).float()
    xf = x[step.f_slab:step.f_slab + nf].float()
    se0, sf0 = step.initial_scales()
    got = lin(xf, xe, step.cam, step.mask, step.dat, se0, True,
              plan=step.plan)
    want = lin_plain(xf, xe, step.cam, step.mask, step.dat[..., 0],
                     step.dat[..., 1], se0, True)
    for k in want:
        assert rel(got[k].cpu(), want[k].cpu()) <= 1e-5, k
    art = step.linearize(x, se0, sf0, True)
    eargs = (art.A, art.etes, art.gse, art.diag_e, 1e4)
    for a, b in zip(elim(*eargs), elim_plain(*eargs)):
        assert rel(a.cpu(), b.cpu()) <= 1e-5
    S, rhs, _, _ = step.reduced_system(art, 1e4)
    assert torch.equal(chol_solve(S, rhs), chol_solve_plain(S, rhs))
    assert rel(snavely_sq(x, step.k4).cpu(),
               snavely_sq_plain(x, step.k4).cpu()) <= 1e-12


def _fast_math(x, d, sqrt):
    """csrc/chol.cu's div_fast / sqrt_fast beside __fdiv_rn / __fsqrt_rn
    on the card: (fast, exact, in range)."""
    from ceres_tpu_torch.ops import _cuda
    fast, exact = torch.empty_like(x), torch.empty_like(x)
    flag = torch.empty(x.shape, dtype=torch.int32, device=x.device)
    _cuda.launch("ceres_fast_math_check", x, d, x.numel(), int(sqrt), fast,
                 exact, flag)
    torch.cuda.synchronize()
    return fast, exact, flag.bool()


def _floats(bits):
    """The floats with these bit patterns (int64 tensor, 0 <= bits < 2^32)."""
    bits = torch.where(bits >= 1 << 31, bits - (1 << 32), bits)
    return bits.to(torch.int32).view(torch.float32)


@pytest.mark.cuda
def test_cuda_k3_fast_sqrt_gives_the_ieee_bits_in_its_range():
    """Every float in [2^-60, 2^64) with exponents of both parities (the
    fast square root depends only on the mantissa and the exponent's
    parity inside its range), and random bit patterns everywhere: the
    same bits as __fsqrt_rn wherever the range check admits the input,
    and admitted throughout [2^-60, 2^60)."""
    _cuda_or_skip()
    mant = torch.arange(1 << 23, device="cuda", dtype=torch.int64)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for exps in ((67, 68), (127, 128), (185, 186)):
        for e in exps:
            x = _floats((e << 23) | mant)
            fast, exact, ok = _fast_math(x, x, True)
            assert ok.all()
            assert torch.equal(fast.view(torch.int32), exact.view(torch.int32))
    x = _floats(torch.randint(0, 1 << 31, (1 << 24,), device="cuda",
                              generator=gen))
    fast, exact, ok = _fast_math(x, x, True)
    assert torch.equal(fast[ok].view(torch.int32),
                       exact[ok].view(torch.int32))


@pytest.mark.cuda
def test_cuda_k3_fast_division_gives_the_ieee_bits_in_its_range():
    """Every divisor mantissa (2^23 of them) against random numerators,
    at exponents across the admitted range, and random operands over the
    whole range of floats: the same bits as __fdiv_rn wherever the range
    check admits the operands; zeros keep their sign."""
    _cuda_or_skip()
    mant = torch.arange(1 << 23, device="cuda", dtype=torch.int64)
    gen = torch.Generator(device="cuda").manual_seed(1)
    n = 1 << 23
    for ed, ex in ((127, 127), (67, 186), (186, 67), (100, 150), (150, 90)):
        d = _floats((ed << 23) | mant)
        for _ in range(8):
            xm = torch.randint(0, 1 << 23, (n,), device="cuda", generator=gen)
            sign = torch.randint(0, 2, (n,), device="cuda", generator=gen)
            x = _floats((sign << 31) | (ex << 23) | xm)
            fast, exact, ok = _fast_math(x, d, False)
            assert ok.all()
            assert torch.equal(fast.view(torch.int32),
                               exact.view(torch.int32))
    for _ in range(8):
        x = _floats(torch.randint(0, 1 << 32, (n,), device="cuda",
                                  generator=gen))
        d = _floats(torch.randint(0, 1 << 31, (n,), device="cuda",
                                  generator=gen))
        fast, exact, ok = _fast_math(x, d, False)
        assert ok.sum() > n // 8
        assert torch.equal(fast[ok].view(torch.int32),
                           exact[ok].view(torch.int32))
    zeros = torch.tensor([0.0, -0.0], device="cuda")
    fast, exact, ok = _fast_math(zeros, torch.ones(2, device="cuda"), False)
    assert ok.all() and torch.equal(fast.view(torch.int32),
                                    exact.view(torch.int32))


@pytest.mark.cuda
def test_cuda_k3_shared_variant_refuses_past_its_edge():
    """A launch the variant's entry point refuses raises: no fallback."""
    _cuda_or_skip()
    S, b = (torch.as_tensor(a).cuda() for a in _spd(224))
    with pytest.raises(RuntimeError, match="CUDA launch failed"):
        _chol_launch(S, b, "shared")
