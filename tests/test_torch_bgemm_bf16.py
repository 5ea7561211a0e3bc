"""``bgemm_bf16`` on the card: every dense plan (tile x split-K) at every
product signature of the full-width bf16 GSR step against the plain
version, bit-equal launches, the plan's independence of the launch's fold
count under ``plan_folds``, and the 4-byte copies of an unaligned view.

Tolerance: the kernel and the plain version form the same exact products
of bf16 values and sum them in fp32 in other orders (split-K changes the
kernel's), so they agree within 1e-5 x max(scale, K), as ``chip_smoke.py``
holds them. Card only (``python3 -m pytest --noconftest -m cuda
tests/test_torch_bgemm_bf16.py`` on the card's machine)."""

from __future__ import annotations

import pytest
import torch

from fcsr_tpu_torch.kernels import KERNEL_OPS_BF16, PLAIN_OPS_BF16
from fcsr_tpu_torch.kernels.ops import (bgemm_bf16_forced, bgemm_bf16_path,
                                        bgemm_bf16_tiles, plan_folds)

SPLITS = (1, 2, 4)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run on the card "
                    "only (python3 chip_smoke.py checks them there)")
    return torch.device("cuda")


def _limit(want, K):
    return 1e-5 * max(1.0, float(want.abs().max()), float(K))


@pytest.mark.cuda
def test_every_plan_matches_plain_at_every_census_signature(cuda_device):
    """Each signature of the bf16 GSR step's census (F = 3, 160 -> 268)
    replayed with its operands' alignment: every forced plan within the
    tolerance of the plain version, two launches of a plan bit-equal, and
    without split-K the tiles bit-equal to each other (each output sums
    the same k16 steps in the same order); the picked plan likewise."""
    from fcsr_tpu_torch.kernels.census import gsr_step_census, replay

    dev = cuda_device
    census = gsr_step_census(dev, ops=KERNEL_OPS_BF16)
    g = torch.Generator(device=dev).manual_seed(11)
    tiles = bgemm_bf16_tiles()
    assert len(census.products) == 79
    dense = 0
    for prod in census.signatures():
        ops = replay(prod, census.layouts[prod], g, dev)
        bo = ops["bias"] is not None and prod.N == 1
        call = dict(ta=prod.ta, tb=prod.tb, bias=ops["bias"], add=ops["add"])
        want = PLAIN_OPS_BF16.bgemm(ops["a"], ops["b"], bias_operand=bo,
                                    **call)
        limit = _limit(want, prod.K)
        got = KERNEL_OPS_BF16.bgemm(ops["a"], ops["b"], bias_operand=bo,
                                    **call)
        assert float((got - want).abs().max()) <= limit, prod.label()
        if min(prod.M, prod.N) == 1 or prod.K <= 1:
            continue
        dense += 1
        unsplit = None
        for t in range(len(tiles)):
            for s in SPLITS:
                runs = [bgemm_bf16_forced(t, s, ops["a"], ops["b"], **call)
                        for _ in range(2)]
                torch.cuda.synchronize()
                assert torch.equal(runs[0], runs[1]), (prod.label(), t, s)
                err = float((runs[0] - want).abs().max())
                assert err <= limit, (prod.label(), t, s, err)
                if s == 1:
                    if unsplit is None:
                        unsplit = runs[0]
                    assert torch.equal(runs[0], unsplit), (prod.label(), t)
    assert dense == 31


@pytest.mark.cuda
def test_plan_under_plan_folds_does_not_depend_on_the_launch(cuda_device):
    """Under ``plan_folds(3)`` a launch over F = 1, 2 or 3 of the folds
    takes the plan of F = 3 and gives each fold the F = 3 launch's bits,
    at the shapes whose plan depends on F (30 and 61 rows: split-K)."""
    dev = cuda_device
    g = torch.Generator(device=dev).manual_seed(4)
    for M in (30, 61, 268):
        a = torch.randn(3, M, 268, generator=g, device=dev)
        b = torch.randn(3, 268, 268, generator=g, device=dev)
        bias = torch.randn(3, 1, 268, generator=g, device=dev)
        with plan_folds(3):
            paths = {bgemm_bf16_path(a[:F], b[:F], bias=bias[:F])
                     for F in (1, 2, 3)}
            outs = [KERNEL_OPS_BF16.bgemm(a[:F], b[:F], bias=bias[:F])
                    for F in (1, 2, 3)]
        assert len(paths) == 1, paths
        assert paths == {bgemm_bf16_path(a, b, bias=bias)}
        for F, out in zip((1, 2, 3), outs):
            assert torch.equal(out, outs[-1][:F]), (M, F)


@pytest.mark.cuda
def test_unaligned_views_take_the_4_byte_copies(cuda_device):
    """Operands that start 1-3 floats into a buffer, as the flat parameter
    buffers' views do, are copied 4 bytes at a time, in each layout."""
    dev = cuda_device
    g = torch.Generator(device=dev).manual_seed(9)
    F, M, N, K = 3, 61, 268, 268
    for off in (1, 2, 3):
        for ta in (False, True):
            for tb in (False, True):
                buf = torch.randn(F * M * K + off, generator=g, device=dev)
                a_shape = (F, K, M) if ta else (F, M, K)
                a = buf[off:].view(a_shape)
                b = torch.randn(*((F, N, K) if tb else (F, K, N)),
                                generator=g, device=dev)
                path = bgemm_bf16_path(a, b, ta, tb)
                assert path.endswith("4/16-byte copies"), path
                want = PLAIN_OPS_BF16.bgemm(a, b, ta, tb)
                got = KERNEL_OPS_BF16.bgemm(a, b, ta, tb)
                assert float((got - want).abs().max()) <= _limit(want, K)
    aligned = torch.randn(F, M, K, generator=g, device=dev)
    b = torch.randn(F, K, N, generator=g, device=dev)
    assert bgemm_bf16_path(aligned, b).endswith("16/16-byte copies")
