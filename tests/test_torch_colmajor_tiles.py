"""``vectorize_colmajor``'s tile plan (``fcsr_tpu_torch/kernels/csrc/
triu.cu::colmajor_tiles``): a block per upper 32 x 32 tile and pair of
matrices that reads the tiles' rows and writes each column's entries as
one run of the output.

On the CPU the plan's Python twins are held to the plain version: the
output rebuilt from the column runs of every tile (``colmajor_tile_runs``)
writes each entry once and equals ``vectorize_colmajor_plain`` bit for bit
on matrices that are not symmetric and carry NaN and -0.0 entries; the
tile map ``sym_pair`` covers every tile once; ``colmajor_plan`` refuses
what the C entry refuses. The card test holds the kernel to the plain
version bit for bit (``pytest --noconftest -m cuda``: it needs no JAX).
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from fcsr_tpu_torch.kernels import KERNEL_OPS, PLAIN_OPS
from fcsr_tpu_torch.kernels.ops import (AV_MAX_B, AV_TILE, CM_MATS,
                                        colmajor_plan, colmajor_tile_runs,
                                        sym_pair, vectorize_colmajor_plain)

SIZES = (2, 3, 31, 32, 33, 64, 160, 268)
TRIU_CU = (Path(__file__).resolve().parents[1] / "fcsr_tpu_torch" /
           "kernels" / "csrc" / "triu.cu")


def _mats(B, n, seed):
    """(B, n, n) normal matrices, not symmetric, with -0.0 and NaN entries
    (one NaN with a payload) on both sides of the diagonal."""
    rng = np.random.default_rng(seed)
    m = rng.standard_normal((B, n, n)).astype(np.float32)
    flat = m.reshape(B, -1)
    flat[:, ::5] = -0.0
    flat[:, 3::11] = np.nan
    flat.view(np.int32)[:, 1::17] = 0x7FC00ABC
    return torch.from_numpy(m)


def _bits(t):
    return t.contiguous().view(torch.int32)


def _tiles(n):
    nt = -(-n // AV_TILE)
    return nt * (nt + 1) // 2


@pytest.mark.parametrize("n", SIZES)
def test_tile_runs_rebuild_the_output_once_each(n):
    B = 3
    m = _mats(B, n, n)
    L = n * (n - 1) // 2
    out = torch.full((B, L), 7.0)
    written = np.zeros(L, np.int64)
    for p in range(colmajor_plan(B, n)[0]):
        for j, i_first, start, count in colmajor_tile_runs(n, p):
            out[:, start:start + count] = m[:, i_first:i_first + count, j]
            written[start:start + count] += 1
    assert (written == 1).all()
    assert torch.equal(_bits(out), _bits(vectorize_colmajor_plain(m)))


@pytest.mark.parametrize("n", SIZES)
def test_runs_are_the_tiles_columns_above_the_diagonal(n):
    """Each run is one column j of the block's upper tile: rows from the
    tile's first to min(its last, j - 1), at j (j - 1) / 2 + i_first."""
    for p in range(_tiles(n)):
        ti, tj = sym_pair(p)
        i0, j0 = ti * AV_TILE, tj * AV_TILE
        runs = colmajor_tile_runs(n, p)
        assert [j for j, *_ in runs] == [
            j for j in range(j0, min(j0 + AV_TILE, n)) if j > i0]
        for j, i_first, start, count in runs:
            assert i_first == i0 and 1 <= count <= AV_TILE
            assert i0 + count == min(i0 + AV_TILE, j)
            assert start == j * (j - 1) // 2 + i0


@pytest.mark.parametrize("n", SIZES + (1300,))
def test_tile_map_covers_every_upper_tile_once(n):
    nt = -(-n // AV_TILE)
    got = [sym_pair(p) for p in range(colmajor_plan(1, n)[0])]
    assert len(got) == len(set(got))
    assert set(got) == {(ti, tj) for tj in range(nt) for ti in range(tj + 1)}


def test_plan_grid_at_the_predict_command_and_past_the_grid():
    """A block per tile and pair of matrices (``CM_MATS``); the grid's y
    extent stops at 65 535 pairs, past which blocks walk."""
    assert CM_MATS == 2
    assert colmajor_plan(112, 268) == (45, 56)
    assert colmajor_plan(167, 160) == (15, 84)
    assert colmajor_plan(1, 33) == (3, 1)
    assert colmajor_plan(65537, 3) == (1, 32769)
    assert colmajor_plan(131073, 3) == (1, 65535)
    assert colmajor_plan(AV_MAX_B, 2) == (1, 65535)


@pytest.mark.parametrize("B,n", [(1, 1), (1, 0), (0, 3), (-1, 3),
                                 (AV_MAX_B + 1, 3), (1, 32 * 65536)])
def test_plan_refuses_what_the_entry_refuses(B, n):
    """n < 2 writes nothing, B outside 1 .. 2^31 - 1 and 2^31 tiles or
    more (n > 2^21) do not fit the launch."""
    with pytest.raises(ValueError, match="vectorize_colmajor"):
        colmajor_plan(B, n)


def test_wrapper_takes_batches_past_the_grid_on_cpu():
    m = _mats(131073, 3, 1)
    got = KERNEL_OPS.vectorize_colmajor(m)
    assert got.shape == (131073, 3)
    assert torch.equal(_bits(got), _bits(m[:, [0, 0, 1], [1, 2, 2]]))


def test_kernel_source_is_the_tile_kernel():
    """The entry launches ``colmajor_tiles`` on the plan's grid (matrices
    a block as ``CM_MATS``); the one-thread-per-entry kernel with its
    square root is gone."""
    src = TRIU_CU.read_text()
    assert "colmajor_tiles<<<grid, AV_THREADS" in src
    assert f"constexpr int CM_MATS = {CM_MATS};" in src
    assert "vectorize_colmajor_kernel" not in src
    assert "sqrt(1.0 + 8.0" not in src


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run on the card "
                    "only (python3 chip_smoke.py checks them there)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n", (33, 268))
def test_kernel_matches_plain_on_card(cuda_device, n):
    m = _mats(5, n, 3)
    got = KERNEL_OPS.vectorize_colmajor(m.to(cuda_device)).cpu()
    assert torch.equal(_bits(got), _bits(PLAIN_OPS.vectorize_colmajor(m)))
