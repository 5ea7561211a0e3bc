"""The symmetric pair of the GSR tail: ``sym_abs_fill`` (|fill_diag((X +
X^T) / 2, 1)|) and its adjoint ``sym_sign_grad`` (``fcsr_tpu_torch/
kernels/csrc/tail.cu``), a block per unordered pair of mirrored tiles.

Their host-side launch plan (``ops.sym_tiles_plan``): the tile pairs and
the grid at widths on and off the tile edge, 16-byte accesses only where
m % 4 == 0 and the operands are aligned, and what no launch can take is
refused. The device's map from a block to its tile pair, as its Python
twin (``ops.sym_pair``, the same float square root and integer
correction), covers every pair exactly once.

Then the plain versions, which the kernels are held to bit for bit on the
card: against the JAX package's ``jnp.abs(fill_diagonal(symmetrize(x),
1.0))`` (``fcsr_tpu.core.normalize``) and its ``jax.vjp``, eager and
jitted, bit for bit, on inputs with exact zeros, -0.0, pairs x_ij = -x_ji,
a NaN (off and on the diagonal), +-inf and an inf - inf pair in the
cotangent; and their outputs bitwise symmetric.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fcsr_tpu.core.normalize import fill_diagonal, symmetrize
from fcsr_tpu_torch.kernels import KERNEL_OPS, PLAIN_OPS
from fcsr_tpu_torch.kernels.ops import (SYM_MAX_F, SYM_TILE,
                                        sym_check_inputs, sym_pair,
                                        sym_tiles_plan)

TAIL_CU = (Path(__file__).resolve().parents[1] / "fcsr_tpu_torch" /
           "kernels" / "csrc" / "tail.cu")
WIDTHS = (1, 31, 32, 33, 268, 270)
FOLDS = (1, 3, 56)
# (F, m) of the plain versions against JAX: the tiny config's width, the
# full width (the GSR tail's 268) and an odd one
JAX_SHAPES = ((3, 32), (3, 268), (2, 33))


def _inputs(F, m, seed):
    """(x, g) float32 (F, m, m) with the special values every case carries
    (``ops.sym_check_inputs``, which chip_smoke.py's card check draws
    too)."""
    return sym_check_inputs(F, m, seed)


def _assert_bits(got, want):
    """NaN where NaN, the same float32 bits everywhere else."""
    got = np.asarray(got, dtype=np.float32)
    want = np.asarray(want, dtype=np.float32)
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(got[~nan].view(np.int32),
                                  want[~nan].view(np.int32))


def _jax_fill(x):
    return jnp.abs(fill_diagonal(symmetrize(x), 1.0))


def _jax_vjp(x, g):
    return jax.vjp(_jax_fill, x)[1](g)[0]


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("F", FOLDS)
@pytest.mark.parametrize("m", WIDTHS)
def test_plan_pairs_and_grid(m, F):
    plan = sym_tiles_plan(F, m, True)
    nt = -(-m // SYM_TILE)
    # one block per unordered tile pair, per fold
    assert plan.pairs == nt * (nt + 1) // 2
    assert plan.grid == (plan.pairs, F)
    # the tiles cover m, and no tile lies wholly past it
    assert nt * SYM_TILE >= m > (nt - 1) * SYM_TILE
    assert plan is sym_tiles_plan(F, m, True)      # pure, cached


def test_plan_at_the_gsr_tail():
    """3 x 268 x 268: 9 tiles a side, 45 pairs (9 of them diagonal), 135
    blocks, 16-byte accesses on aligned operands."""
    plan = sym_tiles_plan(3, 268, True)
    assert plan == (45, (45, 3), True)


@pytest.mark.parametrize("m", WIDTHS)
@pytest.mark.parametrize("aligned", (True, False))
def test_plan_16_byte_only_where_allowed(m, aligned):
    assert sym_tiles_plan(3, m, aligned).vec is (aligned and m % 4 == 0)


@pytest.mark.parametrize("args", (
    (0, 268, True), (3, 0, True), (SYM_MAX_F + 1, 268, True),
    (3, 2 ** 16 * SYM_TILE, True)), ids=str)
def test_plan_refusals(args):
    """No fold, no width, more folds than the grid's y extent, more tile
    pairs than its x extent."""
    with pytest.raises(ValueError):
        sym_tiles_plan(*args)


def test_plan_at_the_grid_limits():
    assert sym_tiles_plan(SYM_MAX_F, 268, True).grid == (45, SYM_MAX_F)
    nt = 2 ** 16 - 1
    assert sym_tiles_plan(1, nt * SYM_TILE, False).pairs \
        == nt * (nt + 1) // 2 < 2 ** 31


def test_grid_stride_kernels_are_gone():
    src = TAIL_CU.read_text()
    assert "sym_abs_fill_kernel" not in src
    assert "sym_sign_grad_kernel" not in src
    assert src.count("sym_tiles_kernel<") >= 2


# ---------------------------------------------------------------------------
# the device's pair map
# ---------------------------------------------------------------------------

def test_pair_map_covers_every_pair_once():
    """p -> (ti, tj) with p = tj (tj + 1) / 2 + ti, 0 <= ti <= tj: for
    every nt up to 400 the first nt (nt + 1) / 2 blocks take each pair of
    an nt-tile side exactly once."""
    n_max = 400
    total = n_max * (n_max + 1) // 2
    pairs = np.array([sym_pair(p) for p in range(total)])
    ti, tj = pairs[:, 0], pairs[:, 1]
    assert (0 <= ti).all() and (ti <= tj).all()
    # the pair gives back its block: no two blocks share a pair
    np.testing.assert_array_equal(tj * (tj + 1) // 2 + ti, np.arange(total))
    # tj never decreases, so the first nt (nt + 1) / 2 blocks are that
    # many distinct pairs with tj < nt: every pair of the grid, once
    assert (np.diff(tj) >= 0).all()
    for nt in range(1, n_max + 1):
        count = nt * (nt + 1) // 2
        assert tj[count - 1] == nt - 1
        assert count == total or tj[count] == nt


@pytest.mark.parametrize("p", (2 ** 24 - 1, 2 ** 24 + 1, 10 ** 9,
                               2 ** 31 - 2))
def test_pair_map_is_exact_past_float_precision(p):
    """Where 8p + 1 no longer fits a float exactly, the integer
    correction still gives the exact pair."""
    ti, tj = sym_pair(p)
    assert 0 <= ti <= tj and tj * (tj + 1) // 2 + ti == p


# ---------------------------------------------------------------------------
# the plain versions against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("jit", (False, True), ids=("eager", "jit"))
@pytest.mark.parametrize("shape", JAX_SHAPES, ids=lambda s: "{}x{}".format(*s))
def test_sym_abs_fill_plain_equals_jax(shape, jit):
    x, _ = _inputs(*shape, seed=1)
    fn = jax.jit(_jax_fill) if jit else _jax_fill
    want = np.asarray(fn(jnp.asarray(x)))
    _assert_bits(PLAIN_OPS.sym_abs_fill(torch.from_numpy(x)), want)


@pytest.mark.parametrize("jit", (False, True), ids=("eager", "jit"))
@pytest.mark.parametrize("shape", JAX_SHAPES, ids=lambda s: "{}x{}".format(*s))
def test_sym_sign_grad_plain_equals_jax_vjp(shape, jit):
    """c = 1/2 is the vjp of sym_abs_fill; c = 1 (the tail's second call,
    the factor 2 of a symmetric cotangent folded in) exactly twice it."""
    x, g = _inputs(*shape, seed=2)
    fn = jax.jit(_jax_vjp) if jit else _jax_vjp
    want = np.asarray(fn(jnp.asarray(x), jnp.asarray(g)))
    xt, gt = torch.from_numpy(x), torch.from_numpy(g)
    _assert_bits(PLAIN_OPS.sym_sign_grad(gt, xt, 0.5), want)
    _assert_bits(PLAIN_OPS.sym_sign_grad(gt, xt, 1.0),
                 np.float32(2.0) * want)


@pytest.mark.parametrize("shape", JAX_SHAPES + ((1, 268), (3, 270)),
                         ids=lambda s: "{}x{}".format(*s))
def test_outputs_are_bitwise_symmetric(shape):
    x, g = _inputs(*shape, seed=3)
    xt, gt = torch.from_numpy(x), torch.from_numpy(g)
    outs = [KERNEL_OPS.sym_abs_fill(xt)] + [
        KERNEL_OPS.sym_sign_grad(gt, xt, c) for c in (0.5, 1.0)]
    for out in outs:
        _assert_bits(out, out.transpose(1, 2))
    # the diagonal: 1 in the forward, +0 in the adjoint, whatever x_ii
    eye = np.eye(shape[1], dtype=bool)
    assert (outs[0].numpy()[:, eye] == 1.0).all()
    for out in outs[1:]:
        assert (out.numpy()[:, eye].view(np.int32) == 0).all()
    # NaN only where sym x is NaN (forward: a NaN entry, inf - inf) and
    # where g has inf - inf (adjoint; a NaN x only flips the sign)
    F, m = shape
    nan_fill = {(0, m - 1, 1), (0, 1, m - 1), (F - 1, 1, m - 2),
                (F - 1, m - 2, 1)}
    assert set(map(tuple, np.argwhere(np.isnan(outs[0].numpy())))) \
        == nan_fill
    for out in outs[1:]:
        assert set(map(tuple, np.argwhere(np.isnan(out.numpy())))) \
            == {(0, 4, 7), (0, 7, 4)}


def test_cpu_wrappers_take_the_plain_versions():
    x, g = _inputs(2, 33, seed=4)
    xt, gt = torch.from_numpy(x), torch.from_numpy(g)
    _assert_bits(KERNEL_OPS.sym_abs_fill(xt), PLAIN_OPS.sym_abs_fill(xt))
    _assert_bits(KERNEL_OPS.sym_sign_grad(gt, xt, 0.5),
                 PLAIN_OPS.sym_sign_grad(gt, xt, 0.5))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run on the card "
                    "only (python3 chip_smoke.py checks them there)")
    return torch.device("cuda")


def _graphed(fn):
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    graph.replay()
    torch.cuda.synchronize()
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("off", (0, 1), ids=("aligned", "1-float-off"))
@pytest.mark.parametrize("shape", ((3, 268), (1, 268), (3, 270), (3, 33)),
                         ids=lambda s: "{}x{}".format(*s))
def test_kernels_match_plain_on_card(cuda_device, shape, off):
    """Each kernel bit for bit with its plain version, eager and graphed,
    on aligned operands and on views 1 float off 16 bytes (the 4-byte
    path)."""
    x, g = _inputs(*shape, seed=5)

    def put(a):
        buf = torch.empty(a.size + off, device=cuda_device)
        view = buf[off:].view(a.shape)
        view.copy_(torch.from_numpy(a))
        return view
    xd, gd = put(x), put(g)
    calls = [(lambda: KERNEL_OPS.sym_abs_fill(xd),
              PLAIN_OPS.sym_abs_fill(xd))]
    for c in (0.5, 1.0):
        calls.append((lambda c=c: KERNEL_OPS.sym_sign_grad(gd, xd, c),
                      PLAIN_OPS.sym_sign_grad(gd, xd, c)))
    for kern, want in calls:
        want = want.cpu().numpy()
        _assert_bits(kern().cpu().numpy(), want)
        _assert_bits(_graphed(kern).cpu().numpy(), want)
