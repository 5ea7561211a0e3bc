"""The CSV path's triangle scatter as mirrored tile pairs
(``anti_vectorize_normalize``, ``fcsr_tpu_torch/kernels/csrc/triu.cu``)
and the upsampler softmax's adjoint in ``col_softmax``'s column blocks
(``col_softmax_bwd``, ``gat.cu``).

The scatter's blocks each stage one upper tile of a pair of mirrored
32 x 32 tiles from the runs of ``v`` that ``ops.antivec_tile_runs`` lists
(the kernel computes the same indices) and write the tile and its mirror.
A Python emulation of that walk rebuilds the plain version bit for bit,
reading every entry of ``v`` once and writing every output entry once, at
n = 2 to 268 with trailing entries and a row stride past the vector's
length. Normalised, a cluster per matrix splits the pairs by
``ops.antivec_plan``: the emulation of its partial row sums, added in
rank order, agrees with the plain version to 1e-6 of its scale, the guard
(a zero row sum gives 0, a negative one NaN) included. The plans cover
every pair and row, take batches past the grid's y extent, and refuse
what the grid or a block's shared memory cannot take.

``col_softmax_bwd`` runs ``col_softmax_plan``: an emulation of its warps'
rows and their meeting in warp order covers every row once and agrees
with the plain version to 1e-6 at R = 1 to 5000; the plain version agrees
with ``jax.vjp`` of the JAX package's upsampler softmax
(``fcsr_tpu/models/fused_gat.py:319-322``) to 1e-6 of its largest entry.

The kernels against their plain versions run on the card only
(``cuda``-marked; ``pytest --noconftest -m cuda``): the JAX side loads
inside the test that compares with it, so the module collects where the
JAX package's dependencies are not installed.
"""

import importlib

import numpy as np
import pytest
import torch

from fcsr_tpu_torch.kernels import KERNEL_OPS, KERNELS, PLAIN_OPS
from fcsr_tpu_torch.kernels.ops import (AV_MAX_B, AV_CHUNK, AV_TILE,
                                        AV_TILE_BYTES,
                                        CSM_MAX_WARPS, CSM_PER, MAX_CLUSTER,
                                        antivec_plan, antivec_tile_runs,
                                        col_softmax_plan, sym_pair)

H100_SMEM = 232448      # an H100's opt-in shared memory per block
H100_SMS = 132          # and its SMs
RUN_SIZES = (2, 3, 31, 32, 33, 64, 160, 268)
# the CSV path's three launches: (B, n)
CSV_SHAPES = ((167, 160), (167, 268), (112, 160))


def _vectors(B, n, seed, extra=3, pad=5):
    """(B, m + extra) vectors (trailing entries) as a view of rows
    ``pad`` floats longer (a row stride past the length), with -0.0
    entries; values in [0, 1)."""
    m = n * (n - 1) // 2
    rng = np.random.default_rng(seed)
    buf = rng.random((B, m + extra + pad)).astype(np.float32)
    buf[:, ::7] = -0.0
    return torch.from_numpy(buf)[:, :m + extra]


def _bits(t):
    return t.contiguous().view(torch.int32)


def _pairs(n):
    nt = -(-n // AV_TILE)
    return nt * (nt + 1) // 2


def _emulate_stage(v_row, n, p, reads):
    """The kernel's staged upper tile of pair p (``av_stage``), v's reads
    counted."""
    ti, tj = sym_pair(p)
    i0, j0 = ti * AV_TILE, tj * AV_TILE
    s = np.zeros((AV_TILE, AV_TILE), np.float32)
    for i, j_first, start, count in antivec_tile_runs(n, p):
        s[i - i0, j_first - j0:j_first - j0 + count] = \
            v_row[start:start + count] + np.float32(0.0)
        reads[start:start + count] += 1
    return s, i0, j0


def _emulate_tiles(s, i0, j0, diag):
    """(tile at (i0, j0), its mirror or None) as ``av_entry`` reads them."""
    if i0 != j0:
        return s, s.T
    r, c = np.indices(s.shape)
    return np.where(c > r, s, np.where(c < r, s.T, np.float32(diag))), None


def _emulate_copy(v, n, diag):
    """The copy form, block by block: (out, reads of each v entry, writes
    of each output entry)."""
    v = v.numpy()
    B = v.shape[0]
    out = np.full((B, n, n), np.nan, np.float32)
    reads = np.zeros(v.shape, np.int64)
    writes = np.zeros((B, n, n), np.int64)
    for b in range(B):
        for p in range(_pairs(n)):
            s, i0, j0 = _emulate_stage(v[b], n, p, reads[b])
            tile, mirror = _emulate_tiles(s, i0, j0, diag)
            for (a, r0, c0) in ((tile, i0, j0), (mirror, j0, i0)):
                if a is None:
                    continue
                rows, cols = min(AV_TILE, n - r0), min(AV_TILE, n - c0)
                out[b, r0:r0 + rows, c0:c0 + cols] = a[:rows, :cols]
                writes[b, r0:r0 + rows, c0:c0 + cols] += 1
    return out, reads, writes


@pytest.mark.parametrize("fill", (0.0, 1.0))
@pytest.mark.parametrize("n", RUN_SIZES)
def test_tile_runs_rebuild_the_plain_copy_bit_for_bit(n, fill):
    v = _vectors(2, n, n)
    m = n * (n - 1) // 2
    out, reads, writes = _emulate_copy(v, n, fill)
    assert (reads[:, :m] == 1).all() and (reads[:, m:] == 0).all()
    assert (writes == 1).all()
    want = PLAIN_OPS.anti_vectorize_normalize(v, n, False, fill)
    assert torch.equal(_bits(torch.from_numpy(out)), _bits(want))
    # -0.0 became +0.0, as the reference's upper + upper^T makes it
    assert not torch.signbit(want).any()


@pytest.mark.parametrize("n", RUN_SIZES)
def test_tile_runs_are_rows_of_the_upper_tile(n):
    """Each run lies in one row of its pair's upper tile, strictly above
    the diagonal, and the pairs' runs tile the triangle."""
    seen = set()
    for p in range(_pairs(n)):
        ti, tj = sym_pair(p)
        for i, j_first, start, count in antivec_tile_runs(n, p):
            assert ti * AV_TILE <= i < min(ti * AV_TILE + AV_TILE, n)
            assert tj * AV_TILE <= j_first and i < j_first
            assert j_first + count <= min(tj * AV_TILE + AV_TILE, n)
            assert start == i * n - i * (i + 1) // 2 + j_first - i - 1
            seen.update((i, j) for j in range(j_first, j_first + count))
    assert seen == {(i, j) for i in range(n) for j in range(i + 1, n)}


def _emulate_normalized(v, n, diag, plan):
    """The normalised forms: each rank's pairs (``plan.per_block`` from
    rank x per_block), its partial row sums pair by pair, the partials of
    a row added in rank order, the guarded root, (a r_i) r_j."""
    v = v.numpy()
    B = v.shape[0]
    out = np.zeros((B, n, n), np.float32)
    owner = {}
    for b in range(B):
        reads = np.zeros(v.shape[1], np.int64)
        parts = np.zeros((plan.cluster, n), np.float32)
        staged = {}
        for rank in range(plan.cluster):
            for p in range(rank * plan.per_block,
                           min(_pairs(n), (rank + 1) * plan.per_block)):
                owner.setdefault(p, rank)
                assert owner[p] == rank
                s, i0, j0 = _emulate_stage(v[b], n, p, reads)
                tile, mirror = _emulate_tiles(s, i0, j0, diag)
                staged[p] = (tile, mirror, i0, j0)
                for a, r0 in ((tile, i0), (mirror, j0)):
                    if a is None:
                        continue
                    rows = min(AV_TILE, n - r0)
                    parts[rank, r0:r0 + rows] += a.sum(1, dtype=np.float32
                                                       )[:rows]
        rowsum = np.zeros(n, np.float32)
        for rank in range(plan.cluster):
            rowsum += parts[rank]
        with np.errstate(divide="ignore", invalid="ignore"):
            r = np.where(rowsum == 0, np.float32(0),
                         np.float32(1) / np.sqrt(rowsum)).astype(np.float32)
        for tile, mirror, i0, j0 in staged.values():
            for a, r0, c0 in ((tile, i0, j0), (mirror, j0, i0)):
                if a is None:
                    continue
                rows, cols = min(AV_TILE, n - r0), min(AV_TILE, n - c0)
                out[b, r0:r0 + rows, c0:c0 + cols] = (
                    a[:rows, :cols] * r[r0:r0 + rows, None]) \
                    * r[None, c0:c0 + cols]
    assert sorted(owner) == list(range(_pairs(n)))
    return torch.from_numpy(out)


def _guard_vectors(n):
    """Vectors whose row 1 sums to zero and row 2 to a negative number."""
    dense = np.random.default_rng(n).random((2, n, n)).astype(np.float32)
    dense = dense + dense.transpose(0, 2, 1)
    dense[:, 1, :] = dense[:, :, 1] = 0.0
    dense[:, 2, 5] = dense[:, 5, 2] = -4.0 * n
    rows, cols = np.triu_indices(n, 1)
    return torch.from_numpy(np.ascontiguousarray(dense[:, rows, cols]))


def _assert_close_nan(got, want, tol):
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    ok = ~torch.isnan(want)
    scale = max(1.0, float(want[ok].abs().max()))
    assert float((got[ok] - want[ok]).abs().max()) <= tol * scale


@pytest.mark.parametrize("n,fill", ((2, 0.0), (31, 1.0), (33, 1.0),
                                    (64, 0.0), (100, 0.0), (160, 0.0),
                                    (200, 1.0), (268, 1.0)))
def test_normalized_cluster_emulation_matches_plain(n, fill):
    """The cluster's blocks, each summing its own pairs' rows, their
    partials added in rank order."""
    v = _vectors(2, n, n + 1)
    _assert_close_nan(_emulate_normalized(v, n, fill,
                                          antivec_plan(2, n, True, H100_SMEM, H100_SMS)),
                      PLAIN_OPS.anti_vectorize_normalize(v, n, True, fill),
                      1e-6)


@pytest.mark.parametrize("n", (8, 33, 70))
def test_normalized_emulation_keeps_the_guard(n):
    v = _guard_vectors(n)
    got = _emulate_normalized(v, n, 0.0, antivec_plan(2, n, True, H100_SMEM, H100_SMS))
    want = PLAIN_OPS.anti_vectorize_normalize(v, n, True)
    _assert_close_nan(got, want, 1e-6)
    assert bool((got[:, 1, 3] == 0).all()) and bool(torch.isnan(got[:, 2])
                                                    .all())
    assert bool(torch.isfinite(got[:, 3, 4]).all())


# ---------------------------------------------------------------------------
# the plans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", RUN_SIZES + (1000, 1300, 4096))
def test_copy_plan_is_a_block_per_pair(n):
    plan = antivec_plan(167, n, False, 0, 0)
    assert plan == (0, (_pairs(n), 167), 1, 1, n % 4 == 0, 0)


@pytest.mark.parametrize("B", (1, 3, 112, 167, 1000, 65536))
@pytest.mark.parametrize("n", RUN_SIZES + (1000, 1300, 4096, 20000))
def test_normalized_plan_covers_every_pair(n, B):
    pairs = _pairs(n)
    plan = antivec_plan(B, n, True, H100_SMEM, H100_SMS)
    C, per = plan.cluster, plan.per_block
    assert plan.form == 1 and 1 <= C <= min(MAX_CLUSTER, pairs)
    # every pair with its block, no block left without one
    assert C * per >= pairs > (C - 1) * per
    # a block's pairs make one chunk where 16 blocks allow
    assert (per <= AV_CHUNK) == (pairs <= MAX_CLUSTER * AV_CHUNK)
    # two blocks an SM, unless the pairs are already spread as thin as 16
    # blocks spread them
    if B * C < 2 * H100_SMS:
        assert per == -(-pairs // min(MAX_CLUSTER, pairs))
    # and no more blocks than the two rules need
    if C > 1:
        assert -(-pairs // (C - 1)) > AV_CHUNK or B * (C - 1) < 2 * H100_SMS
    assert plan.grid == (C, min(B, 65535))
    assert plan.vec == (n % 4 == 0)
    assert plan.smem == 4 * (2 * n + -(-n // AV_TILE)) \
        + AV_CHUNK * AV_TILE_BYTES <= H100_SMEM


def test_plan_at_the_csv_shapes_and_shared_memory_limits():
    # the CSV path's shapes: 45 pairs over 6 blocks at n = 268, 15 over 2
    # at n = 160, or over 3 at B = 112 (two blocks an SM)
    assert antivec_plan(167, 268, True, H100_SMEM, H100_SMS)[:4] == (
        1, (6, 167), 6, 8)
    assert antivec_plan(167, 160, True, H100_SMEM, H100_SMS)[:4] == (
        1, (2, 167), 2, 8)
    assert antivec_plan(112, 160, True, H100_SMEM, H100_SMS)[:4] == (
        1, (3, 112), 3, 5)
    assert antivec_plan(1, 2, True, H100_SMEM, H100_SMS)[:4] == (
        1, (1, 1), 1, 1)
    # few matrices spread thin: 45 pairs over 15 blocks at B = 3; 120 at
    # n = 480: 8 a block over 15; 861 at n = 1300: 54 a block over 16, in
    # chunks of 8
    assert antivec_plan(3, 268, True, H100_SMEM, H100_SMS)[:4] == (
        1, (15, 3), 15, 3)
    assert antivec_plan(3, 480, True, H100_SMEM, H100_SMS)[:4] == (
        1, (15, 3), 15, 8)
    assert antivec_plan(2, 1300, True, H100_SMEM, H100_SMS)[:4] == (
        1, (16, 2), 16, 54)
    # the last n whose normalised form fits an H100's block, and the first
    # past it (the parent's limit was n = 12 288)
    last = max(n for n in range(20_000, 30_000)
               if 4 * (2 * n + -(-n // AV_TILE)) + AV_CHUNK * AV_TILE_BYTES
               <= H100_SMEM)
    assert last > 12 * 1024
    assert antivec_plan(1, last, True, H100_SMEM, H100_SMS).smem <= H100_SMEM
    with pytest.raises(ValueError, match="shared memory"):
        antivec_plan(1, last + 1, True, H100_SMEM, H100_SMS)
    antivec_plan(1, last + 1, False, 0, 0)    # the copy has no such limit
    # a block's shared memory to the byte
    need = antivec_plan(3, 268, True, H100_SMEM, H100_SMS).smem
    assert antivec_plan(3, 268, True, need, H100_SMS).smem == need
    with pytest.raises(ValueError, match="shared memory"):
        antivec_plan(3, 268, True, need - 1, H100_SMS)


@pytest.mark.parametrize("norm", (False, True))
@pytest.mark.parametrize("B", (65535, 65536, 2 ** 31 - 1))
def test_plan_takes_batches_past_the_grid_y_extent(B, norm):
    """The grid's y extent stops at 65 535 matrices; the kernels walk the
    rest, so the plan keeps the parent's range of 2^31 - 1."""
    plan = antivec_plan(B, 268, norm, H100_SMEM, H100_SMS)
    assert plan.grid[1] == 65535


@pytest.mark.parametrize("B,n,norm", ((0, 8, False), (AV_MAX_B + 1, 8, False),
                                      (AV_MAX_B + 1, 8, True), (3, 1, False)))
def test_plan_refuses_what_the_grid_cannot_take(B, n, norm):
    with pytest.raises(ValueError, match="per launch"):
        antivec_plan(B, n, norm, H100_SMEM, H100_SMS)


def test_plan_refuses_pairs_past_the_grid():
    nt = 65536                                   # nt (nt + 1) / 2 >= 2^31
    with pytest.raises(ValueError, match="past the grid"):
        antivec_plan(1, nt * AV_TILE, False, 0, 0)
    antivec_plan(1, (nt - 1) * AV_TILE, False, 0, 0)


def test_wrapper_launches_nothing_on_cpu():
    k = KERNELS["anti_vectorize_normalize"]
    before = k.launches
    v = _vectors(2, 33, 0)
    assert torch.equal(KERNEL_OPS.anti_vectorize_normalize(v, 33, False),
                       PLAIN_OPS.anti_vectorize_normalize(v, 33, False))
    assert k.launches == before
    assert len(k.argtypes) == 10     # ..., form, cluster, pairs, vec
    with pytest.raises(ValueError, match="V >= 528"):
        KERNEL_OPS.anti_vectorize_normalize(v[:, :500], 33)


# ---------------------------------------------------------------------------
# col_softmax_bwd
# ---------------------------------------------------------------------------

def _emulate_softmax_bwd(g_q, q, plan):
    """The kernel's rows per warp for ``plan`` (form 0: warp w keeps rows
    4w .. 4w + 3; form 1: rows w, w + W, ...), each warp's partial dot in
    row order, the partials met in warp order; returns g_y and each row's
    visits."""
    F, R, C = q.shape
    if plan.form == 0:
        rows = [[r for r in range(w * CSM_PER, (w + 1) * CSM_PER) if r < R]
                for w in range(plan.warps)]
    else:
        rows = [list(range(w, R, plan.warps)) for w in range(plan.warps)]
    visits = np.zeros(R, np.int64)
    dot = np.zeros((F, C), np.float32)
    for mine in rows:
        part = np.zeros((F, C), np.float32)
        for r in mine:
            part += q[:, r] * g_q[:, r]
            visits[r] += 1
        dot += part
    return q * (g_q - dot[:, None]), visits


@pytest.mark.parametrize("R", (1, 16, 64, 128, 129, 200, 5000))
def test_col_softmax_bwd_plan_covers_every_row(R):
    plan = col_softmax_plan(3, R)
    assert 1 <= plan.warps <= CSM_MAX_WARPS
    # the C entry's check: the register form holds every row
    assert plan.form == (0 if R <= CSM_PER * CSM_MAX_WARPS else 1)
    if plan.form == 0:
        assert plan.warps * CSM_PER >= R > (plan.warps - 1) * CSM_PER
    rng = np.random.default_rng(R)
    C = 5 if R == 5000 else 37
    y = torch.from_numpy((rng.standard_normal((2, R, C)) * 4).astype(
        np.float32))
    q = PLAIN_OPS.col_softmax(y).numpy()
    g_q = rng.standard_normal((2, R, C)).astype(np.float32)
    got, visits = _emulate_softmax_bwd(g_q, q, plan)
    assert (visits == 1).all()
    want = PLAIN_OPS.col_softmax_bwd(torch.from_numpy(g_q),
                                     torch.from_numpy(q)).numpy()
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= 1e-6 * scale


def test_col_softmax_bwd_wrapper_checks_shapes_and_launches_nothing():
    k = KERNELS["col_softmax_bwd"]
    before = k.launches
    q = torch.rand(2, 4, 6)
    assert torch.equal(KERNEL_OPS.col_softmax_bwd(q, q),
                       PLAIN_OPS.col_softmax_bwd(q, q))
    assert k.launches == before and len(k.argtypes) == 8


def _jax_softmax_vjp(y, g):
    """g_y of the upsampler softmax as the JAX package writes it
    (fcsr_tpu/models/fused_gat.py:319-322) over each fold's (feat, m), by
    ``jax.vjp``."""
    jax = importlib.import_module("jax")
    jnp = importlib.import_module("jax.numpy")

    def one(y):
        zmax = jax.lax.stop_gradient(jnp.max(y, axis=0, keepdims=True))
        e = jnp.exp(y - zmax)
        return e / jnp.sum(e, axis=0, keepdims=True)
    _, vjp = jax.vjp(jax.vmap(one), jnp.asarray(y))
    return np.asarray(vjp(jnp.asarray(g))[0])


@pytest.mark.parametrize("shape", ((3, 16, 268), (2, 64, 32), (1, 1, 5),
                                   (2, 200, 7)))
def test_col_softmax_bwd_plain_matches_jax_vjp(shape):
    rng = np.random.default_rng(sum(shape))
    y = (rng.standard_normal(shape) * 4.0).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    want = _jax_softmax_vjp(y, g)
    q = PLAIN_OPS.col_softmax(torch.from_numpy(y))
    scale = max(1.0, float(np.abs(want).max()))
    for ops in (PLAIN_OPS, KERNEL_OPS):
        got = ops.col_softmax_bwd(torch.from_numpy(g), q).numpy()
        assert float(np.abs(got - want).max()) <= 1e-6 * scale
    # the adjoint of a softmax sums to zero down each column
    assert float(np.abs(got.sum(1)).max()) <= 1e-6 * scale


# ---------------------------------------------------------------------------
# the kernels on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run on the card "
                    "only (python3 chip_smoke.py checks them there)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_antivec_kernel_matches_plain_on_card(cuda_device):
    """The copy bit-equal to the plain version, the normalised form
    within 1e-6 with the guard; every launch bit-equal to the next."""
    K, P = KERNEL_OPS, PLAIN_OPS
    cases = [(B, n, 0.0) for B, n in CSV_SHAPES]
    cases += [(3, n, fill) for n in RUN_SIZES for fill in (0.0, 1.0)]
    cases += [(2, 1300, 0.0), (2, 1301, 1.0)]
    # past the grid's y extent: blocks walk the matrices beyond 65 535
    cases += [(65537, 3, 0.0), (65537, 4, 1.0)]
    props = torch.cuda.get_device_properties(cuda_device)
    forms = set()
    for B, n, fill in cases:
        v = _vectors(B, n, n).to(cuda_device)
        for norm in (False, True):
            got = K.anti_vectorize_normalize(v, n, norm, fill)
            again = K.anti_vectorize_normalize(v, n, norm, fill)
            want = P.anti_vectorize_normalize(v, n, norm, fill)
            assert torch.equal(_bits(got), _bits(again))
            if norm:
                _assert_close_nan(got, want, 1e-6)
            else:
                assert torch.equal(_bits(got), _bits(want))
            plan = antivec_plan(B, n, norm,
                                props.shared_memory_per_block_optin,
                                props.multi_processor_count)
            forms.add((plan.form, plan.vec))
    assert forms == {(f, vec) for f in (0, 1) for vec in (False, True)}
    for n in (8, 33, 70):
        v = _guard_vectors(n).to(cuda_device)
        got = K.anti_vectorize_normalize(v, n, True)
        _assert_close_nan(got, P.anti_vectorize_normalize(v, n, True), 1e-6)
        assert bool(torch.isnan(got[:, 2]).all())
        assert bool((got[:, 1, 3] == 0).all())


@pytest.mark.cuda
def test_col_softmax_bwd_kernel_matches_plain_on_card(cuda_device):
    """Within 1e-6 of the plain version's scale in both forms of the plan,
    and bit-equal run to run."""
    g = torch.Generator(device="cpu").manual_seed(0)
    for shape in ((3, 16, 268), (56, 16, 268), (3, 64, 268), (3, 200, 268),
                  (2, 2048, 40), (1, 1, 5)):
        y = (torch.randn(*shape, generator=g) * 4.0).to(cuda_device)
        g_q = torch.randn(*shape, generator=g).to(cuda_device)
        q = KERNEL_OPS.col_softmax(y)
        got = KERNEL_OPS.col_softmax_bwd(g_q, q)
        again = KERNEL_OPS.col_softmax_bwd(g_q, q)
        want = PLAIN_OPS.col_softmax_bwd(g_q, q)
        assert torch.equal(_bits(got), _bits(again))
        scale = max(1.0, float(want.abs().max()))
        assert float((got - want).abs().max()) <= 1e-6 * scale
