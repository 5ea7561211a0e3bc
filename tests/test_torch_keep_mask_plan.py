"""The standalone keep mask's launch plan (``fcsr_tpu_torch/kernels/csrc/
gat.cu::philox_keep_mask_kernel``).

A block walks one strip of one (fold, head) plane: grid (strips, heads, F),
``KM_THREADS`` threads of ``vec`` consecutive draws, planes longer than the
strips grid-stride. Here the kernel's thread-to-element map is emulated in
numpy over hypothesis-drawn (batch, heads, per_head), the 4-byte path
(per_head % 4 != 0, an unaligned x) among them: every element of every
plane is written exactly once, with the generator's counter equal to the
element's index in its plane, so the emulated output equals the plain
version bit for bit. The plan refuses what no grid or counter takes. On the
CPU the wrapper launches nothing and returns the plain version; the kernel
against the plain version runs on the card only (``cuda``-marked). No test
here touches torch's global generator.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from fcsr_tpu_torch.kernels import KERNEL_OPS, KERNELS, PLAIN_OPS
from fcsr_tpu_torch.kernels.ops import (KM_THREADS, KM_WAVE, MAX_F,
                                        bits_to_keep, philox_keep_mask_plain,
                                        philox_keep_mask_plan, philox_words)
from fcsr_tpu_torch.models.fused_gat import _mask_shapes

EDGE_SEEDS = (-2 ** 31, 2 ** 31 - 1)
# the shipped GAT config's masks (dim 16, ks (0.5, 0.5, 0.5), 4 heads, 160
# nodes): (name, heads, (rows, cols)) in draw_masks' order
GAT_MASKS = tuple(_mask_shapes(16, (0.5, 0.5, 0.5), 160, 4))


def _seeds(F, seed, edge=False):
    rng = np.random.default_rng(seed)
    s = rng.integers(-2 ** 31, 2 ** 31, size=(F, 2), dtype=np.int64)
    if edge:
        s[0] = EDGE_SEEDS
    return torch.from_numpy(s.astype(np.int32))


def _thread_elements(plan, per_head):
    """(starts, vec) of every draw group the kernel's threads take in one
    plane, in launch order: thread t of strip b starts at (b T + t) vec and
    steps by the grid's stride while the 32-bit loop lets it (the
    kernel's ``per_head - e <= stride`` break)."""
    T, V = KM_THREADS, plan.vec
    stride = plan.strips * T * V
    assert stride < 2 ** 32
    starts = []
    for first in (np.arange(plan.strips * T, dtype=np.int64) * V):
        e = int(first)
        while e < per_head:
            starts.append(e)
            if per_head - e <= stride:
                break
            e += stride
    return np.asarray(starts, dtype=np.int64), V


def _emulate(seeds, mask_id, heads, per_head, drop_p, plan):
    """The kernel's output by its thread map: block (strip, head, f)
    writes plane f heads + head at the elements its threads take, each the
    keep bit of the word at counter (element, head, mask_id, 0); also the
    number of writes of each element."""
    F = seeds.shape[0]
    keep = bits_to_keep(philox_words(seeds, mask_id, heads, per_head),
                        drop_p).numpy()
    out = np.full(F * heads * per_head, np.nan, np.float32)
    writes = np.zeros(F * heads * per_head, np.int64)
    starts, V = _thread_elements(plan, per_head)
    elems = (starts[:, None] + np.arange(V)[None, :]).ravel()
    assert elems.max(initial=-1) < per_head      # no vector past the plane
    for f in range(F):
        for head in range(heads):
            base = (f * heads + head) * per_head
            out[base + elems] = keep[f, head, elems]   # counter = element
            np.add.at(writes, base + elems, 1)
    return out, writes


@settings(max_examples=60, deadline=None, derandomize=True)
@given(batch=st.integers(1, 5), heads=st.integers(1, 4),
       per_head=st.one_of(st.integers(1, 3000),
                          st.integers(1, 800).map(lambda k: 4 * k),
                          st.sampled_from([2 ** 16, 2 ** 18 + 4, 2 ** 18 + 3,
                                           KM_THREADS * 4 * 17])),
       aligned=st.booleans())
def test_plan_writes_every_element_once_at_its_counter(batch, heads,
                                                       per_head, aligned):
    plan = philox_keep_mask_plan(batch, heads, per_head, aligned)
    assert plan.vec == (4 if aligned and per_head % 4 == 0 else 1)
    assert 1 <= plan.strips <= MAX_F
    # no more strips than the plane needs; about one wave in all
    assert (plan.strips - 1) * KM_THREADS * plan.vec < per_head
    assert plan.strips * batch * heads <= max(KM_WAVE, batch * heads)
    seeds = _seeds(batch, per_head + heads)
    out, writes = _emulate(seeds, 3, heads, per_head, 0.3, plan)
    assert (writes == 1).all()
    want = philox_keep_mask_plain(seeds, 3, heads, 1, per_head, 0.3)
    np.testing.assert_array_equal(out, want.numpy().ravel())


@pytest.mark.parametrize("shape,aligned,want", (
    # the keep-rate shape: 64 strips x 16 planes, 1 024 blocks, one wave
    ((4, 4, 256 * 256), True, (64, 4)),
    # draw_masks' largest and smallest F = 3 masks, a pool mask
    ((3, 4, 160 * 160), True, (25, 4)),
    ((3, 2, 20 * 20), True, (1, 4)),
    ((3, 1, 160 * 32), True, (5, 4)),
    # the 4-byte path: an odd plane, an unaligned x
    ((3, 2, 7 * 9), True, (1, 1)),
    ((3, 1, 160 * 32), False, (20, 1)),
    # one long plane: a wave of strips, walked grid-stride
    ((1, 1, 2 ** 32 - 4), True, (KM_WAVE, 4)),
    ((1, 1, 2 ** 32 - 1), True, (KM_WAVE, 1)),
    # more planes than a wave: a strip each
    ((MAX_F, 2, 64), True, (1, 4)),
))
def test_plan_at_the_masks_shapes(shape, aligned, want):
    assert tuple(philox_keep_mask_plan(*shape, aligned)) == want


def test_plan_shapes_of_the_shipped_gat_masks():
    """Every mask draw_masks dumps at F = 3 takes the 16-byte path."""
    for name, heads, (rows, cols) in GAT_MASKS:
        plan = philox_keep_mask_plan(3, heads, rows * cols, True)
        assert plan.vec == 4, name
        assert plan.strips * KM_THREADS * 4 >= rows * cols, name


def test_plan_refuses_what_no_grid_or_counter_takes():
    with pytest.raises(ValueError, match="folds"):
        philox_keep_mask_plan(MAX_F + 1, 1, 16, True)
    with pytest.raises(ValueError, match="heads"):
        philox_keep_mask_plan(1, MAX_F + 1, 16, True)
    with pytest.raises(ValueError, match="32-bit"):
        philox_keep_mask_plan(1, 1, 2 ** 32, True)
    with pytest.raises(ValueError, match="32-bit"):
        philox_keep_mask_plan(3, 4, 2 ** 16 * 2 ** 16 + 4, False)
    philox_keep_mask_plan(MAX_F, MAX_F, 2 ** 32 - 1, False)  # the largest


def test_wrapper_on_cpu_is_the_plain_version_and_launches_nothing():
    seeds = _seeds(3, 1, edge=True)
    g = torch.Generator(device="cpu").manual_seed(2)
    flat = torch.randn(3 * 2 * 7 * 9 + 1, generator=g)
    x = flat[1:].view(3, 2, 7, 9)           # one float off 16 bytes
    assert x.data_ptr() % 16 != 0
    before = sum(k.launches for k in KERNELS.values())
    for args in ((seeds, 0, 4, 16, 16, 0.1),
                 (seeds, 4, 2, 7, 9, 0.3, x, 1 / 0.7)):
        got = KERNEL_OPS.philox_keep_mask(*args)
        want = PLAIN_OPS.philox_keep_mask(*args)
        assert torch.equal(got, want)
        assert torch.equal(got, philox_keep_mask_plain(*args))
    assert sum(k.launches for k in KERNELS.values()) == before


# ---------------------------------------------------------------------------
# the kernel on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run on the card "
                    "only (python3 chip_smoke.py checks them there)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernel_matches_plain_bit_for_bit_on_card(cuda_device):
    """At the keep-rate shape, every mask draw_masks dumps at F = 3, an odd
    plane (the 4-byte path), x applied from an aligned buffer and from a
    view one float off 16 bytes, and the edge seeds."""
    dev = cuda_device
    K, P = KERNEL_OPS, PLAIN_OPS
    g = torch.Generator(device="cpu").manual_seed(5)
    cases = [(4, 0, 4, 256, 256, 0.1)]
    cases += [(3, mask_id, heads, rows, cols, 0.01)
              for mask_id, (_, heads, (rows, cols)) in enumerate(GAT_MASKS)]
    cases += [(3, 1, 2, 7, 9, 0.3)]
    for F, mask_id, heads, rows, cols, p in cases:
        for edge in (False, True):
            seeds = _seeds(F, mask_id + 7 * heads, edge).to(dev)
            args = (seeds, mask_id, heads, rows, cols, p)
            assert torch.equal(K.philox_keep_mask(*args),
                               P.philox_keep_mask(*args))
            n = F * heads * rows * cols
            flat = torch.randn(n + 1, generator=g).to(dev)
            for x in (flat[:n], flat[1:]):      # aligned, one float off
                x = x.view(F, heads, rows, cols)
                s = 1.0 / (1.0 - p)
                assert torch.equal(K.philox_keep_mask(*args, x, s),
                                   P.philox_keep_mask(*args, x, s))
