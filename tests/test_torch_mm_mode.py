"""``fcsr_tpu_torch/core/mm_mode.py`` (the in-kernel products' precision,
``FCSR_MM_MODE``) against ``fcsr_tpu/core/mosaic_mm.py``, the op
namespaces that follow it, and the bf16 kernels' plain versions.

Tolerances: in the ``bf16`` mode both packages multiply the same bf16
values exactly and sum in fp32, in other orders: within 2e-6 of the
result's scale. In the compensated modes the port multiplies in IEEE fp32
where the JAX package takes three bf16 passes (f32-class, about 2^-17
relative per product): within 1e-4 of the scale. The plain formulations
(``mm_bf16x3`` ...) emulate the JAX ones step for step: within 2e-6.

The JAX side reads ``mosaic_mm.MODE`` at each eager call of ``mm``; the
tests set it only around such calls (never around a cached kernel).
"""

import importlib
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from fcsr_tpu_torch.core import mm_mode
from fcsr_tpu_torch.kernels import (KERNEL_OPS, KERNEL_OPS_BF16, KERNELS,
                                    PLAIN_OPS, PLAIN_OPS_BF16, mode_ops)
from fcsr_tpu_torch.kernels.ops import bgemm_plain

ROOT = Path(__file__).resolve().parents[1]
FORMULATIONS = ("mm_bf16", "mm_bf16x3", "mm_bf16x3_concat")


def _jmm():
    return importlib.import_module("fcsr_tpu.core.mosaic_mm")


def _operands(seed=0, m=12, k=40, n=9):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32)
            for s in ((m, k), (k, n), (m, n))]


def _close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= tol * scale


def _port_vjp(fn, a, b, ct):
    ta, tb = (torch.from_numpy(x).requires_grad_() for x in (a, b))
    out = fn(ta, tb)
    da, db = torch.autograd.grad(out, (ta, tb), torch.from_numpy(ct))
    return out.detach().numpy(), da.numpy(), db.numpy()


def _jax_vjp(fn, a, b, ct):
    jax = importlib.import_module("jax")
    out, vjp = jax.vjp(fn, a, b)
    return (np.asarray(out),) + tuple(np.asarray(g) for g in vjp(ct))


@pytest.mark.parametrize("mode", mm_mode.MODES)
def test_mm_and_its_adjoints_match_jax_in_each_mode(mode, monkeypatch):
    a, b, ct = _operands()
    jmm = _jmm()
    monkeypatch.setattr(mm_mode, "MODE", mode)
    monkeypatch.setattr(jmm, "MODE", mode)
    got = _port_vjp(mm_mode.mm, a, b, ct)
    want = _jax_vjp(jmm.mm, a, b, ct)
    for g, w in zip(got, want):
        _close(g, w, 2e-6 if mode == "bf16" else 1e-4)


@pytest.mark.parametrize("name", FORMULATIONS)
def test_plain_formulations_match_jax(name):
    a, b, _ = _operands(1)
    got = getattr(mm_mode, name)(torch.from_numpy(a), torch.from_numpy(b))
    _close(got.numpy(), getattr(_jmm(), name)(a, b), 2e-6)


@pytest.mark.parametrize("name", ("mm_compensated", "mm_compensated3"))
def test_compensated_products_ignore_the_mode(name, monkeypatch):
    """Always their compensated formulation with its ideal adjoints, as in
    the JAX package (its GAT kernels pin ``mm_compensated``)."""
    a, b, ct = _operands(2)
    want = _jax_vjp(getattr(_jmm(), name), a, b, ct)
    for mode in mm_mode.MODES:
        monkeypatch.setattr(mm_mode, "MODE", mode)
        for g, w in zip(_port_vjp(getattr(mm_mode, name), a, b, ct), want):
            _close(g, w, 2e-6)


def test_bf16_mode_rounds_operands_and_cotangents(monkeypatch):
    """The bf16 adjoints are products of the rounded cotangent: ``da =
    bf16(ct) bf16(b)^T`` exactly as that product, ``db`` likewise."""
    a, b, ct = (torch.from_numpy(x) for x in _operands(3))
    monkeypatch.setattr(mm_mode, "MODE", "bf16")
    r = mm_mode.round_bf16
    out, da, db = _port_vjp(mm_mode.mm, a.numpy(), b.numpy(), ct.numpy())
    assert np.array_equal(out, (r(a) @ r(b)).numpy())
    assert np.array_equal(da, (r(ct) @ r(b).T).numpy())
    assert np.array_equal(db, (r(a).T @ r(ct)).numpy())
    # and the rounding is round to nearest even, as XLA's convert
    jnp = importlib.import_module("jax.numpy")
    x = np.random.default_rng(4).normal(size=4096).astype(np.float32)
    assert np.array_equal(mm_mode.round_bf16(torch.from_numpy(x)).numpy(),
                          np.asarray(jnp.asarray(x).astype(jnp.bfloat16)
                                     .astype(jnp.float32)))


def test_round_through_rounds_value_and_cotangent():
    x = torch.from_numpy(_operands(5)[0]).requires_grad_()
    y = mm_mode.round_through(x)
    ct = torch.from_numpy(_operands(6)[0])
    (g,) = torch.autograd.grad(y, x, ct)
    assert torch.equal(y, mm_mode.round_bf16(x.detach()))
    assert torch.equal(g, mm_mode.round_bf16(ct))


def test_unknown_mode_raises_at_the_first_product(monkeypatch):
    monkeypatch.setattr(mm_mode, "MODE", "fp8")
    a, b = (torch.from_numpy(x) for x in _operands()[:2])
    for call in (lambda: mm_mode.mm(a, b), mode_ops,
                 lambda: mode_ops(plain=True)):
        with pytest.raises(ValueError, match="unknown FCSR_MM_MODE='fp8'; "
                           "expected 'bf16x3_concat', 'bf16' or 'bf16x3'"):
            call()


@pytest.mark.parametrize("mode,kernel,plain", [
    ("bf16x3_concat", KERNEL_OPS, PLAIN_OPS),
    ("bf16x3", KERNEL_OPS, PLAIN_OPS),
    ("bf16", KERNEL_OPS_BF16, PLAIN_OPS_BF16)])
def test_mode_ops_read_the_mode_at_each_call(mode, kernel, plain,
                                             monkeypatch):
    monkeypatch.setattr(mm_mode, "MODE", mode)
    assert mode_ops() is kernel and mode_ops(plain=True) is plain


def test_mode_comes_from_the_environment_at_import():
    code = "from fcsr_tpu_torch.core import mm_mode; print(mm_mode.MODE)"
    for env, want in (({}, "bf16x3_concat"), ({"FCSR_MM_MODE": "bf16"},
                                             "bf16")):
        e = {k: v for k, v in os.environ.items() if k != "FCSR_MM_MODE"}
        out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                             env={**e, **env}, capture_output=True,
                             text=True, check=True)
        assert out.stdout.strip() == want


def test_bf16_namespaces_swap_only_the_rounding_ops():
    swapped = {"bgemm", "rank_select", "gather_rows", "scatter_rows",
               "pool_bwd_pair", "add_bias"}
    for fp32, bf16 in ((KERNEL_OPS, KERNEL_OPS_BF16),
                       (PLAIN_OPS, PLAIN_OPS_BF16)):
        assert vars(fp32).keys() == vars(bf16).keys()
        for name in vars(fp32):
            assert (getattr(fp32, name) is getattr(bf16, name)) == (
                name not in swapped), name
    assert {f"{n}_bf16" for n in swapped} <= set(KERNELS)


def _r(x):
    return x.to(torch.bfloat16).to(torch.float32)


def test_bgemm_bf16_plain_is_the_product_of_rounded_operands():
    """Every form of the product (ta / tb, a row of ones, bias, add) is
    ``bgemm_plain`` of the rounded operands; the bias is rounded only as a
    product's operand (``bias_operand``)."""
    g = torch.Generator().manual_seed(0)
    a, b = torch.randn(2, 5, 7, generator=g), torch.randn(2, 7, 3,
                                                          generator=g)
    bias, add = torch.randn(2, 1, 3, generator=g), torch.randn(2, 5, 3,
                                                               generator=g)
    P = PLAIN_OPS_BF16
    for ta, tb in ((False, False), (True, False), (False, True)):
        x = a.transpose(1, 2).contiguous() if ta else a
        y = b.transpose(1, 2).contiguous() if tb else b
        assert torch.equal(P.bgemm(x, y, ta, tb, bias=bias, add=add),
                           bgemm_plain(_r(x), _r(y), ta, tb, bias, add))
    assert torch.equal(P.bgemm(a, b, bias=bias, bias_operand=True),
                       bgemm_plain(_r(a), _r(b), bias=_r(bias)))
    assert torch.equal(P.bgemm(None, b), bgemm_plain(None, _r(b)))
    # the fp32 product takes the bias as it is either way
    assert torch.equal(PLAIN_OPS.bgemm(a, b, bias=bias, bias_operand=True),
                       PLAIN_OPS.bgemm(a, b, bias=bias))


def test_rounding_instances_round_what_a_one_hot_product_rounds():
    """The pool, the row kernels and the bias add in the bf16 mode against
    the fp32 plain versions with the rounding written out: the kept scores
    and rows, the scattered rows (scaled, before the addend), the
    adjoint's products and their sum, the start weights."""
    g = torch.Generator().manual_seed(1)
    F, n, k, m = 2, 20, 13, 8
    logits = torch.randn(F, n, generator=g) * 100
    src, gp = torch.randn(F, n, m, generator=g), torch.randn(F, k, m,
                                                             generator=g)
    pre, add = torch.randn(F, k, m, generator=g), torch.randn(F, n, m,
                                                              generator=g)
    P, P32 = PLAIN_OPS_BF16, PLAIN_OPS
    s, idx, vals, slot, pre_r, x = P.rank_select(logits, k, src=src)
    s32, idx32, vals32, slot32 = P32.rank_select(logits, k)
    assert torch.equal(s, s32) and torch.equal(idx, idx32)
    assert torch.equal(slot, slot32) and torch.equal(vals, _r(vals32))
    assert torch.equal(pre_r, _r(P32.gather_rows(src, idx)))
    assert torch.equal(x, pre_r * vals[..., None])
    assert torch.equal(P.gather_rows(gp, idx[:, :k]),
                       _r(P32.gather_rows(gp, idx[:, :k])))
    assert torch.equal(P.scatter_rows(gp, slot),
                       _r(P32.scatter_rows(gp, slot)))
    g_d, g_l = P.pool_bwd_pair(gp, pre, slot, s, vals, add)
    assert torch.equal(g_d, _r(P32.scatter_rows(gp, slot, vals)) + add)
    dot = _r(gp * pre).sum(-1)
    g_s = torch.where(slot >= 0, torch.take_along_dim(
        dot, slot.clamp(min=0).long(), 1), torch.zeros(()))
    assert torch.equal(g_l, _r(g_s) * s * (1.0 - s) * (1.0 / 100.0))
    w, bias = torch.randn(F, n, m, generator=g), torch.randn(F, 1, m,
                                                             generator=g)
    assert torch.equal(P.add_bias(w, bias), _r(w) + bias)


def test_gat_step_ignores_the_mode(monkeypatch):
    """The GAT U-Net's step takes its ops from ``KERNEL_OPS`` in every
    mode, as the JAX package's GAT kernels pin ``mm_compensated``."""
    from fcsr_tpu_torch.models.fused_gat import GATLayout, gat_train_step_fused
    rng = np.random.default_rng(0)
    F, n, mm, dim, ks, heads = 2, 20, 32, 4, (0.5, 0.5), 2
    layout = GATLayout(dim, ks, heads, n, mm)

    def t(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale)
                                .astype(np.float32))

    p = t(F, layout.size, scale=0.1)
    a0 = t(F, n, n, scale=0.1).abs()
    a0 = 0.5 * (a0 + a0.transpose(1, 2))
    args = (p, torch.zeros_like(p), torch.zeros_like(p), a0, t(F, n, dim),
            t(F, mm, mm).abs(), torch.tensor([[1.0, 1e-3, 0.1, 0.001]] * F))
    kw = dict(dim=dim, ks=ks, n_nodes=n, m_nodes=mm, heads=heads,
              device="cpu")
    outs = []
    for mode in ("bf16x3_concat", "bf16"):
        monkeypatch.setattr(mm_mode, "MODE", mode)
        outs.append(gat_train_step_fused(*args, **kw))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run on the card "
                    "only (python3 chip_smoke.py checks them there)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3, 268, 268, 268), (3, 30, 268, 268),
                                   (3, 268, 1, 160), (3, 1, 268, 144),
                                   (2, 33, 17, 1)])
def test_bgemm_bf16_kernel_matches_plain_on_card(cuda_device, shape):
    """The dense, matrix-vector, column-sum (``a=None``) and rank-1 paths
    against the plain version: the same exact products, fp32 sums in
    another order (within 1e-5 x max(scale, K)), two launches bit-equal."""
    F, M, N, K = shape
    g = torch.Generator().manual_seed(0)
    a = None if M == 1 else torch.randn(F, M, K, generator=g).to(cuda_device)
    b = torch.randn(F, K, N, generator=g).to(cuda_device)
    bias = torch.randn(F, 1, N, generator=g).to(cuda_device)
    for bo in (False, True):
        got = KERNEL_OPS_BF16.bgemm(a, b, bias=bias, bias_operand=bo)
        again = KERNEL_OPS_BF16.bgemm(a, b, bias=bias, bias_operand=bo)
        want = PLAIN_OPS_BF16.bgemm(a, b, bias=bias, bias_operand=bo)
        scale = max(1.0, float(want.abs().max()), float(K))
        assert float((got - want).abs().max()) <= 1e-5 * scale
        assert torch.equal(got, again)


@pytest.mark.cuda
def test_rounding_instances_match_plain_on_card(cuda_device):
    g = torch.Generator().manual_seed(2)
    F, n, k, m = 3, 160, 144, 268
    dev = cuda_device
    logits = (torch.randn(F, n, generator=g) * 100).to(dev)
    src, skip = (torch.randn(F, n, m, generator=g).to(dev) for _ in range(2))
    gp, pre = (torch.randn(F, k, m, generator=g).to(dev) for _ in range(2))
    K, P = KERNEL_OPS_BF16, PLAIN_OPS_BF16
    for got, want in zip(K.rank_select(logits, k, src=src),
                         P.rank_select(logits, k, src=src)):
        assert torch.equal(got, want)
    s, idx, vals, slot = K.rank_select(logits, k)
    assert torch.equal(K.gather_rows(src, idx), P.gather_rows(src, idx))
    assert torch.equal(K.scatter_rows(gp, slot), P.scatter_rows(gp, slot))
    g_d, g_l = K.pool_bwd_pair(gp, pre, slot, s, vals, skip)
    w_d, w_l = P.pool_bwd_pair(gp, pre, slot, s, vals, skip)
    assert torch.equal(g_d, w_d)
    assert float((g_l - w_l).abs().max()) <= 1e-5 * max(
        1.0, float(w_l.abs().max()))
    w, bias = torch.randn(F, n, m, generator=g).to(dev), torch.randn(
        F, 1, m, generator=g).to(dev)
    assert torch.equal(K.add_bias(w, bias), P.add_bias(w, bias))
