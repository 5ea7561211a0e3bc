"""The loss entry points' scalars written by the spectral term's
``l1_term`` launch (``fcsr_tpu_torch/kernels/csrc/tail.cu``), where the
TPU kernels store their two (1, 1) outputs.

``l1_term`` at slot 2 with ``loss`` / ``recon`` writes ``vals[0] +
(vals[1] + vals[2])`` (``adam_masked``'s order) or, without ``with_l1``,
``vals[1] + vals[2]`` (slot 0 unread), and ``vals[1]``: bit for bit, on
terms whose two summation orders round apart. The three loss entry points
(#4 ``tail_loss_fused``, #8 ``gsr_step_loss_fused``, #10
``step_value_and_grad_fused``) return exactly those sums of their own
terms, and ``train_step_fused`` passes no scalars (its loss is Adam's).
The card test holds the kernel to the same sums (``pytest --noconftest -m
cuda``: it needs no JAX).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from fcsr_tpu_torch.iox.weights import leaf_names, leaf_tensors_to_state
from fcsr_tpu_torch.kernels import KERNEL_OPS, KERNELS, PLAIN_OPS
from fcsr_tpu_torch.models import fused_step as fs
from fcsr_tpu_torch.models.fused_tail import (tail_loss_fused,
                                              tail_value_and_grad)
from fcsr_tpu_torch.models.gsr import GSRNet, pool_sizes

N, M, KS, LMBDA = 20, 32, (0.9, 0.7), 16.0
TAIL = ("layer.weights", "gc1.weight", "gc2.weight")
CSRC = Path(__file__).resolve().parents[1] / "fcsr_tpu_torch" / "kernels" / \
    "csrc"
TINY = 2.0 ** -24


def _terms(F=3):
    """vals with slot 0 = 1 and slot 1 = 2^-24, and (a, b) whose spectral
    term is exactly 2^-24: 1 + (2^-24 + 2^-24) = 1 + 2^-23, while (1 +
    2^-24) + 2^-24 rounds to 1."""
    vals = torch.tensor([[1.0, TINY, 0.0]] * F)
    a = torch.full((F, M, N), TINY)
    return vals, a, torch.zeros(F, M, N)


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("ops", ["plain", "kernel"])
@pytest.mark.parametrize("with_l1", [True, False])
def test_l1_term_writes_the_loss_in_adam_masked_order(ops, with_l1):
    op = (PLAIN_OPS if ops == "plain" else KERNEL_OPS).l1_term
    vals, a, b = _terms()
    if not with_l1:
        vals[:, 0] = float("nan")                 # never read
    loss, recon = torch.empty(3), torch.empty(3)
    grad = op(a, b, vals, 2, 1.0, 1.0 / (M * N), False, loss=loss,
              recon=recon, with_l1=with_l1)
    assert float(vals[0, 2]) == TINY
    want = torch.full((3,), 1.0 + 2.0 ** -23 if with_l1 else 2.0 ** -23)
    assert torch.equal(_bits(loss), _bits(want))
    assert torch.equal(_bits(recon), _bits(vals[:, 1]))
    if with_l1:     # the other order rounds apart: the test would see it
        assert float((vals[0, 0] + vals[0, 1]) + vals[0, 2]) != 1.0 + 2 ** -23
    # the scalars change nothing else
    v2, _, _ = _terms()
    assert torch.equal(grad, op(a, b, v2, 2, 1.0, 1.0 / (M * N), False))
    assert torch.equal(v2[:, 1:], vals[:, 1:])


def test_loss_without_recon_and_without_scalars():
    vals, a, b = _terms()
    loss = torch.empty(3)
    PLAIN_OPS.l1_term(a, b, vals, 2, 1.0, 1.0, False, loss=loss)
    assert torch.equal(loss, vals[:, 0] + (vals[:, 1] + vals[:, 2]))
    before = vals.clone()
    PLAIN_OPS.l1_term(a, b, vals, 1, 1.0, 1.0, False)
    assert torch.equal(vals[:, 1], torch.full((3,), TINY))
    assert torch.equal(vals[:, [0, 2]], before[:, [0, 2]])


@pytest.mark.parametrize("case", ["slot 1", "slot 0", "recon alone",
                                  "short loss"])
def test_l1_term_refuses_scalars_off_the_last_term(case):
    vals, a, b = _terms()
    kw = {"slot 1": dict(slot=1, loss=torch.empty(3)),
          "slot 0": dict(slot=0, loss=torch.empty(3), recon=torch.empty(3)),
          "recon alone": dict(slot=2, recon=torch.empty(3)),
          "short loss": dict(slot=2, loss=torch.empty(2))}[case]
    slot = kw.pop("slot")
    for op in (PLAIN_OPS.l1_term, KERNEL_OPS.l1_term):
        with pytest.raises(ValueError, match="l1_term|loss and recon"):
            op(a, b, vals, slot, 1.0, 1.0, False, **kw)


def _inputs(F=2, seed=0):
    """Flat weights of F GSRNet inits at the tiny width and seeded data."""
    from fcsr_tpu_torch.iox.weights import state_to_flat
    flat = np.stack([state_to_flat({k: v.numpy() for k, v in GSRNet(
        KS, N, M, M, device="cpu", seed=seed + j).state_dict().items()})
        for j in range(F)])
    g = torch.Generator().manual_seed(seed)
    u_lr = torch.linalg.qr(torch.randn(F, N, N, generator=g))[0]
    u_hr = torch.randn(F, M, N, generator=g)
    hr = torch.rand(F, M, M, generator=g)
    return (torch.from_numpy(flat), u_lr.contiguous(), u_hr,
            (hr + hr.transpose(1, 2)) / 2)


def _entry_losses(p, u_lr, u_hr, hr):
    """#4, #8 and #10's (loss, recon) on the given inputs, and the terms of
    the tail and of the step computed by the same ops."""
    P = fs.FlatLayout(N, M, len(KS)).views(p)
    tail = [P[k] for k in TAIL]
    F = p.shape[0]
    with torch.no_grad():
        f0, _ = fs.unet_forward_rankselect(P, KS, N)
        t_loss = tail_loss_fused(*tail, f0, u_lr, u_hr, hr, device=p.device)
        l8, r8 = fs.gsr_step_loss_fused(
            {k: P[k] for k in leaf_names(len(KS), tail=False)}, *tail, u_lr,
            u_hr, hr, KS, N, M, LMBDA, device=p.device)
        state = {k: t.contiguous()
                 for k, t in leaf_tensors_to_state(P).items()}
        l10, r10, _ = fs.step_value_and_grad_fused(
            state, u_lr, u_hr, hr, KS, N, M, M, LMBDA, device=p.device)
        t_vals = torch.full((F, 3), float("nan"), device=p.device)
        tail_value_and_grad(KERNEL_OPS, *tail, f0, u_lr, u_hr, hr, t_vals)
        G = fs.FlatLayout(N, M, len(KS)).views(torch.empty_like(p))
        s_vals = fs.step_value_and_grads(KERNEL_OPS, P, G, u_lr, u_hr, hr,
                                         pool_sizes(N, KS), LMBDA)
    return (t_loss, (l8, r8), (l10, r10), t_vals, s_vals)


def test_entry_points_return_their_terms_summed_in_adam_masked_order():
    t_loss, step8, step10, t_vals, s_vals = _entry_losses(*_inputs())
    assert torch.equal(_bits(t_loss), _bits(t_vals[:, 1] + t_vals[:, 2]))
    want = s_vals[:, 0] + (s_vals[:, 1] + s_vals[:, 2])
    for loss, recon in (step8, step10):
        assert torch.equal(_bits(loss), _bits(want))
        assert torch.equal(_bits(recon), _bits(s_vals[:, 1]))


def test_train_step_passes_no_scalars_and_adam_sums_the_loss():
    """``train_step_fused``'s loss and recon are ``adam_masked``'s (times
    ok), the same bits as the loss entry point's on the same weights."""
    p, u_lr, u_hr, hr = _inputs()
    z = torch.zeros_like(p)
    scal = torch.tensor([[1.0, 0.1, 0.001]] * 2)
    loss, recon, *_ = fs.train_step_fused(p, z, z, u_lr, u_hr, hr, scal, KS,
                                          N, M, LMBDA, 1e-4, device="cpu")
    _, (l8, r8), _, _, _ = _entry_losses(p, u_lr, u_hr, hr)
    assert torch.equal(_bits(loss), _bits(l8))
    assert torch.equal(_bits(recon), _bits(r8))


def test_loss_terms_launch_is_gone():
    """The scalars have no kernel of their own: no binding, no C entry."""
    assert "loss_terms" not in KERNELS
    assert not hasattr(KERNEL_OPS, "loss_terms")
    assert not hasattr(PLAIN_OPS, "loss_terms")
    for src in CSRC.glob("*.cu"):
        assert not re.search(r"loss_terms", src.read_text()), src.name


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run on the card "
                    "only (python3 chip_smoke.py checks them there)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_entry_point_scalars_match_the_plain_fused_form_on_card(cuda_device):
    """On the card: the kernel's scalars are the plain fused form's sums of
    the kernel's own terms, bit for bit, at the tiny width and for
    ``l1_term`` alone on terms that round apart."""
    t_loss, step8, step10, t_vals, s_vals = _entry_losses(
        *[t.to(cuda_device) for t in _inputs()])
    assert torch.equal(_bits(t_loss), _bits(t_vals[:, 1] + t_vals[:, 2]))
    want = s_vals[:, 0] + (s_vals[:, 1] + s_vals[:, 2])
    for loss, recon in (step8, step10):
        assert torch.equal(_bits(loss), _bits(want))
        assert torch.equal(_bits(recon), _bits(s_vals[:, 1]))
    for with_l1 in (True, False):
        vals, a, b = (t.to(cuda_device) for t in _terms())
        loss, recon = (torch.empty(3, device=cuda_device) for _ in range(2))
        KERNEL_OPS.l1_term(a, b, vals, 2, 1.0, 1.0, False, loss=loss,
                           recon=recon, with_l1=with_l1)
        plain = vals.cpu()
        p_loss, p_recon = torch.empty(3), torch.empty(3)
        PLAIN_OPS.l1_term(a.cpu(), b.cpu(), plain, 2, 1.0, 1.0, False,
                          loss=p_loss, recon=p_recon, with_l1=with_l1)
        assert torch.equal(_bits(loss.cpu()), _bits(p_loss))
        assert torch.equal(_bits(recon.cpu()), _bits(p_recon))
